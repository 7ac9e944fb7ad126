"""Shared harness of the port's int8 tests of the models that serve in float
(tests/test_torch_int8_{norms,norm_models,nestfuse,rfnnest,mafusion,pfnet,
myfusion,myfusion_sep,mixformer,transformer}.py, one deep model a file so
that `--dist loadfile` spreads them) against the JAX package's int8 route.
It holds no test itself.

Weights: the variables tree of `jax.eval_shape` of the JAX model's init
filled from a numpy seed (`jax_model`, as test_torch_myfusion.seeded
fills MyFusion's), carried by `jax_to_state_dict`.

Images: two pairs of 32x40 from numpy seed 2 (64x64 for MyFusion, whose
four levels and the Attention's k16 pool need it). The port calibrates on
them (`quant.calibrate`); the JAX side records its own amax in the same
jitted forward that gives its f32 output (`model.apply(...,
mutable=["quant_stats"])`), and the calibration check holds the two
within 1e-5 of each layer's largest value. Both int8 forwards then
quantize on the port's amax. The JAX int8 forward runs the real kernel
(conv_tlane_dma_q) in the Pallas interpreter (MMIF_CHAIN_INTERPRET=1)
under jax.jit with the amax passed as arguments (as tests/
test_torch_int8_multiscale.py runs it), with two changes that touch no
JAX file: its fold `choose_fold` returns the port's fold of the same
amax, passed as a traced argument (tests/test_torch_quant.py holds the
two folds within two ulps; under jit XLA evaluated JAX's pow one ulp
apart from its eager route at NestFuse's CB4_0 conv1, which moved one
weight quantum and every output pixel by up to 2.1e-2), and its
quantizer's integer outputs are returned beside the image. The f32
forward, its calibration and the int8 forward are one jitted function,
compiled once a model and process (`jax_forwards`, functools.lru_cache).

`check_int8`: the port's int8 forward with the JAX package's integer
inputs replayed into its quantizer (each int8 conv convolves JAX's
integers) within max 2e-2 and mean 1e-4 of max|y| (tests/test_int8.py:
121-128; it agrees to ~1e-7, the float layers' f32 rounding); the JAX
int8 output differs from its f32 output by more than 1e-3 of the largest
value (the int8 route ran); the port's own quantizer, on the inputs it
computes from JAX's integers upstream, rounds at most 1e-3 of the values
to another integer, one quantum each: flips of values within f32 noise
of a half-integer. Where no flip reaches the output the port's own int8
forward is also within the tolerance. Where one does, a flip spreads
through the layers after it: mixformer_ls_concat, one flipped quantum of
6.8 million, moves the fused image by up to 5.2e-2 of its largest value
(mean 3.5e-3); transformer_fs_elem (4 of 7.7 million) 1.3e-2 (1.4e-3);
RFNNest (12 of 6.1 million) 8.5e-3 (7.0e-4). Those three hold the replay
and the flip count only. The port runs on one torch thread (`one_thread`:
a loaded test run's six workers otherwise oversubscribe the cores); its
f32 rounding, and so its flips, depend on the thread count (RFNNest
flips none on eight threads).
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_myfusion as mf

from flax import linen as flax_nn

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops import quant as jquant
from multi_modal_image_fusion_tpu.ops.layers import ConvLayer as JConvLayer
from multi_modal_image_fusion_tpu.ops.pallas import conv_int8 as jq
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import quant
from multi_modal_image_fusion_tpu_torch.ops.cuda import conv_int8 as cint8
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

MAX_REL, MEAN_REL = 2e-2, 1e-4
TRANSFORMER_FS_ELEM = dict(encoder="transformer", decoder="fs",
                           fusion_method="elem", fusion_mode="sum")
MIXFORMER_LS_CONCAT = dict(encoder="mix_former", decoder="ls",
                           fusion_method="concat", up_mode="nearest",
                           share_weight_levels=2)
# key: (model, configuration, MyFusion weight seed); module 4's models
CONFIGS = {
    **{n: (n, {}, None) for n in (
        "ifcnn", "difnet", "pmgi", "sedrfuse", "nestfuse", "rfnnest",
        "mafusion", "pfnetv1", "pfnetv2")},
    "myfusion_default": ("myfusion", {}, 0),
    "myfusion_sep_batch": ("myfusion", dict(encoder="sep", norm="batch"),
                           0),
    "myfusion_mixformer_ls_concat": ("myfusion", MIXFORMER_LS_CONCAT, 0),
    "myfusion_transformer_fs_elem": ("myfusion", TRANSFORMER_FS_ELEM, 0),
}
# conv layers the JAX forward runs and no output reads (PMGI's reference
# quirk, models/zoo.py PMGI): the port runs them in training and
# calibration only
DEAD = {"pmgi": {"transfer1_1"}}


@contextlib.contextmanager
def setenv(key, value):
    old = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old


@contextlib.contextmanager
def one_thread():
    """torch on one thread: the port's side is small, and a loaded test
    run's workers otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def images(key):
    name = CONFIGS[key][0]
    h, w = (64, 64) if name == "myfusion" else (32, 40)
    r = np.random.RandomState(2)
    return [r.rand(2, h, w, 1).astype(np.float32) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def jax_model(key):
    """(JAX model, variables) of a configuration, built once: the variables
    tree of `jax.eval_shape` of its init filled from a numpy seed
    (`test_torch_myfusion.seeded_tree`: Kaiming normal kernels, conv_out's
    as |w|, biases, norm shifts and means within +-0.1, scales in [0.5,
    1.5], variances in [0.5, 2]); no init compile."""
    name, cfg, seed = CONFIGS[key]
    if name == "myfusion":
        return mf.seeded(cfg, seed)
    jm = jcreate(name, **cfg)
    x = jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.PRNGKey(0), x, x)
    shapes = {k: shapes[k] for k in ("params", "batch_stats") if k in shapes}
    return jm, mf.seeded_tree(shapes, 100, live=("conv_out",))


def port_model(key):
    name, cfg, _ = CONFIGS[key]
    model = create_model(name, **cfg)
    model.load_state_dict(jax_to_state_dict(
        jax_model(key)[1], name, **getattr(model, "layout_cfg", {})))
    return model.eval()


@functools.lru_cache(maxsize=None)
def port_amax(key):
    with one_thread():
        return quant.calibrate(port_model(key), [tuple(
            torch.from_numpy(x) for x in images(key))])


@functools.lru_cache(maxsize=None)
def port_folds(key):
    """{flax path: the port's fold of the layer's calibrated amax}
    (`quant.choose_fold`), the fold both int8 forwards quantize on."""
    amax = port_amax(key)
    model = quant.name_layers(port_model(key))
    return {m.qpath: quant.choose_fold(amax[m.qpath], m.weight.detach())
            .numpy() for m in int8_layers(model)}


@functools.lru_cache(maxsize=None)
def jax_forwards(key):
    """The JAX model on `images(key)`, one jitted function compiled once:
    (its f32 output, its calibration {flax path: amax} from the same
    forward with the quant_stats collection mutable, its int8 output
    quantized on the port's amax, [(flax path, its integer input with the
    reflect halo cropped)] of every int8 conv in call order, recorded from
    the quantizer's outputs that the function returns beside the image)."""
    jm, variables = jax_model(key)
    where, quanta = [], []

    def intercept(next_fun, args, kwargs, context):
        if not (isinstance(context.module, JConvLayer)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        where.append(("/".join(context.module.path), context.module.ksize))
        try:
            return next_fun(*args, **kwargs)
        finally:
            where.pop()
    real_q = jq.quantize_input_scaled

    def recorded_q(x, f):
        q = real_q(x, f)
        quanta.append((*where[-1], q))
        return q

    def fwd(v, am, folds, a, b):
        y32, upd = jm.apply(v, a, b, train=False, mutable=["quant_stats"])
        quanta.clear()

        def fold(*_, **__):         # the layer's fold, a traced argument
            return folds[where[-1][0]]
        with jquant.quantized_inference(am), flax_nn.intercept_methods(
                intercept), patched(jq, choose_fold=fold):
            y = jm.apply(v, a, b, train=False)
        return y32, upd.get("quant_stats", {}), y, [q for _, _, q in quanta]
    args = (variables,
            {k: jnp.asarray(v) for k, v in port_amax(key).items()},
            {k: jnp.asarray(v) for k, v in port_folds(key).items()},
            *map(jnp.asarray, images(key)))
    with jax.default_matmul_precision("float32"), \
            setenv("MMIF_CHAIN_INTERPRET", "1"), patched(
                jq, quantize_input_scaled=recorded_q):
        y32, stats, y, qs = jax.jit(fwd)(*args)
    record = []
    for (path, k), q in zip([(p, k) for p, k, _ in quanta], qs):
        p = k // 2
        q = np.asarray(q)
        record.append((path, q[:, p:q.shape[1] - p, p:q.shape[2] - p]
                       if p else q))
    stats = {k: np.asarray(v, np.float32)
             for k, v in jquant._flatten(stats).items()}
    return np.asarray(y32), stats, np.asarray(y), record


@contextlib.contextmanager
def patched(module, **attrs):
    kept = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in kept.items():
            setattr(module, k, v)


def _by_path(record):
    out = {}
    for path, q in record:
        out.setdefault(path, []).append(q)
    return out


def port_int8(key, model=None, replay=None):
    """(the port's int8 output on `images(key)`, [(flax path, integer
    input)] of its int8 convs). `replay` (jax_forwards' record): each int8
    conv convolves the JAX package's integer input in place of its own
    (a layer the JAX encoder ran once a modality reads both calls'
    integers in one batch)."""
    model = model or port_model(key)
    quant.name_layers(model)
    jax_q = {k: list(v) for k, v in _by_path(replay or []).items()}
    where, record = [], []
    real_int8, real_q = ConvLayer._int8, cint8.quantize_input_scaled

    def int8(self, *a, **kw):
        where.append(self.qpath)
        try:
            return real_int8(self, *a, **kw)
        finally:
            where.pop()

    def recorded_q(x, f):
        q = real_q(x, f)
        record.append((where[-1], q.numpy()))
        if replay is None:
            return q
        queue = jax_q[where[-1]]
        want = queue.pop(0)
        if want.shape != q.shape:       # one call a modality in JAX
            want = np.concatenate([want, queue.pop(0)])
        return torch.tensor(want)
    with quant.quantized_inference(port_amax(key)), torch.no_grad(), \
            one_thread(), patched(ConvLayer, _int8=int8), \
            patched(cint8, quantize_input_scaled=recorded_q):
        y = model(*map(torch.from_numpy, images(key))).numpy()
    if replay is not None:
        left = {k for k, v in jax_q.items() if v}
        assert left <= DEAD.get(key, set()), f"JAX integers left: {left}"
    return y, record


def check_calibrate(key):
    """The port's calibration against the JAX package's: the same keys (the
    flax paths of every conv layer), each layer's values within 1e-5 of
    its largest."""
    _, want, _, _ = jax_forwards(key)
    got = port_amax(key)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-5 * max(float(w.max()), 1e-30),
                                   err_msg=k)


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    d = np.abs(got - want)
    assert d.max() <= MAX_REL * scale, (d.max() / scale, d.mean() / scale)
    assert d.mean() <= MEAN_REL * scale, (d.max() / scale, d.mean() / scale)
    return d.max() / scale


def flips(key):
    """(quanta where the port's quantizer, on the inputs it computes from
    the JAX package's integers replayed upstream, rounds to another integer
    than the JAX package's, quanta in all): each by one quantum at most,
    a rounding flip of a value within f32 noise of a half-integer."""
    _, _, _, jrec = jax_forwards(key)
    _, prec = port_int8(key, replay=jrec)
    jq_, pq = _by_path(jrec), _by_path(prec)
    assert set(jq_) - DEAD.get(key, set()) == set(pq)
    n_diff = n_all = 0
    for path, qs in pq.items():
        want = np.concatenate(jq_[path]).astype(np.int32)
        got = np.concatenate(qs).astype(np.int32)
        assert got.shape == want.shape, path
        d = np.abs(got - want)
        assert d.max() <= 1, (path, int(d.max()))
        n_diff += int((d > 0).sum())
        n_all += d.size
    return n_diff, n_all


def check_int8(key, flip_free=True):
    """The port's int8 forward against the JAX int8 route: with the JAX
    package's integer inputs replayed, within `close`; the route ran (the
    JAX int8 output is not its f32 one); the port's own integers differ
    from the JAX package's in one quantum at most, at no more than 1e-3 of
    them. `flip_free`: also the port's own forward within `close` (a
    model whose float layers put no value on a rounding boundary at these
    inputs)."""
    want32, _, want, record = jax_forwards(key)
    close(port_int8(key, replay=record)[0], want)
    assert np.abs(want - want32).max() > 1e-3 * np.abs(want32).max()
    n_diff, n_all = flips(key)
    assert n_diff <= 1e-3 * n_all, (n_diff, n_all)
    if flip_free:
        close(port_int8(key)[0], want)
    return n_diff, n_all


def int8_layers(model):
    """The ConvLayers the int8 gate sends to conv_int8."""
    return [m for m in model.modules()
            if isinstance(m, ConvLayer) and m._int8_eligible()]
