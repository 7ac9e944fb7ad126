"""The port's SEDRFuse (plain path, CPU) against the JAX package (harness:
tests/test_torch_zoo_common.py), its conv biases and group norms seeded
non-trivial:

- JAX `model.apply` (max fusion of the shallow features, softmax-attention
  fusion of the deep one) and autoencoder mode at 64x64 and 32x48;
- the reference PyTorch goldens `model_sedrfuse.npz` and
  `model_fwd_sedrfuse.npz`, state dicts loaded by their own names; an
  image whose H or W is not a multiple of 4 (the goldens' 45x61) raises;
- the layers SEDRFuse adds: `group_norm` against flax GroupNorm and
  float64, the stride-2 route's NHWC reflect pad against F.pad, a
  group-normed layer against the reference golden, the transpose conv
  against the JAX ConvLayer(transpose=True) and the reference golden, a
  group-normed stride-1 conv against the JAX kernel `conv_tlane_dma` in the
  Pallas interpreter followed by the flax norm;
- the parameter count and state-dict shapes, the weight carry round trip,
  its leftover rejection and the carry of a JAX TrainState;
- the serving routes at the published widths, counted on the CPU as the
  card's launches (1 conv_gray_enter, 2 conv_chain, 1 conv_gray_exit), the
  fast training route's conv_valid_fast calls, and the int8 route's
  refusal (queued);
- one JAX train step against the port's, plain and fast routes: loss parts
  within 2e-5, gradients within 1e-4 of the largest, parameters within
  1e-6 where the gradient is above that (`_compare_step`; a conv bias
  under a group norm has a zero gradient in exact arithmetic, so it is
  among the loose elements).

Tolerances: 1e-4 for model forwards, 2e-5 for layers (docs/PARITY.md),
f32 on both sides.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from flax import serialization
from flax.core import FrozenDict

import test_torch_zoo_common as common
from conftest import nchw_to_nhwc, nhwc_to_nchw
from param_synth import synth_state_dict
from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops.layers import ConvLayer as JConvLayer
from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import \
    conv_tlane_dma
from multi_modal_image_fusion_tpu.parallel.mesh import make_mesh, replicate
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule as jax_schedule
from multi_modal_image_fusion_tpu.train.trainer import Trainer as JTrainer
from multi_modal_image_fusion_tpu.train.trainer import TrainState
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import layers
from multi_modal_image_fusion_tpu_torch.ops.layers import (ConvLayer,
                                                           fast_training,
                                                           group_norm)
from multi_modal_image_fusion_tpu_torch.train.schedules import \
    make_lr_schedule
from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import (
    jax_to_state_dict, jax_train_state_to_torch)

NAME = "sedrfuse"
HWS = [(64, 64), (32, 48)]
LAUNCHES = {"conv_gray_enter": 1, "conv_chain": 2, "conv_gray_exit": 1}
ATOL = common.ATOL          # model forwards
LAYER_ATOL = 2e-5           # layers


def _x(shape, seed, lo=-0.5):
    return (np.random.RandomState(seed).rand(*shape) + lo).astype(np.float32)


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("ae", [False, True], ids=["fuse", "ae"])
def test_vs_jax_apply(ae, hw):
    common.check_vs_apply(NAME, hw, ae)


@pytest.mark.parametrize("fname", ["model_sedrfuse", "model_fwd_sedrfuse"])
def test_vs_reference_goldens(golden, fname):
    """The reference goldens (y, y_ae); the state dict by its own names
    (`sd__*` keys, or synthesised from `keyshapes`)."""
    d = golden(fname)
    if "keyshapes" in d.files:
        sd = {k: torch.from_numpy(v) for k, v in synth_state_dict(
            json.loads(bytes(d["keyshapes"]).decode())).items()}
    else:
        sd = {k[len("sd__"):]: torch.from_numpy(d[k]) for k in d.files
              if k.startswith("sd__")}
    model = create_model(NAME)
    model.load_state_dict(sd)
    model.eval()
    x1, x2 = nchw_to_nhwc(d["x1"]), nchw_to_nhwc(d["x2"])
    np.testing.assert_allclose(nhwc_to_nchw(common.run(model, x1, x2)),
                               d["y"], atol=ATOL)
    np.testing.assert_allclose(nhwc_to_nchw(common.run(model, x1)),
                               d["y_ae"], atol=ATOL)


def test_rejects_sizes_not_multiple_of_4(golden):
    d = golden("model_fwd_sedrfuse")
    model = create_model(NAME).eval()
    x1o, x2o = nchw_to_nhwc(d["x1o"]), nchw_to_nhwc(d["x2o"])
    assert x1o.shape[1:3] == (45, 61)
    with pytest.raises(ValueError, match="multiples of 4"):
        common.run(model, x1o, x2o)


def test_param_count_and_names():
    common.check_counts(NAME, "SEDRFuse")


def test_weight_carry_round_trip():
    common.check_round_trip(NAME, common.variables(NAME))


@pytest.mark.parametrize("where", ["top", "conv", "stats", "norm"])
def test_weight_carry_rejects_leftovers(where):
    if where != "norm":
        common.check_rejects_leftovers(NAME, where)
        return
    v = jax.tree.map(np.copy, common.variables(NAME))
    v["params"]["enc1"]["norm"]["mean"] = np.zeros(128, np.float32)
    with pytest.raises(ValueError, match="unconverted"):
        jax_to_state_dict(v, NAME)


def test_serving_routes(monkeypatch):
    model = common.random_norms(create_model(NAME), 1).eval()
    x1, x2 = torch.rand(2, 16, 24, 1), torch.rand(2, 16, 24, 1)
    assert common.kernel_calls(monkeypatch, model, x1, x2) == LAUNCHES
    assert common.kernel_calls(monkeypatch, model, x1) == LAUNCHES


def test_int8_route_raises():
    """SEDRFuse's int8 route (the name is the test's first one, when the
    route refused): the four stride-1 convs (enc0, the ResBlock's two,
    dec2) run conv_int8, the stride-2 and transpose convs stay float (the
    JAX package's gate); enc0's output is its integer conv dequantized
    plus the bias, then the group norm and relu, within 2e-5 of max|y|."""
    from multi_modal_image_fusion_tpu_torch.ops import quant
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import \
        int_conv_plain
    model = common.random_norms(create_model(NAME), 2).eval()
    x = torch.rand(1, 16, 16, 1)
    calls = []
    real = layers.conv_int8

    def spy(xx, qw, *a, **kw):
        calls.append(tuple(qw.shape))
        return real(xx, qw, *a, **kw)
    layers.conv_int8 = spy
    try:
        with torch.no_grad(), quant.quantized_inference({}):
            y = model(x, x)
            got = model.encode[0](x)
    finally:
        layers.conv_int8 = real
    assert torch.isfinite(y).all() and y.shape == (1, 16, 16, 1)
    assert calls == [(64, 1, 3, 3), (256, 256, 3, 3), (256, 256, 3, 3),
                     (1, 64, 3, 3), (64, 1, 3, 3)]
    enc0 = model.encode[0]
    with torch.no_grad():
        f = quant.choose_fold(x.abs().amax(dim=(0, 1, 2)), enc0.weight)
        qw, sw = quant.quantize_weights(quant.fold_weights(enc0.weight, f))
        acc = int_conv_plain(quant.quantize_input_scaled(x, f), qw)
        gn = enc0.layers[1]
        want = F.group_norm((acc * sw + enc0.bias).permute(0, 3, 1, 2), 64,
                            gn.weight, gn.bias, eps=1e-5).relu().permute(
                                0, 2, 3, 1)
    assert float((got - want).abs().max()) <= 2e-5 * float(
        want.abs().max())


def test_fast_training_route(monkeypatch):
    """Under fast_training(True) with a gradient, the four stride-1 convs
    (enc0, the ResBlock's two, dec2) take conv_valid_fast, the stride-2 and
    transpose convs F.conv2d / F.conv_transpose2d; the output equals the
    plain training route's and the serving route's (a group norm has no
    running statistics)."""
    model = create_model(NAME, generator=torch.Generator().manual_seed(3))
    calls = []
    real = layers.conv_valid_fast
    monkeypatch.setattr(layers, "conv_valid_fast",
                        lambda x, w: calls.append(w.shape) or real(x, w))
    x1, x2 = (torch.from_numpy(_x((2, 16, 24, 1), s, 0.0)) for s in (4, 5))
    with fast_training(True):
        y = model(x1, x2)
    assert sorted(calls) == sorted([(64, 1, 3, 3), (256, 256, 3, 3),
                                    (256, 256, 3, 3), (1, 64, 3, 3)])
    assert y.grad_fn is not None
    with fast_training(False):
        y_plain = model(x1, x2)
    with torch.no_grad():
        y_serve = model(x1, x2)
    np.testing.assert_allclose(y.detach().numpy(), y_plain.detach().numpy(),
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(y.detach().numpy(), y_serve.numpy(),
                               atol=LAYER_ATOL)


# --- layers -----------------------------------------------------------------

def _gn_input(spread, offset, seed=6, c=32):
    """(x, scale, bias): NHWC channels of spreads in `spread` and means in
    +-offset, a seeded non-trivial affine."""
    r = np.random.RandomState(seed)
    x = (_x((3, 11, 14, c), seed + 1) * r.uniform(*spread, c)
         + r.uniform(-offset, offset, c)).astype(np.float32)
    return (x, r.uniform(0.5, 1.5, c).astype(np.float32),
            r.uniform(-0.1, 0.1, c).astype(np.float32))


@pytest.mark.parametrize("act", [None, "relu"])
def test_group_norm_vs_flax(act):
    """group_norm against flax GroupNorm(num_groups=C). Flax takes the
    fast variance E[x^2] - E[x]^2, whose f32 rounding grows with
    (mean / std)^2: the channels keep that ratio below ~5, as a conv's
    outputs do (test_group_norm_vs_float64 holds the port where it is
    larger)."""
    x, scale, bias = _gn_input((0.5, 3.0), 1.0)
    gn = fnn.GroupNorm(num_groups=x.shape[-1], epsilon=1e-5)
    want = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}},
                               jnp.asarray(x)))
    if act == "relu":
        want = np.maximum(want, 0.0)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias), act).numpy()
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL)


def test_group_norm_vs_float64():
    """group_norm in f32 against the same function in float64 on channels
    whose mean is up to ~70 times their spread: the port's two-pass
    variance stays within 2e-5 there."""
    x, scale, bias = _gn_input((0.1, 3.0), 2.0)
    m = x.astype(np.float64).mean(axis=(1, 2), keepdims=True)
    v = ((x - m) ** 2).mean(axis=(1, 2), keepdims=True)
    want = (x - m) / np.sqrt(v + 1e-5) * scale + bias
    got = group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL)


def test_group_norm_batch_chunks(monkeypatch):
    """In batch chunks the norm is the same function (per-image
    statistics), on the autograd path too."""
    x = torch.from_numpy(_x((5, 9, 7, 16), 8)).requires_grad_()
    w, b = torch.rand(16) + 0.5, torch.rand(16) - 0.5
    want = group_norm(x, w, b, "relu")
    monkeypatch.setattr(layers, "GN_CHUNK_ELEMS", 2 * 9 * 7 * 16)
    got = group_norm(x, w, b, "relu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (g1,) = torch.autograd.grad(want.square().sum(), x)
    (g2,) = torch.autograd.grad(got.square().sum(), x)
    torch.testing.assert_close(g2, g1, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_reflect_pad_nhwc(p):
    """The stride-2 route's NHWC reflect pad equals F.pad(mode='reflect') on
    the NCHW view bit for bit; its gradient (the same sums in another
    order) within f32 rounding."""
    x = torch.from_numpy(_x((2, 9, 7, 5), 20 + p)).requires_grad_()
    got = layers.reflect_pad_nhwc(x, p)
    want = F.pad(x.permute(0, 3, 1, 2), (p,) * 4,
                 mode="reflect").permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    (g1,) = torch.autograd.grad((got * got).sum(), x)
    (g2,) = torch.autograd.grad((want * want).sum(), x)
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-6)


def _golden_layer(d, key, layer):
    sd = {k[len(key) + 6:]: torch.from_numpy(d[k]) for k in d.files
          if k.startswith(f"{key}__sd__")}
    layer.load_state_dict(sd)
    with torch.no_grad():
        return nhwc_to_nchw(layer(torch.from_numpy(
            nchw_to_nhwc(d["x"]))).numpy())


def test_group_norm_layer_vs_reference_golden(golden):
    """ConvLayer(norm='group') against the reference layer's output
    (layers.npz `gn`: k3 8 -> 16, GroupNorm(16, 16), relu), its state dict
    by name."""
    d = golden("layers")
    got = _golden_layer(d, "gn", ConvLayer(8, 16, norm="group").eval())
    np.testing.assert_allclose(got, d["gn__out"], atol=LAYER_ATOL,
                               rtol=1e-4)


def test_transpose_conv_vs_reference_golden(golden):
    """The transpose conv (k3, stride 2, padding 1, output padding 1, relu)
    against the reference layer (layers.npz `deconv`: 8 -> 4, 21x27 ->
    42x54)."""
    d = golden("layers")
    got = _golden_layer(d, "deconv", ConvLayer(8, 4, stride=2,
                                               transpose=True).eval())
    assert got.shape == d["deconv__out"].shape
    np.testing.assert_allclose(got, d["deconv__out"], atol=LAYER_ATOL,
                               rtol=1e-4)


def _seeded_jax_layer(jl, x, seed):
    v = jax.tree.map(np.array, jl.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(x))["params"])
    r = np.random.RandomState(seed)
    v["bias"] = r.uniform(-0.1, 0.1, v["bias"].shape).astype(np.float32)
    if "norm" in v:
        n = v["norm"]["scale"].shape
        v["norm"] = {"scale": r.uniform(0.5, 1.5, n).astype(np.float32),
                     "bias": r.uniform(-0.1, 0.1, n).astype(np.float32)}
    return v


def _port_layer(layer, v):
    k = v["kernel"]
    sd = {"layers.0.weight": torch.from_numpy(np.ascontiguousarray(
              k.transpose(2, 3, 0, 1) if layer.transpose
              else k.transpose(3, 2, 0, 1))),
          "layers.0.bias": torch.from_numpy(v["bias"])}
    if "norm" in v:
        sd["layers.1.weight"] = torch.from_numpy(v["norm"]["scale"])
        sd["layers.1.bias"] = torch.from_numpy(v["norm"]["bias"])
    layer.load_state_dict(sd)
    return layer.eval()


@pytest.mark.parametrize("norm", [None, "group"])
@pytest.mark.parametrize("kind", ["transpose", "stride2"])
def test_strided_layers_vs_jax(kind, norm):
    """SEDRFuse's decoder transpose convs and encoder stride-2 convs, with
    and without the group norm, against the JAX ConvLayer (its XLA routes),
    on odd sizes."""
    x = _x((2, 9, 13, 24), 9)
    kw = dict(transpose=True) if kind == "transpose" else {}
    jl = JConvLayer(16, stride=2, norm=norm, **kw)
    v = _seeded_jax_layer(jl, x, 10)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jl.apply({"params": v}, jnp.asarray(x)))
    layer = _port_layer(ConvLayer(24, 16, stride=2, norm=norm, **kw), v)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL)


def test_group_normed_conv_vs_tpu_kernel():
    """A group-normed stride-1 conv at a narrow shape (64 channels at 16x24)
    on its serving route (conv_chain's plain version, no activation, then
    group_norm and relu) against the JAX package's kernel route: the
    reflect-padded input through `conv_tlane_dma` in the Pallas
    interpreter, the bias, flax GroupNorm, relu."""
    x = _x((2, 16, 24, 64), 11)
    jl = JConvLayer(64, norm="group")
    v = _seeded_jax_layer(jl, x, 12)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                 mode="reflect")
    with jax.default_matmul_precision("float32"):
        y = conv_tlane_dma(xp, jnp.asarray(v["kernel"]), 3,
                           interpret=True) + v["bias"]
    y = fnn.GroupNorm(num_groups=64, epsilon=1e-5).apply(
        {"params": v["norm"]}, y)
    want = np.maximum(np.asarray(y), 0.0)
    layer = _port_layer(ConvLayer(64, 64, norm="group"), v)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL)


# --- training ---------------------------------------------------------------

SCHED = (1e-4, 10, 12)


def _batch(seed):
    r = np.random.RandomState(seed)
    return (r.rand(2, 32, 32, 1).astype(np.float32),
            r.rand(2, 32, 32, 1).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """A JAX Trainer's state on the harness's seeded init (conv biases and
    norms non-trivial), its gradients on one batch and the state after one
    step, as numpy trees: (params before, grads, params after, loss parts,
    serialised state)."""
    jt = JTrainer(jcreate(NAME), jax_schedule(*SCHED),
                  mesh=make_mesh(jax.devices()[:1]))
    params = common.variables(NAME)["params"]
    jparams = jax.tree.map(jnp.asarray, params)
    state = replicate(TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        batch_stats=FrozenDict(), opt_state=jt.tx.init(jparams)), jt.mesh)
    x1, x2 = map(jnp.asarray, _batch(13))

    def loss_fn(p):
        return jt.loss_bundle(x1, x2, jt.model.apply({"params": p}, x1, x2,
                                                     train=True))[0]
    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(jparams))
    state, parts, _ = jt.train_step(state, (x1, x2))
    after = jax.tree.map(np.asarray, jax.device_get(state.params))
    blob = serialization.to_bytes(jax.device_get(state))
    return (params, grads, after, {k: float(v) for k, v in parts.items()},
            serialization.msgpack_restore(blob))


@pytest.mark.parametrize("fast", [False, True])
def test_train_step_matches_jax(fast):
    params, grads, after, jparts, _ = _jax_step()
    model = create_model(NAME)
    model.load_state_dict(jax_to_state_dict({"params": params}, NAME))
    pt = Trainer(model, make_lr_schedule(*SCHED), fast=fast)
    x1, x2 = map(torch.from_numpy, _batch(13))
    jg = jax_to_state_dict({"params": grads}, NAME)
    with fast_training(fast):
        total, _ = pt.loss_bundle(x1, x2, pt.model(x1, x2))
        pg = dict(zip(pt.params, torch.autograd.grad(
            total, list(pt.params.values()))))
    scale = max(float(g.abs().max()) for g in jg.values())
    for k, g in pg.items():
        assert float((g - jg[k]).abs().max()) <= 1e-4 * scale, k
    parts, imgf = pt.train_step((x1, x2))
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k]), jparts[k], atol=2e-5)
    jp = jax_to_state_dict({"params": after}, NAME)
    for k, v in pt.model.state_dict().items():
        # Adam's first step moves a parameter by lr * g / (|g| + eps): held
        # to 1e-6 wherever the gradient is above the gradient tolerance, as
        # tests/test_torch_train.py does; below it (the biases under a
        # group norm among them) by at most 2 lr
        loose = jg[k].abs() < 1e-4 * scale
        diff = (v - jp[k]).abs()
        assert float(torch.where(loose, 0.0, diff).max()) <= 1e-6, k
        assert float(diff.max()) <= 2e-4, k
    assert pt.step == 1 and imgf.shape == (2, 32, 32, 1)


def test_train_state_carry():
    """The JAX TrainState after one step (flax msgpack, as a checkpoint
    stores it) carried into the port's model and Trainer: parameters and
    Adam moments equal."""
    _, _, after, _, restored = _jax_step()
    sd, opt = jax_train_state_to_torch(restored, NAME)
    assert opt["step"] == 1
    model = create_model(NAME)
    model.load_state_dict(sd)
    want = jax_to_state_dict({"params": after}, NAME)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    pt = Trainer(model, make_lr_schedule(*SCHED))
    pt.load_state_dict(opt)
    assert pt.step == 1
    assert sorted(pt.mu) == sorted(pt.nu) == sorted(sd)
    assert any(float(v.abs().max()) > 0 for v in pt.mu.values())
