"""The port's int8 inference (ops/quant.py, ConvLayer's int8 route, DeepFuse's
int8 chain, the test CLI's --int8) against the JAX package's, on the CPU,
with images made from a numpy seed and the same weights (JAX's init with
seeded biases, carried by jax_to_state_dict) and the same amax dict on both
sides:

- DeepFuse's int8 chain against JAX `fast_inference` + MMIF_CHAIN_INTERPRET
  (conv_hiw_chain_q and conv_hiw_chain in Pallas interpret mode): 'sum'
  with int8-resident hops, 'sum' with MMIF_HIW_INT8_RES=0, and 'mean';
  and with MMIF_HIW_INT8=0 and in autoencoder mode, the ConvLayer route on
  all five layers;
- DenseFuse and VIFNet: ConvLayer's int8 route against the JAX package's
  NHWC int8 route with its real kernel (conv_tlane_dma_q,
  MMIF_CHAIN_INTERPRET=1 outside fast_inference), applied eagerly as
  tests/test_int8.py applies it (DBNet, Res2Fusion and UNFusion: tests/
  test_torch_int8_multiscale.py);
- the test CLI's --int8 on a tiny dataset prints the calibrated count the
  JAX test CLI prints.

Tolerance as tests/test_int8.py:121-128: max <= 2e-2 and mean <= 1e-4 of
max|y|. The integer dots are exact and both sides round the dequant's
multiply-add once, so where every layer is int8 the forwards agree to f32
rounding; the tolerance admits isolated one-quantum flips, where a value
that f32 noise of the float layers (stride-2 convs, upsamples, attention,
the depthwise convs) or an ulp of the fold puts on a rounding boundary
quantizes to the neighbouring integer, and their spread downstream. The
JAX package's fake-quant emulation (MMIF_INT8_FAKE=1) is not the
reference here: its f32 conv of dequantized values flips quanta against
its own kernel (the JAX test allows the same 2e-2 / 1e-4 for it).
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.cli import test as jax_test_cli
from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops import quant as jquant
from multi_modal_image_fusion_tpu.ops.layers import fast_inference
from multi_modal_image_fusion_tpu.train.checkpoint import save_checkpoint
from multi_modal_image_fusion_tpu_torch.cli import test as test_cli
from multi_modal_image_fusion_tpu_torch.data.io import imwrite
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import quant
from multi_modal_image_fusion_tpu_torch.train.checkpoint import \
    save_state_dict
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

MAX_REL, MEAN_REL = 2e-2, 1e-4


def _with_bias(tree, r):
    for leaf in tree.values():
        if "bias" in leaf:
            leaf["bias"] = (0.1 * (r.rand(*leaf["bias"].shape)
                                   - 0.5)).astype(np.float32)
        elif "kernel" not in leaf:
            _with_bias(leaf, r)


@functools.lru_cache(maxsize=None)
def _variables(name):
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    v = jax.jit(functools.partial(jcreate(name).init, train=False))(
        jax.random.PRNGKey(0), x, x)
    params = jax.tree.map(np.array, v["params"])
    _with_bias(params, np.random.RandomState(1))
    return {"params": params}


def _pairs(seed, b, h, w):
    r = np.random.RandomState(seed)
    return [r.rand(b, h, w, 1).astype(np.float32) for _ in range(2)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    d = np.abs(got - want)
    assert d.max() <= MAX_REL * scale, (d.max() / scale, d.mean() / scale)
    assert d.mean() <= MEAN_REL * scale, (d.max() / scale, d.mean() / scale)
    return d.max() / scale


def _both(name, imgs, jax_scope, env=(), **cfg):
    """(JAX int8 output, port int8 output, JAX f32 output) of one model on
    `imgs`, both quantized on the port's calibration of the same images."""
    variables = _variables(name)
    port = create_model(name, **cfg)
    port.load_state_dict(jax_to_state_dict(variables, name))
    port.eval()
    amax = quant.calibrate(port, [tuple(torch.from_numpy(x) for x in imgs)])
    jm = jcreate(name, **cfg)
    with contextlib.ExitStack() as stack:
        for k, v in env:
            stack.enter_context(_setenv(k, v))
        with jax.default_matmul_precision("float32"):
            want32 = np.asarray(jm.apply(variables, *map(jnp.asarray, imgs),
                                         train=False))
            with _setenv("MMIF_CHAIN_INTERPRET", "1"), jax_scope(), \
                    jquant.quantized_inference(amax):
                want = np.asarray(jm.apply(variables, *map(jnp.asarray, imgs),
                                           train=False))
        with quant.quantized_inference(amax), torch.no_grad():
            got = port(*map(torch.from_numpy, imgs)).numpy()
    return want, got, want32


@contextlib.contextmanager
def _setenv(key, value):
    old = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old


@pytest.mark.parametrize("mode,env", [
    ("sum", ()), ("sum", (("MMIF_HIW_INT8_RES", "0"),)), ("mean", ())],
    ids=["sum_resident", "sum_nonresident", "mean"])
def test_deepfuse_int8_chain_vs_jax(mode, env):
    imgs = _pairs(3, 2, 40, 64)
    want, got, want32 = _both("deepfuse", imgs, fast_inference, env,
                              fusion_mode=mode)
    _close(got, want)
    assert np.abs(want - want32).max() > 1e-3 * np.abs(want32).max()


def test_deepfuse_resident_hops_change_the_result():
    """The int8-resident hops are taken: with them the output differs
    from the non-resident chain's (per-branch requant and an integer
    siamese sum against one rounding of the float sum)."""
    imgs = _pairs(5, 2, 40, 64)
    outs = {}
    for flag in ("1", "0"):
        with _setenv("MMIF_HIW_INT8_RES", flag):
            outs[flag] = _both("deepfuse", imgs, fast_inference)[1]
    assert np.abs(outs["1"] - outs["0"]).max() > 0


@pytest.mark.parametrize("case", ["hiw_int8_off", "ae"])
def test_deepfuse_conv_layer_route_vs_jax(case):
    """MMIF_HIW_INT8=0, and autoencoder mode: every layer on ConvLayer's
    int8 route (c_in 1 and c_out 1 included)."""
    imgs = _pairs(6, 2, 33, 47)
    if case == "ae":
        imgs = imgs[:1]
        env = ()
    else:
        env = (("MMIF_HIW_INT8", "0"),)
    want, got, _ = _both("deepfuse", imgs, contextlib.nullcontext, env)
    assert _close(got, want) < 1e-5        # every layer int8: no flips


@pytest.mark.parametrize("name", ["densefuse", "vifnet"])
def test_models_int8_vs_jax(name):
    imgs = _pairs(2, 2, 32, 40)
    want, got, want32 = _both(name, imgs, contextlib.nullcontext)
    assert _close(got, want) < 1e-5        # every layer int8: no flips
    assert np.abs(want - want32).max() > 1e-3 * np.abs(want32).max()


def test_skip_keeps_layers_float():
    """Skipping every layer gives the float forward exactly; the env
    variable adds to the context's set."""
    imgs = [torch.from_numpy(x) for x in _pairs(7, 1, 24, 32)]
    model = create_model("densefuse",
                         generator=torch.Generator().manual_seed(0)).eval()
    amax = quant.calibrate(model, [tuple(imgs)])
    with torch.no_grad():
        want = model(*imgs)
        with quant.quantized_inference(amax, skip=tuple(amax)):
            assert torch.equal(model(*imgs), want)
        with quant.quantized_inference(amax, skip=("dec1",)):
            assert not torch.equal(model(*imgs), want)
        with _setenv("MMIF_INT8_SKIP", ",".join(amax)), \
                quant.quantized_inference(amax, skip=("dec1",)):
            assert torch.equal(model(*imgs), want)


def test_int8_route_is_forward_only():
    imgs = [torch.from_numpy(x) for x in _pairs(8, 1, 16, 16)]
    for name in ("deepfuse", "densefuse"):
        model = create_model(name, generator=torch.Generator().manual_seed(0))
        amax = quant.calibrate(model, [tuple(imgs)])
        for a in (amax, {}):        # the chain's legs, the dynamic route
            if name == "deepfuse" and not a:
                continue            # uncalibrated chain legs stay float
            with quant.quantized_inference(a), \
                    pytest.raises(RuntimeError, match="forward-only"):
                model(*imgs)


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_int8_cli")
    data = root / "datasets" / "tinyset"
    rng = np.random.RandomState(0)
    for mod in ("vis", "ir"):
        os.makedirs(data / "test" / mod)
    for i, (h, w) in enumerate([(40, 56), (33, 47), (36, 40)]):
        base = (rng.rand(h, w) * 255).astype(np.uint8)
        noise = (rng.rand(h, w) * 60).astype(np.uint8)
        imwrite(str(data / "test" / "vis" / f"{i + 1}.png"), base)
        imwrite(str(data / "test" / "ir" / f"{i + 1}.png"),
                255 - base // 2 + noise // 3)
    variables = _variables("deepfuse")
    meta = {"model": "deepfuse"}
    save_checkpoint(str(root / "jax" / "run" / "epoch_best.ckpt"), variables,
                    meta=meta)
    save_state_dict(str(root / "port" / "run" / "epoch_best.pth"),
                    jax_to_state_dict(variables, "deepfuse"), meta=meta)
    return root


def test_cli_int8_prints_the_jax_calibrated_count(cli_setup, capsys):
    def args(side, *extra):
        return ["--data", "tinyset", "--data_root",
                str(cli_setup / "datasets"), "--ckpt_root",
                str(cli_setup / side), "--ckpt", "run", "--int8", *extra]
    ssim_j, _ = jax_test_cli.main(args("jax"))
    line_j = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("int8:")]
    ssim_p, _ = test_cli.main(args("port", "--device", "cpu"))
    line_p = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("int8:")]
    assert line_p == line_j == ["int8: calibrated 5 conv layers on 3 image "
                                "pairs"]
    # outside fast_inference the JAX CLI runs its float convs here (its
    # int8 route needs a TPU or MMIF_CHAIN_INTERPRET); the port's int8
    # SSIM stays near that float SSIM
    assert np.isfinite(ssim_p) and abs(ssim_p - ssim_j) < 1e-2
