"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device, nvcc and no JAX; every test skips without a card.
Run on the GPU machine with (the JAX-importing conftest is skipped):

    python -m pytest --noconftest tests/test_torch_kernels.py

Tolerances, relative to the largest magnitude of the plain output: f32
1e-4 (the kernel and the plain version sum the same f32 products in another
order; TF32 is off for the plain convs); bf16 2e-2 (both compute in f32 and
round the output to bf16, whose 8-bit mantissa is 2^-8 ~ 4e-3 of a value,
and a different summation order can flip that rounding). conv_chain and
conv_multi in bf16 (the wgmma body), like conv_wide: 1e-3 beyond one bf16
ulp of each output (the same exact products of bf16 weights and inputs, an
f32 sum in another order, one rounding to bf16), with controls that must
miss by 10x (`test_conv_chain_controls_fail`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    conv_chain, conv_chain_plain, conv_gray_enter, conv_gray_enter_plain,
    conv_gray_exit, conv_gray_exit_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import (
    conv_multi, conv_multi_plain, identity_weights)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_valid import (
    conv_valid, conv_valid_dw, conv_valid_dw_plain, conv_valid_dx,
    conv_valid_dx_plain, conv_valid_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.moments import (
    moments, moments_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_vjp import \
    conv_valid_fast
from multi_modal_image_fusion_tpu_torch.ops.cuda.ssim_kernel import (
    ssim_maps, ssim_maps_plain)
from multi_modal_image_fusion_tpu_torch.ops.ssim import gaussian_kernel

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, dev, dtype=torch.float32, lo=-0.5):
    r = np.random.RandomState(seed)
    return torch.from_numpy((r.rand(*shape) + lo).astype(np.float32)).to(
        dev, dtype)


def _close(got, want, dtype):
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k,cin,cout,h,w,fuse_n", [
    (7, 16, 32, 45, 61, 0),       # enc1, odd H and W (ragged tiles)
    (7, 32, 32, 45, 61, 1),       # dec0 with the siamese-sum prologue
    (5, 32, 16, 33, 130, 0),      # dec1
    (5, 24, 16, 9, 70, 0),        # Cin not a multiple of 8
    (3, 64, 32, 45, 61, 0),       # DenseFuse dec1 (k3)
    (3, 128, 128, 20, 70, 0),     # VIFNet dec1's width class
    (3, 64, 64, 33, 47, 2),       # DenseFuse 'l1' dec0 width, with fuse_n
])
def test_conv_chain(cuda, dt, k, cin, cout, h, w, fuse_n):
    dtype = DTYPES[dt]
    b = 2 * fuse_n if fuse_n else 2
    x = _rand((b, h, w, cin), 0, cuda, dtype)
    wt = (_rand((cout, cin, k, k), 1, cuda) * 0.2).to(dtype)
    bias = _rand((cout,), 2, cuda)
    before = build.LAUNCHES["conv_chain"]
    got = conv_chain(x, wt, bias, "relu", fuse_n)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_chain"] == before + 1
    assert got.dtype == dtype
    want = conv_chain_plain(x, wt, bias, "relu", fuse_n)
    assert _wide_rel(got, want, dtype) <= WIDE_TOL[dtype]


@pytest.mark.parametrize("act", ["relu6", "lrelu", "tanh", None])
def test_conv_chain_activations(cuda, act):
    x = _rand((1, 20, 30, 16), 3, cuda)
    wt = _rand((16, 16, 5, 5), 4, cuda) * 0.2
    got = conv_chain(x, wt, None, act)
    _close(got, conv_chain_plain(x, wt, None, act), torch.float32)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("pair", [True, False])
def test_conv_gray_enter(cuda, dt, pair, k):
    img1 = _rand((2, 45, 61, 1), 5, cuda, DTYPES[dt], lo=0.0)
    img2 = _rand((2, 45, 61, 1), 6, cuda, DTYPES[dt], lo=0.0) \
        if pair else None
    wt = _rand((16, 1, k, k), 7, cuda)
    bias = _rand((16,), 8, cuda)
    got = conv_gray_enter(img1, img2, wt, bias, "relu")
    assert got.dtype == DTYPES[dt]
    want = conv_gray_enter_plain(img1, img2, wt, bias, "relu")
    _close(got, want, DTYPES[dt])


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("h,w", [(45, 61), (8, 200)])
def test_conv_gray_exit(cuda, dt, h, w, k):
    x = _rand((3, h, w, 16), 9, cuda, DTYPES[dt])
    wt = _rand((1, 16, k, k), 10, cuda) * 0.2
    bias = _rand((1,), 11, cuda)
    got = conv_gray_exit(x, wt, bias, None)
    _close(got, conv_gray_exit_plain(x, wt, bias, None), DTYPES[dt])


@pytest.mark.parametrize("ws,use_padding", [(11, False), (11, True),
                                            (7, False)])
def test_ssim_maps(cuda, ws, use_padding):
    a = _rand((2, 45, 61, 1), 12, cuda, lo=0.0)
    b = (a + 0.1 * _rand((2, 45, 61, 1), 13, cuda)).clamp(0, 1)
    got = ssim_maps(a, b, ws, 1.0, use_padding, sigma=1.5)
    want = ssim_maps_plain(a, b, gaussian_kernel(ws, 1.5), 1.0, use_padding)
    for g, w_ in zip(got, want):
        _close(g, w_, torch.float32)


def test_full_resolution_deepfuse_layers(cuda):
    """Every DeepFuse layer at 1224x1024 (one pair), bf16 chain."""
    h, w = 1224, 1024
    bf = torch.bfloat16
    img1 = _rand((1, h, w, 1), 14, cuda, bf, lo=0.0)
    img2 = _rand((1, h, w, 1), 15, cuda, bf, lo=0.0)
    w0 = _rand((16, 1, 5, 5), 16, cuda) * 0.4
    t = conv_gray_enter(img1, img2, w0, None, "relu")
    _close(t, conv_gray_enter_plain(img1, img2, w0, None, "relu"), bf)
    for cin, cout, k, fuse in ((16, 32, 7, 0), (32, 32, 7, 1),
                               (32, 16, 5, 0)):
        wt = (_rand((cout, cin, k, k), cin + cout + k, cuda) * 0.1).to(bf)
        y = conv_chain(t, wt, None, "relu", fuse)
        assert _wide_rel(y, conv_chain_plain(t, wt, None, "relu", fuse),
                         bf) <= WIDE_TOL[bf]
        t = y
    wt = _rand((1, 16, 5, 5), 17, cuda) * 0.2
    _close(conv_gray_exit(t, wt, None, None),
           conv_gray_exit_plain(t, wt, None, None), bf)


@pytest.mark.parametrize("mode", ["sum", "mean", "max", "ae"])
def test_deepfuse_on_card_matches_cpu(cuda, mode):
    """The whole model through the kernels (enter, chain with and without
    the fuse_n prologue, exit) against the same weights on the CPU's plain
    path, f32, odd size."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    model = create_model("deepfuse", fusion_mode="sum" if mode == "ae"
                         else mode,
                         generator=torch.Generator().manual_seed(1)).eval()
    x1 = _rand((2, 45, 61, 1), 18, "cpu", lo=0.0)
    x2 = _rand((2, 45, 61, 1), 19, "cpu", lo=0.0)
    b = None if mode == "ae" else x2
    with torch.no_grad():
        want = model(x1, b)
        build.LAUNCHES.clear()
        got = model.to(cuda)(x1.to(cuda), None if b is None else b.to(cuda))
    assert dict(build.LAUNCHES) == {"conv_gray_enter": 1, "conv_chain": 3,
                                    "conv_gray_exit": 1}
    _close(got.cpu(), want, torch.float32)


def test_wrappers_raise_on_unsupported(cuda):
    x = torch.zeros((1, 16, 16, 12), device=cuda)
    with pytest.raises(ValueError):
        conv_chain(x, torch.zeros((12, 12, 5, 5), device=cuda))  # Cout 12
    with pytest.raises(TypeError):
        conv_chain(x.half(), torch.zeros((16, 12, 5, 5), device=cuda))
    with pytest.raises(ValueError):
        conv_chain(x[:, :, :8], torch.zeros((16, 12, 5, 5), device=cuda))
    with pytest.raises(ValueError):       # k9 is not built
        conv_chain(x, torch.zeros((16, 12, 9, 9), device=cuda))
    img = torch.zeros((1, 16, 16, 1), device=cuda)
    with pytest.raises(TypeError):        # img1 and img2 in one dtype
        conv_gray_enter(img, img.bfloat16(),
                        torch.zeros((16, 1, 5, 5), device=cuda))
    with pytest.raises(ValueError):       # k7 exit is not built
        conv_gray_exit(x[..., :8].contiguous(),
                       torch.zeros((1, 8, 7, 7), device=cuda))
    legs = [(x, 0)] * 9
    with pytest.raises(ValueError):       # at most 8 legs
        conv_multi(legs, torch.zeros((16, 108, 3, 3), device=cuda))
    with pytest.raises(ValueError):       # k9 is not built
        conv_multi([(x, 0)], torch.zeros((16, 12, 9, 9), device=cuda))
    with pytest.raises(ValueError):       # offset past the leg's batch
        conv_multi([(x, 1)], torch.zeros((16, 12, 3, 3), device=cuda),
                   n_out=1)
    with pytest.raises(ValueError):       # channels do not add up
        conv_multi([(x, 0)], torch.zeros((16, 13, 3, 3), device=cuda))
    with pytest.raises(ValueError):       # window above 17
        moments(img, img, 19, 3.8)


# DeepFuse's train-step launches of conv_valid at 64x64 patches:
# (c_in, c_out, k) of the five forward convs and the four dx convs
_VALID_FWD = [(1, 16, 5), (16, 32, 7), (32, 32, 7), (32, 16, 5), (16, 1, 5)]
_VALID_DX = [(1, 16, 5), (16, 32, 5), (32, 32, 7), (32, 16, 7)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cin,cout,k", _VALID_FWD + _VALID_DX)
def test_conv_valid(cuda, dt, cin, cout, k):
    dtype = DTYPES[dt]
    xp = _rand((3, 37 + k - 1, 70 + k - 1, cin), cin + k, cuda, dtype)
    wt = (_rand((cout, cin, k, k), cout + k, cuda) * 0.2).to(dtype)
    before = build.LAUNCHES["conv_valid/valid"]
    got = conv_valid(xp, wt)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_valid/valid"] == before + 1
    assert got.dtype == dtype
    _close(got, conv_valid_plain(xp, wt), dtype)


@pytest.mark.parametrize("act", ["relu", None, "lrelu", "tanh", "relu6"])
@pytest.mark.parametrize("cout", [16, 24, 1])
def test_conv_valid_epilogue(cuda, act, cout):
    """The valid step's fused bias + activation, and Cout not a multiple of
    the 16-channel tile."""
    xp = _rand((2, 20 + 4, 33 + 4, 16), 20, cuda)
    wt = _rand((cout, 16, 5, 5), 21, cuda) * 0.2
    bias = _rand((cout,), 22, cuda)
    _close(conv_valid(xp, wt, bias, act),
           conv_valid_plain(xp, wt, bias, act), torch.float32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cin,cout,k", _VALID_FWD + [(16, 32, 3)])
def test_conv_valid_fast_grads(cuda, dt, cin, cout, k):
    """conv_valid_fast's forward, dx and dw (kernel launches) against
    F.conv2d's autograd on the same inputs in float64 (an f32 reference
    through cuDNN's weight gradient was itself 1e-3 off at c_in=1)."""
    dtype = DTYPES[dt]
    xp = _rand((4, 64 + k - 1, 64 + k - 1, cin), k, cuda, dtype)
    wt = (_rand((cout, cin, k, k), cin, cuda) * 0.2).to(dtype)
    cot = _rand((4, 64, 64, cout), cout, cuda, torch.float32)
    xa, wa = xp.clone().requires_grad_(), wt.clone().requires_grad_()
    xb, wb = (xp.double().clone().requires_grad_(),
              wt.double().clone().requires_grad_())
    before = dict(build.LAUNCHES)
    ya = conv_valid_fast(xa, wa)
    (torch.tanh(ya.float()) * cot).sum().backward()
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_valid/forward"] == \
        before.get("conv_valid/forward", 0) + 1
    assert build.LAUNCHES["conv_valid/dx"] == \
        before.get("conv_valid/dx", 0) + 1
    assert build.LAUNCHES["conv_valid_dw"] == \
        before.get("conv_valid_dw", 0) + 1
    yb = F.conv2d(xb.permute(0, 3, 1, 2), wb).permute(0, 2, 3, 1)
    (torch.tanh(yb) * cot.double()).sum().backward()
    _close(ya, yb, dtype)
    _close(xa.grad, xb.grad, dtype)
    _close(wa.grad, wb.grad, dtype)


def test_conv_valid_full_resolution(cuda):
    """enc1 at 1224x1024 in bf16, batch 2."""
    k = 7
    xp = _rand((2, 1224 + k - 1, 1024 + k - 1, 16), 30, cuda, torch.bfloat16)
    wt = (_rand((32, 16, k, k), 31, cuda) * 0.1).bfloat16()
    _close(conv_valid(xp, wt), conv_valid_plain(xp, wt), torch.bfloat16)


VALID_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}

# (c_in, c_out, k) of the forward layer whose dx or dw a train step runs,
# with its images and output size: DeepFuse's at 16 pairs of 64x64 (the
# encoder runs both images of a pair), a k3 layer, and one 20x50 image
_DX_CASES = [(cin, cout, k, 2 * 16 if cin == 16 and cout == 32 else 16, 64,
              64) for cin, cout, k in _VALID_FWD[1:]] + [
    (16, 32, 3, 16, 64, 64), (32, 16, 5, 1, 20, 50)]
_DW_CASES = [(1, 16, 5, 32, 64, 64)] + _DX_CASES


def _centred(shape, seed, dev, dtype):
    return _rand(shape, seed, dev, torch.float32, lo=-0.5).to(dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cin,cout,k,b,h,w", _DX_CASES)
def test_conv_valid_dx(cuda, dt, cin, cout, k, b, h, w):
    """The dx mode (the cotangent read in place, its zero halo and the
    flipped taps in the kernel's loads) against the plain full
    correlation, f32 1e-4 and bf16 1e-3 of max|dx| (bf16 beyond one ulp of
    each output); controls that must miss by 10x: the taps not flipped,
    the output shifted by one pixel (a halo off by one)."""
    dtype = DTYPES[dt]
    dy = _centred((b, h, w, cout), 70 + k, cuda, dtype)
    wt = (_centred((cout, cin, k, k), 71 + cin, cuda, torch.float32)
          / np.sqrt(cout * k * k)).to(dtype)
    before = build.LAUNCHES["conv_valid/dx"]
    got = conv_valid_dx(dy, wt)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_valid/dx"] == before + 1
    assert got.dtype == dtype and got.shape == (b, h + k - 1, w + k - 1, cin)
    want = conv_valid_dx_plain(dy, wt)
    tol = VALID_TOL[dtype]
    assert _wide_rel(got, want, dtype) <= tol
    for control in (conv_valid_dx_plain(dy, wt.flip(2, 3)),
                    torch.roll(want, 1, dims=2)):
        assert _wide_rel(got, control, dtype) > 10 * tol


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cin,cout,k,b,h,w", _DW_CASES)
def test_conv_valid_dw(cuda, dt, cin, cout, k, b, h, w):
    """conv_valid_dw against the plain per-tap contraction in float64, f32
    1e-4 and bf16 1e-3 of max|dw|, the same bits on two runs; the control
    (kh and kw swapped) must miss by 10x."""
    dtype = DTYPES[dt]
    xp = _centred((b, h + k - 1, w + k - 1, cin), 72 + k, cuda, dtype)
    dy = _centred((b, h, w, cout), 73 + cin, cuda, dtype)
    before = build.LAUNCHES["conv_valid_dw"]
    got = conv_valid_dw(xp, dy)
    again = conv_valid_dw(xp, dy)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_valid_dw"] == before + 2
    assert got.dtype == torch.float32 and got.shape == (cout, cin, k, k)
    assert torch.equal(got, again)
    want = conv_valid_dw_plain(xp.double(), dy.double())
    tol = VALID_TOL[dtype]
    assert _wide_rel(got, want, torch.float32) <= tol
    assert _wide_rel(got, want.transpose(2, 3), torch.float32) > 10 * tol


def test_densefuse_k3_train_step_through_kernels(cuda):
    """One DenseFuse (k3) train step through the kernels (fast_training)
    and through F.conv2d, f32, TF32 off: loss parts within 1e-5 relative,
    every gradient non-zero and within 1e-4 of the largest."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
    from multi_modal_image_fusion_tpu_torch.train.trainer import \
        make_loss_bundle
    model = create_model("densefuse",
                         generator=torch.Generator().manual_seed(4)).to(cuda)
    x1 = _rand((4, 64, 64, 1), 74, cuda, lo=0.0)
    x2 = _rand((4, 64, 64, 1), 75, cuda, lo=0.0)
    bundle = make_loss_bundle()
    out = {}
    for fast in (True, False):
        build.LAUNCHES.clear()
        with fast_training(fast):
            total, parts = bundle(x1, x2, model(x1, x2))
            grads = torch.autograd.grad(total, list(model.parameters()))
        torch.cuda.synchronize()
        out[fast] = ({k: float(v) for k, v in parts.items()}, grads,
                     dict(build.LAUNCHES))
    (pf, gf, lf), (pp, gp, lp) = out[True], out[False]
    assert lf["conv_valid/forward"] > 0 and lf["conv_valid_dw"] > 0
    assert lp == {}
    for key in pf:
        assert abs(pf[key] - pp[key]) <= 1e-5 * abs(pp[key]), key
    scale = max(float(b.abs().max()) for b in gp)
    for a, b in zip(gf, gp):
        assert float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_conv_valid_raises_on_unsupported(cuda):
    xp = torch.zeros((1, 20, 20, 8), device=cuda)
    with pytest.raises(ValueError):       # k1 is not built
        conv_valid(xp, torch.zeros((8, 8, 1, 1), device=cuda))
    with pytest.raises(TypeError):        # weight in another dtype
        conv_valid(xp, torch.zeros((8, 8, 5, 5), device=cuda).bfloat16())
    with pytest.raises(ValueError):       # channel mismatch
        conv_valid(xp, torch.zeros((8, 4, 5, 5), device=cuda))


def test_forward_only_kernels_raise_with_grad(cuda):
    """With grad mode on and a weight or image that requires grad, the
    forward-only wrappers raise instead of returning a tensor with no
    grad_fn; under no_grad they run."""
    x = _rand((1, 20, 30, 16), 40, cuda)
    img = _rand((1, 20, 30, 1), 41, cuda, lo=0.0)
    w16 = _rand((16, 16, 5, 5), 42, cuda).requires_grad_()
    w_in = _rand((16, 1, 5, 5), 43, cuda).requires_grad_()
    w_out = _rand((1, 16, 5, 5), 44, cuda).requires_grad_()
    xp = _rand((1, 24, 34, 16), 45, cuda)
    calls = [lambda: conv_chain(x, w16, None, "relu"),
             lambda: conv_gray_enter(img, img, w_in, None, "relu"),
             lambda: conv_gray_exit(x, w_out, None, None),
             lambda: conv_valid(xp, w16),
             lambda: conv_valid_dx(x, w16),
             lambda: conv_valid_dw(xp, x.clone().requires_grad_()),
             lambda: ssim_maps(img.clone().requires_grad_(), img, 11),
             lambda: conv_multi([(x, 0), (x, 0)], w16.repeat(1, 2, 1, 1)),
             lambda: moments(img.clone().requires_grad_(), img, 9, 1.8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            call()


def test_deepfuse_train_step_reaches_every_parameter(cuda):
    """A DeepFuse train step on the card, through the kernels
    (fast_training) and through F.conv2d: every parameter gets a non-zero
    gradient, and the two routes agree within 1e-4 of the largest gradient
    (f32, TF32 off)."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
    from multi_modal_image_fusion_tpu_torch.train.trainer import \
        make_loss_bundle
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(2)).to(cuda)
    x1 = _rand((4, 64, 64, 1), 46, cuda, lo=0.0)
    x2 = _rand((4, 64, 64, 1), 47, cuda, lo=0.0)
    bundle = make_loss_bundle()
    grads = {}
    for fast in (True, False):
        build.LAUNCHES.clear()
        with fast_training(fast):
            total, _ = bundle(x1, x2, model(x1, x2))
            grads[fast] = torch.autograd.grad(total, list(model.parameters()))
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        if fast:
            assert launches == {"conv_valid": 9, "conv_valid/forward": 5,
                                "conv_valid/dx": 4, "conv_valid_dw": 5}
        else:
            assert launches == {}
    # against the largest gradient magnitude, as chip_smoke.py phase 6: a
    # one-element bias gradient sums every output pixel with cancellation,
    # and cuDNN's weight gradient picks its summation order per run
    scale = max(float(b.abs().max()) for b in grads[False])
    for a, b in zip(grads[True], grads[False]):
        assert float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("mode", ["amp_bf16", "ae"])
def test_trainer_fast_on_card(cuda, mode):
    """Trainer steps through the kernels on the card, 5 forward + 4 dx
    launches a train step and 5 a valid step. amp bf16 (bf16 conv_valid
    forward and dx on f32 master weights) keeps f32 masters and tracks the
    f32 kernel route's loss over 5 steps within the JAX package's
    test_amp_bf16_trains bound; autoencoder mode's loss falls."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    ae = mode == "ae"
    x1 = _rand((4, 64, 64, 1), 48, cuda, lo=0.0)
    x2 = _rand((4, 64, 64, 1), 49, cuda, lo=0.0)
    batch = x1 if ae else (x1, x2)
    runs = {}
    for amp in (["bf16", None] if mode == "amp_bf16" else [None]):
        model = create_model(
            "deepfuse", generator=torch.Generator().manual_seed(3)).to(cuda)
        trainer = Trainer(model, make_lr_schedule(1e-3 if ae else 1e-4,
                                                  10, 12),
                          fast=True, ae=ae, amp=amp)
        losses = []
        for _ in range(5):
            build.LAUNCHES.clear()
            parts, imgf = trainer.train_step(batch)
            losses.append(float(parts["loss"]))
        assert build.LAUNCHES["conv_valid/forward"] == 5
        assert build.LAUNCHES["conv_valid/dx"] == 4
        assert build.LAUNCHES["conv_valid_dw"] == 5
        assert imgf.dtype == torch.float32 and imgf.shape == x1.shape
        assert all(np.isfinite(losses))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        build.LAUNCHES.clear()
        parts, _ = trainer.valid_step(batch)
        assert dict(build.LAUNCHES) == {"conv_valid": 5,
                                        "conv_valid/valid": 5}
        assert np.isfinite(float(parts["loss"]))
        runs[amp] = losses
    if ae:
        assert runs[None][-1] < runs[None][0]
    else:
        l16, l32 = runs["bf16"][-1], runs[None][-1]
        assert abs(l16 - l32) < 0.05 * abs(l32) + 1e-3, (runs)


@pytest.mark.parametrize("use_padding", [False, True])
@pytest.mark.parametrize("ws", [17, 9, 5, 3])
def test_moments(cuda, ws, use_padding):
    """The VIF pyramid's windows, f32, against the plain filters (TF32 off);
    a pair smaller than the window gives empty maps and no launch."""
    a = _rand((2, 45, 61, 1), 50, cuda, lo=0.0) * 255
    b = (a + 40 * _rand((2, 45, 61, 1), 51, cuda)).clamp(0, 255)
    before = build.LAUNCHES["moments"]
    got = moments(a, b, ws, ws / 5, use_padding)
    torch.cuda.synchronize()
    assert build.LAUNCHES["moments"] == before + 1
    want = moments_plain(a, b, gaussian_kernel(ws, ws / 5), use_padding)
    for g, w_ in zip(got, want):
        _close(g, w_, torch.float32)
    empty = moments(a[:, :2, :2], b[:, :2, :2], 3, 0.6)
    assert build.LAUNCHES["moments"] == before + 1
    assert all(t.shape == (2, 0, 0, 1) for t in empty)


def _multi_cases(dev, dtype):
    """The six multi-leg cases of tests/test_hiw.py, plus a k7 case: (legs,
    OIHW weight, bias, fuse_n)."""
    x40 = [_rand((2, 40, 96, c), 60 + i, dev, dtype)
           for i, c in enumerate((16, 16, 8))]
    x4 = _rand((4, 33, 61, 16), 63, dev, dtype)
    f4 = [_rand((4, 32, 64, 16), 64 + i, dev, dtype) for i in range(2)]
    g2 = [_rand((2, 40, 96, 1), 66 + i, dev, dtype, lo=0.0) for i in range(2)]
    ident = torch.cat([_rand((16, 16, 3, 3), 68, dev) * 0.2,
                       identity_weights(3, 16).to(dev)], 1)
    return {
        "dense": ([(t, 0) for t in x40], _rand((16, 40, 3, 3), 69, dev) * 0.2,
                  _rand((16,), 70, dev), 0),
        "cross": ([(x4, 0), (x4, 2)], _rand((32, 32, 3, 3), 71, dev) * 0.2,
                  None, 0),
        "fuse": ([(t, 0) for t in f4], _rand((16, 32, 3, 3), 72, dev) * 0.2,
                 None, 2),
        "identity": ([(x40[0], 0), (x40[1], 0)], ident, None, 0),
        "k1": ([(x40[0], 0), (x40[1], 0)], _rand((16, 32, 1, 1), 73, dev),
               _rand((16,), 74, dev), 0),
        "gray": ([(t, 0) for t in g2], _rand((16, 2, 5, 5), 75, dev), None,
                 0),
        "k7": ([(t, 0) for t in f4], _rand((32, 32, 7, 7), 76, dev) * 0.1,
               None, 0),
    }


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", ["dense", "cross", "fuse", "identity", "k1",
                                  "gray", "k7"])
def test_conv_multi(cuda, dt, case):
    dtype = DTYPES[dt]
    legs, wt, bias, fuse_n = _multi_cases(cuda, dtype)[case]
    wt = wt.to(dtype)
    before = build.LAUNCHES["conv_multi"]
    got = conv_multi(legs, wt, bias, "relu", fuse_n)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_multi"] == before + 1
    assert got.dtype == dtype
    want = conv_multi_plain(legs, wt, bias, "relu", fuse_n)
    assert _wide_rel(got, want, dtype) <= WIDE_TOL[dtype]


def _zero_halo_plain(legs, wt, bias, fuse_n):
    """conv_multi_plain with a zero-padded halo instead of the reflect."""
    x = torch.cat([t for t, _ in legs], -1)
    if fuse_n:
        x = x[:fuse_n] + x[fuse_n:]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), wt.float(), bias,
                 padding=wt.shape[-1] // 2)
    return torch.relu(y).permute(0, 2, 3, 1).to(x.dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", ["dec0", "dense"])
def test_conv_chain_controls_fail(cuda, dt, case):
    """The checks of conv_chain / conv_multi can fail: taps transposed, two
    legs of one width swapped, a zero halo, and one fuse_n half's images in
    reverse order each miss the plain version by more than 10x the
    tolerance, while the kernel passes it."""
    dtype = DTYPES[dt]
    if case == "dec0":             # DeepFuse dec0, k7, fuse_n
        n, cins, cout, k = 2, [32], 32, 7
    else:                          # DenseFuse dec0's legs, k3, fuse_n
        n, cins, cout, k = 2, [16, 16, 16, 16], 64, 3
    h, w = 64, 200
    legs = [(_drand((2 * n, h, w, c), 240 + i, cuda, dtype), 0)
            for i, c in enumerate(cins)]
    cin = sum(cins)
    wt = (_drand((cout, cin, k, k), 250, cuda, torch.float32)
          / np.sqrt(cin * k * k)).to(dtype)
    bias = _drand((cout,), 251, cuda, torch.float32) * 0.1
    want = conv_multi_plain(legs, wt, bias, "relu", n)
    tol = WIDE_TOL[dtype]
    assert _wide_rel(conv_multi(legs, wt, bias, "relu", n), want,
                     dtype) <= tol
    controls = {
        "taps": conv_multi(legs, wt.transpose(2, 3), bias, "relu", n),
        "zero halo": _zero_halo_plain(legs, wt, bias, n),
        "half reversed": conv_multi(
            [(torch.cat([t[:n], t[n:].flip(0)]), 0) for t, _ in legs], wt,
            bias, "relu", n)}
    if len(legs) > 1:
        controls["legs"] = conv_multi([legs[1], legs[0]] + legs[2:], wt,
                                      bias, "relu", n)
    for what, ctl in controls.items():
        assert _wide_rel(ctl, want, dtype) > 10 * tol, what


def test_full_resolution_dense_layers(cuda):
    """DenseFuse's dense convs and dec0 at 1224x1024 (one pair), and
    VIFNet's 8-leg dec0, bf16."""
    h, w = 1224, 1024
    bf = torch.bfloat16
    tol = WIDE_TOL[bf]
    legs = [_rand((2, h, w, 16), 80, cuda, bf)]
    for i in range(3):
        wt = (_rand((16, 16 * (i + 1), 3, 3), 81 + i, cuda) * 0.2).to(bf)
        ls = [(t, 0) for t in legs]
        y = conv_multi(ls, wt, None, "relu")
        assert _wide_rel(y, conv_multi_plain(ls, wt, None, "relu"),
                         bf) <= tol
        legs.append(y)
    ls = [(t, 0) for t in legs]
    wt = (_rand((64, 64, 3, 3), 84, cuda) * 0.1).to(bf)
    assert _wide_rel(conv_multi(ls, wt, None, "relu", fuse_n=1),
                     conv_multi_plain(ls, wt, None, "relu", fuse_n=1),
                     bf) <= tol
    ls = ls + [(t, 1) for t in legs]
    wt = (_rand((128, 128, 3, 3), 85, cuda) * 0.05).to(bf)
    assert _wide_rel(conv_multi(ls, wt, None, "relu", n_out=1),
                     conv_multi_plain(ls, wt, None, "relu", n_out=1),
                     bf) <= tol


# launches of one fused forward: (model, model kwargs, autoencoder) ->
# counts; DenseFuse 'l1' fuses in torch, so its dec0 is a conv_chain
_FORWARD_LAUNCHES = {
    ("densefuse", "sum", False): {"conv_gray_enter": 1, "conv_multi": 4,
                                  "conv_chain": 2, "conv_gray_exit": 1},
    ("densefuse", "l1", False): {"conv_gray_enter": 1, "conv_multi": 3,
                                 "conv_chain": 3, "conv_gray_exit": 1},
    ("densefuse", "sum", True): {"conv_gray_enter": 1, "conv_multi": 4,
                                 "conv_chain": 2, "conv_gray_exit": 1},
    ("vifnet", None, False): {"conv_gray_enter": 1, "conv_multi": 4,
                              "conv_chain": 3, "conv_gray_exit": 1},
}


@pytest.mark.parametrize("key", sorted(_FORWARD_LAUNCHES, key=str))
def test_dense_models_on_card_match_cpu(cuda, key):
    """DenseFuse and VIFNet through the kernels against the same weights on
    the CPU's plain path, f32, odd size, with exact launch counts."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    name, mode, ae = key
    kw = {} if mode is None else {"fusion_mode": mode}
    model = create_model(name, generator=torch.Generator().manual_seed(4),
                         **kw).eval()
    x1 = _rand((2, 45, 61, 1), 86, "cpu", lo=0.0)
    x2 = None if ae else _rand((2, 45, 61, 1), 87, "cpu", lo=0.0)
    with torch.no_grad():
        want = model(x1, x2)
        build.LAUNCHES.clear()
        got = model.to(cuda)(x1.to(cuda), None if x2 is None else x2.to(cuda))
    assert dict(build.LAUNCHES) == _FORWARD_LAUNCHES[key]
    _close(got.cpu(), want, torch.float32)


def test_eval_metrics_on_card_match_cpu(cuda):
    """The 16-metric bundle on the card (ssim_maps and moments kernels)
    against the CPU's plain path: 1e-4 relative, VIFF 1e-3; 12 ssim_maps
    and 8 moments launches a call."""
    from multi_modal_image_fusion_tpu_torch.ops.metrics import eval_metrics
    r = np.random.RandomState(88)
    a = (r.rand(3, 90, 110, 1) * 255).astype(np.float32)
    b = np.clip(255 - 0.6 * a + r.randn(3, 90, 110, 1) * 20, 0, 255)
    f = np.clip(0.5 * a + 0.5 * b + r.randn(3, 90, 110, 1) * 5, 0, 255)
    imgs = [torch.from_numpy(np.asarray(v, np.float32)) for v in (a, b, f)]
    want = eval_metrics(*imgs)
    build.LAUNCHES.clear()
    got = eval_metrics(*[t.to(cuda) for t in imgs])
    assert dict(build.LAUNCHES) == {"ssim_maps": 12, "moments": 8}
    for k, w_ in want.items():
        tol = 1e-3 if k == "viff" else 1e-4
        np.testing.assert_allclose(got[k].cpu().numpy(), w_.numpy(),
                                   rtol=tol, atol=tol, err_msg=k)


def test_eval_metrics_small_image_on_card(cuda):
    """40x40: the VIF pyramid's last scale is smaller than its window, so
    moments gives empty maps without a launch there and the weighted VIFF
    is NaN, as in the JAX package; every other value is finite and equals
    the CPU's."""
    from multi_modal_image_fusion_tpu_torch.ops.metrics import eval_metrics
    r = np.random.RandomState(89)
    imgs = [torch.from_numpy((r.rand(1, 40, 40, 1) * 255).astype(np.float32))
            for _ in range(3)]
    want = eval_metrics(*imgs)
    build.LAUNCHES.clear()
    got = eval_metrics(*[t.to(cuda) for t in imgs])
    assert dict(build.LAUNCHES) == {"ssim_maps": 12, "moments": 6}
    assert np.isnan(float(got["viff"])) and np.isnan(float(want["viff"]))
    for k, w_ in want.items():
        if k != "viff":
            np.testing.assert_allclose(got[k].cpu().numpy(), w_.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


# nl tolerances (chip_smoke.NL_TOL): nl_minmax relative to the range hi -
# lo in both dtypes (bf16 products are exact in f32); nl_apply relative to
# the largest attention term |out - mean(k)|, bf16 5e-2 (the kernel rounds
# the unnormalised weights to bf16, the plain version the normalised ones).
# Keys swapped within pairs in the value product miss by more than the
# whole term (checked here as the control). The bf16 kernel is also held to
# nl_apply_flash_plain, the same function with the TPU kernel's rounding, at
# NL_ROUND_TOL: both round the output to bf16 (2^-9 of a value), and the f32
# sums and exps differ in order and implementation (expect ~1e-3).
NL_TOL = {"nl_minmax": {torch.float32: 1e-4, torch.bfloat16: 1e-4},
          "nl_apply": {torch.float32: 1e-4, torch.bfloat16: 5e-2}}
NL_ROUND_TOL = 1e-2


def _nl_inputs(b, n, m, c, seed, dev, dtype):
    """Independent centred q (b, n, c) and k (b, m, c), k of zero mean over
    the keys: the output is the attention term alone."""
    r = np.random.RandomState(seed)
    q = r.rand(b, n, c).astype(np.float32) * 2 - 1
    k = r.rand(b, m, c).astype(np.float32) * 2 - 1
    k -= k.mean(1, keepdims=True)
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(k).to(dev, dtype))


def _nl_err(got, want, scale):
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    return float((got - want).abs().max()) / scale


def _nl_close(name, got, want, scale, dtype):
    err = _nl_err(got, want, scale)
    assert err <= NL_TOL[name][dtype], (name, err)


def _nl_check(q, k, lohi, got, dtype):
    """lohi and got (nl_apply's output) against the plain passes at
    NL_TOL, bf16 also against the TPU kernel's rounding at NL_ROUND_TOL,
    and the swapped-keys control outside NL_TOL."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        nl_apply_flash_plain, nl_apply_plain, nl_minmax_plain)
    want_lohi = nl_minmax_plain(q, k)
    _nl_close("nl_minmax", lohi, want_lohi,
              float(want_lohi[1] - want_lohi[0]), dtype)
    want = nl_apply_plain(q, k, want_lohi)
    scale = float((want.double() - k.double().mean(1, keepdim=True))
                  .abs().max())
    _nl_close("nl_apply", got, want, scale, dtype)
    if dtype == torch.bfloat16:
        err = _nl_err(got, nl_apply_flash_plain(q, k, want_lohi), scale)
        assert err <= NL_ROUND_TOL, ("rounding", err)
    m = k.shape[1]
    swap = torch.arange(m, device=k.device) ^ 1
    swap[swap >= m] = m - 1
    ctl_err = 0.0
    for i in range(0, q.shape[1], 4096):
        e = (torch.matmul(q[:, i:i + 4096].float(), k.float().transpose(1, 2))
             - want_lohi[0]) / (want_lohi[1] - want_lohi[0])
        ctl = torch.matmul(torch.softmax(e, -1).to(dtype).float(),
                           k[:, swap].float())
        ctl_err = max(ctl_err, float((ctl - want[:, i:i + 4096].float())
                                     .abs().max()))
    assert ctl_err > NL_TOL["nl_apply"][dtype] * scale


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,h,w,c", [
    (2, 45, 61, 112),     # Res2Fusion's features at an odd size (5x7 pool)
    (1, 64, 200, 112),    # several key tiles, a ragged last one
    (2, 20, 50, 112),     # ragged query tile, 12 keys
    (1, 9, 130, 112)])    # one pooled row
def test_nl_kernels(cuda, dt, b, h, w, c):
    """nl_minmax's batch-global (lo, hi) and nl_apply's output against the
    plain two-pass version on q and k of the 'nl' pooling's shapes; one
    launch each."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        nl_apply, nl_minmax, nl_spatial_flash)
    dtype = DTYPES[dt]
    q, k = _nl_inputs(b, h * w, (h // 8) * (w // 8), c, h + w, cuda, dtype)
    before = dict(build.LAUNCHES)
    lohi = nl_minmax(q, k)
    got = nl_apply(q, k, lohi)
    torch.cuda.synchronize()
    for name in ("nl_minmax", "nl_apply"):
        assert build.LAUNCHES[name] == before.get(name, 0) + 1
    assert got.dtype == dtype and got.shape == q.shape
    _nl_check(q, k, lohi, got, dtype)
    _nl_check(q, k, lohi, nl_spatial_flash(q, k), dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,n,m", [
    (1, 1000, 3 * 64 + 17),   # 3 full key tiles and a ragged one; pass 1's
                              # last block 232 rows, pass 2's 104
    (2, 3 * 256 + 1, 4 * 64),  # full key tiles; a last block of one row
    (1, 5 * 128, 2 * 64 + 1),  # pass 2's blocks full; pass 1's last block
                               # half empty; a last tile of one key
    (2, 37, 5)])               # fewer keys than a tile, rows than a block
def test_nl_kernel_tiling(cuda, dt, b, n, m):
    """The kernels at the edges of the bf16 kernels' tiling (64 keys a
    staged tile, 256 query rows a block in pass 1, 128 in pass 2)."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        nl_apply, nl_minmax)
    dtype = DTYPES[dt]
    q, k = _nl_inputs(b, n, m, 112, n + m, cuda, dtype)
    lohi = nl_minmax(q, k)
    _nl_check(q, k, lohi, nl_apply(q, k, lohi), dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_nl_batch_global(cuda, dt):
    """Image 1's queries scaled 3x: lo and hi come from it, so a range
    reduced per image (the control) misses image 0's (lo, hi) and output
    by more than NL_TOL, while the kernels hold the batch-global ones."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        nl_apply, nl_apply_plain, nl_minmax, nl_minmax_plain)
    dtype = DTYPES[dt]
    q, k = _nl_inputs(2, 1500, 90, 112, 77, cuda, dtype)
    q[1] *= 3
    lohi = nl_minmax(q, k)
    got = nl_apply(q, k, lohi)
    _nl_check(q, k, lohi, got, dtype)
    want_lohi = nl_minmax_plain(q, k)
    span = float(want_lohi[1] - want_lohi[0])
    own = nl_minmax_plain(q[:1], k[:1])
    assert float((own - want_lohi).abs().max()) / span > \
        NL_TOL["nl_minmax"][dtype]
    want = nl_apply_plain(q, k, want_lohi)
    scale = float((want.double() - k.double().mean(1, keepdim=True))
                  .abs().max())
    ctl = nl_apply_plain(q[:1], k[:1], own)
    assert _nl_err(ctl, want[:1], scale) > NL_TOL["nl_apply"][dtype]


def test_nl_full_resolution(cuda):
    """One modality's nl call of the test CLI: 1224x1024, 112 channels,
    f32."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        nl_apply, nl_minmax)
    q, k = _nl_inputs(1, 1224 * 1024, 153 * 128, 112, 90, cuda,
                      torch.float32)
    lohi = nl_minmax(q, k)
    _nl_check(q, k, lohi, nl_apply(q, k, lohi), torch.float32)


def test_nl_full_resolution_bf16(cuda):
    """One nl call of the Res2Fusion bench: 1224x1024, 112 channels, bf16,
    batch 2."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        nl_apply, nl_minmax)
    q, k = _nl_inputs(2, 1224 * 1024, 153 * 128, 112, 91, cuda,
                      torch.bfloat16)
    lohi = nl_minmax(q, k)
    _nl_check(q, k, lohi, nl_apply(q, k, lohi), torch.bfloat16)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cx,c,k,lo,with_add,act", [
    (64, 16, 1, 0, False, None), (64, 16, 3, 16, False, None),
    (64, 16, 3, 48, True, None), (384, 48, 3, 336, True, None),
    (384, 48, 1, 0, False, "relu6"), (24, 8, 3, 8, True, "relu")])
def test_conv_dw(cuda, dt, cx, c, k, lo, with_add, act):
    """The depthwise kernel on Res2Fusion's windows (and a bias and
    activation) against F.conv2d(groups=C) in f32; one launch."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import (
        conv_dw, conv_dw_plain)
    dtype = DTYPES[dt]
    x = _rand((2, 37, 70, cx), cx + lo, cuda, dtype)
    wt = _rand((c, 1, k, k), c + k, cuda).to(dtype)
    bias = None if act is None else _rand((c,), c, cuda)
    add = _rand((2, 37, 70, c), lo, cuda, dtype) if with_add else None
    before = build.LAUNCHES["conv_dw"]
    got = conv_dw(x, wt, bias, act, lo, add)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_dw"] == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    _close(got, conv_dw_plain(x, wt, bias, act, lo, add), dtype)


def test_new_wrappers_raise(cuda):
    """Shapes the nl and depthwise kernels are not built for, and inputs
    that need a gradient, raise on the card; under no_grad they run."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import conv_dw
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        nl_apply, nl_minmax)
    q = _rand((1, 64, 129), 91, cuda)
    with pytest.raises(ValueError):       # only C = 112 is built
        nl_minmax(q, q[:, :8].contiguous())
    q = _rand((1, 64, 16), 91, cuda, torch.bfloat16)
    with pytest.raises(ValueError):
        nl_minmax(q, q[:, :8].contiguous())
    x = _rand((1, 20, 30, 64), 92, cuda)
    with pytest.raises(ValueError):       # k5 is not built
        conv_dw(x, torch.zeros((16, 1, 5, 5), device=cuda))
    with pytest.raises(ValueError):       # window past the channels
        conv_dw(x, torch.zeros((16, 1, 3, 3), device=cuda), lo=56)
    q, k = _rand((1, 64, 112), 93, cuda), _rand((1, 8, 112), 94, cuda)
    wdw = _rand((16, 1, 3, 3), 95, cuda).requires_grad_()
    calls = [lambda: nl_minmax(q.clone().requires_grad_(), k),
             lambda: nl_apply(q, k.clone().requires_grad_(), nl_minmax(q, k)),
             lambda: conv_dw(x, wdw, lo=16)]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            call()


# launches of one Res2Fusion forward: (fusion_method, autoencoder) -> counts
_RES2_LAUNCHES = {
    ("attn", False): {"conv_gray_enter": 1, "conv_chain": 5, "conv_multi": 4,
                      "conv_dw": 12, "nl_minmax": 2, "nl_apply": 2,
                      "conv_gray_exit": 1},
    ("elem", False): {"conv_gray_enter": 1, "conv_chain": 4, "conv_multi": 5,
                      "conv_dw": 12, "conv_gray_exit": 1},
    ("attn", True): {"conv_gray_enter": 1, "conv_chain": 4, "conv_multi": 5,
                     "conv_dw": 12, "conv_gray_exit": 1},
}


@pytest.mark.parametrize("key", sorted(_RES2_LAUNCHES, key=str))
def test_res2fusion_on_card_matches_cpu(cuda, key):
    """Res2Fusion through the kernels against the same weights on the CPU's
    plain path, f32, odd size, with exact launch counts."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    method, ae = key
    model = create_model("res2fusion", fusion_method=method,
                         generator=torch.Generator().manual_seed(5)).eval()
    x1 = _rand((2, 45, 61, 1), 96, "cpu", lo=0.0)
    x2 = None if ae else _rand((2, 45, 61, 1), 97, "cpu", lo=0.0)
    with torch.no_grad():
        want = model(x1, x2)
        build.LAUNCHES.clear()
        got = model.to(cuda)(x1.to(cuda), None if x2 is None else x2.to(cuda))
    assert dict(build.LAUNCHES) == _RES2_LAUNCHES[key]
    _close(got.cpu(), want, torch.float32)


# conv_wide (csrc/conv_wide.cu). Tolerances relative to max|y| of the plain
# version on the same inputs (bf16 weights and inputs for bf16): f32 1e-4;
# bf16 1e-3 beyond one bf16 ulp of each output (both round an f32 sum to
# bf16, and a sum taken in another order can land on the neighbouring
# value, 2^-7 of it). A control must miss by 10x that: the kernel with the
# kh/kw taps transposed, with two legs of one width swapped, and with leg
# 0's images in reverse order.
WIDE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# (name, legs' channels, c_out, k, fuse_n, images out, h, w)
WIDE_CASES = [
    ("DB3_1.conv1", [256, 1024], 640, 3, 0, 2, 306, 256),
    ("DB1_3.conv1", [16, 16, 16, 64], 56, 3, 0, 1, 1224, 1024),
    ("odd", [40, 24, 40], 40, 3, 0, 2, 45, 61),
    ("EB4_3.conv1.k1", [64, 128, 304, 256], 376, 1, 0, 2, 19, 16),
    ("dbnet.dec0", [16, 16, 16, 16, 64], 64, 3, 2, 2, 45, 61),
    ("cout8", [24, 24], 8, 3, 0, 2, 20, 70),
    ("cout12", [24, 24], 12, 3, 0, 2, 20, 70),     # 8-byte stores
]


def _drand(shape, seed, dev, dtype):
    """Centred uniform [-1, 1), drawn on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(shape, generator=g, device=dev) * 2 - 1).to(dtype)


def _wide_rel(got, want, dtype):
    """max |got - want| relative to max|want|; in bf16, beyond one bf16 ulp
    of each output."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    d = (got - want).abs()
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(
            min=1e-30))) - 7)
        d = (d - ulp).clamp(min=0)
    return float(d.max()) / float(want.abs().max())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_conv_wide(cuda, case, dt):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import (
        conv_wide, conv_wide_plain)
    name, cins, cout, k, fuse_n, n, h, w = case
    dtype = DTYPES[dt]
    b = 2 * n if fuse_n else n
    legs = [(_drand((b, h, w, c), 200 + i, cuda, dtype), 0)
            for i, c in enumerate(cins)]
    cin = sum(cins)
    wt = (_drand((cout, cin, k, k), 210, cuda, torch.float32)
          / np.sqrt(cin * k * k)).to(dtype)
    bias = _drand((cout,), 211, cuda, torch.float32) * 0.1
    before = build.LAUNCHES["conv_wide"]
    got = conv_wide(legs, wt, bias, "relu", fuse_n)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_wide"] == before + 1
    assert got.dtype == dtype and got.shape == (n, h, w, cout)
    want = conv_wide_plain(legs, wt, bias, "relu", fuse_n)
    tol = WIDE_TOL[dtype]
    assert _wide_rel(got, want, dtype) <= tol
    controls = []
    if k > 1:
        controls.append(conv_wide(legs, wt.transpose(2, 3), bias, "relu",
                                  fuse_n))
    same = [(i, j) for i in range(len(cins)) for j in range(i + 1, len(cins))
            if cins[i] == cins[j]]
    if same:
        i, j = same[0]
        swapped = list(legs)
        swapped[i], swapped[j] = legs[j], legs[i]
        controls.append(conv_wide(swapped, wt, bias, "relu", fuse_n))
    if b > 1:                             # leg 0 read at the other images
        controls.append(conv_wide([(legs[0][0].flip(0), 0)] + legs[1:], wt,
                                  bias, "relu", fuse_n))
    assert controls
    for ctl in controls:
        assert _wide_rel(ctl, want, dtype) > 10 * tol


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["relu6", "lrelu", "tanh", None])
def test_conv_wide_activations(cuda, act, dt):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import (
        conv_wide, conv_wide_plain)
    dtype = DTYPES[dt]
    legs = [(_drand((2, 17, 70, 40), 220, cuda, dtype), 0),
            (_drand((2, 17, 70, 24), 221, cuda, dtype), 0)]
    wt = (_drand((48, 64, 3, 3), 222, cuda, torch.float32) / 24).to(dtype)
    bias = _drand((48,), 223, cuda, torch.float32)
    got = conv_wide(legs, wt, bias, act)
    assert _wide_rel(got, conv_wide_plain(legs, wt, bias, act),
                     dtype) <= WIDE_TOL[dtype]


def test_conv_wide_raises(cuda):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import \
        conv_wide
    x = _drand((2, 16, 16, 16), 230, cuda, torch.float32)
    with pytest.raises(ValueError):       # k7 is not built
        conv_wide([(x, 0)], torch.zeros((16, 16, 7, 7), device=cuda))
    with pytest.raises(ValueError):       # Cout not a multiple of 4
        conv_wide([(x, 0)], torch.zeros((10, 16, 3, 3), device=cuda))
    with pytest.raises(ValueError):       # s2d mode: one packed leg
        conv_wide([(x, 0)] * 2, torch.zeros((16, 32, 3, 3), device=cuda),
                  s2d_f=2)
    with pytest.raises(ValueError):       # s2d mode: f = 2 only
        conv_wide([(x, 0)], torch.zeros((16, 16, 3, 3), device=cuda),
                  s2d_f=4)
    with pytest.raises(ValueError):       # at most 8 legs
        conv_wide([(x, 0)] * 9, torch.zeros((16, 144, 3, 3), device=cuda))
    with pytest.raises(TypeError):
        conv_wide([(x.half(), 0)], torch.zeros((16, 16, 3, 3), device=cuda))
    wt = torch.zeros((16, 16, 3, 3), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv_wide([(x, 0)], wt)
    with torch.no_grad():
        conv_wide([(x, 0)], wt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("s2d", [False, True], ids=["cout12", "dec2p"])
def test_conv_wide_stores_stop_at_cout(cuda, dt, s2d):
    """A Cout of 4 mod 8 (DeepFuse's packed dec2, 64 -> 4; a plain 12-wide
    output): written into the head of a buffer one image longer,
    prefilled with a sentinel. The head equals conv_wide's own output and
    the plain version; the sentinel past it is untouched."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import (
        conv_wide, conv_wide_into, conv_wide_plain)
    dtype = DTYPES[dt]
    cin, cout, h, w = (64, 4, 23, 70) if s2d else (24, 12, 21, 67)
    x = _drand((2, h, w, cin), 240, cuda, dtype)
    wt = (_drand((cout, cin, 3, 3), 241, cuda, torch.float32)
          / np.sqrt(9 * cin)).to(dtype)
    bias = _drand((cout,), 242, cuda, torch.float32) * 0.1
    f = 2 if s2d else 1
    buf = torch.full((3, h, w, cout), 1234.0, dtype=dtype, device=cuda)
    conv_wide_into(buf[:2], [(x, 0)], wt, bias, None, s2d_f=f)
    got = conv_wide([(x, 0)], wt, bias, None, s2d_f=f)
    torch.cuda.synchronize()
    assert torch.equal(buf[:2], got)
    assert bool((buf[2] == 1234.0).all())
    want = conv_wide_plain([(x, 0)], wt, bias, None, s2d_f=f)
    assert _wide_rel(got, want, dtype) <= WIDE_TOL[dtype]


def test_fast_training_dw_and_k1_take_conv2d(cuda):
    """Inside fast_training(True) a depthwise and a k1 layer train on
    F.conv2d, as the JAX package's gate sends them to XLA's conv: no
    conv_valid launch, the values and weight gradients of the F.conv2d
    route (f32, TF32 off). A dense k5 layer launches conv_valid."""
    from multi_modal_image_fusion_tpu_torch.ops.layers import (
        ConvLayer, fast_training)
    gen = torch.Generator().manual_seed(5)
    x = _rand((2, 20, 24, 16), 60, cuda)
    for layer in (ConvLayer(16, 16, 3, act=None, groups=16, generator=gen),
                  ConvLayer(16, 24, 1, generator=gen)):
        layer = layer.to(cuda)
        grads = []
        for fast in (True, False):
            build.LAUNCHES.clear()
            with fast_training(fast):
                y = layer(x)
            y.square().sum().backward()
            assert build.LAUNCHES["conv_valid"] == 0
            grads.append((y.detach(), layer.weight.grad))
            layer.weight.grad = None
        _close(grads[0][0], grads[1][0], torch.float32)
        _close(grads[0][1], grads[1][1], torch.float32)
    k5 = ConvLayer(16, 16, 5, generator=gen).to(cuda)
    build.LAUNCHES.clear()
    with fast_training(True):
        k5(x).sum().backward()
    assert build.LAUNCHES["conv_valid/forward"] == 1


# launches of one forward: (model, config, autoencoder) -> counts
_WIDE_MODEL_LAUNCHES = {
    ("dbnet", "sum", False): {"conv_gray_enter": 1, "conv_chain": 1,
                              "conv_multi": 3, "conv_wide": 3,
                              "conv_gray_exit": 1},
    ("dbnet", "avg", False): {"conv_gray_enter": 1, "conv_chain": 1,
                              "conv_multi": 3, "conv_wide": 3,
                              "conv_gray_exit": 1},
    ("dbnet", "sum", True): {"conv_gray_enter": 1, "conv_chain": 1,
                             "conv_multi": 3, "conv_wide": 3,
                             "conv_gray_exit": 1},
    ("unfusion", "wavg", False): {"conv_gray_enter": 1, "conv_chain": 9,
                                  "conv_wide": 18, "conv_gray_exit": 1},
    ("unfusion", "wavg", True): {"conv_gray_enter": 1, "conv_chain": 9,
                                 "conv_wide": 18, "conv_gray_exit": 1},
}


@pytest.mark.parametrize("key", sorted(_WIDE_MODEL_LAUNCHES, key=str))
def test_wide_models_on_card_match_cpu(cuda, key):
    """DBNet and UNFusion through the kernels against the same weights on
    the CPU's plain path, f32, odd size, with exact launch counts."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    name, mode, ae = key
    model = create_model(name, fusion_mode=mode,
                         generator=torch.Generator().manual_seed(6)).eval()
    x1 = _rand((2, 45, 57, 1), 98, "cpu", lo=0.0)
    x2 = None if ae else _rand((2, 45, 57, 1), 99, "cpu", lo=0.0)
    with torch.no_grad():
        want = model(x1, x2)
        build.LAUNCHES.clear()
        got = model.to(cuda)(x1.to(cuda), None if x2 is None else x2.to(cuda))
    assert dict(build.LAUNCHES) == _WIDE_MODEL_LAUNCHES[key]
    _close(got.cpu(), want, torch.float32)


# ---------------------------------------------------------------------------
# int8 inference: conv_int8 (row 11) and conv_int8_chain (row 12)
# ---------------------------------------------------------------------------


def _int8_layer(cin, cout, k, seed, dev):
    from multi_modal_image_fusion_tpu_torch.ops.quant import (
        choose_fold, fold_weights, quantize_weights)
    w = _rand((cout, cin, k, k), seed, dev) / np.sqrt(cin * k * k)
    bias = _rand((cout,), seed + 1, dev) * 0.2
    # channel ranges spanning 100x, so the fold is far from constant
    spread = torch.logspace(-1.5, 0.5, cin)[torch.randperm(
        cin, generator=torch.Generator().manual_seed(seed))].to(dev)
    x = _rand((4, 33, 70, cin), seed + 2, dev, lo=-0.3) * 2 * spread
    f = choose_fold(x.abs().amax(dim=(0, 1, 2)), w)
    qw, sw = quantize_weights(fold_weights(w, f))
    qw0, _ = quantize_weights(w)
    return x, w, bias, f, qw, sw, qw0


def _int8_rel(got, want):
    """max |got - want| / max|want| in f32 (int8 outputs as integers)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k,cin,cout,act", [
    (1, 24, 16, "relu"), (3, 1, 16, "relu"), (3, 40, 24, "relu6"),
    (5, 16, 1, None), (7, 32, 32, "relu"), (3, 72, 130, "lrelu"),
    (3, 64, 64, "tanh")])
def test_conv_int8(cuda, dt, k, cin, cout, act):
    """conv_int8 equals its plain version (the same integers; one rounding
    of the multiply-add on both sides): f32 bit for bit, bf16 too. The
    controls (taps transposed, the fold left out of the weights) miss by
    more than 1e-2 of max|y|."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8, conv_int8_plain)
    x, _, bias, f, qw, sw, qw0 = _int8_layer(cin, cout, k, 600 + k + cin,
                                             cuda)
    x = x.to(DTYPES[dt])
    before = build.LAUNCHES["conv_int8"]
    want = conv_int8_plain(x, qw, sw, f, bias, act)
    got = conv_int8(x, qw, sw, f, bias, act)
    assert build.LAUNCHES["conv_int8"] == before + 1
    assert _int8_rel(got, want) <= (1e-6 if dt == "f32" else 2 ** -8)
    # with one input channel the fold is a scalar the weight quantizer
    # absorbs, so leaving it out changes nothing
    controls = [conv_int8(x, qw0, sw, f, bias, act)] if cin > 1 else []
    if k > 1:
        controls.append(conv_int8(x, qw.transpose(2, 3).contiguous(), sw, f,
                                  bias, act))
    for y in controls:
        assert _int8_rel(y, want) > 1e-2


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k,cin,cout", [(7, 16, 32), (7, 32, 32),
                                        (5, 32, 16)])
@pytest.mark.parametrize("src,dst,fuse", [
    ("float", "float", False), ("float", "float", True),
    ("float", "int8", False), ("int8", "int8", True),
    ("int8", "float", True), ("int8", "float", False)])
def test_conv_int8_chain(cuda, dt, k, cin, cout, src, dst, fuse):
    """conv_int8_chain equals its plain version on float (quantized by the
    reciprocal) and int8-resident inputs, with and without fuse_n, writing
    the chain dtype or int8; the controls (taps transposed, the fold left
    out, one fuse_n half's images in reverse order) miss by more than
    1e-2 of max|y|."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8_chain, conv_int8_chain_plain)
    dtype = DTYPES[dt]
    x, _, bias, f, qw, sw, qw0 = _int8_layer(cin, cout, k, 700 + k + cin,
                                             cuda)
    x = x.to(dtype)
    if src == "int8":
        x = torch.clamp(torch.round(x.float() / f), -127, 127).to(torch.int8)
    fuse_n = 2 if fuse else 0
    dq, b = sw, bias
    out_int8 = dst == "int8"
    if out_int8:
        y = conv_int8_chain_plain(x, qw, sw, bias, "relu", 1.0 / f, fuse_n,
                                  out_dtype=dtype)
        f_next = y.float().abs().amax(dim=(0, 1, 2)).clamp(min=1e-3) / 127
        dq, b = sw / f_next, bias / f_next

    def run(w=qw, xx=x):
        return conv_int8_chain(xx, w, dq, b, "relu", 1.0 / f, fuse_n,
                               out_int8, dtype)
    want = conv_int8_chain_plain(x, qw, dq, b, "relu", 1.0 / f, fuse_n,
                                 out_int8, dtype)
    before = build.LAUNCHES["conv_int8_chain"]
    got = run()
    assert build.LAUNCHES["conv_int8_chain"] == before + 1
    if out_int8:
        assert got.dtype == torch.int8 and torch.equal(got, want)
    else:
        assert _int8_rel(got, want) <= (1e-6 if dt == "f32" else 2 ** -8)
    controls = [run(qw.transpose(2, 3).contiguous()), run(qw0)]
    if fuse:
        controls.append(run(xx=torch.cat([x[:2], x[2:].flip(0)])))
    for y in controls:
        assert _int8_rel(y, want) > 1e-2


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k,cins,cout", [(3, [1], 16), (3, [16], 16),
                                         (5, [16], 1), (7, [16], 32),
                                         (3, [8, 8], 16)])
def test_conv_int8_tap_pairs(cuda, dt, k, cins, cout):
    """The tap-pair route (at most 16 input channels: a k-step's halves
    carry taps kw and kw + 1, half 1 read one pixel on) equals its plain
    version; the controls (taps transposed; the rows of taps in reverse
    order) miss by more than 1e-2 of max|y|."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8, conv_int8_plain, tap_pairs)
    assert tap_pairs(k, sum(cins))
    x, _, bias, f, qw, sw, _ = _int8_layer(sum(cins), cout, k,
                                           900 + k + sum(cins), cuda)
    x = x.to(DTYPES[dt])
    legs, ofs = [], 0
    for c in cins:
        legs.append((x[..., ofs:ofs + c].contiguous(), 0))
        ofs += c
    want = conv_int8_plain(x, qw, sw, f, bias, "relu")
    got = conv_int8(legs, qw, sw, f, bias, "relu")
    assert _int8_rel(got, want) <= (1e-6 if dt == "f32" else 2 ** -8)
    for ctl in (qw.transpose(2, 3).contiguous(), qw.flip(2).contiguous()):
        assert _int8_rel(conv_int8(legs, ctl, sw, f, bias, "relu"),
                         want) > 1e-2


@pytest.mark.parametrize("dst", ["int8", "float"])
def test_conv_int8_chain_pair_in_shared_memory(cuda, dst):
    """An int8-resident fuse_n pair at DeepFuse's dec0 shape (k7, 32 -> 32)
    is copied into two buffers of a ring slot and summed in shared memory
    (int8_plan's pair), saturating at +-127 as the plain version's sum;
    the input at the int8 limits, so the saturation is exercised. The
    control (one half's images in reverse order) misses by more than 1e-2
    of max|y|."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8_chain, conv_int8_chain_plain, int8_plan, pick_bn_int8)
    out = torch.int8 if dst == "int8" else torch.bfloat16
    bn = pick_bn_int8(32, 32, 7, True, out)
    assert int8_plan(7, bn, 32, True, out)[3] == 1
    _, _, bias, f, qw, sw, _ = _int8_layer(32, 32, 7, 950, cuda)
    g = torch.Generator(device=cuda).manual_seed(951)
    x = torch.randint(-127, 128, (4, 33, 70, 32), generator=g, device=cuda,
                      dtype=torch.int8)
    x[:2, :5] = 127
    x[2:, :5] = 100
    dq, b = sw, bias
    if dst == "int8":
        y = conv_int8_chain_plain(x, qw, sw, bias, "relu", fuse_n=2,
                                  out_dtype=torch.float32)
        f_next = y.abs().amax(dim=(0, 1, 2)).clamp(min=1e-3) / 127
        dq, b = sw / f_next, bias / f_next

    def run(xx):
        return conv_int8_chain(xx, qw, dq, b, "relu", fuse_n=2,
                               out_int8=dst == "int8", out_dtype=out)
    want = conv_int8_chain_plain(x, qw, dq, b, "relu", fuse_n=2,
                                 out_int8=dst == "int8", out_dtype=out)
    got = run(x)
    assert torch.equal(got, want) if dst == "int8" \
        else _int8_rel(got, want) <= 2 ** -8
    assert _int8_rel(run(torch.cat([x[:2], x[2:].flip(0)])), want) > 1e-2


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv_int8_legs_in_place(cuda, dt):
    """conv_int8 over legs read in place (three legs, a batch offset,
    fuse_n, each leg quantized by its slice of the concat's fold) equals
    the plain version of the concat route; the control (two legs' scale
    slices swapped) misses by more than 1e-2 of max|y|."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8, conv_int8_plain)
    from multi_modal_image_fusion_tpu_torch.ops.layers import concat_sum
    x, _, bias, f, qw, sw, _ = _int8_layer(80, 48, 3, 960, cuda)
    x = x.to(DTYPES[dt])
    extra = _rand((1, *x.shape[1:3], 48), 961, cuda, DTYPES[dt]) * 2
    legs = [(x[..., :16].contiguous(), 0), (x[..., 16:32].contiguous(), 0),
            (torch.cat([extra, x[..., 32:]]).contiguous(), 1)]
    want = conv_int8_plain(concat_sum(legs, 2, 2), qw, sw, f, bias, "relu")
    got = conv_int8(legs, qw, sw, f, bias, "relu", fuse_n=2)
    assert _int8_rel(got, want) <= (1e-6 if dt == "f32" else 2 ** -8)
    f_swapped = torch.cat([f[16:32], f[:16], f[32:]])
    assert _int8_rel(conv_int8(legs, qw, sw, f_swapped, bias, "relu",
                               fuse_n=2), want) > 1e-2


def test_int8_raises_with_grad_and_on_unsupported(cuda):
    """The int8 wrappers and ConvLayer's int8 route are forward-only: a CUDA
    input or bias that needs a gradient raises (under no_grad they run);
    shapes outside the instances raise."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops import quant
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8, conv_int8_chain)
    x, _, bias, f, qw, sw, _ = _int8_layer(16, 32, 7, 800, cuda)
    bg = bias.clone().requires_grad_()
    calls = [lambda: conv_int8(x.clone().requires_grad_(), qw, sw, f),
             lambda: conv_int8(x, qw, sw, f, bg),
             lambda: conv_int8_chain(x, qw, sw, bg, "relu", 1.0 / f)]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            call()
    with pytest.raises(ValueError):             # k3 has no chain instance
        conv_int8_chain(x, qw[..., 2:5, 2:5].contiguous(), sw, bias, "relu",
                        1.0 / f)
    with pytest.raises(ValueError):             # relu6 on an int8 output
        conv_int8_chain(x, qw, sw, bias, "relu6", 1.0 / f, out_int8=True)
    img = _rand((1, 20, 30, 1), 801, cuda, lo=0.0)
    for name in ("deepfuse", "densefuse"):
        model = create_model(name,
                             generator=torch.Generator().manual_seed(0)).to(
            cuda)
        amax = quant.calibrate(model, [(img, img)])
        with quant.quantized_inference(amax), \
                pytest.raises(RuntimeError, match="forward-only"):
            model(img, img)


# launches of one int8 forward: model -> counts (ops/quant.py routes)
_INT8_MODEL_LAUNCHES = {
    "deepfuse": {"conv_gray_enter": 1, "conv_int8_chain": 3,
                 "conv_gray_exit": 1},
    "densefuse": {"conv_int8": 8},
    "dbnet": {"conv_int8": 9},
    "unfusion": {"conv_int8": 29},
}


@pytest.mark.parametrize("name", sorted(_INT8_MODEL_LAUNCHES))
def test_int8_models_on_card_match_plain(cuda, name):
    """An int8 forward through the kernels against the plain int8 path on
    the card (ConvLayer's int8 wrappers swapped for their plain versions,
    every float layer on the same kernels), same weights and amax, f32,
    odd size: equal, with exact launch counts. (Against the CPU the float
    layers differ by f32 rounding, and a value that lands on a rounding
    boundary flips a quantum that spreads downstream.)"""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops import layers, quant
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8_chain_plain, conv_int8_plain)
    model = create_model(name, generator=torch.Generator().manual_seed(
        8)).to(cuda).eval()
    x1 = _rand((2, 45, 57, 1), 96, cuda, lo=0.0)
    x2 = _rand((2, 45, 57, 1), 97, cuda, lo=0.0)
    amax = quant.calibrate(model, [(x1, x2)])
    with torch.no_grad(), quant.quantized_inference(amax):
        build.LAUNCHES.clear()
        got = model(x1, x2)
        assert dict(build.LAUNCHES) == _INT8_MODEL_LAUNCHES[name]
        kernels = layers.conv_int8, layers.conv_int8_chain
        # the plain versions take no `weights` (ConvLayer's cached packing)
        layers.conv_int8 = lambda *a, weights=None, **kw: conv_int8_plain(
            *a, **kw)
        layers.conv_int8_chain = lambda *a, weights=None, **kw: \
            conv_int8_chain_plain(*a, **kw)
        try:
            want = model(x1, x2)
        finally:
            layers.conv_int8, layers.conv_int8_chain = kernels
    assert torch.equal(got, want)


def test_train_conv_reflect_pad_past_int32(cuda):
    """The training route pads the whole batch in one call
    (ConvLayer._train_conv): at DenseFuse's 64-channel concat of 32
    images at 1224x1024 the padded tensor holds 2.58e9 elements, past
    2^31. It must give the batch-chunked result (within the bf16
    tolerance: cuDNN may pick another algorithm for another batch)."""
    from multi_modal_image_fusion_tpu_torch.ops.layers import (ConvLayer,
                                                               fast_training)
    layer = ConvLayer(64, 64, generator=torch.Generator().manual_seed(0)).to(
        cuda, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((32, 1224, 1024, 64), generator=g, device=cuda).to(
        torch.bfloat16)
    assert 32 * 64 * 1226 * 1026 > 2 ** 31
    with torch.no_grad(), fast_training(False):
        got = layer._train_conv(x)
        want = torch.cat([layer._train_conv(x[i:i + 8])
                          for i in range(0, 32, 8)])
    assert got.shape == (32, 1224, 1024, 64)
    for i in range(0, 32, 4):             # f64 copies of 2.6e9 elements
        _close(got[i:i + 4], want[i:i + 4], torch.bfloat16)


# ---------------------------------------------------------------------------
# DeepFuse's opt-in chain routes: conv_pair (row 10), conv_wide's s2d mode
# (row 9) and s2d_enter / s2d_exit (rows 13-14)
# ---------------------------------------------------------------------------

# the pair's tolerance: conv_wide's (f32 1e-4 of max|y|; bf16 1e-3 of max|y|
# beyond one bf16 ulp of each output). In bf16 the mid is rounded to bf16 on
# both sides; an f32 sum taken in another order flips a mid value by one
# ulp now and then, which moves an output by |w| * 2^-8 of one of its
# 400-784 terms: far inside 1e-3 of max|y|.
PAIR_CASES = [("enter", 2, 45, 61, "f32"), ("enter", 1, 20, 130, "f32"),
              ("exit", 2, 45, 61, "f32"), ("exit", 1, 33, 70, "f32"),
              ("exit", 1, 16, 5, "f32"),
              # the bench's size; a height whose last tile is one row
              # (PAIR_TILES: 8 and 20 rows); the enter narrower than a tile.
              # "chain": the enter's images in the weights' dtype (bf16: the
              # cp.async staging, W a multiple of 8)
              ("enter", 2, 1224, 1024, "chain"), ("exit", 2, 1224, 1024, "f32"),
              ("enter", 1, 41, 72, "chain"), ("exit", 1, 41, 70, "f32"),
              ("enter", 1, 24, 40, "chain")]


def _pair_weights(kind, dev, dtype):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
        ENTER_SHAPES, EXIT_SHAPES)
    out = []
    for i, shape in enumerate(ENTER_SHAPES if kind == "enter"
                              else EXIT_SHAPES):
        fan = shape[1] * shape[2] * shape[3]
        out += [(_drand(shape, 300 + i, dev, torch.float32)
                 / np.sqrt(fan)).to(dtype),
                _drand((shape[0],), 310 + i, dev, torch.float32) * 0.1]
    wa, ba, wb, bb = out
    return wa, ba, "relu", wb, bb, "relu" if kind == "enter" else None


def _extended_mid(x, wa, ba, wb, bb, act_b):
    """The control: the mid's halo computed as conv_a over the reflect-
    extended input, then conv_b VALID (f32, cast like the pair)."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        apply_act
    p = wa.shape[-1] // 2 + wb.shape[-1] // 2
    xp = F.pad(x.float().permute(0, 3, 1, 2), (p,) * 4, mode="reflect")
    mid = apply_act(F.conv2d(xp, wa.float(), ba), "relu").to(x.dtype).float()
    y = apply_act(F.conv2d(mid, wb.float(), bb), act_b)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _corner_unfixed(kind, want, ext):
    """The second control: the pair with the mid's reflect fix-up left out
    on the tile at the image's bottom-right corner (PAIR_TILES), there the
    extended-input mid of `ext`, the plain pair elsewhere."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import \
        pair_tile
    h, w = want.shape[1:3]
    _, n = pair_tile(kind, 1, h, w, 0)
    (_, y0, x0, _, _), _ = pair_tile(kind, 1, h, w, n - 1)
    ctl = want.clone()
    ctl[:, y0:, x0:] = ext[:, y0:, x0:]
    return ctl


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", PAIR_CASES, ids=[
    f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}" for c in PAIR_CASES])
def test_conv_pair(cuda, case, dt):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
        conv_pair_enter, conv_pair_exit, conv_pair_plain)
    kind, b, h, w, imgs = case
    dtype = DTYPES[dt]
    args = _pair_weights(kind, cuda, dtype)
    name = f"conv_pair_{kind}"
    before = build.LAUNCHES[name]
    if kind == "enter":
        idt = torch.float32 if imgs == "f32" else dtype
        img1 = _drand((b, h, w, 1), 320, cuda, idt)
        img2 = _drand((b, h, w, 1), 321, cuda, idt)
        x = torch.cat([img1, img2]).to(dtype)
        got = conv_pair_enter(img1, img2, *args)   # the cast inside
    else:
        x = _drand((b, h, w, 32), 322, cuda, dtype)
        got = conv_pair_exit(x, *args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    assert got.dtype == dtype
    want = conv_pair_plain(x, *args)
    tol = WIDE_TOL[dtype]
    assert _wide_rel(got, want, dtype) <= tol
    if min(h, w) > 8:
        ext = _extended_mid(x, args[0], args[1], args[3], args[4], args[5])
        assert _wide_rel(got, ext, dtype) > 10 * tol
        ctl = _corner_unfixed(kind, want, ext)
        assert _wide_rel(got, ctl, dtype) > 10 * tol


def test_conv_pair_bf16_images(cuda):
    """conv_pair_enter reads bf16 images as well as f32 ones."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
        conv_pair_enter, conv_pair_plain)
    args = _pair_weights("enter", cuda, torch.bfloat16)
    img1 = _drand((1, 40, 70, 1), 323, cuda, torch.bfloat16)
    img2 = _drand((1, 40, 70, 1), 324, cuda, torch.bfloat16)
    got = conv_pair_enter(img1, img2, *args)
    want = conv_pair_plain(torch.cat([img1, img2]), *args)
    assert _wide_rel(got, want, torch.bfloat16) <= WIDE_TOL[torch.bfloat16]


@pytest.mark.parametrize("kind,acts", [("enter", ("lrelu", "relu6")),
                                       ("exit", ("tanh", "lrelu"))])
def test_conv_pair_other_activations(cuda, kind, acts):
    """The bf16 kernels compile in the models' activations (relu/relu,
    relu/none); any other pair goes through the activation switch."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
        conv_pair_enter, conv_pair_exit, conv_pair_plain)
    wa, ba, _, wb, bb, _ = _pair_weights(kind, cuda, torch.bfloat16)
    args = (wa, ba, acts[0], wb, bb, acts[1])
    if kind == "enter":
        imgs = [_drand((1, 45, 72, 1), 330 + i, cuda, torch.bfloat16)
                for i in range(2)]
        got = conv_pair_enter(*imgs, *args)
        x = torch.cat(imgs)
    else:
        x = _drand((1, 45, 61, 32), 332, cuda, torch.bfloat16)
        got = conv_pair_exit(x, *args)
    want = conv_pair_plain(x, *args)
    assert _wide_rel(got, want, torch.bfloat16) <= WIDE_TOL[torch.bfloat16]


def test_conv_pair_raises(cuda):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
        conv_pair_enter, conv_pair_exit)
    wa, ba, aa, wb, bb, ab = _pair_weights("exit", cuda, torch.float32)
    x = torch.zeros((1, 16, 16, 32), device=cuda)
    with pytest.raises(ValueError, match="built for"):
        conv_pair_exit(x, wb, bb, aa, wa, ba, ab)
    with pytest.raises(ValueError, match="32 input channels"):
        conv_pair_exit(x[..., :16].contiguous(), wa, ba, aa, wb, bb, ab)
    with pytest.raises(TypeError):
        conv_pair_exit(x.to(torch.bfloat16), wa, ba, aa, wb, bb, ab)
    img = torch.zeros((1, 16, 16, 1), device=cuda)
    with pytest.raises(ValueError, match="built for"):
        conv_pair_enter(img, img, wa, ba, aa, wb, bb, ab)
    wa.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv_pair_exit(x, wa, ba, aa, wb, bb, ab)


# conv_wide's s2d mode at DeepFuse's packed layers: (name, c_in, c_out, k
# of the original layer, act, fuse_n), run packed (4x the channels, k5 ->
# k3, k7 -> k5); packed heights 15 and 23 reach the bottom mirror of both
# phases. The control, the phase-blind reflect of the packed tensor
# (conv_wide without s2d mode), must miss by 10x the tolerance.
S2D_LAYERS = [("enc0", 1, 16, 5, "relu", 0), ("enc1", 16, 32, 7, "relu", 0),
              ("dec0", 32, 32, 7, "relu", 2), ("dec1", 32, 16, 5, "relu", 0),
              ("dec2", 16, 1, 5, None, 0)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hw", [(30, 44), (46, 130)])
@pytest.mark.parametrize("layer", S2D_LAYERS, ids=[c[0] for c in S2D_LAYERS])
def test_conv_wide_s2d(cuda, layer, hw, dt):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import (
        conv_wide, conv_wide_plain)
    from multi_modal_image_fusion_tpu_torch.ops.s2d import (
        s2d_pack, s2d_pack_bias, s2d_pack_weights)
    name, cin, cout, k, act, fuse_n = layer
    dtype = DTYPES[dt]
    h, w = hw
    x = _drand((2 * fuse_n or 2, h, w, cin), 330 + cin, cuda, dtype)
    wt = (_drand((cout, cin, k, k), 331 + cout, cuda, torch.float32)
          / np.sqrt(cin * k * k)).to(dtype)
    bias = _drand((cout,), 332, cuda, torch.float32) * 0.1
    xp, wp, bp = s2d_pack(x).contiguous(), s2d_pack_weights(wt), \
        s2d_pack_bias(bias)
    before = build.LAUNCHES["conv_wide/s2d"]
    got = conv_wide([(xp, 0)], wp, bp, act, fuse_n, s2d_f=2)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_wide/s2d"] == before + 1
    want = conv_wide_plain([(xp, 0)], wp, bp, act, fuse_n, s2d_f=2)
    tol = WIDE_TOL[dtype]
    assert _wide_rel(got, want, dtype) <= tol
    blind = conv_wide([(xp, 0)], wp, bp, act, fuse_n)
    assert _wide_rel(blind, want, dtype) > 10 * tol


@pytest.mark.parametrize("in_dt", sorted(DTYPES))
@pytest.mark.parametrize("out_dt", sorted(DTYPES))
@pytest.mark.parametrize("hw", [(30, 44), (40, 256), (2, 2)])
def test_s2d_enter_exit(cuda, in_dt, out_dt, hw):
    """Bit for bit against the plain pack and unpack; the control (a pack
    with the px phases swapped) must differ."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.s2d_io import (
        s2d_enter, s2d_enter_plain, s2d_exit, s2d_exit_plain)
    h, w = hw
    img1 = _drand((3, h, w, 1), 340, cuda, DTYPES[in_dt])
    img2 = _drand((3, h, w, 1), 341, cuda, DTYPES[in_dt])
    before = dict(build.LAUNCHES)
    t = s2d_enter(img1, img2, DTYPES[out_dt])
    want = s2d_enter_plain(img1, img2, DTYPES[out_dt])
    assert t.dtype == DTYPES[out_dt] and torch.equal(t, want)
    assert not torch.equal(t, want[..., [1, 0, 3, 2]])
    y = s2d_exit(t)
    torch.cuda.synchronize()
    assert torch.equal(y, s2d_exit_plain(t))
    assert torch.equal(y, torch.cat([img1, img2]).to(DTYPES[out_dt]))
    for name in ("s2d_enter", "s2d_exit"):
        assert build.LAUNCHES[name] == before.get(name, 0) + 1
    with pytest.raises(ValueError, match="even"):
        s2d_enter(img1[:, :-1].contiguous(), img2[:, :-1].contiguous(),
                  torch.float32)


# launches of one DeepFuse forward on each opt-in route
_VARIANT_LAUNCHES = {
    "pair": {"conv_pair_enter": 1, "conv_chain": 1, "conv_pair_exit": 1},
    "s2d": {"conv_wide": 5, "conv_wide/s2d": 5},
    "s2d_io": {"s2d_enter": 1, "conv_wide": 5, "conv_wide/s2d": 5,
               "s2d_exit": 1},
}
_VARIANT_ENV = {"pair": {"MMIF_CHAIN_PAIR": "1"},
                "s2d": {"MMIF_S2D": "1", "MMIF_CHAIN_HIW": "0"},
                "s2d_io": {"MMIF_S2D": "1", "MMIF_CHAIN_HIW": "0",
                           "MMIF_S2D_IO": "1"}}


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("route", sorted(_VARIANT_LAUNCHES))
def test_deepfuse_routes_on_card(cuda, monkeypatch, route, mode):
    """DeepFuse's opt-in routes through the kernels against the default
    route of the same weights on the CPU (f32, 1e-4 of max|y|), with exact
    launch counts; the s2d_io route in bf16 at an eligible shape, bit for
    bit against the packed route without it, and within the bf16
    tolerance of the CPU."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    for k, v in _VARIANT_ENV[route].items():
        monkeypatch.setenv(k, v)
    dtype = torch.bfloat16 if route == "s2d_io" else torch.float32
    h, w = (32, 256) if route == "s2d_io" else (46, 70)
    model = create_model("deepfuse", fusion_mode=mode,
                         generator=torch.Generator().manual_seed(7)).eval()
    x1 = _rand((2, h, w, 1), 350, "cpu", lo=0.0)
    x2 = _rand((2, h, w, 1), 351, "cpu", lo=0.0)
    with torch.no_grad():
        with monkeypatch.context() as m:
            for k in _VARIANT_ENV[route]:
                m.delenv(k)
            want = model(x1, x2)
        card = model.to(cuda, dtype)
        a, b = x1.to(cuda, dtype), x2.to(cuda, dtype)
        assert card.route(a, b) == route.split("_")[0]
        build.LAUNCHES.clear()
        got = card(a, b)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == _VARIANT_LAUNCHES[route]
        if route == "s2d_io":
            monkeypatch.setenv("MMIF_S2D_IO", "0")
            assert torch.equal(card(a, b), got)
    _close(got.float().cpu(), want, dtype)
