"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device, nvcc and no JAX; every test skips without a card.
Run on the GPU machine with (the JAX-importing conftest is skipped):

    python -m pytest --noconftest tests/test_torch_kernels.py

Tolerances, relative to the largest magnitude of the plain output: f32
1e-4 (the kernel and the plain version sum the same f32 products in another
order; TF32 is off for the plain convs); bf16 2e-2 (both compute in f32 and
round the output to bf16, whose 8-bit mantissa is 2^-8 ~ 4e-3 of a value,
and a different summation order can flip that rounding).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    conv_chain, conv_chain_plain, conv_gray_enter, conv_gray_enter_plain,
    conv_gray_exit, conv_gray_exit_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_valid import (
    conv_valid, conv_valid_plain)
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
])
def test_conv_chain(cuda, dt, k, cin, cout, h, w, fuse_n):
    dtype = DTYPES[dt]
    b = 2 * fuse_n if fuse_n else 2
    x = _rand((b, h, w, cin), 0, cuda, dtype)
    wt = _rand((cout, cin, k, k), 1, cuda) * 0.2
    bias = _rand((cout,), 2, cuda)
    before = build.LAUNCHES["conv_chain"]
    got = conv_chain(x, wt, bias, "relu", fuse_n)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_chain"] == before + 1
    _close(got, conv_chain_plain(x, wt, bias, "relu", fuse_n), dtype)


@pytest.mark.parametrize("act", ["relu6", "lrelu", "tanh", None])
def test_conv_chain_activations(cuda, act):
    x = _rand((1, 20, 30, 16), 3, cuda)
    wt = _rand((16, 16, 5, 5), 4, cuda) * 0.2
    got = conv_chain(x, wt, None, act)
    _close(got, conv_chain_plain(x, wt, None, act), torch.float32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("pair", [True, False])
def test_conv_gray_enter(cuda, dt, pair):
    img1 = _rand((2, 45, 61, 1), 5, cuda, DTYPES[dt], lo=0.0)
    img2 = _rand((2, 45, 61, 1), 6, cuda, DTYPES[dt], lo=0.0) \
        if pair else None
    wt = _rand((16, 1, 5, 5), 7, cuda)
    bias = _rand((16,), 8, cuda)
    got = conv_gray_enter(img1, img2, wt, bias, "relu")
    assert got.dtype == DTYPES[dt]
    want = conv_gray_enter_plain(img1, img2, wt, bias, "relu")
    _close(got, want, DTYPES[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("h,w", [(45, 61), (8, 200)])
def test_conv_gray_exit(cuda, dt, h, w):
    x = _rand((3, h, w, 16), 9, cuda, DTYPES[dt])
    wt = _rand((1, 16, 5, 5), 10, cuda) * 0.2
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
        wt = _rand((cout, cin, k, k), cin + cout + k, cuda) * 0.1
        y = conv_chain(t, wt, None, "relu", fuse)
        _close(y, conv_chain_plain(t, wt, None, "relu", fuse), bf)
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
    with pytest.raises(ValueError):       # k3 is not built
        conv_chain(x, torch.zeros((16, 12, 3, 3), device=cuda))
    img = torch.zeros((1, 16, 16, 1), device=cuda)
    with pytest.raises(TypeError):        # img1 and img2 in one dtype
        conv_gray_enter(img, img.bfloat16(),
                        torch.zeros((16, 1, 5, 5), device=cuda))
    with pytest.raises(ValueError):       # k7 exit is not built
        conv_gray_exit(x[..., :8].contiguous(),
                       torch.zeros((1, 8, 7, 7), device=cuda))


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
@pytest.mark.parametrize("cin,cout,k", _VALID_FWD)
def test_conv_valid_fast_grads(cuda, dt, cin, cout, k):
    """conv_valid_fast's forward and dx (kernel launches) and dw (torch
    matmuls) against F.conv2d's autograd on the same inputs in float64 (an
    f32 reference through cuDNN's weight gradient was itself 1e-3 off at
    c_in=1)."""
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


def test_conv_valid_raises_on_unsupported(cuda):
    xp = torch.zeros((1, 20, 20, 8), device=cuda)
    with pytest.raises(ValueError):       # k3 is not built
        conv_valid(xp, torch.zeros((8, 8, 3, 3), device=cuda))
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
             lambda: ssim_maps(img.clone().requires_grad_(), img, 11)]
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
                                "conv_valid/dx": 4}
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
