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

from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    conv_chain, conv_chain_plain, conv_gray_enter, conv_gray_enter_plain,
    conv_gray_exit, conv_gray_exit_plain)
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
    got, want = got.float(), want.float()
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
