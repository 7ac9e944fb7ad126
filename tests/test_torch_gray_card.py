"""conv_gray_enter and conv_gray_exit (csrc/conv_gray.cu) against their
plain versions, on the card.

Needs a CUDA device and nvcc; every test skips without a card. Run on the
GPU machine with (the JAX-importing conftest is skipped):

    python -m pytest --noconftest tests/test_torch_gray_card.py

Every built instance (enter k1, k3 and k5 at Cout 16 and 32, exit k1, k3 and
k5 from 16 channels, and exit channel counts that take several k-steps or
the element-wise copy) in bf16 and f32, at the bench's 16 pairs of
1224x1024, at an odd 45x61, and where the persistent grid's last tile is
ragged (8x200, 1224x1000: GRAY_TILES' 128-pixel rows). Tolerances, relative
to the plain output's largest magnitude: f32 1e-4 of max(|y|, 1) (the same
f32 products summed in another order); bf16 1e-3 beyond one bf16 ulp of
each output (the same exact products of bf16 weights and inputs summed in
f32 in another order, one rounding to bf16). At the bench's shape, controls
that must miss by 10x: the taps transposed, the halo zero-padded instead of
reflected, and for the enter the two images swapped; a k1 enter (no halo, one
tap) has the bias dropped and its output channels reversed in their place.
"""

import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    apply_act, conv_gray_enter, conv_gray_enter_plain, conv_gray_exit,
    conv_gray_exit_plain)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# (pairs, h, w): the bench, an odd size, two ragged last tiles
SHAPES = [(16, 1224, 1024), (2, 45, 61), (2, 8, 200), (1, 1224, 1000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, dev, dtype=torch.float32, lo=-0.5):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(shape, generator=g, device=dev) + lo).to(dtype)


def _rel(got, want, dtype):
    """max |got - want| over max(|want|) (f32: max(|want|, 1)); in bf16
    beyond one bf16 ulp of each output."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    d = (got - want).abs()
    if dtype == torch.bfloat16:
        d = (d - torch.exp2(torch.floor(torch.log2(
            want.abs().clamp(min=1e-30))) - 7)).clamp(min=0)
        return float(d.max()) / float(want.abs().max())
    return float(d.max()) / max(float(want.abs().max()), 1.0)


def _zero_halo(x, wt, bias, act):
    """The plain conv with a zero halo in place of the reflect."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wt.to(x.dtype).float(),
                 bias, padding=wt.shape[-1] // 2)
    return apply_act(y, act).permute(0, 2, 3, 1).to(x.dtype)


def _launched(name, fn):
    before = build.LAUNCHES[name]
    y = fn()
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    return y


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k,cout", [(1, 16), (3, 16), (5, 16), (1, 32),
                                    (3, 32), (5, 32)])
def test_conv_gray_enter(cuda, k, cout, dt, shape):
    n, h, w = shape
    dtype = DTYPES[dt]
    img1 = _rand((n, h, w, 1), 1, cuda, dtype, lo=0.0)
    img2 = _rand((n, h, w, 1), 2, cuda, dtype, lo=0.0)
    wt = _rand((cout, 1, k, k), 3, cuda) * 0.8
    bias = _rand((cout,), 4, cuda) * 0.2
    got = _launched("conv_gray_enter",
                    lambda: conv_gray_enter(img1, img2, wt, bias, "relu"))
    assert got.dtype == dtype and got.shape == (2 * n, h, w, cout)
    want = conv_gray_enter_plain(img1, img2, wt, bias, "relu")
    assert _rel(got, want, dtype) <= TOL[dtype]
    if dt != "bf16" or n != 16:
        return
    wq = wt.to(dtype)
    ctls = {"images swapped": conv_gray_enter(img2, img1, wq, bias, "relu")}
    if k > 1:
        ctls["taps transposed"] = conv_gray_enter(
            img1, img2, wq.transpose(2, 3), bias, "relu")
        ctls["zero halo"] = _zero_halo(torch.cat([img1, img2]), wq, bias,
                                       "relu")
    else:
        ctls["bias dropped"] = conv_gray_enter(img1, img2, wq, None, "relu")
        ctls["channels reversed"] = conv_gray_enter(img1, img2, wq.flip(0),
                                                    bias, "relu")
    for what, y in ctls.items():
        assert _rel(y, want, dtype) > 10 * TOL[dtype], what


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv_gray_exit(cuda, k, dt, shape):
    n, h, w = shape
    dtype = DTYPES[dt]
    x = _rand((n, h, w, 16), 5, cuda, dtype)
    wt = _rand((1, 16, k, k), 6, cuda) * (2.0 / k)
    bias = _rand((1,), 7, cuda) * 0.2
    got = _launched("conv_gray_exit",
                    lambda: conv_gray_exit(x, wt, bias, None))
    assert got.dtype == dtype and got.shape == (n, h, w, 1)
    want = conv_gray_exit_plain(x, wt, bias, None)
    assert _rel(got, want, dtype) <= TOL[dtype]
    if dt != "bf16" or n != 16 or k == 1:
        return
    wq = wt.to(dtype)
    ctls = {"taps transposed": conv_gray_exit(x, wq.transpose(2, 3), bias,
                                              None),
            "zero halo": _zero_halo(x, wq, bias, None)}
    for what, y in ctls.items():
        assert _rel(y, want, dtype) > 10 * TOL[dtype], what


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cin", [8, 12, 40, 1])
@pytest.mark.parametrize("k", [3, 5])
def test_conv_gray_exit_channels(cuda, k, cin, dt):
    """Channel counts the models do not use: half a k-step (8), the
    element-wise copy (12, 1) and three k-steps (40), at an odd size."""
    dtype = DTYPES[dt]
    x = _rand((2, 45, 61, cin), 8, cuda, dtype)
    wt = _rand((1, cin, k, k), 9, cuda) * (2.0 / k)
    got = _launched("conv_gray_exit",
                    lambda: conv_gray_exit(x, wt, None, "relu"))
    want = conv_gray_exit_plain(x, wt, None, "relu")
    assert _rel(got, want, dtype) <= TOL[dtype]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["relu6", "lrelu", "tanh", None])
def test_conv_gray_activations(cuda, act, dt):
    """The activations the kernels take through their switch (relu and none
    are compiled in), one image, odd size."""
    dtype = DTYPES[dt]
    img = _rand((1, 45, 61, 1), 10, cuda, dtype, lo=0.0)
    wt = _rand((16, 1, 3, 3), 11, cuda) * 2.0
    got = conv_gray_enter(img, None, wt, None, act)
    assert _rel(got, conv_gray_enter_plain(img, None, wt, None, act),
                dtype) <= TOL[dtype]
    x = _rand((1, 45, 61, 16), 12, cuda, dtype)
    w2 = _rand((1, 16, 5, 5), 13, cuda) * 0.4
    got = conv_gray_exit(x, w2, None, act)
    assert _rel(got, conv_gray_exit_plain(x, w2, None, act),
                dtype) <= TOL[dtype]


def test_conv_gray_enter_wide_cout(cuda):
    """Cout 48 and 64: several passes of the output tile a tile."""
    img = _rand((2, 45, 61, 1), 14, cuda, torch.bfloat16, lo=0.0)
    for cout in (48, 64):
        wt = _rand((cout, 1, 5, 5), 15, cuda)
        got = conv_gray_enter(img, None, wt, None, "relu")
        want = conv_gray_enter_plain(img, None, wt, None, "relu")
        assert _rel(got, want, torch.bfloat16) <= TOL[torch.bfloat16]
