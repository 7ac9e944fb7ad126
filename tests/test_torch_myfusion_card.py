"""MyFusion's kernel instances and its forward on the card, against their
plain versions.

Needs a CUDA device and nvcc; every test skips without a card. Run on the
GPU machine with (the JAX-importing conftest is skipped):

    python -m pytest --noconftest tests/test_torch_myfusion_card.py

- conv_gray_enter's 8-channel k1 pass (MyFusion's conv_in, 1 -> 8, relu6;
  also 24 channels, three passes) in bf16 and f32 at the bench's 16 pairs
  of 1224x1024, an odd 45x61 and two ragged last tiles; at the bench's
  shape, controls that must miss by 10x: the bias dropped, the output
  channels reversed, the two images swapped;
- conv_gray_exit's k1 16 -> 1 relu6 (conv_out), control: the input
  channels reversed, the relu6 left out;
- conv_dw at MyFusion's widths: 8 (k1, relu6: level 1's down), 24, 40 and
  120 (k3, relu6: the DCBlocks' hidden widths), 64 and 512 (k3, none: the
  SepConvBlocks'), controls: a zero halo (k3), the channels reversed (k1);
- conv_wide's k1 over two legs 16 + 32 -> 24 (DB1_1's pw1), control: the
  two legs' weights swapped in their place;
- the default MyFusion forward and res2_plain_rfn's (f32, 2 pairs at
  64x80 and at an odd 45x57) through the kernels against the plain path
  (F.conv2d for every conv, TF32 off), every kernel of the route launched.

Tolerances as tests/test_torch_gray_card.py: relative to the plain
output's largest magnitude, f32 1e-4 of max(|y|, 1), bf16 1e-3 beyond one
bf16 ulp of each output.
"""

import collections

import pytest
import torch

from test_torch_gray_card import DTYPES, SHAPES, TOL, _launched, _rand, \
    _rel

from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    conv_gray_enter, conv_gray_enter_plain, conv_gray_exit,
    conv_gray_exit_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import (
    conv_dw, conv_dw_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import (
    conv_wide, conv_wide_plain)
from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training

RES2_PLAIN_RFN = dict(encoder="res2", decoder="plain", fusion_method="rfn",
                      down_mode="maxpool", share_weight_levels=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cout", [8, 24])
def test_conv_gray_enter_cout8(cuda, cout, dt, shape):
    n, h, w = shape
    dtype = DTYPES[dt]
    img1 = _rand((n, h, w, 1), 1, cuda, dtype, lo=0.0)
    img2 = _rand((n, h, w, 1), 2, cuda, dtype, lo=0.0)
    wt = _rand((cout, 1, 1, 1), 3, cuda) * 16.0
    wt[cout // 2] = 8.0                    # a channel that reaches the clip
    bias = _rand((cout,), 4, cuda)
    got = _launched("conv_gray_enter",
                    lambda: conv_gray_enter(img1, img2, wt, bias, "relu6"))
    assert got.dtype == dtype and got.shape == (2 * n, h, w, cout)
    want = conv_gray_enter_plain(img1, img2, wt, bias, "relu6")
    assert _rel(got, want, dtype) <= TOL[dtype]
    assert float(want.float().amax()) == 6.0      # the clip is reached
    if n != 16:
        return
    wq = wt.to(dtype)
    ctls = {"images swapped": conv_gray_enter(img2, img1, wq, bias, "relu6"),
            "bias dropped": conv_gray_enter(img1, img2, wq, None, "relu6"),
            "channels reversed": conv_gray_enter(img1, img2, wq.flip(0),
                                                 bias, "relu6")}
    for what, y in ctls.items():
        assert _rel(y, want, dtype) > 10 * TOL[dtype], what


def test_conv_gray_enter_cout8_refused(cuda):
    """The 8-channel pass is the k1 one-leg entry's only."""
    img = _rand((1, 45, 61, 1), 5, cuda, lo=0.0)
    with pytest.raises(ValueError, match="Cout"):
        conv_gray_enter(img, None, _rand((8, 1, 3, 3), 6, cuda), None,
                        "relu6")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv_gray_exit_k1_relu6(cuda, dt, shape):
    n, h, w = shape
    dtype = DTYPES[dt]
    x = _rand((n, h, w, 16), 7, cuda, dtype, lo=0.0) * 6.0
    wt = _rand((1, 16, 1, 1), 8, cuda) * 1.5
    got = _launched("conv_gray_exit",
                    lambda: conv_gray_exit(x, wt, None, "relu6"))
    want = conv_gray_exit_plain(x, wt, None, "relu6")
    assert _rel(got, want, dtype) <= TOL[dtype]
    if n != 16:
        return
    wq = wt.to(dtype)
    ctls = {"channels reversed": conv_gray_exit(x, wq.flip(1), None,
                                                "relu6"),
            "relu6 left out": conv_gray_exit(x, wq, None, None)}
    for what, y in ctls.items():
        assert _rel(y, want, dtype) > 10 * TOL[dtype], what


# (channels, k, act): level 1's down, the DCBlocks' hidden widths (nest and
# fs decoders), the SepConvBlocks' expansions
DW_CASES = [(8, 1, "relu6"), (24, 3, "relu6"), (40, 3, "relu6"),
            (120, 3, "relu6"), (64, 3, None), (512, 3, None)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("c,k,act", DW_CASES,
                         ids=[f"c{c}k{k}" for c, k, _ in DW_CASES])
@pytest.mark.parametrize("full", [True, False], ids=["306x256", "45x61"])
def test_conv_dw_widths(cuda, c, k, act, dt, full):
    dtype = DTYPES[dt]
    b, h, w = (4, 306, 256) if full else (2, 45, 61)
    x = _rand((b, h, w, c), 9, cuda, dtype)
    wt = _rand((c, 1, k, k), 10, cuda) * (4.0 / k)
    bias = _rand((c,), 11, cuda)
    got = _launched("conv_dw", lambda: conv_dw(x, wt.to(dtype), bias, act))
    want = conv_dw_plain(x, wt.to(dtype), bias, act)
    assert _rel(got, want, dtype) <= TOL[dtype]
    if not full:
        return
    wq = wt.to(dtype)
    if k > 1:
        ctl = _zero_halo_dw(x, wq, bias, act)
    else:
        ctl = conv_dw(x, wq.flip(0), bias, act)
    assert _rel(ctl, want, dtype) > 10 * TOL[dtype]


def _zero_halo_dw(x, wt, bias, act):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        apply_act
    y = torch.nn.functional.conv2d(
        x.float().permute(0, 3, 1, 2), wt.float(), bias, padding=1,
        groups=wt.shape[0])
    return apply_act(y, act).permute(0, 2, 3, 1).to(x.dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv_wide_k1_two_legs(cuda, dt):
    """DB1_1's pw1: legs 16 + 32 -> 24, relu6, read in place."""
    dtype = DTYPES[dt]
    a = _rand((4, 306, 256, 16), 12, cuda, dtype, lo=0.0)
    b = _rand((4, 306, 256, 32), 13, cuda, dtype, lo=0.0)
    wt = _rand((24, 48, 1, 1), 14, cuda) * 0.5
    legs = [(a, 0), (b, 0)]
    got = _launched("conv_wide", lambda: conv_wide(legs, wt.to(dtype), None,
                                                   "relu6"))
    want = conv_wide_plain(legs, wt.to(dtype), None, "relu6")
    assert _rel(got, want, dtype) <= TOL[dtype]
    wq = wt.to(dtype)
    swapped = torch.cat([wq[:, 16:32], wq[:, :16], wq[:, 32:]], 1)
    assert _rel(conv_wide(legs, swapped, None, "relu6"), want,
                dtype) > 10 * TOL[dtype]


@pytest.mark.parametrize("hw", [(64, 80), (45, 57)], ids=["64x80", "45x57"])
@pytest.mark.parametrize("cfg", [{}, RES2_PLAIN_RFN],
                         ids=["default", "res2_plain_rfn"])
def test_myfusion_forward(cuda, cfg, hw):
    """The f32 forward through the kernels against F.conv2d for every conv
    (fast_training(False)); every kernel of the route launched."""
    model = create_model("myfusion", generator=torch.Generator().manual_seed(
        0), **cfg).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    x1, x2 = (torch.rand((2, *hw, 1), generator=g, device=cuda)
              for _ in range(2))
    build.LAUNCHES.clear()
    with torch.no_grad():
        got = model(x1, x2)
        counts = collections.Counter(build.LAUNCHES)
        with fast_training(False):
            want = model(x1, x2)
    kernels = {"conv_gray_enter", "conv_chain", "conv_multi", "conv_dw",
               "conv_gray_exit"} | ({"conv_wide"} if not cfg else set())
    assert set(counts) == kernels and all(counts.values())
    assert float(want.std()) > 0
    assert _rel(got, want, torch.float32) <= TOL[torch.float32]
