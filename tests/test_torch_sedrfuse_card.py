"""SEDRFuse's kernel shapes against their plain versions, on the card: the
three serving launches (enc0 on conv_gray_enter, 1 -> 64, k3, no
activation: its group norm follows; the ResBlock's conv on conv_chain,
256 -> 256, k3, no activation, at 306x256; dec2 on conv_gray_exit, 64 ->
1, k3, relu) and the three conv_valid shapes of its --fast_train step at
16 pairs of 64x64 patches (enc0 1 -> 64 over 32 images; the ResBlock's
convs 256 -> 256 over 32 images at 16x16; dec2 64 -> 1 over 16 images),
forward, dx (where the step takes one) and dw.

Needs a CUDA device and nvcc; every test skips without a card. Run on the
GPU machine with (the JAX-importing conftest is skipped):

    python -m pytest --noconftest tests/test_torch_sedrfuse_card.py

Serving: bf16 at the bench's 16 pairs of 1224x1024 (the encoder over 32
images), f32 at the test CLI's one pair. Tolerances as
tests/test_torch_gray_card.py: f32 1e-4 of max(|y|, 1), bf16 1e-3 of
max|y| beyond one bf16 ulp of each output, the error taken in batch chunks
(the f32 temporaries of 32 images of 64 channels at 1224x1024 are 10 GB
each). Controls that must miss by 10x in both dtypes: the taps
transposed, a zero halo, the enter's images swapped, the exit's relu left
out. Training: f32 and bf16 at 1e-4 and 1e-3 of the plain output's largest
magnitude (bf16 forward and dx outputs beyond one ulp; dw, f32 out of bf16
inputs, against the float64 plain version); controls: the taps transposed
(forward), not flipped (dx), kh and kw swapped (dw).
"""

import pytest
import torch

from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    conv_chain, conv_chain_plain, conv_gray_enter, conv_gray_enter_plain,
    conv_gray_exit, conv_gray_exit_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_valid import (
    conv_valid, conv_valid_dw, conv_valid_dw_plain, conv_valid_dx,
    conv_valid_dx_plain, conv_valid_plain)
from test_torch_gray_card import DTYPES, TOL, _launched, _rand, cuda  # noqa
from test_torch_gray_card import _zero_halo
from test_torch_gray_legs_card import _check

# (dtype, pairs): the bench's 16 pairs, the test CLI's one
SERVE = [("bf16", 16), ("f32", 1)]
H, W = 1224, 1024


@pytest.mark.parametrize("dt,n", SERVE)
def test_enc0_enter(cuda, dt, n):
    dtype = DTYPES[dt]
    img1 = _rand((n, H, W, 1), 61, cuda, dtype, lo=0.0)
    img2 = _rand((n, H, W, 1), 62, cuda, dtype, lo=0.0)
    wt = _rand((64, 1, 3, 3), 63, cuda) * 0.6
    bias = _rand((64,), 64, cuda) * 0.2
    got = _launched("conv_gray_enter",
                    lambda: conv_gray_enter(img1, img2, wt, bias, None))
    assert got.shape == (2 * n, H, W, 64)
    want = conv_gray_enter_plain(img1, img2, wt, bias, None)
    wq = wt.to(dtype)
    _check(got, want, dtype, {
        "taps transposed": lambda: conv_gray_enter(
            img1, img2, wq.transpose(2, 3), bias, None),
        "zero halo": lambda: _zero_halo(torch.cat([img1, img2]), wq, bias,
                                        None),
        "images swapped": lambda: conv_gray_enter(img2, img1, wq, bias,
                                                  None)}, True)


@pytest.mark.parametrize("dt,n", SERVE)
def test_res_conv_chain(cuda, dt, n):
    """The ResBlock's conv at 306x256 over both images of each pair."""
    dtype = DTYPES[dt]
    x = _rand((2 * n, 306, 256, 256), 65, cuda, dtype, lo=0.0)
    wt = _rand((256, 256, 3, 3), 66, cuda) * (2.0 / 48.0)
    bias = _rand((256,), 67, cuda) * 0.2
    got = _launched("conv_chain", lambda: conv_chain(x, wt, bias, None))
    want = conv_chain_plain(x, wt, bias, None)
    wq = wt.to(dtype)
    _check(got, want, dtype, {
        "taps transposed": lambda: conv_chain(x, wq.transpose(2, 3), bias,
                                              None),
        "zero halo": lambda: _zero_halo(x, wq, bias, None)}, True)


@pytest.mark.parametrize("dt,n", SERVE)
def test_dec2_exit(cuda, dt, n):
    dtype = DTYPES[dt]
    x = _rand((n, H, W, 64), 68, cuda, dtype)
    wt = _rand((1, 64, 3, 3), 69, cuda) * 0.25
    bias = _rand((1,), 70, cuda) * 0.2 + 0.3
    got = _launched("conv_gray_exit",
                    lambda: conv_gray_exit(x, wt, bias, "relu"))
    assert got.shape == (n, H, W, 1)
    want = conv_gray_exit_plain(x, wt, bias, "relu")
    wq = wt.to(dtype)
    _check(got, want, dtype, {
        "taps transposed": lambda: conv_gray_exit(x, wq.transpose(2, 3),
                                                  bias, "relu"),
        "zero halo": lambda: _zero_halo(x, wq, bias, "relu"),
        "relu left out": lambda: conv_gray_exit(x, wq, bias, None)}, True)


# the --fast_train step's conv_valid launches: (layer, images, c_in, c_out,
# h, w), k3; enc0 takes no dx (the images carry no gradient)
VALID = [("enc0", 32, 1, 64, 64, 64), ("res", 32, 256, 256, 16, 16),
         ("dec2", 16, 64, 1, 64, 64)]
VALID_CASES = [(layer, kind) for layer in VALID for kind in ("fwd", "dx",
                                                              "dw")
               if not (layer[0] == "enc0" and kind == "dx")]


def _rel_max(got, want):
    d = (got.float() - want.float()).abs().max()
    return float(d) / float(want.float().abs().max())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", VALID_CASES,
                         ids=lambda c: f"{c[0][0]}-{c[1]}")
def test_conv_valid_train_shapes(cuda, dt, case):
    (name, b, cin, cout, h, w), kind = case
    dtype = DTYPES[dt]
    wt = (_rand((cout, cin, 3, 3), 71, cuda)
          * (2.0 / (3 * cin ** 0.5))).to(dtype)
    if kind == "fwd":
        x = _rand((b, h + 2, w + 2, cin), 72, cuda, dtype, lo=0.0)
        got = _launched("conv_valid/valid", lambda: conv_valid(x, wt))
        want = conv_valid_plain(x, wt)
        control = conv_valid(x, wt.transpose(2, 3))
    elif kind == "dx":
        dy = _rand((b, h, w, cout), 73, cuda, dtype)
        got = _launched("conv_valid/dx", lambda: conv_valid_dx(dy, wt))
        want = conv_valid_dx_plain(dy, wt)
        control = conv_valid_dx_plain(dy, wt.flip(2, 3))
    else:
        x = _rand((b, h + 2, w + 2, cin), 74, cuda, dtype)
        dy = _rand((b, h, w, cout), 75, cuda, dtype)
        before = build.LAUNCHES["conv_valid_dw"]
        got = conv_valid_dw(x, dy)
        torch.cuda.synchronize()
        assert build.LAUNCHES["conv_valid_dw"] == before + 1
        want = conv_valid_dw_plain(x.double(), dy.double()).float()
        assert _rel_max(got, want) <= TOL[dtype]
        assert _rel_max(got, want.transpose(2, 3)) > 10 * TOL[dtype]
        return
    _check(got, want, dtype, {"control": lambda: control}, True)
