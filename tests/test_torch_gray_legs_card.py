"""The enter and exit instances of IFCNN and PMGI (csrc/conv_gray.cu)
against their plain versions, on the card: the k7 enter (IFCNN's enc0, 1 ->
64, no activation), the two-gray-leg enter (PMGI's entry convs, c_in 2 ->
16, k5, lrelu) and the exit over legs (PMGI's decode, eight 16-channel legs
-> 1, k1, tanh; and legs at batch offsets, k3).

Needs a CUDA device and nvcc; every test skips without a card. Run on the
GPU machine with (the JAX-importing conftest is skipped):

    python -m pytest --noconftest tests/test_torch_gray_legs_card.py

bf16 at the bench's 16 pairs of 1224x1024 and f32 at the test CLI's one
pair, an odd 45x61 and a ragged last tile (8x200). Tolerances as
tests/test_torch_gray_card.py: f32 1e-4 of max(|y|, 1), bf16 1e-3 of
max|y| beyond one bf16 ulp of each output. Controls that must miss by 10x
at the models' shapes, both dtypes: the k7 taps transposed and a zero halo;
the second leg's weight dropped and the two legs' weights swapped; a leg's
batch offset wrong, two legs swapped and the tanh left out.
"""

import pytest
import torch

from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    conv_gray_enter, conv_gray_enter_plain, conv_gray_exit,
    conv_gray_exit_plain)
from test_torch_gray_card import DTYPES, TOL, _launched, _rand, cuda  # noqa
from test_torch_gray_card import _rel as _rel_whole
from test_torch_gray_card import _zero_halo

# (dtype, pairs, h, w): the bench's shape, the test CLI's, an odd size and
# a ragged last tile
CASES = [("bf16", 16, 1224, 1024), ("f32", 1, 1224, 1024),
         ("bf16", 2, 45, 61), ("f32", 2, 45, 61), ("bf16", 2, 8, 200),
         ("f32", 1, 8, 200)]


def _ids(case):
    return "{}-{}x{}x{}".format(*case)


def _rel(got, want, dtype, step=4):
    """tests/test_torch_gray_card.py's relative error, in batch chunks: the
    f32 temporaries of 32 images of 64 channels at 1224x1024 are 10 GB
    each."""
    num = den = 0.0
    for i in range(0, want.shape[0], step):
        w = want[i:i + step]
        scale = max(float(w.float().abs().max()),
                    0.0 if dtype == torch.bfloat16 else 1.0)
        num = max(num, _rel_whole(got[i:i + step], w, dtype) * scale)
        den = max(den, scale)
    return num / den


def _check(got, want, dtype, ctls, full):
    """The kernel's output within TOL; with `full` each control (a
    callable, run one at a time) misses by 10x."""
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want, dtype) <= TOL[dtype]
    if full:
        del got
        for what, ctl in ctls.items():
            assert _rel(ctl(), want, dtype) > 10 * TOL[dtype], what


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_enter_k7(cuda, case):
    dt, n, h, w = case
    dtype = DTYPES[dt]
    img1 = _rand((n, h, w, 1), 21, cuda, dtype, lo=0.0)
    img2 = _rand((n, h, w, 1), 22, cuda, dtype, lo=0.0)
    wt = _rand((64, 1, 7, 7), 23, cuda) * 0.4
    bias = _rand((64,), 24, cuda) * 0.2
    got = _launched("conv_gray_enter",
                    lambda: conv_gray_enter(img1, img2, wt, bias, None))
    want = conv_gray_enter_plain(img1, img2, wt, bias, None)
    wq = wt.to(dtype)
    _check(got, want, dtype, {
        "taps transposed": lambda: conv_gray_enter(
            img1, img2, wq.transpose(2, 3), bias, None),
        "zero halo": lambda: _zero_halo(torch.cat([img1, img2]), wq, bias,
                                        None),
        "images swapped": lambda: conv_gray_enter(img2, img1, wq, bias,
                                                  None)},
        h == 1224)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_enter_two_legs(cuda, case):
    dt, n, h, w = case
    dtype = DTYPES[dt]
    img1 = _rand((n, h, w, 1), 31, cuda, dtype, lo=0.0)
    img2 = _rand((n, h, w, 1), 32, cuda, dtype, lo=0.0)
    wt = _rand((16, 2, 5, 5), 33, cuda) * 0.5
    bias = _rand((16,), 34, cuda) * 0.2
    got = _launched("conv_gray_enter",
                    lambda: conv_gray_enter(img1, img2, wt, bias, "lrelu"))
    assert got.shape == (n, h, w, 16)
    want = conv_gray_enter_plain(img1, img2, wt, bias, "lrelu")
    wq = wt.to(dtype)
    _check(got, want, dtype, {
        "second leg dropped": lambda: conv_gray_enter(
            img1, img2, torch.cat([wq[:, :1], 0 * wq[:, 1:]], 1), bias,
            "lrelu"),
        "legs' weights swapped": lambda: conv_gray_enter(
            img1, img2, wq.flip(1), bias, "lrelu"),
        "taps transposed": lambda: conv_gray_enter(
            img1, img2, wq.transpose(2, 3), bias, "lrelu")},
        h == 1224)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_exit_eight_legs(cuda, case):
    """PMGI's decode: eight 16-channel legs, k1, tanh; leg 3 read at batch
    offset 1 of a tensor with one more image."""
    dt, n, h, w = case
    dtype = DTYPES[dt]
    ts = [_rand((n + (i == 3), h, w, 16), 40 + i, cuda, dtype)
          for i in range(8)]
    legs = [(t, int(i == 3)) for i, t in enumerate(ts)]
    wt = _rand((1, 128, 1, 1), 49, cuda) * 0.3
    bias = _rand((1,), 50, cuda) * 0.2
    got = _launched("conv_gray_exit",
                    lambda: conv_gray_exit(legs, wt, bias, "tanh"))
    want = conv_gray_exit_plain(legs, wt, bias, "tanh")
    assert want.shape == (n, h, w, 1)
    wq = wt.to(dtype)

    _check(got, want, dtype, {
        "tanh left out": lambda: conv_gray_exit(legs, wq, bias, None),
        "two legs swapped": lambda: conv_gray_exit(
            [legs[1], legs[0], *legs[2:]], wq, bias, "tanh"),
        "a leg's offset wrong": lambda: conv_gray_exit(
            [(t, 0) for t in ts], wq, bias, "tanh")}, h == 1224)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_exit_legs_offsets(cuda, dt):
    """Legs of one tensor at batch offsets 0 and n, of 8 and 24 channels
    (a staged k-step over two legs), k3 and k5, no activation."""
    dtype = DTYPES[dt]
    n = 3
    t = _rand((2 * n, 45, 61, 8), 51, cuda, dtype)
    u = _rand((n + 1, 45, 61, 24), 52, cuda, dtype)
    legs = [(t, 0), (u, 1), (t, n)]
    for k in (3, 5):
        wt = _rand((1, 40, k, k), 53 + k, cuda) * (1.0 / k)
        got = _launched("conv_gray_exit",
                        lambda: conv_gray_exit(legs, wt, None, None))
        want = conv_gray_exit_plain(legs, wt, None, None)
        assert want.shape == (n, 45, 61, 1)
        assert _rel(got, want, dtype) <= TOL[dtype]
        wrong = conv_gray_exit([(t, 0), (u, 0), (t, n)], wt.to(dtype), None,
                               None)
        assert _rel(wrong, want, dtype) > 10 * TOL[dtype]


def test_new_instances_raise(cuda):
    """Two gray legs are built at k5 only and need img2; legs of the exit
    take multiples of 8 channels."""
    img = _rand((1, 16, 16, 1), 60, cuda, lo=0.0)
    with pytest.raises(ValueError):
        conv_gray_enter(img, img, torch.zeros((16, 2, 3, 3), device=cuda))
    with pytest.raises(ValueError):
        conv_gray_enter(img, None, torch.zeros((16, 2, 5, 5), device=cuda))
    x = _rand((1, 16, 16, 12), 61, cuda)
    with pytest.raises(ValueError):
        conv_gray_exit([(x, 0), (x, 0)], torch.zeros((1, 24, 1, 1),
                                                     device=cuda))
