"""The plain versions of the port's int8 conv kernels (ops/cuda/conv_int8.py)
against the JAX package's TPU kernels in Pallas interpret mode, on the CPU,
with inputs made from a numpy seed and JAX's own fold and quantized weights
handed to the port (the fold is not bit-portable: tests/test_torch_quant.py):

- row 11, `conv_int8_plain` against `conv_tlane_dma_q(interpret=True)` on
  the reflect-padded input quantized by `quantize_input_scaled`, for k 1, 3,
  5 and 7, each activation, c_in 1 and c_out 1;
- row 12, `conv_int8_chain_plain` against `conv_hiw_chain_q(interpret=True)`
  through tests/test_hiw.py's H-major layout helpers, at
  tests/test_hiw_int8.py's shapes: plain, fuse_n, int8-resident output, and
  int8-resident input with fuse_n.

f32 outputs within 1e-6 of max|y| (the integer dot is exact on both sides
and both round the multiply-add once; the activation's transcendental, if
any, is the other rounding); int8 outputs equal; and the int32 dot of the
plain version equal to an int64 matmul of the unfolded input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.ops.pallas import conv_int8 as jq
from multi_modal_image_fusion_tpu.ops.pallas.hiw_int8 import (
    conv_hiw_chain_q, hiw_fold_scale)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
    conv_int8, conv_int8_chain, conv_int8_chain_plain, conv_int8_plain,
    int_conv_plain, pack_weights_int8, pick_bn)
from tests.test_hiw import _from_hmajor, _ref_conv, _to_hmajor

REL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(w_hwio):
    return _t(np.transpose(np.asarray(w_hwio), (3, 2, 0, 1)))


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), err


@pytest.mark.parametrize("k,cin,cout,act", [
    (1, 24, 16, "relu"), (3, 1, 16, "relu"), (3, 40, 24, "relu6"),
    (5, 16, 1, None), (7, 32, 32, "lrelu"), (3, 16, 8, "tanh")])
def test_row11_plain_matches_conv_tlane_dma_q(k, cin, cout, act):
    r = np.random.RandomState(k + cin)
    x = ((r.rand(2, 21, 37, cin) - 0.3) * 2).astype(np.float32)
    w = (r.rand(k, k, cin, cout) - 0.5).astype(np.float32)
    b = (r.rand(cout) - 0.5).astype(np.float32)
    f = jq.choose_fold(jnp.max(jnp.abs(x), axis=(0, 1, 2)), jnp.asarray(w))
    qw, sw = jq.quantize_weights(jq.fold_weights(jnp.asarray(w), f))
    p = k // 2
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (p, p), (p, p), (0, 0)), "reflect")
    want = jq.conv_tlane_dma_q(jq.quantize_input_scaled(xp, f), qw, sw, k,
                               bias=jnp.asarray(b), act=act,
                               out_dtype=jnp.float32, interpret=True)
    args = (_t(x), _oihw(qw), _t(sw), _t(f), _t(b), act)
    got = conv_int8_plain(*args)
    _close(got.numpy(), want)
    # a CPU tensor takes the plain version through the wrapper
    np.testing.assert_array_equal(conv_int8(*args).numpy(), got.numpy())


@pytest.mark.parametrize("k,c_in,c_out,g,h,w", [
    (7, 16, 32, 4, 40, 96),     # enc1 class
    (7, 32, 32, 2, 41, 61),     # dec0 class, odd size
    (5, 32, 16, 4, 33, 61),     # dec1 class
])
def test_row12_plain_matches_conv_hiw_chain_q(k, c_in, c_out, g, h, w):
    r = np.random.RandomState(0)
    x = (r.rand(2, h, w, c_in) - 0.5).astype(np.float32)
    wgt = (r.rand(k, k, c_in, c_out) - 0.5).astype(np.float32)
    bias = (r.rand(c_out) - 0.5).astype(np.float32)
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=(0, 1, 2))
    want = _from_hmajor(conv_hiw_chain_q(
        _to_hmajor(jnp.asarray(x)), jnp.asarray(wgt), k, h=h, w_valid=w,
        c_in=c_in, amax=amax, bias=jnp.asarray(bias), act="relu", g=g,
        interpret=True), h, w, c_out)
    f = jq.choose_fold(amax, jnp.asarray(wgt), "smooth")
    qw, sw = jq.quantize_weights(jq.fold_weights(jnp.asarray(wgt), f))
    got = conv_int8_chain(_t(x), _oihw(qw), _t(sw), _t(bias), "relu",
                          1.0 / _t(f))
    _close(got.numpy(), want)


def test_row12_fuse_n_float():
    """fuse_n on a float chain tensor: the halves summed in its dtype,
    then quantized by the reciprocal."""
    r = np.random.RandomState(1)
    h, w = 32, 64
    x = (r.rand(4, h, w, 32) - 0.5).astype(np.float32)
    wgt = (r.rand(7, 7, 32, 32) - 0.5).astype(np.float32)
    amax = jnp.max(jnp.abs(jnp.asarray(x[:2] + x[2:])), axis=(0, 1, 2))
    want = _from_hmajor(conv_hiw_chain_q(
        _to_hmajor(jnp.asarray(x)), jnp.asarray(wgt), 7, h=h, w_valid=w,
        c_in=32, amax=amax, act="relu", g=2, fuse_n=2, interpret=True),
        h, w, 32)
    f = jq.choose_fold(amax, jnp.asarray(wgt), "smooth")
    qw, sw = jq.quantize_weights(jq.fold_weights(jnp.asarray(wgt), f))
    got = conv_int8_chain_plain(_t(x), _oihw(qw), _t(sw), None, "relu",
                                1.0 / _t(f), fuse_n=2)
    _close(got.numpy(), want)


def test_row12_resident_out_and_in():
    """enc1 -> dec0 class hop (tests/test_hiw_int8.py:test_hiw_q_resident_
    hop): the producer's int8-resident output equal to JAX's, and the
    consumer on it (fuse_n as a saturating integer sum) within 1e-6."""
    r = np.random.RandomState(2)
    h, w, n = 40, 96, 2
    x = (r.rand(2 * n, h, w, 16) - 0.5).astype(np.float32)
    w1 = (r.rand(7, 7, 16, 32) - 0.5).astype(np.float32)
    b1 = (r.rand(32) - 0.5).astype(np.float32)
    w2 = (r.rand(7, 7, 32, 32) - 0.5).astype(np.float32)
    b2 = (r.rand(32) - 0.5).astype(np.float32)
    y1 = _ref_conv(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), "relu")
    amax1 = jnp.max(jnp.abs(jnp.asarray(x)), axis=(0, 1, 2))
    amax2 = jnp.max(jnp.abs(y1[:n] + y1[n:]), axis=(0, 1, 2))
    f2 = hiw_fold_scale(amax2, jnp.asarray(w2))
    q1 = conv_hiw_chain_q(_to_hmajor(jnp.asarray(x)), jnp.asarray(w1), 7,
                          h=h, w_valid=w, c_in=16, amax=amax1,
                          bias=jnp.asarray(b1), act="relu", g=4,
                          out_scale=f2, interpret=True)
    want_q1 = np.asarray(_from_hmajor(q1, h, w, 32))
    f1 = jq.choose_fold(amax1, jnp.asarray(w1), "smooth")
    qw1, sw1 = jq.quantize_weights(jq.fold_weights(jnp.asarray(w1), f1))
    got_q1 = conv_int8_chain_plain(_t(x), _oihw(qw1), _t(sw1) / _t(f2),
                                   _t(b1) / _t(f2), "relu", 1.0 / _t(f1),
                                   out_int8=True)
    assert got_q1.dtype == torch.int8
    np.testing.assert_array_equal(got_q1.numpy(), want_q1)

    y = conv_hiw_chain_q(q1, jnp.asarray(w2), 7, h=h, w_valid=w, c_in=32,
                         amax=amax2, bias=jnp.asarray(b2), act="relu", g=2,
                         fuse_n=n, out_dtype=jnp.float32, interpret=True)
    qw2, sw2 = jq.quantize_weights(jq.fold_weights(jnp.asarray(w2), f2))
    got = conv_int8_chain(got_q1, _oihw(qw2), _t(sw2), _t(b2), "relu",
                          fuse_n=n, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got.numpy(), _from_hmajor(y, h, w, 32))


@pytest.mark.parametrize("cin,cout,k", [(1, 16, 3), (16, 32, 7), (40, 1, 5)])
def test_int_conv_plain_is_exact(cin, cout, k):
    """The float64 conv of integer values equals an int64 matmul of the
    unfolded reflect-padded input, at the largest magnitudes."""
    g = torch.Generator().manual_seed(cin + k)
    q = torch.randint(-127, 128, (2, 9, 11, cin), generator=g)
    q[0, 0, 0] = -127
    qw = torch.randint(-127, 128, (cout, cin, k, k), generator=g).to(
        torch.int8)
    qw[0] = -127
    p = k // 2
    xp = F.pad(q.permute(0, 3, 1, 2).double(), (p, p, p, p), mode="reflect")
    cols = F.unfold(xp, k).round().long()               # (B, cin*k*k, L)
    want = torch.einsum("ol,blp->bop", qw.reshape(cout, -1).long(), cols)
    got = int_conv_plain(q.to(torch.int8), qw)
    assert torch.equal(got.permute(0, 3, 1, 2).reshape(2, cout, -1),
                       want.float())


def test_pack_weights_int8_layout():
    qw = torch.arange(3 * 40 * 3 * 3).reshape(3, 40, 3, 3).remainder(
        251).sub(125).to(torch.int8)
    bn = pick_bn(3)
    wk = pack_weights_int8(qw, bn)
    assert bn == 16 and wk.shape == (9, 16, 64) and wk.dtype == torch.int8
    assert torch.equal(wk[4, :3, :40], qw[:, :, 1, 1])
    assert not wk[:, 3:].any() and not wk[:, :, 40:].any()
    assert pick_bn(640) == 64 and pick_bn(32) == 32 and pick_bn(1) == 16
