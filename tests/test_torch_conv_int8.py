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

The s8 wgmma body's arithmetic outside the kernel, which a CUDA kernel
cannot show on the CPU: the packed weight layout read back at every built
instance (kernel size, N block, tap pairs); the block pick and the
shared-memory plan at every int8 layer of DeepFuse, DenseFuse and UNFusion;
a numpy mirror of the kernel's staged tile, descriptors and packed weights
(the tap-pair half one pixel on included) whose sum over k-steps equals
`int_conv_plain` exactly; and conv_int8 over legs with fuse_n equal, bit
for bit, to the concat route's plain version.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.ops.pallas import conv_int8 as jq
from multi_modal_image_fusion_tpu.ops.pallas.hiw_int8 import (
    conv_hiw_chain_q, hiw_fold_scale)
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import layers, quant
from multi_modal_image_fusion_tpu_torch.ops.cuda import conv_int8 as ci8
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import _tc_mt
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
    INT8_INSTANCES, Int8Weights, conv_int8, conv_int8_chain, conv_int8_chain_plain,
    conv_int8_plain, int8_ksteps, int8_plan, int8_weight_index,
    int_conv_plain, pack_weights_int8, pick_bn_int8, tap_pairs)
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


_INSTANCES = [(k, bn, tp) for k, (bns, tp_bns) in INT8_INSTANCES.items()
              for tp, blocks in ((False, bns), (True, tp_bns))
              for bn in blocks]


@pytest.mark.parametrize("k,bn,tp", _INSTANCES)
def test_pack_weights_int8_layout(k, bn, tp):
    """Every weight read back where `int8_weight_index` (the kernel's
    [cout_pad / bn][KS][taps][half][bn][16] layout) puts it, and nothing
    else in the packed weights, at every built instance: c_in 13 with tap
    pairs, else 40 (a second k-step three quarters empty), c_out 3 short of
    the block's multiple."""
    cin = 13 if tp else 40
    assert tap_pairs(k, cin) == tp
    cout = 2 * bn - 3
    qw = torch.arange(cout * cin * k * k).reshape(cout, cin, k, k).remainder(
        251).sub(125).to(torch.int8)
    wk = pack_weights_int8(qw, bn)
    taps = k * ((k + 1) // 2) if tp else k * k
    assert wk.dtype == torch.int8
    assert wk.numel() == 2 * int8_ksteps(k, cin) * taps * 2 * bn * 16
    co, ci, kh, kw = np.meshgrid(np.arange(cout), np.arange(cin),
                                 np.arange(k), np.arange(k), indexing="ij")
    idx = int8_weight_index(k, bn, cin, co, ci, kh, kw)
    flat = wk.numpy()
    np.testing.assert_array_equal(flat[idx], qw.numpy())
    rest = np.ones(flat.size, bool)
    rest[idx.ravel()] = False
    assert not flat[rest].any()


def _model_int8_layers(name):
    """Every conv_int8 / conv_int8_chain launch of one int8 forward of a
    ported model on CPU tensors: (kernel, leg channels, c_out, k, fuse_n,
    input dtype, output dtype), with DeepFuse's layers in both routes
    (bf16, legs read in place)."""
    seen = []
    orig = layers.conv_int8, layers.conv_int8_chain

    def rec_int8(x, qw, sw, f, bias=None, act=None, fuse_n=0, weights=None):
        xs = [t for t, _ in x] if isinstance(x, list) else [x]
        seen.append(("conv_int8", [t.shape[-1] for t in xs], qw.shape[0],
                     qw.shape[-1], fuse_n, xs[0].dtype, xs[0].dtype))
        return orig[0](x, qw, sw, f, bias, act, fuse_n, weights)

    def rec_chain(x, qw, dq, bias=None, act=None, invf=None, fuse_n=0,
                  out_int8=False, out_dtype=None, weights=None):
        seen.append(("conv_int8_chain", [x.shape[-1]], qw.shape[0],
                     qw.shape[-1], fuse_n, x.dtype,
                     torch.int8 if out_int8 else out_dtype))
        return orig[1](x, qw, dq, bias, act, invf, fuse_n, out_int8,
                       out_dtype, weights)
    model = create_model(name, generator=torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16).eval()
    g = torch.Generator().manual_seed(1)
    a, b = (torch.rand((1, 24, 24, 1), generator=g) for _ in range(2))
    amax = quant.calibrate(model, [(a, b)])
    layers.conv_int8, layers.conv_int8_chain = rec_int8, rec_chain
    try:
        with torch.no_grad(), quant.quantized_inference(amax):
            model(a, b)
            if name == "deepfuse":
                os.environ["MMIF_HIW_INT8"] = "0"
                try:
                    model(a, b)
                finally:
                    del os.environ["MMIF_HIW_INT8"]
    finally:
        layers.conv_int8, layers.conv_int8_chain = orig
    return seen


# the layers whose weights stream through the ring at every block: UNFusion's
# EB4_3 conv2 (376 -> 1024), DB3_1 conv1 (1280 -> 640) and conv2 (640 -> 256)
_STREAMED = {("conv_int8", (376,), 1024), ("conv_int8", (256, 1024), 640),
             ("conv_int8", (640,), 256)}


@pytest.mark.parametrize("name,n_layers", [("deepfuse", 8), ("densefuse", 8),
                                           ("unfusion", 29)])
def test_int8_plan_at_every_model_layer(name, n_layers):
    """At every int8 layer of the model the body (on the layer's int8
    input: the quantized concat of its legs, or an int8-resident tensor)
    has a block the kernel size was built with and a plan: the weights
    resident but for UNFusion's three widest layers, tap pairs exactly
    where the input has at most 16 channels (k > 1), a fuse_n pair summed
    in shared memory exactly on an int8-resident input (DeepFuse's
    dec0)."""
    seen = _model_int8_layers(name)
    assert len(seen) == n_layers
    for kern, cins, cout, k, fuse_n, din, dout in seen:
        cin = sum(cins)
        pair_ok = din == torch.int8 and fuse_n > 0
        bn = pick_bn_int8(cout, cin, k, pair_ok, dout)
        assert bn in INT8_INSTANCES[k][tap_pairs(k, cin)]
        resident, ring, smem, pair = int8_plan(k, bn, cin, pair_ok, dout)
        assert smem <= 232448 and ring >= 2
        assert resident == ((kern, tuple(cins), cout) not in _STREAMED)
        assert tap_pairs(k, cin) == (k > 1 and cin <= 16)
        assert pair == pair_ok


def test_int8_pair_plan_in_shared_memory_or_registers():
    """An int8 fuse_n pair takes a plan whose ring slots hold both halves
    (summed in shared memory) where one fits, else one with single slots
    (summed in registers as the tile is staged): DeepFuse's dec0 (k7, 32
    -> 32) writing int8 or bf16 takes the first, writing f32 the second
    (its output tile is twice as large), as does k7 at 64 channels; with
    no pair the plan never doubles its slots."""
    for out in (torch.int8, torch.bfloat16):
        assert int8_plan(7, 32, 32, True, out)[3] == 1
    assert int8_plan(7, 32, 32, True, torch.float32)[3] == 0
    for bn in INT8_INSTANCES[7][False]:
        assert int8_plan(7, bn, 64, True)[3] == 0
        assert int8_plan(7, bn, 32, False)[3] == 0
    bn = pick_bn_int8(32, 32, 7, True, torch.float32)
    assert int8_plan(7, bn, 32, True, torch.float32)[3] == 0


def test_int8_register_pair_at_deepfuse_dec0_f32(monkeypatch):
    """The register route of the int8 pair is reached by a model: DeepFuse
    in f32 under int8 with dec1 left in float (MMIF_INT8_SKIP=dec1) runs
    dec0 on enc1's int8-resident output, fuse_n, writing f32, which no
    pair plan fits."""
    monkeypatch.setenv("MMIF_INT8_SKIP", "dec1")
    seen = []
    orig = layers.conv_int8_chain

    def rec_chain(x, qw, dq, bias=None, act=None, invf=None, fuse_n=0,
                  out_int8=False, out_dtype=None, weights=None):
        seen.append((x.dtype, fuse_n, torch.int8 if out_int8 else out_dtype,
                     x.shape[-1], qw.shape[0], qw.shape[-1]))
        return orig(x, qw, dq, bias, act, invf, fuse_n, out_int8, out_dtype,
                    weights)
    model = create_model("deepfuse", generator=torch.Generator().manual_seed(
        0)).eval()
    g = torch.Generator().manual_seed(1)
    a, b = (torch.rand((1, 24, 24, 1), generator=g) for _ in range(2))
    amax = quant.calibrate(model, [(a, b)])
    monkeypatch.setattr(layers, "conv_int8_chain", rec_chain)
    with torch.no_grad(), quant.quantized_inference(amax):
        y = model(a, b)
    assert torch.isfinite(y).all()
    dec0 = [c for c in seen if c[1] > 0]
    assert dec0 == [(torch.int8, 1, torch.float32, 32, 32, 7)]
    bn = pick_bn_int8(32, 32, 7, True, torch.float32)
    assert int8_plan(7, bn, 32, True, torch.float32)[3] == 0


@pytest.mark.parametrize("which", range(4))
def test_int8_weights_must_hold_the_call_tensors(which):
    """A wrapper given an Int8Weights launches from its packing, so one made
    from other tensors than the call's (qw, scale, bias or fold) raises,
    on either wrapper; the one made from the call's tensors runs."""
    g = torch.Generator().manual_seed(which)
    x = torch.rand((1, 9, 11, 16), generator=g)
    qw = torch.randint(-127, 128, (16, 16, 5, 5), generator=g,
                       dtype=torch.int8)
    sw, bias, f = (torch.rand((16,), generator=g) + 0.5 for _ in range(3))
    args = [qw, sw, bias, f]
    wts = Int8Weights(*args)
    other = list(args)
    other[which] = args[which].clone()
    assert wts.holds(*args) and not wts.holds(*other)
    with pytest.raises(ValueError, match="other tensors"):
        conv_int8(x, other[0], other[1], other[3], other[2], "relu",
                  weights=wts)
    with pytest.raises(ValueError, match="other tensors"):
        conv_int8_chain(x, other[0], other[1], other[2], "relu", other[3],
                        weights=wts)
    torch.testing.assert_close(
        conv_int8(x, qw, sw, f, bias, "relu", weights=wts),
        conv_int8_plain(x, qw, sw, f, bias, "relu"), rtol=0, atol=0)
    torch.testing.assert_close(
        conv_int8_chain(x, qw, sw, bias, "relu", f, weights=wts),
        conv_int8_chain_plain(x, qw, sw, bias, "relu", f), rtol=0, atol=0)


def _reflect(i, n):
    """csrc/common.cuh reflect_index."""
    i = np.abs(i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _mirror_conv(q, qw, bn, seed=0):
    """A numpy mirror of csrc/conv_int8.cuh's body for one int8 image q
    (H, W, c_in) and int8 OIHW qw: for every tile, N slice and k-step, the
    staged tile ([half][row][pixel][16 ch], the reflect halo in the source
    index, zeros past the last channel, the rest of the slot random, as
    shared memory holds leftovers), each wgmma's A and B read through the
    no-swizzle descriptor arithmetic (leading byte offset HALF, or 16 for a
    tap pair's half one pixel on; stride byte offset 128) from the slot and
    the packed weights, their integer products summed. Returns (H, W,
    c_out) int64."""
    r = np.random.RandomState(seed)
    h, w, cin = q.shape
    cout, _, k, _ = qw.shape
    tp = tap_pairs(k, cin)
    mt = _tc_mt(bn)
    th = 2 * mt
    in_h, in_w = th + k - 1, 64 + k - 1
    half_b = -(-in_h * in_w * 16 // 128) * 128 + 64
    kw_n = (k + 1) // 2 if tp else k
    w_bytes = k * kw_n * bn * 32
    n_ks = int8_ksteps(k, cin)
    wk = pack_weights_int8(torch.from_numpy(qw), bn).numpy()
    rows = np.arange(64)[:, None]
    kk = np.arange(32)[None, :]
    nn = np.arange(bn)[:, None]
    out = np.zeros((-(-h // th) * th, -(-w // 64) * 64, -(-cout // bn) * bn),
                   np.int64)
    for nb in range(-(-cout // bn)):
        for ty in range(-(-h // th)):
            for tx in range(-(-w // 64)):
                y0, x0 = ty * th - k // 2, tx * 64 - k // 2
                ys = _reflect(y0 + np.arange(in_h), h)
                xs = _reflect(x0 + np.arange(in_w), w)
                acc = np.zeros((th, 64, bn), np.int64)
                for ks in range(n_ks):
                    slot = r.randint(-128, 128, 2 * half_b).astype(np.int64)
                    for half in range(1 if tp else 2):
                        ch = ks * 32 + 16 * half
                        vals = np.zeros((in_h, in_w, 16), np.int64)
                        c1 = min(ch + 16, cin)
                        if ch < c1:
                            vals[..., :c1 - ch] = q[ys][:, xs, ch:c1]
                        slot[half * half_b:half * half_b
                             + in_h * in_w * 16] = vals.ravel()
                    wbase = (nb * n_ks + ks) * w_bytes
                    lbo = 16 if tp else half_b
                    for wg in range(2):
                        for m in range(mt):
                            for kh in range(k):
                                for j in range(kw_n):
                                    kw = 2 * j if tp else j
                                    da = (wg * mt * in_w * 16
                                          + ((m + kh) * in_w + kw) * 16)
                                    ia = (da + rows // 8 * 128
                                          + kk // 16 * lbo
                                          + rows % 8 * 16 + kk % 16)
                                    assert ia.max() < 2 * half_b
                                    db = wbase + (kh * kw_n + j) * bn * 32
                                    ib = (db + nn // 8 * 128
                                          + kk // 16 * bn * 16
                                          + nn % 8 * 16 + kk % 16)
                                    acc[wg * mt + m] += slot[ia] @ wk[
                                        ib].astype(np.int64).T
                out[ty * th:(ty + 1) * th, tx * 64:(tx + 1) * 64,
                    nb * bn:(nb + 1) * bn] = acc
    return out[:h, :w, :cout]


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("cin", [16, 40, 1])
def test_staged_mirror_equals_int_conv(k, cin):
    """The mirror of the kernel's staging, descriptors and packed weights
    sums, over its k-steps, exactly the integer conv of `int_conv_plain`:
    c_in 16 (tap pairs at k > 1), 40 (a ragged second k-step) and 1, on a
    tile grid with ragged edges (11 x 70: a part-filled tile row and
    column), at the block the body picks."""
    r = np.random.RandomState(k * 100 + cin)
    h, w, cout = 11, 70, 24
    q = r.randint(-127, 128, (h, w, cin)).astype(np.int64)
    qw = r.randint(-127, 128, (cout, cin, k, k)).astype(np.int8)
    got = _mirror_conv(q, qw, pick_bn_int8(cout, cin, k))
    want = int_conv_plain(torch.from_numpy(q[None]).to(torch.int8),
                          torch.from_numpy(qw))[0].double().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_conv_int8_legs_equal_concat_route(dt):
    """conv_int8 over legs with fuse_n and batch offsets (CPU: its plain
    version) equals, bit for bit, the route it replaces: the legs' concat
    with each leg's sibling sum taken in their dtype (layers.concat_sum),
    then conv_int8 on that tensor."""
    r = np.random.RandomState(5)
    n, h, w = 2, 9, 13
    shapes = [(5, 16, 0), (4, 16, 0), (6, 8, 1)]   # (batch, c, b_off)
    legs = [(torch.from_numpy(((r.rand(b, h, w, c) - 0.4) * 3).astype(
        np.float32)).to(dt), off) for b, c, off in shapes]
    cin, cout, k = 40, 24, 3
    wt = torch.from_numpy((r.rand(cout, cin, k, k) - 0.5).astype(np.float32))
    bias = torch.from_numpy((r.rand(cout) - 0.5).astype(np.float32))
    amax = torch.from_numpy((r.rand(cin) + 0.5).astype(np.float32)) * 3
    f = quant.choose_fold(amax, wt)
    qw, sw = quant.quantize_weights(quant.fold_weights(wt, f))
    x = layers.concat_sum(legs, n, n)
    want = conv_int8(x, qw, sw, f, bias, "relu")
    got = conv_int8(legs, qw, sw, f, bias, "relu", fuse_n=n)
    assert got.dtype == dt and torch.equal(got, want)


def test_pick_bn_int8_picks(monkeypatch):
    """The block pick at a few layers: DeepFuse's enc1 (tap pairs, N 32),
    dec0 on int8 (N 32, the pair in shared memory), UNFusion's DB3_1 conv1
    (N 128, streamed weights); a layer no plan fits raises."""
    assert pick_bn_int8(32, 16, 7, False, torch.int8) == 32
    assert int8_plan(7, 32, 32, True, torch.int8)[3] == 1
    assert pick_bn_int8(640, 1280, 3) == 128
    assert int8_plan(3, 128, 1280)[0] == 0
    monkeypatch.setattr(ci8, "_SMEM_MAX", 64 * 1024)   # a smaller card
    with pytest.raises(ValueError, match="no int8 block fits k7, 32 -> 32"):
        pick_bn_int8(32, 32, 7)


def _div_rint(x, f, r):
    """numpy mirror of csrc/conv_int8.cuh div_rint (float32 arithmetic,
    rounding to nearest): round(x * r) unless x * r lies within 2^-20 of a
    half-integer (relative), then round(x / f)."""
    f32 = np.float32
    y = (x * r).astype(f32)
    t = np.abs(y)
    near = (t < 256) & (np.abs(y - (np.floor(y) + f32(0.5)))
                        <= t * f32(2.0 ** -20))
    return np.where(near, np.rint((x / f).astype(f32)), np.rint(y)), near


@pytest.mark.parametrize("seed", range(4))
def test_div_rint_equals_division(seed):
    """The quantizer's shortcut for round(x / f) through the reciprocal
    (1/f rounded, as Int8Weights.rscale holds it) gives the integer the
    rounded quotient gives, clipped to +-127: on values at exact ties of
    f / 2 multiples and one ulp either side of them (where a wrong side of
    the rounding shows), and on uniform ones, for scales over five
    decades."""
    rng = np.random.default_rng(seed)
    n = 500_000
    f = (10 ** rng.uniform(-4, 1, n)).astype(np.float32)
    tie = (rng.integers(-300, 300, n).astype(np.float32) * np.float32(0.5)
           * f).astype(np.float32)
    side = np.where(rng.random(n) < 0.5, np.inf, -np.inf).astype(np.float32)
    for x in (tie, np.nextafter(tie, side).astype(np.float32),
              (rng.uniform(-130, 130, n) * f).astype(np.float32)):
        r = torch.ones(n).div(torch.from_numpy(f)).numpy()
        got, near = _div_rint(x, f, r)
        want = np.rint((x / f).astype(np.float32))
        np.testing.assert_array_equal(np.clip(got, -127, 127),
                                      np.clip(want, -127, 127))
    # uniform values take the division at about 2^-19 |x / f| of them
    assert near.mean() < 5e-4
