"""The bf16 function of the port's conv_chain / conv_multi and the weight
layout of their tensor-core body, on the CPU.

- The plain versions in bf16 (`conv_chain_plain`, `conv_multi_plain`: the
  weight and the fuse_n sum rounded to bf16, the conv in f32) against the
  JAX kernels `conv_hiw_chain` and `conv_hiw_chain_multi` in bf16, run in
  the Pallas interpreter (`interpret=True`, what MMIF_CHAIN_INTERPRET=1
  selects on the JAX chain route), within one bf16 ulp of each output plus
  1e-3 of max|y|: both round an f32 sum of the same exact products to
  bf16, summed in another order, so an output may land on the neighbouring
  bf16 value.
- `pack_weights_tc` read back through `tc_weight_index`, the Python copy of
  the kernel's offset function (csrc/conv_chain.cuh): every OIHW weight at
  its place, zeros in the padding of 1-, 24- and 48-channel legs and of
  Cout, for every N block.
- `pick_bn_tc` / `tc_plan`: each model layer's block, and a plan that fits
  for every Cout and input width the wrapper takes.
- The f32 plain path unchanged: against the JAX kernel in f32 at 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops.pallas.hiw_kernel import (
    conv_hiw_chain, conv_hiw_chain_multi)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    TC_BNS, conv_chain_plain, pack_weights_tc, pick_bn_tc, tc_plan,
    tc_weight_index)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import \
    conv_multi_plain

from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import (
    CHAIN_GUARD, CHAIN_WG, chain_shape)

# (seed, c_in, c_out, k, fuse_n, h, w): DeepFuse's enc1, dec0 and dec1, a
# 24-channel input, a k3 DenseFuse width
CHAIN_CASES = [(1, 16, 32, 7, 0, 20, 37),
               (2, 32, 32, 7, 2, 18, 29),
               (3, 32, 16, 5, 0, 21, 40),
               (4, 24, 16, 3, 0, 17, 33),
               (5, 64, 32, 3, 0, 16, 24)]


def _to_hmajor(x, garbage=7.75):
    """NHWC -> the JAX chain's H-major tensor, guard bands of garbage (the
    kernel makes its own reflect halo)."""
    b, h, w, c = x.shape
    hg, wp = chain_shape(h, w)
    t = jnp.full((b, hg, c, wp), garbage, x.dtype)
    t = t.at[:, CHAIN_GUARD:CHAIN_GUARD + h, :, CHAIN_WG:CHAIN_WG + w].set(
        jnp.transpose(x, (0, 1, 3, 2)))
    return t.reshape(b, hg * c, wp)


def _from_hmajor(t, h, w, c):
    b, hgc, wp = t.shape
    t = t.reshape(b, hgc // c, c, wp)
    sl = t[:, CHAIN_GUARD:CHAIN_GUARD + h, :, CHAIN_WG:CHAIN_WG + w]
    return np.asarray(jnp.transpose(sl, (0, 1, 3, 2)).astype(jnp.float32))


def _rand(r, *shape):
    return (r.rand(*shape) - 0.5).astype(np.float32)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w_hwio), (3, 2, 0, 1))))


def _ulp_rel(got, want):
    """max |got - want| beyond one bf16 ulp of each output, over max|y|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    d = np.maximum(np.abs(got - want) - ulp, 0.0)
    return float(d.max() / np.abs(want).max())


def _bf16(x):
    return np.asarray(torch.from_numpy(x).bfloat16().float())


@pytest.mark.parametrize("seed,cin,cout,k,fuse_n,h,w", CHAIN_CASES)
def test_bf16_plain_matches_jax_chain(seed, cin, cout, k, fuse_n, h, w):
    r = np.random.RandomState(seed)
    b = 2 * fuse_n if fuse_n else 2
    x = _bf16(_rand(r, b, h, w, cin) * 2)
    wgt = _rand(r, k, k, cin, cout) / np.sqrt(cin * k * k)   # f32 HWIO
    bias = _rand(r, cout) * 0.1
    want = conv_hiw_chain(_to_hmajor(jnp.asarray(x, jnp.bfloat16)),
                          jnp.asarray(wgt), k, h=h, w_valid=w, c_in=cin,
                          bias=jnp.asarray(bias), act="relu", fuse_n=fuse_n,
                          interpret=True)
    want = _from_hmajor(want, h, w, cout)
    got = conv_chain_plain(torch.from_numpy(x).bfloat16(), _oihw(wgt),
                           torch.from_numpy(bias), "relu", fuse_n)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape
    assert _ulp_rel(got.float().numpy(), want) <= 1e-3


@pytest.mark.parametrize("fuse_n", [0, 2])
def test_bf16_multi_plain_matches_jax_multi(fuse_n):
    """Three legs (16, 16 and 8 channels), one of them read at a batch
    offset, in bf16."""
    r = np.random.RandomState(20 + fuse_n)
    h, w, k, cout = 19, 35, 3, 16
    nb = 4 if fuse_n else 2
    xs = [_bf16(_rand(r, nb + 1, h, w, c) * 2) for c in (16, 16, 8)]
    offs = (0, 1, 0)
    wgt = _rand(r, k, k, 40, cout) / np.sqrt(40 * k * k)
    n_out = 2
    want = conv_hiw_chain_multi(
        tuple(_to_hmajor(jnp.asarray(x, jnp.bfloat16)) for x in xs),
        jnp.asarray(wgt), k, h=h, w_valid=w, c_ins=(16, 16, 8), b_offs=offs,
        n_out=n_out, act="relu", fuse_n=fuse_n, interpret=True)
    want = _from_hmajor(want, h, w, cout)
    got = conv_multi_plain([(torch.from_numpy(x).bfloat16(), o)
                            for x, o in zip(xs, offs)], _oihw(wgt), None,
                           "relu", fuse_n, n_out)
    assert got.shape == want.shape
    assert _ulp_rel(got.float().numpy(), want) <= 1e-3


def test_bf16_plain_rounds_weight_and_fuse_sum():
    """The plain version's bf16 function: bf16(x[i] + x[i+n]) and bf16(W),
    then the f32 conv; the sum and the weight kept in f32 give another
    result."""
    r = np.random.RandomState(30)
    x = torch.from_numpy(_rand(r, 4, 12, 16, 16) * 2).bfloat16()
    wt = torch.from_numpy(_rand(r, 16, 16, 3, 3) / 12)
    got = conv_chain_plain(x, wt, None, None, 2)
    s = (x[:2] + x[2:]).float()
    p = torch.nn.functional.pad(s.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                mode="reflect")
    want = torch.nn.functional.conv2d(p, wt.bfloat16().float()).permute(
        0, 2, 3, 1).bfloat16()
    assert torch.equal(got, want)
    p32 = torch.nn.functional.pad(
        (x[:2].float() + x[2:].float()).permute(0, 3, 1, 2), (1, 1, 1, 1),
        mode="reflect")
    f32 = torch.nn.functional.conv2d(p32, wt).permute(0, 2, 3, 1).bfloat16()
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("cins,cout,k,bn", [
    ([1], 16, 5, 16),                 # a gray leg: 15 channels of padding
    ([24], 40, 3, 32),                # 8 channels and 24 outputs of padding
    ([48], 64, 1, 64),
    ([16, 24, 48, 1], 48, 3, 48),     # four legs, each to whole k-steps
    ([32], 32, 7, 32),                # DeepFuse dec0 (fuse_n packs alike)
    ([376], 1024, 3, 256),            # UNFusion EB4_3, four N blocks
    # conv_wide's layers: UNFusion DB1_3 conv1 (56 of a 64 block), the
    # EB4_3 k1 over four legs (a 304-channel leg: 19 k-steps), DBNet's
    # five-leg dec0, DeepFuse's packed dec2 (4 of a 16 block)
    ([16, 16, 16, 64], 56, 3, 64),
    ([64, 128, 304, 256], 376, 1, 96),
    ([16, 16, 16, 16, 64], 64, 3, 64),
    ([64], 4, 3, 16)])
def test_pack_weights_tc_read_back(cins, cout, k, bn):
    r = np.random.RandomState(sum(cins) + cout + k)
    wt = torch.from_numpy(_rand(r, cout, sum(cins), k, k))
    packed = pack_weights_tc(wt, cins, bn)
    ks = [-(-c // 16) for c in cins]
    ks0 = np.concatenate([[0], np.cumsum(ks)])
    cout_pad = -(-cout // bn) * bn
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == cout_pad * int(ks0[-1]) * 16 * k * k
    co, kh, kw = np.meshgrid(np.arange(cout), np.arange(k), np.arange(k),
                             indexing="ij")
    seen = np.zeros(packed.numel(), bool)
    flat = packed.float().numpy()
    wq = wt.bfloat16().float().numpy()
    ofs = 0
    for leg, c in enumerate(cins):
        for ci in range(c):
            idx = tc_weight_index(k, bn, int(ks0[-1]), co,
                                  int(ks0[leg]) + ci // 16, ci % 16, kh, kw)
            np.testing.assert_array_equal(flat[idx],
                                          wq[:, ofs + ci][co, kh, kw])
            seen[idx] = True
        ofs += c
    assert seen.sum() == cout * sum(cins) * k * k
    assert not flat[~seen].any()


@pytest.mark.parametrize("cins,cout,k,bn,resident", [
    ([16], 32, 7, 32, 1),             # DeepFuse enc1
    ([32], 32, 7, 32, 1),             # DeepFuse dec0
    ([32], 16, 5, 16, 1),             # DeepFuse dec1
    ([16] * 4, 64, 3, 64, 1),         # DenseFuse dec0
    ([16] * 8, 128, 3, 64, 1),        # VIFNet dec0: two resident blocks
    ([144], 304, 3, 64, 1),           # UNFusion EB4_2: 304 = 5 x 64 - 16
    ([376], 1024, 3, 256, 0),         # UNFusion EB4_3: weights in the ring
    ([16, 32], 384, 1, 128, 1),       # Res2Fusion RB2 pwconv1
    # conv_wide's layers: UNFusion DB3_1 conv1 and conv2 (80 and 40
    # k-steps: the weights in the ring), EB4_2's and EB4_3's k1 over three
    # and four legs (a stage's fixed cost favours the wider blocks there),
    # DeepFuse's packed enc1 and dec1 (k5 and k3 on 4x the channels)
    ([256, 1024], 640, 3, 128, 0),
    ([640], 256, 3, 256, 0),
    ([64, 128, 96], 144, 1, 96, 1),
    ([64, 128, 304, 256], 376, 1, 128, 0),
    ([64], 128, 5, 48, 1),
    ([128], 64, 3, 64, 1)])
def test_pick_bn_tc_for_model_layers(cins, cout, k, bn, resident):
    assert pick_bn_tc(cout, cins, k) == bn
    assert tc_plan(k, bn, sum(-(-c // 16) for c in cins))[0] == resident


@pytest.mark.parametrize("cins,cout,k,bn,resident,pair,alone", [
    ([16, 16, 16, 16, 64], 64, 3, 64, 0, 1, 1),   # DBNet dec0
    ([128], 128, 5, 64, 0, 1, 0),                  # DeepFuse's packed dec0
    ([16, 16, 16, 16], 64, 3, 64, 1, 1, 1),        # DenseFuse dec0
    ([32], 32, 7, 32, 1, 0, 1)])                   # DeepFuse dec0
def test_pick_bn_tc_pair_plan(cins, cout, k, bn, resident, pair, alone):
    """The fuse_n layers: where a ring of slots holding both halves of the
    pair (twice the input tile) fits, the pair is summed in shared memory,
    even when the second buffer pushes the weights into the ring (DBNet's
    dec0); DeepFuse's k7 dec0 has no such plan and sums in registers. The
    N block is the one the layer picks without the pair."""
    ks = sum(-(-c // 16) for c in cins)
    assert pick_bn_tc(cout, cins, k, fuse_n=1) == bn == pick_bn_tc(cout,
                                                                    cins, k)
    plan = tc_plan(k, bn, ks, fuse_n=1)
    assert plan[0] == resident and plan[3] == pair
    one = tc_plan(k, bn, ks)
    assert one[0] == alone and one[3] == 0
    assert plan[2] > one[2] or plan[0] != alone or not pair
    if not pair:
        assert plan == one


def test_tc_plan_fits_every_width():
    for k in (1, 3, 5, 7):
        for bn in TC_BNS:
            plan = tc_plan(k, bn, 1)
            # 200 KB or more a k-step; k7 at N 96 since the block holds two
            # m-tiles a warpgroup there (its input and output tiles grew)
            if (k, bn) in ((5, 256), (7, 96), (7, 128), (7, 256)):
                assert plan is None
            else:
                assert plan is not None and plan[2] <= 232448
        for cout in range(16, 1025, 16):
            for cin in (1, 16, 200, 1280):
                bn = pick_bn_tc(cout, [cin], k)
                assert bn in TC_BNS
                assert tc_plan(k, bn, -(-cin // 16)) is not None


@pytest.mark.parametrize("seed,cin,cout,k,fuse_n,h,w", CHAIN_CASES[:3])
def test_f32_plain_matches_jax_chain(seed, cin, cout, k, fuse_n, h, w):
    r = np.random.RandomState(40 + k)
    b = 2 * fuse_n if fuse_n else 2
    x = _rand(r, b, h, w, cin)
    wgt = _rand(r, k, k, cin, cout) / np.sqrt(cin * k * k)
    bias = _rand(r, cout) * 0.1
    want = conv_hiw_chain(_to_hmajor(jnp.asarray(x)), jnp.asarray(wgt), k,
                          h=h, w_valid=w, c_in=cin, bias=jnp.asarray(bias),
                          act="relu", fuse_n=fuse_n, interpret=True)
    want = _from_hmajor(want, h, w, cout)
    got = conv_chain_plain(torch.from_numpy(x), _oihw(wgt),
                           torch.from_numpy(bias), "relu", fuse_n)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# conv_wide's s2d mode on the bf16 body: DeepFuse's packed layers (c_in and
# c_out packed, k packed). enc1-dec2 stage a half of 8 channels in one
# phase (c_in / 4 a multiple of 8); enc0's 4 channels go one by one.
S2D_PACKED = [("enc0", 4, 64, 3), ("enc1", 64, 128, 5), ("dec0", 128, 128, 5),
              ("dec1", 128, 64, 3), ("dec2", 64, 4, 3)]


def _reflect(i, n):
    """common.cuh reflect_index, clamped as the kernel clamps."""
    i = np.abs(i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _src_pixel(y, x, h, w, ph):
    """common.cuh src_pixel in s2d mode: (packed row, packed column)."""
    return (_reflect(2 * y + (ph >> 1), 2 * h) >> 1,
            _reflect(2 * x + (ph & 1), 2 * w) >> 1)


def _staged_tile(x, ty, tx, c0, k, th, s2d):
    """The mirror of conv_chain.cuh tc_load_stage_t: the (th + k - 1) x (64
    + k - 1) x 16 tile of k-step channels c0 .. c0 + 15 that a stage
    stages for tile (ty, tx), zeros past the last channel."""
    b, h, w, cin = x.shape
    p = k // 2
    rows = np.arange(th + k - 1)[:, None] + ty * th - p
    cols = np.arange(64 + k - 1)[None, :] + tx * 64 - p
    cb = cin // 4
    vec = cin % 8 == 0 and (not s2d or cb % 8 == 0)
    tile = np.zeros((b, *np.broadcast(rows, cols).shape, 16), x.dtype)
    for half in range(2):
        ch = c0 + 8 * half
        for j in range(8):
            if ch + j >= cin:
                continue
            if not s2d:
                r, c = _reflect(rows, h), _reflect(cols, w)
            else:
                r, c = _src_pixel(rows, cols, h, w,
                                  (ch if vec else ch + j) // cb)
            tile[..., 8 * half + j] = x[:, r, c, ch + j]
    return tile


@pytest.mark.parametrize("hw", [(45, 61), (45, 161)])
@pytest.mark.parametrize("name,cin,cout,k", S2D_PACKED,
                         ids=[c[0] for c in S2D_PACKED])
def test_s2d_staged_index_is_the_packed_reflect(name, cin, cout, k, hw):
    """Every staged tile of a 45x61 and a 45x161 packed image (ragged last
    tiles, the top, bottom, left and right mirrors of all four phases; at
    161 columns a middle column of tiles off the mirrors) holds what
    s2d_reflect_pad puts at its place, wherever the tile lies inside the
    padded image (the rest feeds no stored output). The control, the
    phase-blind reflect of the packed tensor, stages the same interior
    tiles and differs on every tile that reaches a mirror."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        _tc_mt
    from multi_modal_image_fusion_tpu_torch.ops.s2d import s2d_reflect_pad
    r = np.random.RandomState(cin + k)
    h, w = hw
    x = _rand(r, 2, h, w, cin)
    p = k // 2
    padded = s2d_reflect_pad(torch.from_numpy(x), p).numpy()
    th = 2 * _tc_mt(pick_bn_tc(cout, [cin], k))
    mirrored, tiles = 0, 0
    for ty in range(-(-h // th)):
        for tx in range(-(-w // 64)):
            y1 = min(ty * th + th + k - 1, h + 2 * p)
            x1 = min(tx * 64 + 64 + k - 1, w + 2 * p)
            mirror = ty == 0 or tx == 0 or y1 > h + p or x1 > w + p
            blind_same = True
            for c0 in range(0, cin, 16):
                want = padded[:, ty * th:y1, tx * 64:x1, c0:c0 + 16]
                cut = (slice(None), slice(0, y1 - ty * th),
                       slice(0, x1 - tx * 64), slice(0, want.shape[-1]))
                got = _staged_tile(x, ty, tx, c0, k, th, True)[cut]
                np.testing.assert_array_equal(got, want)
                blind = _staged_tile(x, ty, tx, c0, k, th, False)[cut]
                blind_same &= bool((blind == want).all())
            assert blind_same != mirror, (ty, tx)
            mirrored += mirror
            tiles += 1
    assert 0 < mirrored and (mirrored < tiles) == (w > 128)
