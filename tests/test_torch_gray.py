"""The chain's enter and exit convs on the CPU: plain versions, weight
packing and tiling of csrc/conv_gray.cu.

- The plain versions compute the JAX chain's function in the input's dtype:
  in bf16 the weight is rounded to bf16 first (hiw_kernel.py:387), so with
  f32 weights they equal an f32 conv over bf16-rounded weights, exactly
  (the same f32 ops), and agree with the JAX kernels in bf16 (interpret
  mode) within one bf16 rounding of each output (exact bf16 products, f32
  sums in another order).
- The bf16 B-fragment packing (`pack_gray_enter`, `pack_gray_exit`) read the
  way the kernels read it (lane (g, t) holds B[2t, 2t+1][g] and B[2t+8,
  2t+9][g]), with the kernels' windows (the enter's even/odd pixel offsets,
  the exit's kw-on-N shift-sum), reproduces the conv in float64 within
  1e-5 of the plain output; the f32 exit layout holds the weight.
- `gray_tile` (the tiling rule of conv_gray.cu) covers every output pixel
  once, and the card tests' shapes leave its last tiles ragged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import (
    CHAIN_GUARD, CHAIN_WG)
from multi_modal_image_fusion_tpu.ops.pallas.hiw_kernel import (
    conv_hiw_chain, hiw_enter, hiw_exit)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    GRAY_TILES, apply_act, conv_gray_enter, conv_gray_enter_plain,
    conv_gray_exit, conv_gray_exit_plain, gray_tile, gray_weights,
    pack_gray_enter, pack_gray_exit)

BF = torch.bfloat16


def _rand(shape, seed, lo=-0.5):
    r = np.random.RandomState(seed)
    return (r.rand(*shape) + lo).astype(np.float32)


def _conv_f32(x, weight, bias, act):
    """f32 reflect-SAME conv of NHWC x with an OIHW weight, bias and act."""
    p = weight.shape[-1] // 2
    xn = torch.nn.functional.pad(x.float().permute(0, 3, 1, 2),
                                 (p, p, p, p), mode="reflect")
    y = torch.nn.functional.conv2d(xn, weight.float(), bias)
    return apply_act(y, act).permute(0, 2, 3, 1)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_enter_plain_rounds_weight_to_bf16(k):
    img1 = torch.from_numpy(_rand((2, 21, 37, 1), 0, 0.0)).to(BF)
    img2 = torch.from_numpy(_rand((2, 21, 37, 1), 1, 0.0)).to(BF)
    w = torch.from_numpy(_rand((32, 1, k, k), 2))
    b = torch.from_numpy(_rand((32,), 3))
    got = conv_gray_enter_plain(img1, img2, w, b, "relu")
    want = _conv_f32(torch.cat([img1, img2]), w.to(BF), b, "relu").to(BF)
    assert got.dtype == BF
    assert torch.equal(got, want)
    # the CPU wrapper is the plain version
    assert torch.equal(conv_gray_enter(img1, img2, w, b, "relu"), got)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_exit_plain_rounds_weight_to_bf16(k):
    x = torch.from_numpy(_rand((2, 19, 33, 16), 4)).to(BF)
    w = torch.from_numpy(_rand((1, 16, k, k), 5) * 0.3)
    b = torch.from_numpy(_rand((1,), 6))
    got = conv_gray_exit_plain(x, w, b, None)
    want = _conv_f32(x, w.to(BF), b, None).to(BF)
    assert got.dtype == BF
    assert torch.equal(got, want)
    assert torch.equal(conv_gray_exit(x, w, b, None), got)


def test_plain_f32_unchanged():
    """In f32 the rounding changes nothing."""
    img = torch.from_numpy(_rand((1, 20, 30, 1), 7, 0.0))
    w = torch.from_numpy(_rand((16, 1, 5, 5), 8))
    assert torch.equal(conv_gray_enter_plain(img, None, w, None, "relu"),
                       _conv_f32(img, w, None, "relu"))
    x = torch.from_numpy(_rand((1, 20, 30, 16), 9))
    w2 = torch.from_numpy(_rand((1, 16, 5, 5), 10))
    assert torch.equal(conv_gray_exit_plain(x, w2, None, None),
                       _conv_f32(x, w2, None, None))


def _bf16_close(got, want):
    """Within one bf16 rounding of each output (relative 2^-7) beside an
    absolute 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


def _from_hmajor(t, h, w, c):
    b, hgc, wp = t.shape
    t = t.reshape(b, hgc // c, c, wp)
    sl = t[:, CHAIN_GUARD:CHAIN_GUARD + h, :, CHAIN_WG:CHAIN_WG + w]
    return jnp.transpose(sl, (0, 1, 3, 2))


def _hwio(w_oihw):
    return jnp.asarray(np.transpose(w_oihw, (2, 3, 1, 0)))


def test_bf16_plain_matches_jax_chain():
    """The JAX chain in bf16 (hiw_enter + the 1 -> 16 k5 conv, the 16 -> 1
    k5 conv + hiw_exit, conv_hiw_chain in interpret mode, f32 weights that
    it rounds to bf16) against the port's plain versions in bf16 on the
    same f32 weights."""
    h, w = 24, 40
    imgs = _rand((2, h, w, 1), 11, 0.0)
    w0, b0 = _rand((16, 1, 5, 5), 12), _rand((16,), 13)
    w2, b2 = _rand((1, 16, 5, 5), 14) * 0.3, _rand((1,), 15)
    xb = jnp.asarray(imgs).astype(jnp.bfloat16)
    t = conv_hiw_chain(hiw_enter(xb), _hwio(w0), 5, h=h, w_valid=w, c_in=1,
                       bias=jnp.asarray(b0), act="relu", interpret=True)
    y = hiw_exit(conv_hiw_chain(t, _hwio(w2), 5, h=h, w_valid=w, c_in=16,
                                bias=jnp.asarray(b2), interpret=True), h, w)
    feat_jax = np.array(_from_hmajor(t, h, w, 16).astype(jnp.float32))
    img = torch.from_numpy(imgs).to(BF)
    feat = conv_gray_enter_plain(img, None, torch.from_numpy(w0),
                                 torch.from_numpy(b0), "relu")
    _bf16_close(feat.float().numpy(), feat_jax)
    # the exit on the JAX chain's own bf16 features
    got = conv_gray_exit_plain(torch.from_numpy(feat_jax).to(BF),
                               torch.from_numpy(w2), torch.from_numpy(b2),
                               None)
    _bf16_close(got.float().numpy(), np.asarray(y.astype(jnp.float32)))


def _reflect(i, n):
    i = np.abs(i)
    return np.where(i >= n, 2 * n - 2 - i, i)


def _enter_b(packed, k, cout):
    """B[par][q][j][co] of the enter as the kernel's lanes read the packed
    fragments: lane (g, t) element e is row 2t + e % 2 + 8 (e // 2), column
    g of N tile nt."""
    nq = (k + 1) // 2
    pk = packed.reshape(2, nq, cout // 8, 32, 4)
    b = np.zeros((2, nq, 16, cout))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(4):
            j = 2 * t + (e & 1) + 8 * (e >> 1)
            for nt in range(cout // 8):
                b[:, :, j, nt * 8 + g] = pk[:, :, nt, lane, e]
    return b


def _emulate_enter(img, packed, k, cout):
    """conv_gray_enter's bf16 arithmetic in float64: output channel co of
    pixel x (parity par) = sum over tap pairs q and j of A[x][j] B[par][q]
    [j][co], A[x][j] = in[y + 2q + j // 8 - P][x - Q + j % 8]."""
    n, h, w = img.shape
    p = k // 2
    qs = (p + (p & 1), p + 1 - (p & 1))
    nq = (k + 1) // 2
    b = _enter_b(packed, k, cout)
    out = np.zeros((n, h, w, cout))
    ys, xs = np.arange(h), np.arange(w)
    for q in range(nq):
        for j in range(16):
            rows = _reflect(ys + 2 * q + j // 8 - p, h)
            for par in range(2):
                cols = _reflect(xs - qs[par] + j % 8, w)
                a = img[:, rows][:, :, cols]            # (n, h, w)
                sel = (xs % 2) == par
                out[:, :, sel] += a[:, :, sel, None] * b[par, q, j]
    return out


@pytest.mark.parametrize("k,cout", [(1, 16), (3, 16), (5, 16), (1, 32),
                                    (3, 32), (5, 32)])
def test_pack_gray_enter_reproduces_the_conv(k, cout):
    img = torch.from_numpy(_rand((2, 13, 22, 1), 20 + k, 0.0)).to(BF)
    w = torch.from_numpy(_rand((cout, 1, k, k), 30 + cout))
    packed = pack_gray_enter(w)
    assert packed.dtype == BF
    assert packed.numel() == 2 * ((k + 1) // 2) * cout * 32 // 2
    got = _emulate_enter(img.double().numpy()[..., 0],
                         packed.double().numpy(), k, cout)
    want = _conv_f32(img, w.to(BF), None, None).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # round trip: each parity's B holds every tap once at its shifted row
    # (j = kw + Q - P within the pair's half for kernel row kh), and
    # nothing else
    b = _enter_b(packed.double().numpy(), k, cout)
    wq = w.to(BF).double().numpy()[:, 0]
    p = k // 2
    for par, q_off in enumerate((p + (p & 1), p + 1 - (p & 1))):
        back = np.zeros_like(wq)
        for kh in range(k):
            for kw in range(k):
                back[:, kh, kw] = b[par, kh // 2, 8 * (kh % 2) + kw
                                    + q_off - p]
        np.testing.assert_array_equal(back, wq)
        assert np.count_nonzero(b[par]) == np.count_nonzero(wq)


def _exit_b(packed, k, cin):
    """B[ci][kh][kw] of the exit, the channels of every k-step in order, as
    the kernel's lanes read the packed fragments (N = kw = g)."""
    ks = -(-cin // 16)
    pk = packed.reshape(ks, k, 32, 4)
    b = np.zeros((ks * 16, k, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(4):
            ci = 2 * t + (e & 1) + 8 * (e >> 1)
            b[ci::16][:ks, :, g] = pk[:, :, lane, e]
    return b


def _emulate_exit(x, packed, k):
    """conv_gray_exit's bf16 arithmetic in float64: P[y][c][kw] = sum_kh
    sum_ci xpad[y + kh][c][ci] B[ci][kh][kw] over the staged columns c,
    then out[y][x] = sum_kw P[y][x + kw][kw]."""
    n, h, w, cin = x.shape
    p = k // 2
    ks = -(-cin // 16)
    b = _exit_b(packed, k, cin)
    rows = _reflect(np.arange(-p, h + p), h)
    cols = _reflect(np.arange(-p, w + p), w)
    xp = np.zeros((n, h + 2 * p, w + 2 * p, ks * 16))
    xp[..., :cin] = x[:, rows][:, :, cols]
    pp = np.zeros((n, h, w + 2 * p, 8))
    for kh in range(k):
        pp += np.einsum("nycj,jk->nyck", xp[:, kh:kh + h], b[:, kh])
    out = sum(pp[:, :, kw:kw + w, kw] for kw in range(k))
    return out[..., None]


@pytest.mark.parametrize("k,cin", [(1, 16), (3, 16), (5, 16), (5, 32),
                                   (3, 12), (5, 40)])
def test_pack_gray_exit_reproduces_the_conv(k, cin):
    x = torch.from_numpy(_rand((2, 11, 23, cin), 40 + cin)).to(BF)
    w = torch.from_numpy(_rand((1, cin, k, k), 50 + k) * 0.3)
    packed = pack_gray_exit(w)
    assert packed.dtype == BF
    assert packed.numel() == -(-cin // 16) * k * 128
    got = _emulate_exit(x.double().numpy(), packed.double().numpy(), k)
    want = _conv_f32(x, w.to(BF), None, None).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # round trip: the weight comes back at kw < K, zeros past Cin and K
    b = _exit_b(packed.double().numpy(), k, cin)
    np.testing.assert_array_equal(b[:cin, :, :k],
                                  w.to(BF).double().numpy()[0])
    assert not b[cin:].any() and not b[:, :, k:].any()


@pytest.mark.parametrize("k,cin", [(1, 16), (5, 16), (3, 12)])
def test_exit_f32_weights_layout(k, cin):
    """f32: [ceil(Cin / 8)][K][K][8], channels zero-padded; bias in f32."""
    w = torch.from_numpy(_rand((1, cin, k, k), 60 + cin))
    b = torch.from_numpy(_rand((1,), 61))
    wk, bk = gray_weights("exit", w, b, torch.float32)
    assert wk.shape == (-(-cin // 8), k, k, 8) and wk.dtype == torch.float32
    for ci in range(-(-cin // 8) * 8):
        want = w[0, ci] if ci < cin else torch.zeros(k, k)
        assert torch.equal(wk[ci // 8, :, :, ci % 8], want)
    assert torch.equal(bk, b)
    we, _ = gray_weights("enter", torch.from_numpy(_rand((16, 1, k, k), 62)),
                         None, torch.float32)
    assert we.shape == (1, k, k, 16)


@pytest.mark.parametrize("kind", sorted(GRAY_TILES))
@pytest.mark.parametrize("b,h,w", [(2, 45, 61), (1, 8, 200), (3, 1224, 1000),
                                   (32, 1224, 1024)])
def test_gray_tiles_cover_every_pixel_once(kind, b, h, w):
    th, tw = GRAY_TILES[kind]
    cover = np.zeros((b, h, w), np.int32)
    _, n = gray_tile(kind, b, h, w, 0)
    assert n == b * -(-h // th) * -(-w // tw)
    for t in range(n):
        (bi, y0, x0, rows, cols), _ = gray_tile(kind, b, h, w, t)
        assert 0 < rows <= th and 0 < cols <= tw
        cover[bi, y0:y0 + rows, x0:x0 + cols] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("kind", sorted(GRAY_TILES))
def test_card_shapes_leave_ragged_tiles(kind):
    """The card tests' odd and ragged shapes (tests/test_torch_gray_card.py)
    end in a tile narrower than GRAY_TILES' width, and 45 rows in a
    partial band."""
    th, tw = GRAY_TILES[kind]
    for h, w in ((45, 61), (8, 200), (1224, 1000)):
        (_, _, _, _, cols), n = gray_tile(kind, 1, h, w,
                                          -(-w // tw) - 1)
        assert cols < tw
    (_, _, _, rows, _), n = gray_tile(kind, 1, 45, 61, -(-45 // th) - 1)
    assert rows < th
