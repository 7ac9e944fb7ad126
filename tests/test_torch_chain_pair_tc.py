"""The bf16 pair kernels' arithmetic and tiling (csrc/conv_pair.cu), on the CPU.

The kernels run only on the card (tests/test_torch_kernels.py holds them
against `conv_pair_plain` there). Here, in float64 from the packed weights
the wrapper hands them (`pair_weights`):

- enc0 through the enter's B fragments (`pack_gray_enter`) at the enter's
  staged-row offsets, enc1 and dec1 through the wgmma body's weights
  (`pack_weights_tc`) read as the kernels' descriptors read them (dec1's A
  fragments reused across kernel rows at the staged pitch), dec2 through the exit's
  fragments (`pack_gray_exit`) and the shift-sum, each against F.conv2d;
- the bf16 tile walk (`PAIR_TILES`, `pair_tile`) covers every pixel once;
- the mid tile as a block computes it (conv_a over the tile, the reflect
  fix-up, conv_b VALID) equals `conv_pair_plain` on tiles at each border and
  corner, and without the fix-up it does not; the card tests' controls
  (the extended-input mid, the corner tile without the fix-up) miss the
  plain pair by far more than the card's tolerance.

f32 or bf16-rounded inputs in float64: tolerance 1e-9 relative where both
sides sum the same bf16 products, 1e-5 against the f32 plain pair.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import apply_act
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
    ENTER_SHAPES, EXIT_SHAPES, PAIR_TILES, conv_pair_plain, pair_tile,
    pair_weights)

BF = torch.bfloat16


def _rand(shape, seed, scale=1.0):
    r = np.random.RandomState(seed)
    return ((r.rand(*shape) * 2 - 1) * scale).astype(np.float32)


def _reflect(i, n):
    """common.cuh reflect_index: mirror once, then clamp."""
    i = np.abs(i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _weights(kind, seed=0):
    """DeepFuse's pair weights (OIHW), rounded to bf16, and biases."""
    shapes = ENTER_SHAPES if kind == "enter" else EXIT_SHAPES
    ws = [torch.from_numpy(_rand(s, seed + i, 1.0 / np.sqrt(s[1] * s[2]
                                                             * s[3]))).to(BF)
          for i, s in enumerate(shapes)]
    bs = [torch.from_numpy(_rand((s[0],), seed + 10 + i, 0.1))
          for i, s in enumerate(shapes)]
    return ws[0], bs[0], ws[1], bs[1]


def _conv_valid(x, w):
    """float64 VALID conv of NHWC x with OIHW w, NHWC out."""
    return F.conv2d(x.double().permute(0, 3, 1, 2), w.double()).permute(
        0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the packed weights as the kernels read them
# ---------------------------------------------------------------------------

def _enter_b(packed, cout=16, nq=3):
    """pack_gray_enter's fragments as B[parity][q][j][co] (lane (g, t) holds
    rows 2t, 2t+1, 2t+8, 2t+9 of column g: common.cuh mma_bf16)."""
    pk = packed.double().numpy().reshape(2, nq, cout // 8, 32, 4)
    b = np.zeros((2, nq, 16, cout))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(4):
            j = 2 * t + (e & 1) + 8 * (e >> 1)
            for nt in range(cout // 8):
                b[:, :, j, nt * 8 + g] = pk[:, :, nt, lane, e]
    return b


def test_enc0_fragments_at_the_enters_offsets():
    """enc0 as pair_enter_kernel computes it: the staged rows y0 - 5 .. and
    columns x0 - 8 .. of one image (reflected), column u of a mid row's
    groups at staged column u + 4, the window from u - Q (Q 2 for an even
    image column, 3 for an odd one), B of its parity; mid column u - 1.
    Against F.conv2d of the reflect-padded image at the mid positions inside
    the image, for a tile at the top-left corner and an interior one."""
    h, w = 30, 150
    img = torch.from_numpy(_rand((1, h, w, 1), 1)).to(BF)
    wa, _, wb, _ = _weights("enter")
    packed, _ = pair_weights("enter", wa, wb)
    b = _enter_b(packed[:2 * 3 * 2 * 32 * 4])
    full = _conv_valid(F.pad(img.double().permute(0, 3, 1, 2), (2,) * 4,
                             mode="reflect").permute(0, 2, 3, 1), wa)[0]
    im = img.double().numpy()[0, :, :, 0]
    for y0, x0 in ((0, 0), (16, 64)):
        staged = im[_reflect(np.arange(y0 - 5, y0 + 13), h)][
            :, _reflect(np.arange(x0 - 8, x0 + 104), w)]
        mid = np.zeros((14, 96, 16))
        u = np.arange(96)
        par = u & 1
        for q in range(3):
            for j in range(16):
                r = 2 * q + j // 8
                if r >= 5:
                    continue
                cols = u + 4 - np.where(par == 0, 2, 3) + j % 8
                a = staged[r:r + 14][:, cols]                     # (14, 96)
                mid += a[:, :, None] * b[par, q, j][None]
        for mr in range(14):
            gy = y0 - 3 + mr
            for uu in range(1, 71):
                gx = x0 - 4 + uu
                if 0 <= gy < h and 0 <= gx < w:
                    np.testing.assert_allclose(mid[mr, uu], full[gy, gx],
                                               rtol=1e-9, atol=1e-12)


def _tc_b(packed, bn, ks, taps):
    """B[ks][tap][k][n] of pack_weights_tc's output read through the wgmma
    body's B descriptor: tap t of k-step s at element (s * taps + t) * bn *
    16, the two 8-channel halves bn * 8 elements apart (leading byte offset
    bn * 16), 8-row groups of n 64 elements apart (stride byte offset
    128), a core matrix row of 8 channels."""
    p = packed.double().numpy()
    b = np.zeros((ks, taps, 16, bn))
    for s in range(ks):
        for t in range(taps):
            base = (s * taps + t) * bn * 16
            for k in range(16):
                for n in range(bn):
                    b[s, t, k, n] = p[base + (k // 8) * bn * 8
                                      + (n // 8) * 64 + (n % 8) * 8 + k % 8]
    return b


def test_enc1_wgmma_weights_reproduce_the_conv():
    """enc1 as 49 wgmmas a row: output (r, p) sums mid (r + kh, p + kw) x
    B[tap], B from the packed weights through the descriptor; against
    F.conv2d VALID over the mid."""
    wa, _, wb, _ = _weights("enter", 3)
    _, packed = pair_weights("enter", wa, wb)
    assert packed.dtype == BF and packed.numel() == 49 * 16 * 32
    b = _tc_b(packed, 32, 1, 49)[0]
    mid = torch.from_numpy(_rand((1, 14, 70, 16), 4)).to(BF)
    m = mid.double().numpy()[0]
    got = np.zeros((8, 64, 32))
    for kh in range(7):
        for kw in range(7):
            got += m[kh:kh + 8, kw:kw + 64] @ b[kh * 7 + kw]
    want = _conv_valid(mid, wb)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_dec1_register_fragments_over_the_staged_rows():
    """dec1 as pair_exit_kernel computes it: the staged input (28 rows of 64
    pixels, two 16-channel k-steps) flattened, mid row r one m64 tile; for
    each kw a warpgroup's A fragments are the 64-pixel windows at row i and
    column kw (i < 12 + 4), and tap (kh, kw) of its m-tile j multiplies
    fragment j + kh; B through the descriptor. The mid's 60 columns equal
    F.conv2d VALID over the staged input."""
    wa, _, wb, _ = _weights("exit", 5)
    packed, _ = pair_weights("exit", wa, wb)
    assert packed.numel() == 2 * 25 * 16 * 16
    b = _tc_b(packed, 16, 2, 25)
    x = torch.from_numpy(_rand((1, 28, 64, 32), 6)).to(BF)
    flat = np.zeros((28 * 64 + 8, 32))
    flat[:28 * 64] = x.double().numpy()[0].reshape(-1, 32)
    d = np.zeros((24, 64, 16))
    for wg in range(2):
        for s in range(2):
            for kw in range(5):
                frags = [flat[64 * (12 * wg + i) + kw:
                              64 * (12 * wg + i) + kw + 64, 16 * s:16 * s + 16]
                         for i in range(16)]
                for kh in range(5):
                    for j in range(12):
                        d[12 * wg + j] += frags[j + kh] @ b[s, kh * 5 + kw]
    want = _conv_valid(x, wa)[0].numpy()
    np.testing.assert_allclose(d[:, :60], want, rtol=1e-9, atol=1e-12)


def test_dec2_fragments_and_shift_sum():
    """dec2 as the exit computes it over the mid (24 x 60, 16 channels):
    P[o][kw][c] = sum_kh mid[o + kh][c] . B[kh][:, kw] with B from
    pack_gray_exit's fragments (N = kw = g), out[o][x] = sum_kw P[o][kw][x +
    kw]; against F.conv2d VALID."""
    wa, _, wb, _ = _weights("exit", 7)
    _, packed = pair_weights("exit", wa, wb)
    assert packed.numel() == 5 * 32 * 4
    pk = packed.double().numpy().reshape(5, 32, 4)
    b = np.zeros((5, 16, 8))                      # [kh][ci][kw]
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(4):
            b[:, 2 * t + (e & 1) + 8 * (e >> 1), g] = pk[:, lane, e]
    assert not b[:, :, 5:].any()
    mid = torch.from_numpy(_rand((1, 24, 60, 16), 8)).to(BF)
    m = mid.double().numpy()[0]
    p = np.zeros((20, 60, 8))
    for kh in range(5):
        p += m[kh:kh + 20] @ b[kh]
    got = sum(p[:, kw:kw + 56, kw] for kw in range(5))
    want = _conv_valid(mid, wb)[0, ..., 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_f32_weights_are_the_fma_rows():
    """f32: (k*k, I, O) rows for the FMA kernel, as before."""
    for kind in ("enter", "exit"):
        wa, _, wb, _ = [t.float() if t is not None else t
                        for t in _weights(kind, 9)]
        wak, wbk = pair_weights(kind, wa, wb)
        for w, wk in ((wa, wak), (wb, wbk)):
            k = w.shape[-1]
            assert wk.dtype == torch.float32
            assert torch.equal(wk, w.permute(2, 3, 1, 0).reshape(
                k * k, w.shape[1], w.shape[0]))


# ---------------------------------------------------------------------------
# the tile walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(PAIR_TILES))
@pytest.mark.parametrize("b,h,w", [(2, 45, 61), (1, 16, 5), (3, 20, 130),
                                   (32, 1224, 1024)])
def test_pair_tiles_cover_every_pixel_once(kind, b, h, w):
    th, tw = PAIR_TILES[kind]
    cover = np.zeros((b, h, w), np.int32)
    _, n = pair_tile(kind, b, h, w, 0)
    assert n == b * -(-h // th) * -(-w // tw)
    for t in range(n):
        (bi, y0, x0, rows, cols), _ = pair_tile(kind, b, h, w, t)
        assert 0 < rows <= th and 0 < cols <= tw
        cover[bi, y0:y0 + rows, x0:x0 + cols] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("kind", sorted(PAIR_TILES))
def test_card_shapes_leave_ragged_tiles(kind):
    """The card tests' shapes end in a tile narrower than PAIR_TILES' width
    (61, 70, 72, 40 columns; the enter's 40 below one tile) and, but for 24
    rows of the enter, in a partial band (45 rows; 41 leaves a one-row last
    tile); at the bench's 1224 x 1024 the exit's last band and column of
    tiles are partial."""
    th, tw = PAIR_TILES[kind]
    for h, w in ((45, 61), (41, 70), (41, 72), (24, 40)):
        (_, _, _, _, cols), n = pair_tile(kind, 1, h, w, -(-w // tw) - 1)
        assert cols < tw
        (_, _, _, rows, _), _ = pair_tile(kind, 1, h, w, n - 1)
        assert (rows < th) == (h % th != 0)
    (_, _, _, rows, _), n = pair_tile(kind, 1, 41, 70, -(-41 // th) * 2 - 1)
    assert rows == 1
    (_, _, _, rows, _), n = pair_tile(kind, 1, 1224, 1024, 10 ** 6)
    assert n == -(-1224 // th) * -(-1024 // tw)
    assert (1224 % th != 0) == (kind == "exit")
    assert (1024 % tw != 0) == (kind == "exit")


# ---------------------------------------------------------------------------
# the mid tile and its reflect fix-up
# ---------------------------------------------------------------------------

def _pair_args(kind, seed=11):
    wa, ba, wb, bb = [t.float() for t in _weights(kind, seed)]
    return wa, ba, "relu", wb, bb, "relu" if kind == "enter" else None


def _tile_out(x, kind, y0, x0, fixup=True):
    """The output tile at (y0, x0) as a block computes it: conv_a over the
    mid tile (output tile + pb each side) from the input rows and columns
    reflected in the load, rounded to x.dtype; with `fixup`, every mid
    position outside the image takes the mid at the reflected position;
    conv_b VALID; cropped to the image."""
    wa, ba, act_a, wb, bb, act_b = _pair_args(kind)
    th, tw = PAIR_TILES[kind]
    pa, pb = wa.shape[-1] // 2, wb.shape[-1] // 2
    _, h, w, _ = x.shape
    mh, mw = th + 2 * pb, tw + 2 * pb
    rows = _reflect(np.arange(y0 - pb - pa, y0 - pb + mh + pa), h)
    cols = _reflect(np.arange(x0 - pb - pa, x0 - pb + mw + pa), w)
    xin = x[:, rows][:, :, cols]
    mid = apply_act(_conv_valid(xin, wa).float() + ba, act_a).to(x.dtype)
    if fixup:
        ry = np.clip(_reflect(np.arange(y0 - pb, y0 - pb + mh), h)
                     - (y0 - pb), 0, mh - 1)
        rx = np.clip(_reflect(np.arange(x0 - pb, x0 - pb + mw), w)
                     - (x0 - pb), 0, mw - 1)
        mid = mid[:, ry][:, :, rx]
    y = apply_act(_conv_valid(mid, wb).float() + bb, act_b).to(x.dtype)
    return y[:, :min(th, h - y0), :min(tw, w - x0)]


def _input(kind, h, w):
    c = 1 if kind == "enter" else 32
    return torch.from_numpy(_rand((2, h, w, c), 12))


# (h, w): a tile walk with interior, border and ragged corner tiles
TILE_IMAGES = {"enter": (37, 200), "exit": (61, 200)}


@pytest.mark.parametrize("kind", sorted(PAIR_TILES))
@pytest.mark.parametrize("where", ["top", "bottom", "left", "right",
                                   "top-left", "bottom-right", "interior"])
def test_mid_tile_with_fixup_is_the_plain_pair(kind, where):
    h, w = TILE_IMAGES[kind]
    th, tw = PAIR_TILES[kind]
    yl, xl = (h - 1) // th * th, (w - 1) // tw * tw
    y0 = {"top": 0, "bottom": yl, "top-left": 0, "bottom-right": yl}.get(
        where, th)
    x0 = {"left": 0, "right": xl, "top-left": 0, "bottom-right": xl}.get(
        where, tw)
    x = _input(kind, h, w)
    want = conv_pair_plain(x, *_pair_args(kind))
    got = _tile_out(x, kind, y0, x0)
    ref = want[:, y0:y0 + got.shape[1], x0:x0 + got.shape[2]]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    if where != "interior":
        # the fix-up is what makes a border tile right
        bad = _tile_out(x, kind, y0, x0, fixup=False)
        assert float((bad - ref).abs().max()) > 1e-2 * float(
            want.abs().max())


def _extended_mid(x, wa, ba, wb, bb, act_b):
    """tests/test_torch_kernels.py's control: conv_a over the input
    reflect-padded by pa + pb, then conv_b VALID."""
    p = wa.shape[-1] // 2 + wb.shape[-1] // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (p,) * 4, mode="reflect")
    mid = apply_act(F.conv2d(xp, wa, ba), "relu")
    return apply_act(F.conv2d(mid, wb, bb), act_b).permute(0, 2, 3, 1)


@pytest.mark.parametrize("kind", sorted(PAIR_TILES))
def test_card_corner_control_misses(kind):
    """The card tests' second control (tests/test_torch_kernels.py
    _corner_unfixed): the plain pair with the extended-input mid on the
    bottom-right tile only, at 45x61 (that tile ragged), misses the plain
    pair by far more than the card's bf16 tolerance (1e-3 of max|y|); the
    no-fix-up emulation of that tile is the extended-input mid there."""
    h, w = 45, 61
    x = _input(kind, h, w)
    args = _pair_args(kind)
    want = conv_pair_plain(x, *args)
    ext = _extended_mid(x, args[0], args[1], args[3], args[4], args[5])
    (_, y0, x0, rows, cols), n = pair_tile(kind, 1, h, w, 0)
    (_, y0, x0, rows, cols), _ = pair_tile(kind, 1, h, w, n - 1)
    assert rows < PAIR_TILES[kind][0] and cols < PAIR_TILES[kind][1]
    np.testing.assert_allclose(_tile_out(x, kind, y0, x0, fixup=False),
                               ext[:, y0:, x0:], rtol=1e-5, atol=1e-5)
    ctl = want.clone()
    ctl[:, y0:, x0:] = ext[:, y0:, x0:]
    assert float((ctl - want).abs().max()) > 1e-2 * float(want.abs().max())
