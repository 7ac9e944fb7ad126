"""The backward of the port's VALID conv on the CPU: the dx and dw kernels'
plain versions against the JAX package, the backward's launch route, and
the kernels' index math emulated.

- `conv_valid_dx_plain` and `conv_valid_dw_plain` (and the wrappers, which
  take them on CPU tensors) against `jax.vjp` of JAX `conv_valid_fast`
  (`ops/pallas/conv_vjp.py:71`, its Pallas forward and dx in interpret
  mode): k 3/5/7, (C_in, C_out) of DeepFuse's layers, ragged 24x40 and
  20x50 outputs, within 1e-4 of the largest value (f32 on both sides; dx
  sums at most 7x7x32 products and dw 2x24x40 per tap, whose rounding stays
  ~1e-6 of the largest value);
- the backward of `conv_valid_fast` makes no `F.pad` call (the zero halo
  is in the dx kernel's loads) and still matches F.conv2d's autograd;
- `valid_plan`: every output pixel computed exactly once, and at the train
  step's launches at most 10 % of the computed positions fall outside the
  output; `dw_plan` partitions the rows;
- the two kernels' walks, stage loads, fragment layouts (ldmatrix with the
  swizzled halves, the weight slots in fragment order, mma.sync m16n8k8 and
  m16n8k16 as the PTX ISA lays them out) and epilogues, emulated in numpy
  with the formulas of csrc/conv_valid.cuh, against the plain versions:
  f32 with the 3xTF32 split within 1e-5 of the largest output (plain TF32,
  hi x hi only, must miss that by 10x), bf16 within 1e-5 (exact products of
  bf16 values summed in float64 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.ops.pallas.conv_vjp import \
    conv_valid_fast as jax_conv_valid_fast
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_valid import (
    DW_CB, DW_QS, TILE_M, TILE_PAIR, conv_valid_dw, conv_valid_dw_plain, conv_valid_dx,
    conv_valid_dx_plain, conv_valid_plain, dw_plan, pick_bn, valid_plan)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_vjp import \
    conv_valid_fast

CHANNELS = [(1, 16), (16, 32), (32, 32), (32, 16), (16, 1)]


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("h,w", [(24, 40), (20, 50)])
@pytest.mark.parametrize("cin,cout", CHANNELS)
@pytest.mark.parametrize("k", [3, 5, 7])
def test_dx_dw_plain_match_jax_vjp(k, cin, cout, h, w):
    r = np.random.RandomState(k * 1000 + cin * 10 + cout + h)
    xp = (r.rand(2, h + k - 1, w + k - 1, cin) - 0.5).astype(np.float32)
    wt = (r.rand(k, k, cin, cout) - 0.5).astype(np.float32)
    cot = (r.rand(2, h, w, cout) - 0.5).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_conv_valid_fast(a, b, k, True),
                     jnp.asarray(xp), jnp.asarray(wt))
    dx_j, dw_j = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    dw_j = np.transpose(dw_j, (3, 2, 0, 1))            # HWIO -> OIHW
    dy, x_t, w_t = torch.from_numpy(cot), torch.from_numpy(xp), _oihw(wt)
    for fn in (conv_valid_dx_plain, conv_valid_dx):
        assert _rel(fn(dy, w_t).numpy(), dx_j) <= 1e-4
    for fn in (conv_valid_dw_plain, conv_valid_dw):
        assert _rel(fn(x_t, dy).numpy(), dw_j) <= 1e-4


def test_backward_makes_no_pad_call(monkeypatch):
    """dx reads the cotangent in place: with F.pad raising, conv_valid_fast's
    backward still gives F.conv2d's gradients (float64)."""
    r = np.random.RandomState(4)
    xp = torch.from_numpy(r.rand(2, 14, 17, 8) - 0.5)
    w = torch.from_numpy(r.rand(16, 8, 5, 5) - 0.5)
    cot = torch.from_numpy(r.rand(2, 10, 13, 16))
    xb, wb = xp.clone().requires_grad_(), w.clone().requires_grad_()
    (F.conv2d(xb.permute(0, 3, 1, 2), wb).permute(0, 2, 3, 1)
     * cot).sum().backward()

    def no_pad(*args, **kw):
        raise AssertionError("F.pad called in the backward")
    monkeypatch.setattr(torch.nn.functional, "pad", no_pad)
    xa, wa = xp.clone().requires_grad_(), w.clone().requires_grad_()
    (conv_valid_fast(xa, wa) * cot).sum().backward()
    assert torch.allclose(xa.grad, xb.grad, atol=1e-10)
    assert torch.allclose(wa.grad, wb.grad, atol=1e-10)


# the train step's launches at 64x64 patches: (h_out, w_out, k) of the
# forwards (64x64) and of the dx (64 + k - 1)
TRAIN_OUTPUTS = [(64, 64, k) for k in (3, 5, 7)] + [
    (64 + k - 1, 64 + k - 1, k) for k in (3, 5, 7)]


def _positions(h_out, w_out, k):
    """Output pixels of each computed position of the conv_valid walk
    (None where it falls outside the output)."""
    tw, pitch, strips, mb = valid_plan(h_out, w_out, k)
    out = []
    for s in range(strips):
        for m in range(mb * TILE_M):
            i, j = divmod(m, pitch)
            ok = j < tw and s * tw + j < w_out and i < h_out
            out.append((i, s * tw + j) if ok else None)
    return out


@pytest.mark.parametrize("h,w,k", TRAIN_OUTPUTS + [
    (20, 50, 3), (1224, 1024, 7), (45, 137, 5), (3, 300, 7), (1, 1, 3)])
def test_valid_plan_covers_each_pixel_once(h, w, k):
    pos = _positions(h, w, k)
    real = [p for p in pos if p is not None]
    assert len(real) == len(set(real)) == h * w
    if (h, w, k) in TRAIN_OUTPUTS or (h, w) == (1224, 1024):
        assert 1.0 - h * w / len(pos) <= 0.10


@pytest.mark.parametrize("b,h,cin,cout,k,slots", [
    (32, 64, 16, 32, 7, 396), (16, 64, 32, 32, 7, 396), (1, 20, 1, 16, 3, 528),
    (2, 306, 1280, 640, 3, 264), (3, 5, 16, 1, 5, 8)])
def test_dw_plan_partitions_rows(b, h, cin, cout, k, slots):
    bn, groups, chunks = dw_plan(b, h, cin, cout, k, slots)
    assert bn == pick_bn(cout)
    assert groups == k * -(-cin // DW_CB) * -(-cout // bn)
    rows = b * h
    bounds = [rows * c // chunks for c in range(chunks + 1)]
    assert bounds[0] == 0 and bounds[-1] == rows
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    assert groups * chunks <= max(slots, groups)      # one wave


# ---- the kernels' index math, emulated ----

LANE = np.arange(32)
G_, T_ = LANE >> 2, LANE & 3


def _tf32(a):
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    a = np.asarray(a, np.float32)
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _product(a, b, bf16, mode):
    """One mma's A @ B as the kernel forms it: bf16 exact; f32 the 3xTF32
    split lo*hi + hi*lo + hi*hi, or plain TF32 (hi*hi) for the control."""
    if bf16:
        return a.astype(np.float64) @ b.astype(np.float64)
    (ah, al), (bh, bl) = _split(a), _split(b)
    ah, al, bh, bl = (v.astype(np.float64) for v in (ah, al, bh, bl))
    if mode == "tf32":
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _a_from_ldsm(rows, bf16):
    """A (16 x k) of mma.sync from ldmatrix.x4 (no trans): `rows` [32][e]
    is the 16 bytes that lane l's row address points at (matrix l // 8, row
    l % 8); thread i's register j is matrix j's row i // 4, 32-bit word i %
    4. f32 m16n8k8: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 =
    A[g+8][t+4]; bf16 m16n8k16: the same with bf16 pairs 2t, 2t+1."""
    if not bf16:
        a = np.zeros((16, 8))
        for j, (r0, c0) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
            a[r0 + G_, c0 + T_] = rows[8 * j + G_, T_]
        return a
    a = np.zeros((16, 16))
    for j, (r0, c0) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
        for e in range(2):
            a[r0 + G_, c0 + 2 * T_ + e] = rows[8 * j + G_, 2 * T_ + e]
    return a


def _wval(w, dx, cc, n, kh, kw, Cc, Cn):
    """B[cc][n] of tap (kh, kw) read as va_load_w reads it: the flat OIHW
    index from the stage's base and the channel, N and tap strides."""
    k = w.shape[-1]
    if cc >= Cc or n >= Cn:
        return 0.0
    kk, ch0, c = k * k, 0, cc
    if dx:
        base, sc, sn, skw = ch0 * Cn * kk + (k - 1 - kh) * k + k - 1, Cn * kk, kk, -1
    else:
        base, sc, sn, skw = ch0 * kk + kh * k, kk, Cc * kk, 1
    v = w.reshape(-1)[base + c * sc + n * sn + kw * skw]
    assert v == (w[cc, n, k - 1 - kh, k - 1 - kw] if dx else w[n, cc, kh, kw])
    return v


def emulate_conv_valid(x, w, bias=None, act=None, dx=False, bf16=False,
                       mode="3xtf32"):
    """conv_valid_tc_kernel's arithmetic with its walk, stage loads, weight
    slots, fragments and epilogue (csrc/conv_valid.cuh), in float64."""
    B, Hin, Win, Cc = x.shape
    K = w.shape[-1]
    Cn = w.shape[1] if dx else w.shape[0]
    Hout, Wout = ((Hin + K - 1, Win + K - 1) if dx
                  else (Hin - K + 1, Win - K + 1))
    tw, P, n_strips, MB = valid_plan(Hout, Wout, K)
    BN = pick_bn(Cn)
    NT, CK = BN // 8, (16 if bf16 else 8)
    EH = CK // 2
    NB, n_chunks, SPIX = -(-Cn // BN), -(-Cc // CK), TILE_M + K - 1
    off = K - 1 if dx else 0
    y = np.zeros((B, Hout, Wout, Cn))
    hits = np.zeros((B, Hout, Wout, Cn), int)
    # a block's item: TILE_PAIR consecutive spatial tiles of one N block
    TS = B * n_strips * MB
    PP = -(-TS // TILE_PAIR)
    tiles = []
    for u in range(NB * PP):
        for sub in range(TILE_PAIR):
            r = u % PP * TILE_PAIR + sub
            if r < TS:
                tiles.append((u // PP * BN, r))
    for n0, r in tiles:
        m0 = r % MB * TILE_M
        r //= MB
        x0, b = r % n_strips * tw, r // n_strips
        acc = np.zeros((TILE_M // 16, 16, BN))
        for c in range(n_chunks):
            for kh in range(K):
                slot = np.zeros((SPIX, 2, EH))        # physical halves
                for p in range(SPIX):
                    q = m0 + kh * P + p
                    rr, cc = q // P - off, x0 + q % P - off
                    for h in range(2):
                        ch = c * CK + h * EH
                        if 0 <= rr < Hin and 0 <= cc < Win and ch < Cc:
                            v = x[b, rr, cc, ch:ch + EH]
                            slot[p, h ^ ((p >> 2) & 1), :len(v)] = v
                # the weight slot as va_store_w fills it: value idx =
                # (n, c, kw), kw fastest, to entry (kw, nt, lane), word
                # (f32: b0 / b1) or half-word (bf16)
                slot_w = np.full((K * NT * 32, 4), np.nan)
                for idx in range(K * CK * BN):
                    kw, cl, nl = idx % K, idx // K % CK, idx // (K * CK)
                    g, nt = nl & 7, nl >> 3
                    v = _wval(w, dx, c * CK + cl, n0 + nl, kh, kw, Cc, Cn)
                    if not bf16:
                        entry = (kw * NT + nt) * 32 + g * 4 + (cl & 3)
                        slot_w[entry, cl >> 2] = v
                    else:
                        entry = (kw * NT + nt) * 32 + g * 4 + ((cl & 7) >> 1)
                        slot_w[entry, (cl >> 3) * 2 + (cl & 1)] = v
                # B (k x 8) of each (kw, n tile) from the lanes' fragments
                bmat = np.zeros((K, NT, CK, 8))
                for kw in range(K):
                    for nt in range(NT):
                        fr = slot_w[(kw * NT + nt) * 32 + LANE]
                        if not bf16:
                            bmat[kw, nt, T_, G_] = fr[:, 0]
                            bmat[kw, nt, T_ + 4, G_] = fr[:, 1]
                        else:
                            for e in range(2):
                                bmat[kw, nt, 2 * T_ + e, G_] = fr[:, e]
                                bmat[kw, nt, 2 * T_ + 8 + e, G_] = fr[:, 2 + e]
                assert not np.isnan(bmat).any()
                for wid in range(TILE_M // 16):
                    for kw in range(K):
                        p = wid * 16 + (LANE & 7) + ((LANE >> 3) & 1) * 8 + kw
                        half = LANE >> 4
                        rows = slot[p, half ^ ((p >> 2) & 1)]
                        a = _a_from_ldsm(rows, bf16)
                        for nt in range(NT):
                            acc[wid, :, nt * 8:nt * 8 + 8] += _product(
                                a, bmat[kw, nt], bf16, mode)
        # epilogue: thread (g, t) holds D[g (+8)][2t, 2t + 1]
        for wid in range(TILE_M // 16):
            for row in range(16):
                m = m0 + wid * 16 + row
                i, j = divmod(m, P)
                if j >= tw or x0 + j >= Wout or i >= Hout:
                    continue
                for col in range(BN):
                    n = n0 + col
                    if n < Cn:
                        v = acc[wid, row, col] + (0.0 if bias is None
                                                  else bias[n])
                        y[b, i, x0 + j, n] = v
                        hits[b, i, x0 + j, n] += 1
    assert (hits == 1).all()
    return apply_np_act(y, act)


def apply_np_act(y, act):
    if act == "relu":
        return np.maximum(y, 0.0)
    if act == "tanh":
        return np.tanh(y)
    assert act is None
    return y


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _case(seed, b, h, w, cin, cout, k, dx, bf16):
    r = np.random.RandomState(seed)
    if dx:
        x = (r.rand(b, h, w, cout) - 0.5).astype(np.float32)
    else:
        x = (r.rand(b, h + k - 1, w + k - 1, cin) - 0.5).astype(np.float32)
    wt = ((r.rand(cout, cin, k, k) - 0.5) * 0.4).astype(np.float32)
    return (_bf16(x), _bf16(wt)) if bf16 else (x, wt)


# (b, h, w, cin, cout, k): DeepFuse-like widths at a small size, the thin
# layers, a channel count that is not a multiple of 16 bytes, two N
# blocks, and an output wider than one strip
EMU_CASES = [(1, 6, 9, 16, 32, 3), (1, 5, 7, 1, 16, 5), (1, 4, 6, 16, 1, 7),
             (1, 3, 5, 6, 40, 3), (1, 2, 150, 8, 8, 3)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dx", [False, True])
@pytest.mark.parametrize("b,h,w,cin,cout,k", EMU_CASES)
def test_conv_valid_kernel_emulated(b, h, w, cin, cout, k, dx, bf16):
    x, wt = _case(cin * 7 + cout + k, b, h, w, cin, cout, k, dx, bf16)
    xt, wtt = torch.from_numpy(x).double(), torch.from_numpy(wt).double()
    want = (conv_valid_dx_plain(xt, wtt) if dx
            else conv_valid_plain(xt, wtt)).numpy()
    got = emulate_conv_valid(x, wt, dx=dx, bf16=bf16)
    assert _rel(got, want) <= 1e-5
    if not bf16 and max(cin, cout) >= 16:
        # plain TF32 would miss the f32 budget
        assert _rel(emulate_conv_valid(x, wt, dx=dx, mode="tf32"),
                    want) > 1e-4


def test_conv_valid_kernel_emulated_epilogue():
    x, wt = _case(9, 1, 5, 7, 8, 16, 5, False, False)
    bias = np.linspace(-0.3, 0.3, 16)
    want = conv_valid_plain(torch.from_numpy(x).double(),
                            torch.from_numpy(wt).double(),
                            torch.from_numpy(bias), "tanh").numpy()
    got = emulate_conv_valid(x, wt, bias, "tanh")
    assert _rel(got, want) <= 1e-5


def emulate_conv_valid_dw(xp, dy, bf16=False, slots=1, mode="3xtf32"):
    """conv_valid_dw_kernel's arithmetic with its grid, stage loads,
    fragments, partial slices and chunk-ordered reduction, in float64."""
    B, Hp, Wp, Cin = xp.shape
    _, H, W, Cout = dy.shape
    K = Hp - H + 1
    bn, groups, chunks = dw_plan(B, H, Cin, Cout, K, slots)
    NT, n_cb = bn // 8, -(-Cin // DW_CB)
    CSX, CSD, XPIX = DW_CB + 8, (8 if bn == 8 else bn + 8), DW_QS + K - 1
    rows, n_seg = B * H, -(-W // DW_QS)
    kstep = 16 if bf16 else 8
    dw = np.full((Cout, Cin, K, K), np.nan)
    for group in range(groups):
        kh, cb, nb = group % K, group // K % n_cb, group // K // n_cb
        c0, n0 = cb * DW_CB, nb * bn
        parts = []
        for chunk in range(chunks):
            acc = np.zeros((K, DW_CB, bn))
            for row in range(rows * chunk // chunks,
                             rows * (chunk + 1) // chunks):
                b, i = divmod(row, H)
                for seg in range(n_seg):
                    j0 = seg * DW_QS
                    xs, ds = np.zeros((XPIX, CSX)), np.zeros((DW_QS, CSD))
                    for p in range(XPIX):
                        if j0 + p < Wp:
                            v = xp[b, i + kh, j0 + p, c0:c0 + DW_CB]
                            xs[p, :len(v)] = v
                    for p in range(DW_QS):
                        if j0 + p < W:
                            v = dy[b, i, j0 + p, n0:n0 + bn]
                            ds[p, :len(v)] = v
                    for kw in range(K):
                        for k0 in range(0, DW_QS, kstep):
                            a = np.zeros((16, kstep))
                            bm = np.zeros((NT, kstep, 8))
                            if not bf16:
                                px = k0 + T_ + kw
                                a[G_, T_] = xs[px, G_]
                                a[G_ + 8, T_] = xs[px, G_ + 8]
                                a[G_, T_ + 4] = xs[px + 4, G_]
                                a[G_ + 8, T_ + 4] = xs[px + 4, G_ + 8]
                                for nt in range(NT):
                                    bm[nt, T_, G_] = ds[k0 + T_, nt * 8 + G_]
                                    bm[nt, T_ + 4, G_] = ds[k0 + T_ + 4,
                                                            nt * 8 + G_]
                            else:
                                # ldmatrix.trans: thread i of matrix j gets
                                # column i // 4 of rows 2(i % 4), + 1
                                ap = kw + ((LANE >> 4) << 3) + (LANE & 7)
                                ac = ((LANE >> 3) & 1) * 8
                                for j, (r0, cl) in enumerate(
                                        [(0, 0), (8, 0), (0, 8), (8, 8)]):
                                    for e in range(2):
                                        src = 8 * j + 2 * T_ + e
                                        a[r0 + G_, cl + 2 * T_ + e] = xs[
                                            k0 + ap[src], ac[src] + G_]
                                bp = LANE & 15
                                for nt in range(NT):
                                    for j in range(2):
                                        for e in range(2):
                                            src = 8 * j + 2 * T_ + e
                                            bm[nt, 8 * j + 2 * T_ + e, G_] = \
                                                ds[k0 + bp[src], nt * 8 + G_]
                            for nt in range(NT):
                                acc[kw, :, nt * 8:nt * 8 + 8] += _product(
                                    a, bm[nt], bf16, mode)
            parts.append(acc.astype(np.float32))    # the partial slice
        total = np.zeros((K, DW_CB, bn), np.float64)
        for part in parts:                           # chunk order
            total += part
        for kw in range(K):
            for cl in range(DW_CB):
                for n in range(bn):
                    co, ci = n0 + n, c0 + cl
                    if co < Cout and ci < Cin:
                        dw[co, ci, kh, kw] = total[kw, cl, n]
    assert not np.isnan(dw).any()
    return dw


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,h,w,cin,cout,k,slots", [
    (2, 3, 9, 16, 32, 3, 3), (1, 4, 70, 1, 16, 5, 10), (2, 2, 5, 16, 1, 7, 21),
    (1, 3, 6, 20, 8, 3, 6)])
def test_conv_valid_dw_kernel_emulated(b, h, w, cin, cout, k, slots, bf16):
    r = np.random.RandomState(cin + cout + k)
    xp = (r.rand(b, h + k - 1, w + k - 1, cin) - 0.5).astype(np.float32)
    dy = (r.rand(b, h, w, cout) - 0.5).astype(np.float32)
    if bf16:
        xp, dy = _bf16(xp), _bf16(dy)
    want = conv_valid_dw_plain(torch.from_numpy(xp).double(),
                               torch.from_numpy(dy).double()).numpy()
    got = emulate_conv_valid_dw(xp, dy, bf16, slots)
    assert _rel(got, want) <= 1e-5
    if not bf16 and cin >= 16:
        assert _rel(emulate_conv_valid_dw(xp, dy, False, slots, "tf32"),
                    want) > 1e-4
