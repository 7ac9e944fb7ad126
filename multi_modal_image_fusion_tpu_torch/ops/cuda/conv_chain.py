"""Reflect-SAME conv kernels of the serving chain, with their plain versions.

Three wrappers, all NHWC, f32 accumulation:

- `conv_chain(x, weight, bias, act, fuse_n)` (csrc/conv_chain.cu) replaces
  the TPU kernel `ops/pallas/hiw_kernel.py:335 conv_hiw_chain`: a k x k
  reflect-SAME conv with bias and activation; with `fuse_n > 0` the input
  holds 2n images and the kernel convolves x[i] + x[i+n] (the siamese 'sum'
  fusion in the load). Its kernel takes a list of input legs;
  `conv_multi.py` launches the same kernel with several
  (`hiw_kernel.py:619 conv_hiw_chain_multi`).
- `conv_gray_enter(img1, img2, weight, ...)` (csrc/conv_gray.cu) replaces
  `ops/pallas/conv_kernel.py:357 _chain_enter_gray` (reached by
  `hiw_enter`) together with the entry conv: it reads the grayscale
  images directly, so the concat, the cast to the chain dtype and the
  reflect halo all happen in its load. Two modes, by the weight's input
  channels: a c_in=1 conv over img1 and img2 as batch halves with shared
  weights (the siamese fold), or a c_in=2 conv over img1 and img2 as the
  two channels of one input (PMGI's entry convs over concat(i, i, j), the
  duplicate's weights summed: JAX models/zoo.py:1521-1526).
- `conv_gray_exit(x, weight, ...)` (csrc/conv_gray.cu) replaces
  `ops/pallas/conv_kernel.py:383 _chain_exit_gray` (reached by `hiw_exit`)
  together with the c_out=1 exit conv, writing (B, H, W, 1) directly. x is
  one tensor or a list of legs [(tensor, b_off), ...] whose channel concat
  is the conv's input (PMGI's decode over 8 legs), read in place.

What bounds them on an H100 and what the design does about it is in the
headers of csrc/conv_chain.cu, csrc/conv_chain.cuh and csrc/conv_gray.cu:
the wide layers are bound by arithmetic; in bf16 `conv_chain` and
`conv_multi` run a `wgmma` implicit GEMM on the tensor cores with an
asynchronous copy ring (`pack_weights_tc` packs its weights, `pick_bn_tc`
picks its block of output channels), in f32 register-blocked FMAs on the
CUDA cores. The thin enter/exit layers are bound by bytes: in bf16 their
products run on `mma.sync` (weights packed as B fragments by
`pack_gray_enter` and `pack_gray_exit`), in f32 on FMAs, both on a
persistent grid with a `cp.async` ring and coalesced stores (tiles:
`GRAY_TILES`).

Each wrapper takes its plain version (`*_plain`, F.pad + F.conv2d in f32;
the weight, and conv_chain's fuse_n sum, rounded to the input's dtype
first, as the JAX kernel does) only for CPU tensors. A CUDA tensor
launches the kernel or raises; there is no fallback. The kernels are
forward-only: on a CUDA tensor with grad mode on and an input, weight or
bias that requires grad, the wrappers raise (training goes through
ops/cuda/conv_vjp.py). They are built for
what the ported models launch: `conv_chain` k1, k3 (DenseFuse, VIFNet,
SEDRFuse's 256-channel ResBlock), k5 and k7 (DeepFuse), `conv_gray_enter`
k1 (NestFuse, RFNNest, MAFusion), k3,
k5 and k7 (IFCNN's enc0) with one input channel and k5 with two (PMGI),
`conv_gray_exit` k1 (UNFusion, NestFuse, RFNNest, MAFusion, PMGI), k3 and
k5 (any Cin on one tensor; legs of a multiple of 8 channels each), output
channels a multiple of 16 (but the exit's 1), input and output in one
dtype. The wrappers raise on anything else.
"""

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle

__all__ = ["ACT_CODES", "CO_TILE", "apply_act", "chain_weights", "conv_chain",
           "conv_chain_plain", "conv_gray_enter", "conv_gray_enter_plain",
           "conv_gray_exit", "conv_gray_exit_plain", "ENTER_KSIZES",
           "ENTER_LEGS_KSIZES", "GRAY_TILES", "gray_legs_input", "gray_tile",
           "gray_weights", "pack_gray_enter", "pack_gray_exit",
           "pack_weights_tc", "pick_bn_tc", "tc_plan", "tc_weight_index"]

# epilogue activations the kernels fuse (csrc/common.cuh Act; the TPU
# kernels' _apply_act, ops/pallas/conv_kernel.py:43)
ACT_CODES = {None: 0, "relu": 1, "relu6": 2, "lrelu": 3, "tanh": 4}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CO_TILE = 16           # output channels per block (csrc/conv_chain.cu)
_GRID_Z_MAX = 65535

_I = ctypes.c_int
_P = ctypes.c_void_p


def apply_act(y, act):
    """The fused epilogue activation (f32, before the output cast)."""
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if act == "lrelu":
        return F.leaky_relu(y, 0.2)
    if act == "tanh":
        return torch.tanh(y)
    raise ValueError(f"unfusable activation {act!r}")


def batch_step(h, w, channels, k):
    """Images per chunk so that one chunk's reflect-padded input and output
    stay under 2^31 elements: torch's reflect pad indexes with 32 bits."""
    p = k // 2
    return max(1, (2 ** 31 - 1) // ((h + 2 * p) * (w + 2 * p) * channels))


def _conv_nhwc_f32(x, weight, bias, groups=1):
    """f32 reflect-SAME conv of an NHWC tensor (OIHW weight), in batch
    chunks of `batch_step` images."""
    k = weight.shape[-1]
    p = k // 2
    b, h, w, c = x.shape
    step = batch_step(h, w, max(c, weight.shape[0]), k)
    wf = weight.float()
    bf = None if bias is None else bias.float()
    outs = []
    for i in range(0, b, step):
        xn = F.pad(x[i:i + step].float().permute(0, 3, 1, 2), (p, p, p, p),
                   mode="reflect")
        outs.append(F.conv2d(xn, wf, bf, groups=groups).permute(0, 2, 3, 1))
    return torch.cat(outs) if len(outs) > 1 else outs[0].contiguous()


def conv_chain_plain(x, weight, bias=None, act=None, fuse_n=0):
    """Plain version of conv_chain, the JAX kernel's function in x.dtype:
    the fuse_n sum and the weight rounded to x.dtype (hiw_kernel.py:297,
    :387), the conv, bias and activation in f32, the cast back. In f32 the
    rounding changes nothing."""
    if fuse_n:
        x = x[:fuse_n] + x[fuse_n:]
    return apply_act(_conv_nhwc_f32(x, weight.to(x.dtype), bias),
                     act).to(x.dtype)


def conv_gray_enter_plain(img1, img2, weight, bias=None, act="relu"):
    """Plain version of conv_gray_enter, the JAX chain's function in the
    images' dtype: the weight rounded to it (hiw_kernel.py:387), the conv,
    bias and activation in f32, the cast back. A c_in=2 weight convolves
    the channel concat of img1 and img2."""
    if weight.shape[1] == 2:
        x = torch.cat([img1, img2], dim=-1)
    else:
        x = img1 if img2 is None else torch.cat([img1, img2], dim=0)
    return apply_act(_conv_nhwc_f32(x, weight.to(x.dtype), bias),
                     act).to(x.dtype)


def gray_legs_input(legs):
    """The channel concat of legs [(tensor, b_off), ...] at their batch
    offsets, as many images as every leg can feed (conv_gray_exit's input
    over legs, which the kernel never builds)."""
    n = min(t.shape[0] - off for t, off in legs)
    return torch.cat([t[off:off + n] for t, off in legs], dim=-1)


def conv_gray_exit_plain(x, weight, bias=None, act=None):
    """Plain version of conv_gray_exit, in x.dtype as conv_gray_enter_plain
    is in the images'; x one tensor or a list of legs (their concat)."""
    if isinstance(x, (list, tuple)):
        x = gray_legs_input(x)
    return apply_act(_conv_nhwc_f32(x, weight.to(x.dtype), bias),
                     act).to(x.dtype)


def check_tensors(name, tensors):
    """The CUDA wrappers' contract on activations: one CUDA device, f32 or
    bf16, contiguous 4-D (NHWC), 16-byte aligned."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on the same "
                             f"CUDA device")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported "
                            f"(float32 or bfloat16)")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous NHWC tensors, got "
                             f"shape {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def _check_cuda_args(name, tensors, weight, bias, h, w, ksizes):
    check_tensors(name, tensors)
    dev = tensors[0].device
    if weight.dim() != 4 or weight.shape[2] != weight.shape[3]:
        raise ValueError(f"{name}: weight must be OIHW with square taps, "
                         f"got {tuple(weight.shape)}")
    k = weight.shape[-1]
    if k not in ksizes:
        raise ValueError(f"{name}: kernel size {k} not built "
                         f"(one of {ksizes})")
    if h <= k // 2 or w <= k // 2:
        raise ValueError(f"{name}: reflect padding {k // 2} needs H and W "
                         f"above it, got {h}x{w}")
    if weight.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"{name}: weight and bias must be on {dev}")
    return k


def weights_f32(weight, bias):
    """OIHW -> [Cin][K][K][Cout] f32 for the kernels' weight slices."""
    wk = weight.detach().permute(1, 2, 3, 0).float().contiguous()
    bk = None if bias is None else bias.detach().float().contiguous()
    return wk, bk


# The bf16 wgmma body (csrc/conv_chain.cuh): its N blocks, tile geometry
# and shared-memory plan, mirrored here to pick the block and pack weights.
TC_BNS = (256, 128, 96, 64, 48, 32, 16)
_TC_CK = 16                 # input channels a k-step
_TC_WG, _TC_TW = 2, 64      # warpgroups a block, pixels an m-tile
_TC_SMEM_MAX = 232448
# cycles of one ring stage's barrier, waits and copy issue, shared by the
# rows of a tile; fitted to UNFusion's k1 convs on an H100 (16 pairs): EB4_2
# conv1 at N 96 1.02 ms against 1.43 at N 48, EB4_3 conv1 at N 128 3.74
# against 4.53 at N 96
_TC_STAGE = 512


def _tc_mt(bn):
    return 1 if bn >= 256 else 2 if bn >= 96 else min(8, 128 // bn)


def tc_plan(k, bn, ks, fuse_n=0):
    """(resident, ring, shared bytes, pair) of conv_chain.cuh tc_plan for
    kernel size k, N block bn and ks k-steps: the layer's weights resident
    beside the deepest ring (4, 3 or 2 input stages) and the output tile
    that fit, else the weights in the ring; with fuse_n, the first such
    plan whose ring slots hold both halves of the pair (pair = 1: summed in
    shared memory), else one half (pair = 0: summed in registers); None if
    nothing fits."""
    th = _TC_WG * _tc_mt(bn)
    in_h, in_w = th + k - 1, _TC_TW + k - 1
    in_tile = 2 * (-(-in_h * in_w * 16 // 128) * 128 + 64)
    w_bytes = k * k * bn * 32
    out_bytes = th * _TC_TW * (2 * bn + 16)
    for pair in ((1, 0) if fuse_n else (0,)):
        in_bytes = in_tile * (1 + pair)
        for resident in (1, 0):
            for ring in (4, 3, 2):
                smem = ring * (in_bytes + (0 if resident else w_bytes)) \
                    + (ks * w_bytes if resident else 0) + out_bytes
                if smem <= _TC_SMEM_MAX:
                    return resident, ring, smem, pair
    return None


def _ksteps(cins):
    return [-(-c // _TC_CK) for c in cins]


def pick_bn_tc(cout, cins, k, fuse_n=0):
    """The bf16 body's block of output channels (one of TC_BNS), by a cost
    per 64 output pixels and k-step of ceil(cout / bn) blocks, each k * k
    wgmmas of max(bn / 2, 16 + bn / 4) cycles (the tensor cores, or the
    shared memory that feeds them 2 KB of A and bn * 32 bytes of B a
    wgmma), half again when the weights cannot stay resident, plus a
    stage's fixed cycles (_TC_STAGE) over the tile's rows; the larger on a
    tie. Each block's plan is tc_plan's for the layer's fuse_n."""
    ks = sum(_ksteps(cins))
    best = None
    for bn in TC_BNS:
        plan = tc_plan(k, bn, ks, fuse_n)
        if plan is None:
            continue
        cost = -(-cout // bn) * (
            k * k * max(bn / 2, 16 + bn / 4) * (1.0 if plan[0] else 1.5)
            + _TC_STAGE / (_TC_WG * _tc_mt(bn)))
        if best is None or cost < best[0]:
            best = (cost, bn)
    if best is None:
        raise ValueError(f"conv_chain: no bf16 block fits k{k} with {ks} "
                         f"k-steps")
    return best[1]


def tc_weight_index(k, bn, ks_total, co, ks, j, kh, kw):
    """Element index in `pack_weights_tc`'s output of output channel co,
    k-step ks, channel j (0-15) of the k-step and tap (kh, kw): the
    kernel's [Cout_pad / bn][KS][k * k][half][bn][8] layout."""
    nb, n = divmod(co, bn)
    return ((((nb * ks_total + ks) * k * k + kh * k + kw) * 2 + j // 8)
            * bn + n) * 8 + j % 8


def pack_weights_tc(weight, cins, bn):
    """OIHW (c_out, sum cins, k, k) -> the bf16 body's flat bf16 weights:
    each leg's channels zero-padded to whole 16-channel k-steps, c_out to a
    multiple of bn, laid out as `tc_weight_index` reads them."""
    cout, _, k, _ = weight.shape
    wq = weight.detach().to(torch.bfloat16)
    blocks, ofs = [], 0
    for c, n in zip(cins, _ksteps(cins)):
        blocks.append(F.pad(wq[:, ofs:ofs + c], (0, 0, 0, 0, 0,
                                                 n * _TC_CK - c)))
        ofs += c
    wp = F.pad(torch.cat(blocks, 1), (0, 0, 0, 0, 0, 0, 0, -cout % bn))
    nnb, ks = wp.shape[0] // bn, wp.shape[1] // _TC_CK
    wp = wp.reshape(nnb, bn, ks, 2, 8, k, k).permute(0, 2, 5, 6, 3, 1, 4)
    return wp.contiguous().reshape(-1)


# csrc/conv_gray.cu's tiles: (output rows, output pixels a row)
GRAY_TILES = {"enter": (4, 128), "exit": (8, 128)}


def gray_tile(kind, b_out, h, w, tile):
    """(image, first row, first column, rows, pixels) of output tile `tile`
    of conv_gray.cu's rule for `kind` ('enter' or 'exit'), x fastest, and
    the tile count: the last tile of a row or band is ragged where H or W
    is not a multiple of GRAY_TILES[kind]."""
    th, tw = GRAY_TILES[kind]
    ty, tx = -(-h // th), -(-w // tw)
    b, r = divmod(tile, ty * tx)
    y0, x0 = r // tx * th, r % tx * tw
    return (b, y0, x0, min(th, h - y0), min(tw, w - x0)), b_out * ty * tx


def _enter_lanes(k):
    """(parity, tap pair q, lane, element) -> (kh, kw) of the enter's B
    fragments that hold a tap (the others are zero): lane (g, t) holds
    B[2t, 2t+1][g] and B[2t+8, 2t+9][g] (common.cuh mma_bf16), B[j][co] =
    w[co][2q + j // 8][j % 8 - d] with d = Q - k // 2 the window shift of
    even (QE) or odd (QO) pixels (csrc/conv_gray.cu EnGeom)."""
    p = k // 2
    qs = (p + (p & 1), p + 1 - (p & 1))
    out = {}
    for par in range(2):
        for q in range((k + 1) // 2):
            for lane in range(32):
                t = lane % 4
                for e in range(4):
                    j = 2 * t + (e & 1) + 8 * (e >> 1)
                    kh, kw = 2 * q + j // 8, j % 8 - (qs[par] - p)
                    if kh < k and 0 <= kw < k:
                        out[par, q, lane, e] = (kh, kw)
    return out


@functools.lru_cache(maxsize=64)
def _gray_index(kind, k, c, device):
    """Flat indices into a weight (OIHW, flattened, a zero appended) that
    give pack_gray_enter's or pack_gray_exit's layout."""
    if kind == "enter":
        cout, zero = c, c * k * k
        nq = (k + 1) // 2
        idx = np.full((2, nq, cout // 8, 32, 4), zero, np.int64)
        for (par, q, lane, e), (kh, kw) in _enter_lanes(k).items():
            for nt in range(cout // 8):
                co = nt * 8 + lane // 4
                idx[par, q, nt, lane, e] = (co * k + kh) * k + kw
    else:
        cin, zero = c, c * k * k
        ks = -(-cin // 16)
        idx = np.full((ks, k, 32, 4), zero, np.int64)
        for s in range(ks):
            for kh in range(k):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for e in range(4):
                        ci = 16 * s + 2 * t + (e & 1) + 8 * (e >> 1)
                        if ci < cin and g < k:
                            idx[s, kh, lane, e] = (ci * k + kh) * k + g
    return torch.from_numpy(idx.reshape(-1)).to(device)


def _gather(weight, kind, c):
    flat = F.pad(weight.detach().to(torch.bfloat16).reshape(-1), (0, 1))
    return flat[_gray_index(kind, weight.shape[-1], c, flat.device)]


def pack_gray_enter(weight):
    """(Cout, L, K, K), L = 1 or 2 input channels (gray legs) ->
    conv_gray_enter's bf16 B fragments, flat [parity][L][(K + 1) / 2][Cout /
    8][lane][4]: for even (parity 0) and odd pixels, leg l, tap pair q, N
    tile nt and lane (g, t), the weights of output channel nt * 8 + g at
    rows j = 2t, 2t+1, 2t+8, 2t+9 of the pair's B (`_enter_lanes`), zero
    outside the taps."""
    cout, legs = weight.shape[:2]
    return torch.stack([
        _gather(weight[:, l:l + 1], "enter", cout).view(2, -1)
        for l in range(legs)], dim=1).reshape(-1)


def pack_gray_exit(weight):
    """(1, Cin, K, K) -> conv_gray_exit's bf16 B fragments, flat
    [ceil(Cin / 16)][K][lane][4]: for k-step s, kernel row kh and lane (g,
    t), w[ci][kh][g] at ci = 16 s + 2t, 2t+1, 2t+8, 2t+9 (N = kw = g), zero
    past Cin and past the K taps."""
    return _gather(weight, "exit", weight.shape[1])


def gray_weights(kind, weight, bias, dtype):
    """conv_gray_enter's or conv_gray_exit's weights and bias: bf16 packed
    as B fragments (`pack_gray_enter`, `pack_gray_exit`); f32 [L][K][K]
    [Cout] for the enter (L gray legs), [ceil(Cin / 8)][K][K][8]
    (zero-padded channels) for the exit. The bias in f32."""
    bk = None if bias is None else bias.detach().float().contiguous()
    if dtype == torch.bfloat16:
        pack = pack_gray_enter if kind == "enter" else pack_gray_exit
        return pack(weight), bk
    if kind == "enter":
        return weights_f32(weight, None)[0], bk
    _, cin, k, _ = weight.shape
    w0 = weight.detach()[0].float()
    if cin % 8:
        w0 = F.pad(w0, (0, 0, 0, 0, 0, -cin % 8))
    return w0.reshape(-1, 8, k, k).permute(0, 2, 3, 1).contiguous(), bk


def chain_weights(weight, bias, cins, dtype, fuse_n=0):
    """The conv_chain kernel's weights, bias and N block: bf16 packed for
    the wgmma body (`pack_weights_tc`, `pick_bn_tc` for the layer's
    fuse_n), f32 [Cin][K][K][Cout] for the FMA body (N block 0, unused)."""
    if dtype == torch.bfloat16:
        bn = pick_bn_tc(weight.shape[0], cins, weight.shape[-1], fuse_n)
        bk = None if bias is None else bias.detach().float().contiguous()
        return pack_weights_tc(weight, cins, bn), bk, bn
    return (*weights_f32(weight, bias), 0)


def act_code(act):
    if act not in ACT_CODES:
        raise ValueError(f"unfusable activation {act!r}")
    return ACT_CODES[act]


def conv_chain(x, weight, bias=None, act=None, fuse_n=0):
    """Reflect-SAME conv: x (B, H, W, Cin) NHWC, weight OIHW (Cout, Cin, K,
    K) -> (B_out, H, W, Cout) in x.dtype, B_out = fuse_n or B. fuse_n > 0:
    x holds 2*fuse_n images and output i is conv(x[i] + x[i + fuse_n])."""
    if x.device.type == "cpu":
        return conv_chain_plain(x, weight, bias, act, fuse_n)
    check_no_grad("conv_chain", x, weight, bias)
    b_in, h, w, cin = x.shape
    k = _check_cuda_args("conv_chain", [x], weight, bias, h, w,
                          (1, 3, 5, 7))
    cout = weight.shape[0]
    if weight.shape[1] != cin:
        raise ValueError(f"conv_chain: weight takes {weight.shape[1]} input "
                         f"channels, x has {cin}")
    if cout % CO_TILE:
        raise ValueError(f"conv_chain: Cout must be a multiple of "
                         f"{CO_TILE}, got {cout}")
    if fuse_n and b_in != 2 * fuse_n:
        raise ValueError(f"conv_chain: fuse_n={fuse_n} needs {2 * fuse_n} "
                         f"input images, got {b_in}")
    b_out = fuse_n or b_in
    if b_out * (cout // CO_TILE) > _GRID_Z_MAX:
        raise ValueError(f"conv_chain: batch {b_out} too large for one "
                         f"launch")
    wk, bk, bn = chain_weights(weight, bias, [cin], x.dtype, fuse_n)
    y = torch.empty((b_out, h, w, cout), dtype=x.dtype, device=x.device)
    fn = kernel_function("mmif_conv_chain",
                         [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P])
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], ptr(x), ptr(wk), ptr(bk), ptr(y),
                 b_out, h, w, cin, cout, k, bn, fuse_n, act_code(act),
                 stream_handle(x.device))
    check_launch("conv_chain", err)
    return y


ENTER_KSIZES = (1, 3, 5, 7)   # one gray input channel
ENTER_LEGS_KSIZES = (5,)      # two gray legs (PMGI)


def conv_gray_enter(img1, img2, weight, bias=None, act="relu"):
    """Entry conv of the chain on gray images img1 (B, H, W, 1) and the
    optional img2 (same shape and dtype), in the images' dtype. Weight
    (Cout, 1, K, K): the siamese mode, img1 and img2 as batch halves ->
    (B or 2B, H, W, Cout), img1's batch first. Weight (Cout, 2, K, K): the
    two-leg mode, img1 and img2 as the two input channels -> (B, H, W,
    Cout)."""
    if img1.device.type == "cpu":
        if weight.shape[1] == 2 and img2 is None:
            raise ValueError("conv_gray_enter: two gray legs need img2")
        return conv_gray_enter_plain(img1, img2, weight, bias, act)
    check_no_grad("conv_gray_enter", img1, img2, weight, bias)
    b, h, w, c = img1.shape
    imgs = [img1] if img2 is None else [img1, img2]
    legs = weight.shape[1] if weight.dim() == 4 else 0
    if legs == 2 and img2 is None:
        raise ValueError("conv_gray_enter: two gray legs need img2")
    k = _check_cuda_args("conv_gray_enter", imgs, weight, bias, h, w,
                          ENTER_LEGS_KSIZES if legs == 2 else ENTER_KSIZES)
    cout = weight.shape[0]
    if c != 1 or legs not in (1, 2):
        raise ValueError("conv_gray_enter: inputs must have one channel and "
                         "the weight one or two")
    if img2 is not None and img2.shape != img1.shape:
        raise ValueError("conv_gray_enter: img1 and img2 shapes differ")
    if img2 is not None and img2.dtype != img1.dtype:
        raise TypeError("conv_gray_enter: img1 and img2 dtypes differ")
    if cout % CO_TILE:
        raise ValueError(f"conv_gray_enter: Cout must be a multiple of "
                         f"{CO_TILE}, got {cout}")
    b_out = b if legs == 2 else b * len(imgs)
    wk, bk = gray_weights("enter", weight, bias, img1.dtype)
    y = torch.empty((b_out, h, w, cout), dtype=img1.dtype,
                    device=img1.device)
    fn = kernel_function("mmif_conv_gray_enter" if legs == 1
                         else "mmif_conv_gray_enter_legs",
                         [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P])
    with torch.cuda.device(img1.device):
        err = fn(DTYPE_CODES[img1.dtype], ptr(img1), ptr(img2), ptr(wk),
                 ptr(bk), ptr(y), b, h, w, cout, k, act_code(act),
                 stream_handle(img1.device))
    check_launch("conv_gray_enter", err)
    return y


EXIT_MAX_LEGS = 8      # csrc/conv_gray.cu EX_MAX_LEGS


def _exit_legs(x):
    """conv_gray_exit's input as (legs, output images): one tensor is one
    leg at offset 0; legs each a multiple of 8 channels (a staged half of
    a k-step never straddles two legs)."""
    if not isinstance(x, (list, tuple)):
        return [(x, 0)], x.shape[0]
    legs = [(t, int(off)) for t, off in x]
    if not 1 <= len(legs) <= EXIT_MAX_LEGS:
        raise ValueError(f"conv_gray_exit: 1 to {EXIT_MAX_LEGS} legs, got "
                         f"{len(legs)}")
    x0 = legs[0][0]
    for t, off in legs:
        if t.shape[1:3] != x0.shape[1:3] or t.dtype != x0.dtype:
            raise ValueError("conv_gray_exit: legs differ in H, W or dtype")
        if t.shape[-1] % 8:
            raise ValueError(f"conv_gray_exit: a leg of {t.shape[-1]} "
                             f"channels (legs take multiples of 8)")
        if not 0 <= off < t.shape[0]:
            raise ValueError(f"conv_gray_exit: offset {off} past a leg of "
                             f"{t.shape[0]} images")
    return legs, min(t.shape[0] - off for t, off in legs)


def conv_gray_exit(x, weight, bias=None, act=None):
    """c_out=1 exit conv of the chain: x (B, H, W, Cin) or a list of legs
    [(x_l, b_off_l), ...] whose channel concat (image b of the output reads
    x_l[b + b_off_l]) has Cin channels, weight (1, Cin, K, K) -> (B, H, W,
    1) in x's dtype, B = min(B_l - b_off_l) over legs."""
    legs, b = _exit_legs(x)
    x0 = legs[0][0]
    if x0.device.type == "cpu":
        return conv_gray_exit_plain(x, weight, bias, act)
    check_no_grad("conv_gray_exit", *[t for t, _ in legs], weight, bias)
    h, w = x0.shape[1:3]
    k = _check_cuda_args("conv_gray_exit", [t for t, _ in legs], weight,
                          bias, h, w, (1, 3, 5))
    cin = sum(t.shape[-1] for t, _ in legs)
    if weight.shape[0] != 1 or weight.shape[1] != cin:
        raise ValueError(f"conv_gray_exit: weight {tuple(weight.shape)} "
                         f"does not map {cin} channels to 1")
    wk, bk = gray_weights("exit", weight, bias, x0.dtype)
    y = torch.empty((b, h, w, 1), dtype=x0.dtype, device=x0.device)
    n = len(legs)
    ptrs = (_P * n)(*[t.data_ptr() for t, _ in legs])
    cins = (_I * n)(*[t.shape[-1] for t, _ in legs])
    offs = (_I * n)(*[off for _, off in legs])
    fn = kernel_function("mmif_conv_gray_exit_legs",
                         [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P])
    with torch.cuda.device(x0.device):
        err = fn(DTYPE_CODES[x0.dtype], n, ptrs, cins, offs, ptr(wk),
                 ptr(bk), ptr(y), b, h, w, k, act_code(act),
                 stream_handle(x0.device))
    check_launch("conv_gray_exit", err)
    return y
