"""The int8 tensor-core convs (csrc/conv_int8.cu, body csrc/conv_int8.cuh)
with their plain versions. Two wrappers launch the one kernel body:

- `conv_int8(x, qw, sw, f, bias, act, fuse_n)` replaces the TPU kernel
  `ops/pallas/conv_int8.py:219 conv_tlane_dma_q`, the int8 conv of the
  JAX package's ConvLayer route (`ops/layers.py:624-691`): a reflect-SAME
  k x k conv of the float NHWC input x, quantized per input channel by
  round(x / f) in the kernel's tile load, against the int8 OIHW weights qw
  (the fold f already in them), int32 accumulate, then acc * sw + bias,
  the activation, and the output in x's dtype. x may be a list of legs
  [(tensor, b_off), ...] read in place (ops/cuda/conv_multi.py's legs):
  the function is that of their channel concat, and with fuse_n > 0 each
  leg's sum with its sibling, rounded to the legs' dtype, is what is
  quantized. k 1, 3, 5 or 7; any channel counts.
- `conv_int8_chain(x, qw, dq, bias, act, invf, fuse_n, out_int8)` replaces
  `ops/pallas/hiw_int8.py:260 conv_hiw_chain_q`, DeepFuse's int8 chain
  conv: x is a float chain tensor, quantized by round(x * invf), or an
  int8-resident one; with fuse_n > 0 it holds 2n images and the conv reads
  x[i] + x[i+n] (the sum in x's dtype before the quantizer, or saturating
  at +-127 on int8); the epilogue is acc * dq + bias (one rounding, an
  FMA) and the activation,
  written in the chain dtype or, with out_int8, rounded and clipped to
  int8 (dq and bias then already divided by the next leg's fold). k 5 or
  7.

One launch (csrc/conv_int8.cu) runs up to two kernels (csrc/conv_int8.cuh):
a float input is quantized once into an int8 tensor (its legs read in
place, the fuse_n sum taken in its dtype), then an s8 `wgmma` implicit
GEMM convolves that, or an int8-resident input, as it stands. The body's
block of output channels (`pick_bn_int8`), its shared-memory plan
(`int8_plan`) and its packed weights (`pack_weights_int8`) are mirrored
here; `Int8Weights` holds a layer's packed weights with its f32 scales, so
a caller that keeps it (ops/layers.py, in the quantized_inference cache)
packs once.

The fold scale and the quantized weights are arguments (ops/quant.py
computes them), so a test can hand both the JAX package's fold. The plain
versions (`*_plain`) quantize with the same torch arithmetic and take the
integer conv exactly: a reflect-padded F.conv2d of the integer values in
float64 (sums reach 127^2 * 49 * 32 > 2^24, past f32's exact integers), in
batch chunks; then the same f32 epilogue, its multiply-add rounded once as
the kernel's FMA and the JAX package's jitted epilogue round it. CPU tensors take
them; a CUDA tensor launches the kernel or raises. The kernel is
forward-only and raises when an input needs a gradient.
"""

import ctypes

import torch
import torch.nn.functional as F

from ..quant import quantize_input_recip, quantize_input_scaled
from .build import check_launch, check_no_grad, kernel_function, \
    stream_handle
from .conv_chain import _TC_STAGE, _TC_TW, _TC_WG, _tc_mt, act_code, \
    apply_act
from .conv_multi import MAX_LEGS, concat_legs, legs_n_out

__all__ = ["CHAIN_KSIZES", "INT8_INSTANCES", "Int8Weights", "KSIZES",
           "conv_int8", "conv_int8_chain", "conv_int8_chain_plain",
           "conv_int8_plain", "int8_ksteps", "int8_plan", "int8_weight_index",
           "int_conv_plain", "pack_weights_int8", "pick_bn_int8",
           "tap_pairs"]

KSIZES = (1, 3, 5, 7)
CHAIN_KSIZES = (5, 7)
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_DIV, _MUL = 0, 1
_PLAIN_CHUNK = 2 ** 27     # elements of one chunk's float64 input or output

# The s8 wgmma body (csrc/conv_int8.cuh): its instances, kernel size ->
# (N blocks, N blocks with tap pairs), those the int8 layers of the six
# models pick (csrc/conv_int8.cu and conv_int8_k3/k5/k7.cu build them), and
# its shared-memory plan, mirrored to pick the block and pack the weights.
# The body convolves one int8 tensor: a float input is first quantized
# into one (its legs' concat, channels padded to a multiple of 16).
INT8_INSTANCES = {1: ((128, 96, 64, 48, 32, 16), ()),
                  3: ((128, 96, 64, 48, 32, 16), (64, 32, 16)),
                  5: ((32, 16), (32, 16)),
                  7: ((32, 16), (32, 16))}
_Q_CK = 32                 # input channels a k-step (m64nNk32)
_SMEM_MAX = 232448


def tap_pairs(k, cin):
    """True when the body pairs taps: the input fits half a k-step (16
    channels), so the k-step's two 16-byte halves carry taps kw and kw + 1
    of the same channels (k > 1)."""
    return k > 1 and cin <= 16


def int8_ksteps(k, cin):
    """The body's k-steps over c_in channels: one with tap pairs, else 32
    channels each."""
    return 1 if tap_pairs(k, cin) else -(-cin // _Q_CK)


def _taps(k, tp):
    """wgmmas a k-step: k * k taps, or k rows of (k + 1) / 2 tap pairs."""
    return k * ((k + 1) // 2) if tp else k * k


def int8_plan(k, bn, cin, pair_ok=False, out_dtype=torch.bfloat16):
    """(resident, ring, shared bytes, pair) of conv_int8.cuh launch_q8: as
    conv_chain.tc_plan (the staged tile is the same bytes: 32 int8 channels
    a pixel), with a k-step's weights of `_taps` wgmmas, the output tile
    in the output's element size and the N slice's f32 dequant scales and
    biases; pair_ok (an int8 input with fuse_n): the first plan whose ring
    slots hold both halves of the pair (summed in shared memory), else one
    whose slots hold one (the pair summed in registers as it is staged).
    None if nothing fits."""
    tp = tap_pairs(k, cin)
    ks = int8_ksteps(k, cin)
    th = _TC_WG * _tc_mt(bn)
    in_h, in_w = th + k - 1, _TC_TW + k - 1
    in_tile = 2 * (-(-in_h * in_w * 16 // 128) * 128 + 64)
    w_bytes = _taps(k, tp) * bn * 32
    # the output tile, and the slice's dequant scales and biases (f32)
    fixed = th * _TC_TW * (_ESIZE[out_dtype] * bn + 16) + 8 * bn
    for pair in ((1, 0) if pair_ok else (0,)):
        in_bytes = in_tile * (1 + pair)
        for resident in (1, 0):
            for ring in (4, 3, 2):
                smem = ring * (in_bytes + (0 if resident else w_bytes)) \
                    + (ks * w_bytes if resident else 0) + fixed
                if smem <= _SMEM_MAX:
                    return resident, ring, smem, pair
    return None


def pick_bn_int8(cout, cin, k, pair_ok=False, out_dtype=torch.bfloat16):
    """The body's block of output channels, by conv_chain.pick_bn_tc's
    cost: per 64 output pixels and k-step, ceil(cout / bn) blocks of
    `_taps` wgmmas of max(bn / 2, 16 + bn / 4) cycles (an m64nNk32 s8
    wgmma takes the cycles of a bf16 m64nNk16, on the same shared-memory
    bytes), half again when the weights stream, plus a stage's fixed
    cycles over the tile's rows; the larger on a tie. Blocks of the built
    instances only (INT8_INSTANCES). Raises if no plan fits."""
    tp = tap_pairs(k, cin)
    best = None
    for bn in INT8_INSTANCES[k][tp]:
        plan = int8_plan(k, bn, cin, pair_ok, out_dtype)
        if plan is None:
            continue
        cost = -(-cout // bn) * (
            _taps(k, tp) * max(bn / 2, 16 + bn / 4)
            * (1.0 if plan[0] else 1.5)
            + _TC_STAGE / (_TC_WG * _tc_mt(bn)))
        if best is None or cost < best[0]:
            best = (cost, bn)
    if best is None:
        raise ValueError(f"conv_int8: no int8 block fits k{k}, {cin} -> "
                         f"{cout} channels")
    return best[1]


def int8_weight_index(k, bn, cin, co, ci, kh, kw):
    """Byte index in `pack_weights_int8`'s output of the weight of output
    channel co, input channel ci and tap (kh, kw): the kernel's [cout_pad /
    bn][KS][taps][half][bn][16] layout (k-step ci // 32, half (ci % 32) //
    16), where with tap pairs (cin <= 16, one k-step) the pair (kh, kw //
    2) holds tap kw in half kw % 2."""
    nb, n = divmod(co, bn)
    tp = tap_pairs(k, cin)
    if tp:
        ks, t, half = 0, kh * ((k + 1) // 2) + kw // 2, kw % 2
    else:
        ks, t, half = ci // _Q_CK, kh * k + kw, ci % _Q_CK // 16
    return ((((nb * int8_ksteps(k, cin) + ks) * _taps(k, tp) + t) * 2
             + half) * bn + n) * 16 + ci % 16


def pack_weights_int8(qw, bn):
    """int8 OIHW (c_out, c_in, k, k) -> the body's flat int8 weights: c_in
    zero-padded to whole k-steps (16 channels with tap pairs, else 32),
    c_out to a multiple of bn, laid out as `int8_weight_index` reads them;
    with tap pairs the odd last tap of a row pairs with zeros."""
    cout, cin, k, _ = qw.shape
    tp = tap_pairs(k, cin)
    ck = 16 if tp else _Q_CK
    wp = F.pad(qw.to(torch.int16),   # F.pad takes no int8
               (0, 0, 0, 0, 0, -cin % ck, 0, -cout % bn))
    nnb, ks = wp.shape[0] // bn, wp.shape[1] // ck
    if tp:
        npair = (k + 1) // 2
        wp = F.pad(wp, (0, 2 * npair - k))
        wp = wp.reshape(nnb, bn, 16, k, npair, 2).permute(0, 3, 4, 5, 1, 2)
    else:
        wp = wp.reshape(nnb, bn, ks, 2, 16, k, k).permute(0, 2, 5, 6, 3, 1, 4)
    return wp.to(torch.int8).contiguous().reshape(-1)


class Int8Weights:
    """A layer's int8 weights for the kernel: the quantized OIHW weights
    packed (`pack_weights_int8`) at the block `pick_bn_int8` picks for one
    input kind and output dtype, beside the contiguous f32 dequant scale,
    bias and input scale. `get` packs once per kind. A wrapper given one
    launches from it only after `holds` confirms that it was made from the
    very tensors of the call."""

    def __init__(self, qw, dq, bias, scale):
        self._made_from = (qw, dq, bias, scale)
        self.qw = qw
        self.dq = dq.detach().float().contiguous()
        self.bias = None if bias is None else bias.detach().float() \
            .contiguous()
        # fresh copies: the kernels read the scales in 16-byte loads
        self.scale = None if scale is None else scale.detach().float() \
            .clone()
        # the quantizer's multiplier for a division by scale (csrc/
        # conv_int8.cuh div_rint), rounded to nearest
        self.rscale = None if scale is None else torch.ones_like(
            self.scale).div(self.scale)
        self._packed = {}

    def holds(self, qw, dq, bias, scale):
        """True when made from these very tensors (qw, dq, bias, scale)."""
        return all(a is b for a, b in zip(self._made_from,
                                          (qw, dq, bias, scale)))

    def get(self, pair_ok, out_dtype):
        """(packed weights, bn) for a launch on an int8 input (pair_ok: an
        int8-resident one with fuse_n) writing out_dtype."""
        key = (bool(pair_ok), out_dtype)
        if key not in self._packed:
            cout, cin, k, _ = self.qw.shape
            bn = pick_bn_int8(cout, cin, k, pair_ok, out_dtype)
            self._packed[key] = (pack_weights_int8(self.qw, bn), bn)
        return self._packed[key]


def int_conv_plain(q, qw):
    """The exact integer reflect-SAME conv of int8-valued NHWC q with int8
    OIHW qw: float64 convs in batch chunks, returned as f32 (the int32
    accumulator's conversion, round to nearest even)."""
    k = qw.shape[-1]
    p = k // 2
    b, h, w, cin = q.shape
    per = (h + 2 * p) * (w + 2 * p) * max(cin, qw.shape[0])
    step = max(1, _PLAIN_CHUNK // per)
    wd = qw.to(torch.float64)
    outs = []
    for i in range(0, b, step):
        xi = q[i:i + step].to(torch.float64).permute(0, 3, 1, 2)
        if p:
            xi = F.pad(xi, (p, p, p, p), mode="reflect")
        outs.append(F.conv2d(xi, wd).permute(0, 2, 3, 1).float())
        del xi
    return torch.cat(outs) if len(outs) > 1 else outs[0].contiguous()


def _dequant(acc, dq, bias, act):
    """act(acc * dq + bias) in f32 with one rounding, as the kernel's FMA
    (the product of two f32 values is exact in f64)."""
    if bias is None:
        y = acc * dq.float()
    else:
        y = (acc.double() * dq.float().double() + bias.float().double()).float()
    return apply_act(y, act)


def _requant(y):
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def _effective_input(x, fuse_n):
    """The tensor a layer quantizes: x itself, or the concat of its legs;
    with fuse_n the sum of the halves in x's dtype."""
    if isinstance(x, (list, tuple)):
        n_out = legs_n_out(x, fuse_n)
        x = concat_legs(x, fuse_n, n_out)
        return x[:n_out] + x[n_out:] if fuse_n else x
    return x[:fuse_n] + x[fuse_n:] if fuse_n else x


def conv_int8_plain(x, qw, sw, f, bias=None, act=None, fuse_n=0):
    """Plain version of conv_int8."""
    x = _effective_input(x, fuse_n)
    q = quantize_input_scaled(x, f)
    return _dequant(int_conv_plain(q, qw), sw, bias, act).to(x.dtype)


def conv_int8_chain_plain(x, qw, dq, bias=None, act=None, invf=None,
                          fuse_n=0, out_int8=False, out_dtype=None):
    """Plain version of conv_int8_chain."""
    if x.dtype == torch.int8:
        q = x.to(torch.int32)
        if fuse_n:
            q = torch.clamp(q[:fuse_n] + q[fuse_n:], -127, 127)
    else:
        q = quantize_input_recip(x[:fuse_n] + x[fuse_n:] if fuse_n else x,
                                 invf)
    y = _dequant(int_conv_plain(q, qw), dq, bias, act)
    return _requant(y) if out_int8 else y.to(out_dtype or x.dtype)


def _check(name, legs, n_out, qw, dq, scale, bias, fuse_n, ksizes):
    if not 1 <= len(legs) <= MAX_LEGS:
        raise ValueError(f"{name}: 1 to {MAX_LEGS} legs, got {len(legs)}")
    x0 = legs[0][0]
    for t, off in legs:
        if not t.is_cuda or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous NHWC CUDA tensors, "
                             f"got {tuple(t.shape)} on {t.device}")
        if t.dtype not in _TYPES or t.data_ptr() % 16:
            raise TypeError(f"{name}: input must be float32, bfloat16 or "
                            f"int8 and 16-byte aligned, got {t.dtype}")
        if t.shape[1:3] != x0.shape[1:3] or t.dtype != x0.dtype \
                or t.device != x0.device:
            raise ValueError(f"{name}: legs differ in H, W, dtype or device")
        if off < 0 or off + fuse_n + n_out > t.shape[0]:
            raise ValueError(f"{name}: a leg of batch {t.shape[0]} at offset "
                             f"{off} cannot feed {n_out} outputs "
                             f"(fuse_n={fuse_n})")
    h, w = x0.shape[1:3]
    cin = sum(t.shape[-1] for t, _ in legs)
    if qw.dtype != torch.int8 or qw.dim() != 4 or qw.shape[1] != cin \
            or qw.shape[2] != qw.shape[3] or qw.shape[-1] not in ksizes:
        raise ValueError(f"{name}: weights must be int8 OIHW (c_out, {cin}, k, "
                         f"k) with k in {ksizes}, got {qw.dtype} "
                         f"{tuple(qw.shape)}")
    cout, k = qw.shape[0], qw.shape[-1]
    if dq.numel() != cout or (bias is not None and bias.numel() != cout):
        raise ValueError(f"{name}: dequant scale and bias need {cout} values")
    if scale is not None and scale.numel() != cin:
        raise ValueError(f"{name}: the fold needs {cin} values")
    if h <= k // 2 or w <= k // 2:
        raise ValueError(f"{name}: {h}x{w} is too small for a reflect pad of "
                         f"{k // 2}")
    if fuse_n < 0 or n_out < 1:
        raise ValueError(f"{name}: fuse_n={fuse_n} and {n_out} outputs")
    for t in (qw, dq, scale, bias):
        if t is not None and t.device != x0.device:
            raise ValueError(f"{name}: tensors on different devices")


def _check_weights(name, weights, qw, dq, bias, scale):
    """A caller's Int8Weights must have been made from this call's tensors:
    the launch reads its packing, not the arguments."""
    if weights is not None and not weights.holds(qw, dq, bias, scale):
        raise ValueError(f"{name}: `weights` was made from other tensors "
                         "than this call's qw, scale, bias and fold")


def _launch(name, legs, n_out, wts, act, fuse_n, out_dtype, qmode):
    x0 = legs[0][0]
    cins = [t.shape[-1] for t, _ in legs]
    _, h, w, _ = x0.shape
    int8_in = x0.dtype == torch.int8
    wk, bn = wts.get(int8_in and fuse_n > 0, out_dtype)
    # a float input's int8 copy, written by the kernel's quantizer
    q = None if int8_in else torch.empty(
        (n_out, h, w, -(-sum(cins) // 16) * 16), dtype=torch.int8,
        device=x0.device)
    cout, k = wts.qw.shape[0], wts.qw.shape[-1]
    y = torch.empty((n_out, h, w, cout), dtype=out_dtype, device=x0.device)
    nl = len(legs)
    P = ctypes.c_void_p
    xs = (P * nl)(*[t.data_ptr() for t, _ in legs])
    cs = (ctypes.c_int * nl)(*cins)
    offs = (ctypes.c_int * nl)(*[off for _, off in legs])
    I = ctypes.c_int
    fn = kernel_function("mmif_conv_int8", [I, I, I, I, P, P, P, P, P, P, P,
                                            P, P, P, I, I, I, I, I, I, I, I,
                                            P])
    bf = wts.bias
    with torch.cuda.device(x0.device):
        err = fn(_TYPES[x0.dtype], _TYPES[out_dtype], qmode, nl,
                 ctypes.cast(xs, P), ctypes.cast(cs, P), ctypes.cast(offs, P),
                 None if int8_in else P(wts.scale.data_ptr()),
                 None if int8_in else P(wts.rscale.data_ptr()),
                 None if q is None else P(q.data_ptr()), P(wk.data_ptr()),
                 P(wts.dq.data_ptr()),
                 None if bf is None else P(bf.data_ptr()), P(y.data_ptr()),
                 n_out, h, w, cout, k, bn, fuse_n, act_code(act),
                 stream_handle(x0.device))
    check_launch(name, err)
    return y


def conv_int8(x, qw, sw, f, bias=None, act=None, fuse_n=0, weights=None):
    """Reflect-SAME int8 conv of float NHWC x (B, H, W, C_in) quantized by
    round(x / f): qw int8 OIHW (C_out, C_in, k, k), sw (C_out,) and f
    (C_in,) f32, bias (C_out,) or None. x may be a list of legs [(tensor,
    b_off), ...] whose channel concat is the input; with fuse_n > 0 image
    i reads the sum of images i and i + fuse_n (of each leg at its
    offset). Output (n_out, H, W, C_out) in x's dtype, n_out = B (legs:
    `legs_n_out`; fuse_n: fuse_n). `weights` is the layer's Int8Weights made
    from these very (qw, sw, bias, f), if the caller keeps one (else
    ValueError)."""
    legs = [(t, int(o)) for t, o in x] if isinstance(x, (list, tuple)) \
        else None
    x0 = x if legs is None else legs[0][0]
    _check_weights("conv_int8", weights, qw, sw, bias, f)
    if x0.device.type == "cpu":
        return conv_int8_plain(x, qw, sw, f, bias, act, fuse_n)
    check_no_grad("conv_int8", bias, *([x] if legs is None
                                       else [t for t, _ in legs]))
    if x0.dtype == torch.int8:
        raise TypeError("conv_int8: the input is float (the chain's int8 "
                        "input is conv_int8_chain's)")
    if legs is None:
        if fuse_n and x.shape[0] != 2 * fuse_n:
            raise ValueError(f"conv_int8: fuse_n={fuse_n} needs 2 * fuse_n "
                             f"images, got {x.shape[0]}")
        legs, n_out = [(x, 0)], fuse_n or x.shape[0]
    else:
        n_out = legs_n_out(legs, fuse_n)
    _check("conv_int8", legs, n_out, qw, sw, f, bias, fuse_n, KSIZES)
    wts = weights or Int8Weights(qw, sw, bias, f)
    return _launch("conv_int8", legs, n_out, wts, act, fuse_n, x0.dtype,
                   _DIV)


def conv_int8_chain(x, qw, dq, bias=None, act=None, invf=None, fuse_n=0,
                    out_int8=False, out_dtype=None, weights=None):
    """Reflect-SAME int8 chain conv of NHWC x: float, quantized by
    round(x * invf) (invf (C_in,) f32), or int8-resident (invf unused). With
    fuse_n > 0, x holds 2 * fuse_n images and image i reads x[i] +
    x[i + fuse_n]. qw int8 OIHW, k 5 or 7; dq (C_out,) f32; bias (C_out,)
    or None. Output int8 when out_int8 (act None or relu), else out_dtype
    (default x's dtype; required for an int8 x). `weights`: the layer's
    Int8Weights made from these very (qw, dq, bias, invf), if the caller
    keeps one (else ValueError)."""
    if out_int8:
        if act not in (None, "relu"):
            raise ValueError(f"conv_int8_chain: an int8 output takes act None "
                             f"or relu, not {act!r}")
        out_dtype = torch.int8
    elif out_dtype is None:
        if x.dtype == torch.int8:
            raise ValueError("conv_int8_chain: an int8 input needs out_int8 "
                             "or an out_dtype")
        out_dtype = x.dtype
    if x.dtype != torch.int8 and invf is None:
        raise ValueError("conv_int8_chain: a float input needs invf")
    _check_weights("conv_int8_chain", weights, qw, dq, bias, invf)
    if x.device.type == "cpu":
        return conv_int8_chain_plain(x, qw, dq, bias, act, invf, fuse_n,
                                     out_int8, out_dtype)
    check_no_grad("conv_int8_chain", x, bias)
    scale = None if x.dtype == torch.int8 else invf
    if x.dtype == torch.int8 and x.shape[-1] % 16:
        raise ValueError(f"conv_int8_chain: an int8-resident input needs a "
                         f"multiple of 16 channels, got {tuple(x.shape)}")
    if fuse_n < 0 or (fuse_n and x.shape[0] != 2 * fuse_n):
        raise ValueError(f"conv_int8_chain: fuse_n={fuse_n} needs 2 * fuse_n "
                         f"images, got {x.shape[0]}")
    n_out = fuse_n or x.shape[0]
    _check("conv_int8_chain", [(x, 0)], n_out, qw, dq, scale, bias, fuse_n,
           CHAIN_KSIZES)
    wts = weights or Int8Weights(qw, dq, bias, scale)
    return _launch("conv_int8_chain", [(x, 0)], n_out, wts, act, fuse_n,
                   out_dtype, _MUL)
