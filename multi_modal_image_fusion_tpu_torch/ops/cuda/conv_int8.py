"""The int8 tensor-core convs (csrc/conv_int8.cu, body csrc/conv_int8.cuh)
with their plain versions. Two wrappers launch the one kernel:

- `conv_int8(x, qw, sw, f, bias, act)` replaces the TPU kernel
  `ops/pallas/conv_int8.py:219 conv_tlane_dma_q`, the int8 conv of the
  JAX package's ConvLayer route (`ops/layers.py:624-691`): a reflect-SAME
  k x k conv of the float NHWC input x, quantized per input channel by
  round(x / f) in the kernel's tile load, against the int8 OIHW weights qw
  (the fold f already in them), int32 accumulate, then acc * sw + bias,
  the activation, and the output in x's dtype. k 1, 3, 5 or 7; any channel
  counts.
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
from .build import check_launch, check_no_grad, kernel_function, stream_handle
from .conv_chain import act_code, apply_act

__all__ = ["CHAIN_KSIZES", "KSIZES", "conv_int8", "conv_int8_chain",
           "conv_int8_chain_plain", "conv_int8_plain", "int_conv_plain",
           "pack_weights_int8", "pick_bn"]

KSIZES = (1, 3, 5, 7)
CHAIN_KSIZES = (5, 7)
_CK = 32                   # input channels a k-step (csrc/conv_int8.cuh)
_BNS = (64, 32, 16)        # output channels a block (csrc/conv_int8.cuh)
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_DIV, _MUL = 0, 1
_PLAIN_CHUNK = 2 ** 27     # elements of one chunk's float64 input or output


def pick_bn(cout):
    """The kernel's output-channel block: the one of 16, 32 and 64 that pads
    c_out least, the larger on a tie."""
    return min(_BNS, key=lambda bn: -(-cout // bn) * bn)


def pack_weights_int8(qw, bn):
    """int8 OIHW (c_out, c_in, k, k) -> (k*k, c_out_pad, c_in_pad) int8, the
    kernel's weight rows: c_in zero-padded to a multiple of 32, c_out to a
    multiple of bn."""
    cout, cin, k, _ = qw.shape
    wp = F.pad(qw.to(torch.int16), (0, 0, 0, 0, 0, -cin % _CK,
                                    0, -cout % bn))
    return wp.permute(2, 3, 0, 1).reshape(k * k, *wp.shape[:2]).to(
        torch.int8).contiguous()


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


def conv_int8_plain(x, qw, sw, f, bias=None, act=None):
    """Plain version of conv_int8."""
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


def _check(name, x, qw, dq, scale, bias, fuse_n, ksizes):
    if not x.is_cuda or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous NHWC CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    if x.dtype not in _TYPES or x.data_ptr() % 16:
        raise TypeError(f"{name}: input must be float32, bfloat16 or int8 and "
                        f"16-byte aligned, got {x.dtype}")
    b, h, w, cin = x.shape
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
    if fuse_n < 0 or (fuse_n and b != 2 * fuse_n):
        raise ValueError(f"{name}: fuse_n={fuse_n} needs 2 * fuse_n images, "
                         f"got {b}")
    for t in (qw, dq, scale, bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices")
    return cout, k


def _launch(name, x, qw, dq, scale, bias, act, fuse_n, out_dtype, qmode):
    cout, k = qw.shape[0], qw.shape[-1]
    b, h, w, cin = x.shape
    n_out = fuse_n if fuse_n else b
    bn = pick_bn(cout)
    wk = pack_weights_int8(qw, bn)
    dqf = dq.detach().float().contiguous()
    sc = None if scale is None else scale.detach().float().contiguous()
    bf = None if bias is None else bias.detach().float().contiguous()
    y = torch.empty((n_out, h, w, cout), dtype=out_dtype, device=x.device)
    I, P = ctypes.c_int, ctypes.c_void_p
    fn = kernel_function("mmif_conv_int8", [I, I, I, P, P, P, P, P, P, I, I,
                                            I, I, I, I, I, I, I, P])
    with torch.cuda.device(x.device):
        err = fn(_TYPES[x.dtype], _TYPES[out_dtype], qmode, P(x.data_ptr()),
                 None if sc is None else P(sc.data_ptr()), P(wk.data_ptr()),
                 P(dqf.data_ptr()), None if bf is None else P(bf.data_ptr()),
                 P(y.data_ptr()), n_out, h, w, cin, cout, k, bn, fuse_n,
                 act_code(act), stream_handle(x.device))
    check_launch(name, err)
    return y


def conv_int8(x, qw, sw, f, bias=None, act=None):
    """Reflect-SAME int8 conv of float NHWC x (B, H, W, C_in) quantized by
    round(x / f): qw int8 OIHW (C_out, C_in, k, k), sw (C_out,) and f
    (C_in,) f32, bias (C_out,) or None. Output (B, H, W, C_out) in x's
    dtype."""
    if x.device.type == "cpu":
        return conv_int8_plain(x, qw, sw, f, bias, act)
    check_no_grad("conv_int8", x, bias)
    if x.dtype == torch.int8:
        raise TypeError("conv_int8: the input is float (the chain's int8 "
                        "input is conv_int8_chain's)")
    _check("conv_int8", x, qw, sw, f, bias, 0, KSIZES)
    return _launch("conv_int8", x, qw, sw, f, bias, act, 0, x.dtype, _DIV)


def conv_int8_chain(x, qw, dq, bias=None, act=None, invf=None, fuse_n=0,
                    out_int8=False, out_dtype=None):
    """Reflect-SAME int8 chain conv of NHWC x: float, quantized by
    round(x * invf) (invf (C_in,) f32), or int8-resident (invf unused). With
    fuse_n > 0, x holds 2 * fuse_n images and image i reads x[i] +
    x[i + fuse_n]. qw int8 OIHW, k 5 or 7; dq (C_out,) f32; bias (C_out,)
    or None. Output int8 when out_int8 (act None or relu), else out_dtype
    (default x's dtype; required for an int8 x)."""
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
    if x.device.type == "cpu":
        return conv_int8_chain_plain(x, qw, dq, bias, act, invf, fuse_n,
                                     out_int8, out_dtype)
    check_no_grad("conv_int8_chain", x, bias)
    scale = None if x.dtype == torch.int8 else invf
    _check("conv_int8_chain", x, qw, dq, scale, bias, fuse_n, CHAIN_KSIZES)
    return _launch("conv_int8_chain", x, qw, dq, scale, bias, act, fuse_n,
                   out_dtype, _MUL)
