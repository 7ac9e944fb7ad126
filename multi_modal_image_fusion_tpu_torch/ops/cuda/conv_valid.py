"""VALID conv kernel of the training path (csrc/conv_valid.cu), with its plain
version.

`conv_valid(xp, weight, bias, act)` replaces the TPU kernel
`ops/pallas/conv_kernel.py:161 conv_tlane_dma`: a k x k VALID conv of a
pre-padded NHWC input, xp (B, H+k-1, W+k-1, C_in), with an OIHW weight
(C_out, C_in, k, k), to (B, H, W, C_out) in xp's dtype, f32 accumulation,
and an optional bias + relu/relu6/lrelu 0.2/tanh epilogue. Any C_in >= 1 and
C_out >= 1; k 5 or 7 (what DeepFuse's training launches); f32 or bf16, with
the weight in xp's dtype. What bounds it on an H100 and what the design does
about it is in the header of csrc/conv_valid.cu.

CPU tensors take `conv_valid_plain`; a CUDA tensor launches the kernel or
raises. The kernel is forward-only: the differentiable conv of the train
step is `conv_vjp.conv_valid_fast`, whose forward and dx launch it.
"""

import ctypes

import torch
import torch.nn.functional as F

from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle
from .conv_chain import (DTYPE_CODES, act_code, apply_act, check_tensors,
                         weights_f32)

__all__ = ["conv_valid", "conv_valid_plain"]

KSIZES = (5, 7)
_CO_TILE = 16          # output channels per block (csrc/conv_valid.cu)
_GRID_Z_MAX = 65535

_I = ctypes.c_int
_P = ctypes.c_void_p


def conv_valid_plain(xp, weight, bias=None, act=None):
    """Plain version of conv_valid: F.conv2d on the NCHW-permuted input, in
    float64 for a float64 input (so gradcheck can run on it), else in f32,
    cast back to xp.dtype."""
    dt = torch.float64 if xp.dtype == torch.float64 else torch.float32
    y = F.conv2d(xp.to(dt).permute(0, 3, 1, 2), weight.to(dt),
                 None if bias is None else bias.to(dt))
    return apply_act(y.permute(0, 2, 3, 1), act).to(xp.dtype).contiguous()


def conv_valid(xp, weight, bias=None, act=None, site="valid"):
    """VALID conv: xp (B, H+k-1, W+k-1, Cin) NHWC, weight OIHW (Cout, Cin,
    k, k) -> (B, H, W, Cout) in xp.dtype. `site` names the caller in the
    launch count (`conv_valid/<site>`): "forward" and "dx" for the train
    step's conv_valid_fast, "valid" for the fused valid-step conv."""
    if xp.device.type == "cpu":
        return conv_valid_plain(xp, weight, bias, act)
    check_no_grad("conv_valid", xp, weight, bias)
    check_tensors("conv_valid", [xp])
    b, hp, wp, cin = xp.shape
    if weight.dim() != 4 or weight.shape[2] != weight.shape[3]:
        raise ValueError(f"conv_valid: weight must be OIHW with square taps, "
                         f"got {tuple(weight.shape)}")
    cout, k = weight.shape[0], weight.shape[-1]
    if k not in KSIZES:
        raise ValueError(f"conv_valid: kernel size {k} not built (one of "
                         f"{KSIZES})")
    if weight.shape[1] != cin:
        raise ValueError(f"conv_valid: weight takes {weight.shape[1]} input "
                         f"channels, xp has {cin}")
    if weight.dtype != xp.dtype:
        raise TypeError(f"conv_valid: weight dtype {weight.dtype} differs "
                        f"from the input's {xp.dtype}")
    if weight.device != xp.device or (bias is not None
                                      and bias.device != xp.device):
        raise ValueError(f"conv_valid: weight and bias must be on "
                         f"{xp.device}")
    h, w = hp - k + 1, wp - k + 1
    if h < 1 or w < 1:
        raise ValueError(f"conv_valid: padded input {hp}x{wp} is smaller "
                         f"than the {k}x{k} window")
    if b * -(-cout // _CO_TILE) > _GRID_Z_MAX:
        raise ValueError(f"conv_valid: batch {b} too large for one launch")
    wk, bk = weights_f32(weight, bias)
    y = torch.empty((b, h, w, cout), dtype=xp.dtype, device=xp.device)
    fn = kernel_function("mmif_conv_valid",
                         [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(xp.device):
        err = fn(DTYPE_CODES[xp.dtype], ptr(xp), ptr(wk), ptr(bk), ptr(y),
                 b, h, w, cin, cout, k, act_code(act),
                 stream_handle(xp.device))
    check_launch("conv_valid", err, site)
    return y
