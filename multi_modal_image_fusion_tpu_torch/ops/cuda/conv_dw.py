"""Depthwise reflect-SAME conv kernel (csrc/conv_dw.cu) with its plain
version.

The depthwise instance of the TPU kernel `ops/pallas/hiw_kernel.py:335
conv_hiw_chain`, which runs depthwise weights as diagonal bands of a dense
conv (:157-185). `conv_dw(x, weight, bias, act, lo, add)` convolves the
channel window [lo, lo + C) of the NHWC tensor x in place (C =
weight.shape[0], weight (C, 1, K, K)), the counterpart of
`hiw_scale.py:50 hiw_channels`: a Res2 block's 384-channel expansion is
never sliced into copies. An optional `add` (B, H, W, C) is summed into the
input before the conv (the Res2 hierarchy y = y_prev + x_i, JAX
ops/blocks.py:286-292). Bias and activation are optional and fused; the
output is contiguous (B, H, W, C) in x's dtype, the arithmetic f32. On an
H100 it is bound by bytes; the kernel stages 2-D tiles with their reflect
halo and keeps the vertical taps in registers (csrc/conv_dw.cu header).

The plain version (`conv_dw_plain`) is F.conv2d(groups=C) in f32 on the
window (plus `add`), reflect-padded in batch chunks under torch's 32-bit
index limit. CPU tensors take it; a CUDA tensor launches the kernel or
raises. The kernel is forward-only (it raises when an input needs a
gradient; ConvLayer's training route runs F.conv2d(groups=C)). Built for
k1 and k3, C a multiple of 8 up to 512, and a window whose base and pixel
stride are multiples of 8 channels.

A call's host work is kept small (a Res2Fusion forward makes 12): the
taps are packed once a layer (`pack_taps`), the C entry is typed once, the
output is one allocation.
"""

import collections
import ctypes
import threading
import weakref

import torch

from .build import check_no_grad
from .conv_chain import DTYPE_CODES, _conv_nhwc_f32, act_code, apply_act
from .window import window_entry, window_launch

__all__ = ["conv_dw", "conv_dw_plain", "pack_taps"]

MAX_C = 512
_I = ctypes.c_int
_P = ctypes.c_void_p
ARGTYPES = (_I, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
# packed taps by (weight storage, version, ...), least recently used first
_TAPS = collections.OrderedDict()
_TAPS_KEPT = 64
_TAPS_LOCK = threading.Lock()


def pack_taps(weight, bias=None):
    """The kernel's [K*K][C] f32 taps of weight (C, 1, K, K) and its C f32
    bias (or None), packed once a layer: reused while the weight and bias
    are the same tensors at the same storage and version, so loading a
    checkpoint, an in-place copy under torch.no_grad or an optimizer step
    packs them anew."""
    key = (weight.data_ptr(), weight._version, weight.dtype, weight.device,
           tuple(weight.shape), None if bias is None else
           (bias.data_ptr(), bias._version, bias.dtype))
    with _TAPS_LOCK:
        hit = _TAPS.get(key)
        if hit is not None and hit[0]() is weight and (
                bias is None or hit[1]() is bias):
            _TAPS.move_to_end(key)
            return hit[2], hit[3]
    c, k = weight.shape[0], weight.shape[-1]
    with torch.no_grad():
        wk = weight.detach().reshape(c, k * k).t().float().contiguous()
        bk = None if bias is None else bias.detach().float().contiguous()
    with _TAPS_LOCK:
        _TAPS[key] = (weakref.ref(weight),
                      None if bias is None else weakref.ref(bias), wk, bk)
        if len(_TAPS) > _TAPS_KEPT:
            _TAPS.popitem(last=False)
    return wk, bk


def conv_dw_plain(x, weight, bias=None, act=None, lo=0, add=None):
    """Plain version of conv_dw: F.conv2d(groups=C) in f32, cast back to
    x.dtype."""
    c = weight.shape[0]
    xf = x[..., lo:lo + c].float()
    if add is not None:
        xf = xf + add.float()
    return apply_act(_conv_nhwc_f32(xf, weight, bias, groups=c),
                     act).to(x.dtype)


def _check(x, weight, bias, lo, add):
    name = "conv_dw"
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or "
                        f"bfloat16)")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous, 16-byte aligned "
                         f"NHWC tensor, got {tuple(x.shape)}")
    b, h, w, pitch = x.shape
    c = weight.shape[0]
    if weight.shape[1:] not in ((1, 1, 1), (1, 3, 3)):
        raise ValueError(f"{name}: weight must be (C, 1, K, K) with K 1 or 3, "
                         f"got {tuple(weight.shape)}")
    k = weight.shape[-1]
    if c % 8 or not 8 <= c <= MAX_C or pitch % 8 or lo % 8:
        raise ValueError(f"{name}: C ({c}), the channels of x ({pitch}) and "
                         f"lo ({lo}) must be multiples of 8, C at most "
                         f"{MAX_C}")
    if lo < 0 or lo + c > pitch:
        raise ValueError(f"{name}: window [{lo}, {lo + c}) outside x's "
                         f"{pitch} channels")
    if h <= k // 2 or w <= k // 2:
        raise ValueError(f"{name}: reflect padding {k // 2} needs H and W "
                         f"above it, got {h}x{w}")
    if add is not None and (add.shape != (b, h, w, c) or add.dtype != x.dtype
                            or add.device != x.device
                            or not add.is_contiguous() or add.data_ptr() % 16):
        raise ValueError(f"{name}: add must be a contiguous, 16-byte aligned "
                         f"{(b, h, w, c)} tensor of x's dtype and device")
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor")
    if weight.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"{name}: weight and bias must be on {dev}")
    return k


def conv_dw(x, weight, bias=None, act=None, lo=0, add=None):
    """Depthwise reflect-SAME conv of channels [lo, lo + C) of x (B, H, W,
    Cx), plus `add` (B, H, W, C) when given; weight (C, 1, K, K) ->
    contiguous (B, H, W, C) in x.dtype."""
    if x.device.type == "cpu":
        return conv_dw_plain(x, weight, bias, act, lo, add)
    check_no_grad("conv_dw", x, weight, bias, add)
    k = _check(x, weight, bias, lo, add)
    b, h, w, pitch = x.shape
    c = weight.shape[0]
    wk, bk = pack_taps(weight, bias)
    y = torch.empty((b, h, w, c), dtype=x.dtype, device=x.device)
    window_launch("conv_dw", window_entry("mmif_conv_dw", ARGTYPES), x,
                  DTYPE_CODES[x.dtype], x.data_ptr(), pitch, lo,
                  None if add is None else add.data_ptr(), c, wk.data_ptr(),
                  None if bk is None else bk.data_ptr(), y.data_ptr(), b, h,
                  w, c, k, act_code(act))
    return y
