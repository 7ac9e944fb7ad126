"""Two chained reflect-SAME convs in one launch (csrc/conv_pair.cu) with
their plain version.

Replaces the TPU kernel `ops/pallas/conv_kernel.py:970
conv_tlane_chain_pair`: conv_a (bias, activation), the intermediate
rounded to the chain dtype and kept on chip with its own reflect halo,
then conv_b (bias, activation). DeepFuse's `MMIF_CHAIN_PAIR` route
(models/zoo.py) runs its two instances:

- `conv_pair_enter(img1, img2, wa, ba, act_a, wb, bb, act_b)`: enc0 (1 ->
  16, k5) then enc1 (16 -> 32, k7) on the grayscale pair (B, H, W, 1),
  read straight from the two images and cast to the chain dtype (the
  weights' dtype) in the load: (2B, H, W, 32), img1's batch first. It
  takes the place of conv_gray_enter + conv_chain on this route.
- `conv_pair_exit(t, wa, ba, act_a, wb, bb, act_b)`: dec1 (32 -> 16, k5)
  then dec2 (16 -> 1, k5) on t (B, H, W, 32): (B, H, W, 1) in t's dtype.

Weights are OIHW, biases (C,) or None. In bf16 the wide conv of each pair
runs on the tensor cores (bf16 weights, f32 sums), the thin one as f32
FMAs; f32 runs f32 FMAs, never TF32.

The plain version (`conv_pair_plain`) is two `conv_chain_plain` calls with
the mid cast to the chain dtype in between: what two launches compute.
CPU tensors take it; a CUDA tensor launches the kernel or raises. The
kernels are forward-only and raise when an input needs a gradient.
"""

import ctypes

import torch

from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle
from .conv_chain import DTYPE_CODES, act_code, check_tensors, conv_chain_plain

__all__ = ["ENTER_SHAPES", "EXIT_SHAPES", "conv_pair_enter",
           "conv_pair_exit", "conv_pair_plain"]

# (wa, wb) OIHW shapes of the two instances built (DeepFuse's pairs)
ENTER_SHAPES = ((16, 1, 5, 5), (32, 16, 7, 7))
EXIT_SHAPES = ((16, 32, 5, 5), (1, 16, 5, 5))
_GRID_Z_MAX = 65535
_I = ctypes.c_int
_P = ctypes.c_void_p


def conv_pair_plain(x, wa, ba=None, act_a=None, wb=None, bb=None,
                    act_b=None):
    """Plain version of the pair: conv_b(cast(conv_a(x))), each a
    reflect-SAME f32 conv cast back to x.dtype."""
    return conv_chain_plain(conv_chain_plain(x, wa, ba, act_a), wb, bb,
                            act_b)


def _check(name, shapes, wa, ba, wb, bb, dev):
    for w, want in zip((wa, wb), shapes):
        if tuple(w.shape) != want:
            raise ValueError(f"{name}: built for weights {shapes}, got "
                             f"{tuple(wa.shape)} and {tuple(wb.shape)}")
    for t in (wa, ba, wb, bb):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: weights and biases must be on {dev}")
    if wa.dtype != wb.dtype or wa.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: weights in one dtype (float32 or "
                        f"bfloat16), got {wa.dtype} and {wb.dtype}")


def _mma_rows(w):
    """OIHW -> (k*k, O, I) bf16: the tensor-core conv's weight rows."""
    k = w.shape[-1]
    return w.detach().permute(2, 3, 0, 1).reshape(k * k, *w.shape[:2]).to(
        torch.bfloat16).contiguous()


def _fma_rows(w):
    """OIHW -> (k*k, I, O) f32: the FMA conv's weight rows."""
    k = w.shape[-1]
    return w.detach().permute(2, 3, 1, 0).reshape(
        k * k, w.shape[1], w.shape[0]).float().contiguous()


def _bias(b):
    return None if b is None else b.detach().float().contiguous()


def conv_pair_enter(img1, img2, wa, ba, act_a, wb, bb, act_b):
    """enc0 then enc1 on a grayscale pair: img1, img2 (B, H, W, 1) in f32 or
    bf16 -> (2B, H, W, 32) in the weights' dtype (the chain dtype)."""
    dtype = wa.dtype
    if img1.device.type == "cpu":
        return conv_pair_plain(torch.cat([img1, img2], 0).to(dtype), wa, ba,
                               act_a, wb, bb, act_b)
    check_no_grad("conv_pair_enter", img1, img2, wa, ba, wb, bb)
    check_tensors("conv_pair_enter", [img1, img2])
    b, h, w, c = img1.shape
    if c != 1 or img2.shape != img1.shape or img2.dtype != img1.dtype:
        raise ValueError(f"conv_pair_enter: a pair of (B, H, W, 1) images "
                         f"of one dtype, got {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)}")
    _check("conv_pair_enter", ENTER_SHAPES, wa, ba, wb, bb, img1.device)
    if h <= 3 or w <= 3:
        raise ValueError(f"conv_pair_enter: reflect padding 3 needs H and W "
                         f"above it, got {h}x{w}")
    if 2 * b > _GRID_Z_MAX:
        raise ValueError(f"conv_pair_enter: batch {b} too large for one "
                         f"launch")
    wak = _fma_rows(wa)
    wbk = _mma_rows(wb) if dtype == torch.bfloat16 else _fma_rows(wb)
    bak, bbk = _bias(ba), _bias(bb)
    y = torch.empty((2 * b, h, w, 32), dtype=dtype, device=img1.device)
    fn = kernel_function("mmif_conv_pair_enter",
                         [_I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I,
                          _I, _P])
    with torch.cuda.device(img1.device):
        err = fn(DTYPE_CODES[dtype], DTYPE_CODES[img1.dtype], ptr(img1),
                 ptr(img2), ptr(wak), ptr(bak), act_code(act_a), ptr(wbk),
                 ptr(bbk), act_code(act_b), ptr(y), b, h, w,
                 stream_handle(img1.device))
    check_launch("conv_pair_enter", err)
    return y


def conv_pair_exit(t, wa, ba, act_a, wb, bb, act_b):
    """dec1 then dec2: t (B, H, W, 32) -> (B, H, W, 1) in t's dtype."""
    if t.device.type == "cpu":
        return conv_pair_plain(t, wa, ba, act_a, wb, bb, act_b)
    check_no_grad("conv_pair_exit", t, wa, ba, wb, bb)
    check_tensors("conv_pair_exit", [t])
    b, h, w, c = t.shape
    if c != 32:
        raise ValueError(f"conv_pair_exit: 32 input channels, got {c}")
    _check("conv_pair_exit", EXIT_SHAPES, wa, ba, wb, bb, t.device)
    if wa.dtype != t.dtype:
        raise TypeError(f"conv_pair_exit: weights in the input's dtype "
                        f"{t.dtype}, got {wa.dtype}")
    if h <= 2 or w <= 2:
        raise ValueError(f"conv_pair_exit: reflect padding 2 needs H and W "
                         f"above it, got {h}x{w}")
    if b > _GRID_Z_MAX:
        raise ValueError(f"conv_pair_exit: batch {b} too large for one "
                         f"launch")
    wak = _mma_rows(wa) if t.dtype == torch.bfloat16 else _fma_rows(wa)
    wbk = _fma_rows(wb)
    bak, bbk = _bias(ba), _bias(bb)
    y = torch.empty((b, h, w, 1), dtype=t.dtype, device=t.device)
    fn = kernel_function("mmif_conv_pair_exit",
                         [_I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I,
                          _P])
    with torch.cuda.device(t.device):
        err = fn(DTYPE_CODES[t.dtype], ptr(t), ptr(wak), ptr(bak),
                 act_code(act_a), ptr(wbk), ptr(bbk), act_code(act_b),
                 ptr(y), b, h, w, stream_handle(t.device))
    check_launch("conv_pair_exit", err)
    return y
