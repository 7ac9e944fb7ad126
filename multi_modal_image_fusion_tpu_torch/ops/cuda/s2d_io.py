"""The packed chain's entry and exit kernels (csrc/s2d_io.cu) with their
plain versions.

- `s2d_enter(img1, img2, dtype)` replaces the TPU kernel
  `ops/pallas/s2d_io.py:155 s2d_chain_enter`: it reads the grayscale pair
  (B, H, W, 1) straight from the two tensors, casts to the chain dtype and
  writes the space-to-depth packed (2B, H/2, W/2, 4), phase-major
  (ops/s2d.py), in one pass.
- `s2d_exit(t)` replaces `ops/pallas/s2d_io.py:249 s2d_chain_exit`: (n,
  H/2, W/2, 4) -> (n, H, W, 1).

The kernels take any even H and W, f32 or bf16 images and either chain
dtype. The plain versions are `s2d_pack` of the concatenated pair with the
cast, and `s2d_unpack`: the same values bit for bit. CPU tensors take
them; a CUDA tensor launches the kernel or raises.
"""

import ctypes

import torch

from ..s2d import s2d_pack, s2d_unpack
from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle
from .conv_chain import DTYPE_CODES, check_tensors

__all__ = ["s2d_enter", "s2d_enter_plain", "s2d_exit", "s2d_exit_plain"]

_I = ctypes.c_int
_P = ctypes.c_void_p


def s2d_enter_plain(img1, img2, dtype):
    """Plain version of s2d_enter."""
    return s2d_pack(torch.cat([img1, img2], 0).to(dtype)).contiguous()


def s2d_exit_plain(t):
    """Plain version of s2d_exit."""
    return s2d_unpack(t).contiguous()


def _check_dtype(name, dtype):
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32 or "
                        f"bfloat16)")


def s2d_enter(img1, img2, dtype):
    """img1, img2 (B, H, W, 1), H and W even -> (2B, H/2, W/2, 4) in
    `dtype`, img1's batch first."""
    if img1.device.type == "cpu":
        return s2d_enter_plain(img1, img2, dtype)
    check_no_grad("s2d_enter", img1, img2)
    check_tensors("s2d_enter", [img1, img2])
    _check_dtype("s2d_enter", dtype)
    b, h, w, c = img1.shape
    if c != 1 or img2.shape != img1.shape or img2.dtype != img1.dtype:
        raise ValueError(f"s2d_enter: a pair of (B, H, W, 1) images of one "
                         f"dtype, got {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)}")
    if h % 2 or w % 2:
        raise ValueError(f"s2d_enter: H and W must be even, got {h}x{w}")
    y = torch.empty((2 * b, h // 2, w // 2, 4), dtype=dtype,
                    device=img1.device)
    fn = kernel_function("mmif_s2d_enter", [_I, _I, _P, _P, _P, _I, _I, _I,
                                            _P])
    with torch.cuda.device(img1.device):
        err = fn(DTYPE_CODES[img1.dtype], DTYPE_CODES[dtype], ptr(img1),
                 ptr(img2), ptr(y), b, h, w, stream_handle(img1.device))
    check_launch("s2d_enter", err)
    return y


def s2d_exit(t):
    """t (n, H/2, W/2, 4) -> (n, H, W, 1) in t's dtype."""
    if t.device.type == "cpu":
        return s2d_exit_plain(t)
    check_no_grad("s2d_exit", t)
    check_tensors("s2d_exit", [t])
    n, h2, w2, c = t.shape
    if c != 4:
        raise ValueError(f"s2d_exit: 4 packed channels, got {c}")
    y = torch.empty((n, 2 * h2, 2 * w2, 1), dtype=t.dtype, device=t.device)
    fn = kernel_function("mmif_s2d_exit", [_I, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(t.device):
        err = fn(DTYPE_CODES[t.dtype], ptr(t), ptr(y), n, 2 * h2, 2 * w2,
                 stream_handle(t.device))
    check_launch("s2d_exit", err)
    return y
