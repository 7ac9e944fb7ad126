"""Windowed-moments kernel (csrc/moments.cu) with its plain version.

Replaces the TPU kernel `ops/pallas/moments_kernel.py:50 moments_pallas`:
one pass over a grayscale pair that writes the five Gaussian-filtered
moment maps mu1, mu2, E[x1^2], E[x2^2] and E[x1*x2] that the VIF pyramid
consumes (ops/metrics.calc_vif). On an H100 it is bound by memory traffic,
so the kernel reads each pixel once per tile and keeps the vertical pass in
shared memory (csrc/moments.cu header).

The taps come from ops/ssim.gaussian_kernel in numpy (f32), so the kernel
and the plain version (`moments_plain`, the five separable Gaussian
filters of ops/ssim.py) use the same numbers. VALID maps are (N, H-ws+1,
W-ws+1, 1); with use_padding the pair is reflect-padded first and the maps
keep (N, H, W, 1). A pair smaller than the window gives empty maps, as the
JAX package's filters do, and launches nothing. CPU tensors take the plain
version; a CUDA tensor launches the kernel or raises. The kernel is
forward-only: with grad mode on and an image that requires grad it raises.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..ssim import gaussian_filter, gaussian_kernel
from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle

__all__ = ["moments", "moments_plain"]

_MAX_WS = 17
_GRID_Z_MAX = 65535


def moments_plain(img1, img2, kernel1d, use_padding=False):
    """The five moment maps as five separable Gaussian filters in f32
    (JAX ops/metrics.py:294-298)."""
    a, b = img1.float(), img2.float()
    return tuple(gaussian_filter(x, kernel1d, use_padding)
                 for x in (a, b, a * a, b * b, a * b))


def moments(img1, img2, win_size, sigma, use_padding=False):
    """(mu1, mu2, m11, m22, m12) of NHWC single-channel pairs, f32, under a
    `win_size`-tap Gaussian of std `sigma`."""
    ws = win_size
    taps = gaussian_kernel(ws, sigma)
    if img1.device.type == "cpu":
        return moments_plain(img1, img2, taps, use_padding)
    check_no_grad("moments", img1, img2)
    if not (img1.is_cuda and img2.is_cuda and img1.device == img2.device):
        raise ValueError("moments: both images must be on one CUDA device")
    if img1.shape != img2.shape or img1.dim() != 4 or img1.shape[-1] != 1:
        raise ValueError(f"moments: expects two (N, H, W, 1) images, got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    if not 1 <= ws <= _MAX_WS:
        raise ValueError(f"moments: window {ws} outside the kernel's 1.."
                         f"{_MAX_WS}")
    a = img1.float()[..., 0]
    b = img2.float()[..., 0]
    if use_padding:
        p = ws // 2
        a = F.pad(a[:, None], (p, p, p, p), mode="reflect")[:, 0]
        b = F.pad(b[:, None], (p, p, p, p), mode="reflect")[:, 0]
    a = a.contiguous()
    b = b.contiguous()
    n, h, w = a.shape
    oh, ow = max(h - ws + 1, 0), max(w - ws + 1, 0)
    out = [torch.empty((n, oh, ow, 1), dtype=torch.float32, device=a.device)
           for _ in range(5)]
    if n == 0 or oh == 0 or ow == 0:
        return tuple(out)
    if n > _GRID_Z_MAX:
        raise ValueError(f"moments: batch {n} too large for one launch")
    taps_c = np.ascontiguousarray(taps, np.float32)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("mmif_moments",
                         [P, P, P, P, P, P, P, I, I, I, I, P, P])
    with torch.cuda.device(a.device):
        err = fn(ptr(a), ptr(b), *map(ptr, out), n, h, w, ws,
                 taps_c.ctypes.data_as(P), stream_handle(a.device))
    check_launch("moments", err)
    return tuple(out)
