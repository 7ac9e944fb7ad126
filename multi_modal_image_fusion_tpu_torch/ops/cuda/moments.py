"""Windowed-moments kernel (csrc/moments.cu) with its plain version.

Replaces the TPU kernel `ops/pallas/moments_kernel.py:50 moments_pallas`:
one pass over a grayscale pair that writes the five Gaussian-filtered
moment maps mu1, mu2, E[x1^2], E[x2^2] and E[x1*x2] that the VIF pyramid
consumes (ops/metrics.calc_vif). On an H100 it is bound by memory traffic;
its body is the window stencil of csrc/window_stencil.cuh, shared with
ssim_maps.

The taps come from ops/ssim.gaussian_kernel in numpy (f32), once per
(window, sigma), so the kernel and the plain version (`moments_plain`, the
five separable Gaussian filters of ops/ssim.py) use the same numbers. VALID
maps are (N, H-ws+1, W-ws+1, 1); with use_padding the pair is
reflect-padded first and the maps keep (N, H, W, 1). A pair smaller than
the window gives empty maps, as the JAX package's filters do, and launches
nothing. CPU tensors take the plain version; a CUDA tensor launches the
kernel or raises. The kernel is forward-only: with grad mode on and an
image that requires grad it raises.
"""

import ctypes

from ..ssim import gaussian_filter
from .window import (window_entry, window_launch, window_outputs,
                     window_planes, window_taps)

__all__ = ["moments", "moments_plain"]

_MAX_WS = 17
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P)


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
    taps, taps_ptr = window_taps(ws, sigma)
    if img1.device.type == "cpu":
        return moments_plain(img1, img2, taps, use_padding)
    a, b = window_planes("moments", img1, img2, ws, _MAX_WS, use_padding)
    n, h, w = a.shape
    out = window_outputs(5, n, max(h - ws + 1, 0), max(w - ws + 1, 0),
                         a.device)
    if n == 0 or h < ws or w < ws:
        return out
    window_launch("moments", window_entry("mmif_moments", ARGTYPES), a,
                  a.data_ptr(), b.data_ptr(), *(o.data_ptr() for o in out),
                  n, h, w, ws, taps_ptr)
    return out
