"""SSIM maps kernel (csrc/ssim.cu) with its plain version.

Replaces the TPU kernel `ops/pallas/ssim_kernel.py:86 ssim_maps_pallas`:
one pass over a grayscale pair that computes the five products, the
separable Gaussian window and the SSIM algebra, and writes the ssim, cs and
sigma1^2 maps. On an H100 it is bound by memory traffic (about 5 operations
per byte); its body is the window stencil of csrc/window_stencil.cuh, which
keeps every filtered map on chip (tall strips, both passes blocked in
registers).

The taps are computed once per (window, sigma) in numpy
(ops/ssim.gaussian_kernel, f32), so the kernel and the plain version use
the same numbers. CPU tensors take the plain version; a CUDA tensor
launches the kernel or raises. The kernel is forward-only: with grad mode
on and an image that requires grad it raises (the training losses use the
differentiable plain maps, ops/ssim.py).
"""

import ctypes

from ..ssim import default_sigma
from ..ssim import ssim_maps as ssim_maps_plain   # the plain version
from .window import (window_entry, window_launch, window_outputs,
                     window_planes, window_taps)

__all__ = ["ssim_maps", "ssim_maps_plain"]

_MAX_WS = 11
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _F, _P)


def ssim_maps(img1, img2, win_size=11, data_range=1.0, use_padding=False,
              sigma=None):
    """(ssim, cs, sigma1_sq) maps of NHWC single-channel pairs, f32.
    VALID: each map is (N, H-ws+1, W-ws+1, 1), or (N, H, W, 1) with
    use_padding (reflect)."""
    ws = win_size
    taps, taps_ptr = window_taps(ws, default_sigma(ws) if sigma is None
                                 else sigma)
    if img1.device.type == "cpu":
        return ssim_maps_plain(img1, img2, taps, data_range, use_padding)
    a, b = window_planes("ssim_maps", img1, img2, ws, _MAX_WS, use_padding)
    n, h, w = a.shape
    if h < ws or w < ws:
        raise ValueError(f"ssim_maps: {h}x{w} is smaller than the window")
    out = window_outputs(3, n, h - ws + 1, w - ws + 1, a.device)
    window_launch("ssim_maps", window_entry("mmif_ssim_maps", ARGTYPES), a,
                  a.data_ptr(), b.data_ptr(), *(o.data_ptr() for o in out),
                  n, h, w, ws, taps_ptr, (0.01 * data_range) ** 2,
                  (0.03 * data_range) ** 2)
    return out
