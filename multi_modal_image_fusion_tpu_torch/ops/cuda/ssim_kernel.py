"""SSIM maps kernel (csrc/ssim.cu) with its plain version.

Replaces the TPU kernel `ops/pallas/ssim_kernel.py:86 ssim_maps_pallas`:
one pass over a grayscale pair that computes the five products, the
separable Gaussian window and the SSIM algebra, and writes the ssim, cs and
sigma1^2 maps. On an H100 it is bound by memory traffic (about 5 operations
per byte), so the kernel reads each pixel once per tile and keeps every
filtered moment map in shared memory (csrc/ssim.cu header).

The taps are computed once in numpy (ops/ssim.gaussian_kernel, f32), so the
kernel and the plain version use the same numbers. CPU tensors take the
plain version; a CUDA tensor launches the kernel or raises. The kernel is
forward-only: with grad mode on and an image that requires grad it raises
(the training losses use the differentiable plain maps, ops/ssim.py).
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..ssim import default_sigma, gaussian_kernel
from ..ssim import ssim_maps as ssim_maps_plain   # the plain version
from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle

__all__ = ["ssim_maps", "ssim_maps_plain"]

_MAX_WS = 11
_GRID_Z_MAX = 65535


def ssim_maps(img1, img2, win_size=11, data_range=1.0, use_padding=False,
              sigma=None):
    """(ssim, cs, sigma1_sq) maps of NHWC single-channel pairs, f32.
    VALID: each map is (N, H-ws+1, W-ws+1, 1), or (N, H, W, 1) with
    use_padding (reflect)."""
    ws = win_size
    taps = gaussian_kernel(ws, default_sigma(ws) if sigma is None else sigma)
    if img1.device.type == "cpu":
        return ssim_maps_plain(img1, img2, taps, data_range, use_padding)
    check_no_grad("ssim_maps", img1, img2)
    if not (img1.is_cuda and img2.is_cuda and img1.device == img2.device):
        raise ValueError("ssim_maps: both images must be on one CUDA device")
    if img1.shape != img2.shape or img1.dim() != 4 or img1.shape[-1] != 1:
        raise ValueError(f"ssim_maps: expects two (N, H, W, 1) images, got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    if not 1 <= ws <= _MAX_WS:
        raise ValueError(f"ssim_maps: window {ws} above the kernel's "
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
    if h < ws or w < ws:
        raise ValueError(f"ssim_maps: {h}x{w} is smaller than the window")
    if n > _GRID_Z_MAX:
        raise ValueError(f"ssim_maps: batch {n} too large for one launch")
    oh, ow = h - ws + 1, w - ws + 1
    out = [torch.empty((n, oh, ow, 1), dtype=torch.float32, device=a.device)
           for _ in range(3)]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    taps_c = np.ascontiguousarray(taps, np.float32)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = kernel_function("mmif_ssim_maps",
                         [P, P, P, P, P, I, I, I, I, P, Fl, Fl, P])
    with torch.cuda.device(a.device):
        err = fn(ptr(a), ptr(b), ptr(out[0]), ptr(out[1]), ptr(out[2]),
                 n, h, w, ws, taps_c.ctypes.data_as(ctypes.c_void_p),
                 c1, c2, stream_handle(a.device))
    check_launch("ssim_maps", err)
    return tuple(out)
