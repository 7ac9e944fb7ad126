"""Host side of the window-stencil kernels (csrc/window_stencil.cuh):
`ssim_maps` (ops/cuda/ssim_kernel.py) and `moments` (ops/cuda/moments.py).

A call's host work is kept small, since the test CLI launches `ssim_maps`
on one 1224x1024 pair, where the kernel takes about as long as the Python
around it: the taps of a (window, sigma) are computed once
(`window_taps`), each C entry is typed once (`window_entry`), the outputs
are one allocation, and the device guard is entered only when the pair
lies on another device than the current one.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ssim import gaussian_kernel
from .build import check_launch, check_no_grad, kernel_function


@functools.lru_cache(maxsize=64)
def window_taps(ws, sigma):
    """The ws f32 taps of a Gaussian of std `sigma` (ops/ssim.
    gaussian_kernel), read-only, and their host address."""
    taps = np.ascontiguousarray(gaussian_kernel(ws, sigma), np.float32)
    taps.flags.writeable = False
    return taps, taps.ctypes.data


@functools.lru_cache(maxsize=None)
def window_entry(name, argtypes):
    """The C entry `name` of the kernel library, typed once."""
    return kernel_function(name, list(argtypes))


def window_planes(name, img1, img2, ws, max_ws, use_padding):
    """The (n, h, w) f32 planes of a CUDA pair of (N, H, W, 1) images for a
    window kernel, reflect-padded by ws // 2 with use_padding; raises on
    what the kernel does not take."""
    check_no_grad(name, img1, img2)
    if not (img1.is_cuda and img2.is_cuda and img1.device == img2.device):
        raise ValueError(f"{name}: both images must be on one CUDA device")
    if img1.shape != img2.shape or img1.dim() != 4 or img1.shape[-1] != 1:
        raise ValueError(f"{name}: expects two (N, H, W, 1) images, got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    if not 1 <= ws <= max_ws:
        raise ValueError(f"{name}: window {ws} outside the kernel's 1.."
                         f"{max_ws}")
    a = img1.float()[..., 0]
    b = img2.float()[..., 0]
    if use_padding:
        p = ws // 2
        a = F.pad(a[:, None], (p, p, p, p), mode="reflect")[:, 0]
        b = F.pad(b[:, None], (p, p, p, p), mode="reflect")[:, 0]
    return a.contiguous(), b.contiguous()


def window_outputs(k, n, oh, ow, device):
    """k f32 maps of (n, oh, ow, 1), one allocation."""
    return torch.empty((k, n, oh, ow, 1), dtype=torch.float32,
                       device=device).unbind(0)


def window_launch(name, fn, a, *args):
    """fn(*args, stream) on a's device and its current stream; raises if the
    launch was refused, else counts it under `name`."""
    dev = a.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return window_launch(name, fn, a, *args)
    check_launch(name, fn(*args, torch.cuda.current_stream().cuda_stream))
