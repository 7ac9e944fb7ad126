"""Gaussian-window SSIM core shared by the losses and metrics (counterpart of
multi_modal_image_fusion_tpu ops/ssim.py). All functions take NHWC tensors
and are differentiable torch.

The 2-D window is the outer product of a 1-D Gaussian, so the filter runs as
two 1-D convolutions (`separable_filter`, which also carries the Sobel
filters of the gradient loss). `ssim_maps` here is the plain version of the
SSIM kernel (ops/cuda/ssim_kernel.py); the training losses call it, never
the kernel, which has no backward.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333],
                          dtype=np.float32)


def gaussian_kernel(win_size, sigma):
    """1-D normalized Gaussian, f32 (reference loss.py:24-30)."""
    g = np.array([
        math.exp(-((x - win_size // 2) ** 2) / (2.0 * sigma ** 2))
        for x in range(win_size)
    ], dtype=np.float32)
    return g / g.sum()


def default_sigma(win_size):
    """1.5 for the canonical 11-tap window (reference loss.py:34)."""
    return 1.5 if win_size == 11 else 0.15 * (win_size - 1)


@functools.lru_cache(maxsize=64)
def _taps_on(taps, device):
    # cached: a host-to-device copy of a pageable array synchronises the
    # stream, once per filter call in a train step otherwise
    return torch.tensor(taps, dtype=torch.float32, device=device)


def separable_filter(img, taps_h, taps_w, reflect=False):
    """Separable filter of an NHWC image in f32: `taps_h` correlated along H,
    `taps_w` along W, per channel. VALID (shrinks by len(taps) - 1) unless
    `reflect` (torch reflect padding, keeps the shape). A VALID filter wider
    than the image gives an empty result, as the JAX package's band-matrix
    filter does (F.conv2d would raise)."""
    n, h, w, c = img.shape
    if not reflect and (h < len(taps_h) or w < len(taps_w)):
        return img.new_zeros((n, max(h - len(taps_h) + 1, 0),
                              max(w - len(taps_w) + 1, 0), c),
                             dtype=torch.float32)
    x = img.float().permute(0, 3, 1, 2)
    th = _taps_on(tuple(float(t) for t in np.asarray(taps_h, np.float32)),
                  x.device)
    tw = _taps_on(tuple(float(t) for t in np.asarray(taps_w, np.float32)),
                  x.device)
    if reflect:
        ph, pw = len(th) // 2, len(tw) // 2
        x = F.pad(x, (pw, pw, ph, ph), mode="reflect")
    x = F.conv2d(x, th.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.conv2d(x, tw.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return x.permute(0, 2, 3, 1)


def gaussian_filter(img, kernel1d, use_padding=False):
    """Separable Gaussian filter of an NHWC image, f32: VALID (shrinks by
    ws-1) unless use_padding (reflect, keeps the shape)."""
    return separable_filter(img, kernel1d, kernel1d, reflect=use_padding)


def ssim_maps(img1, img2, kernel1d, data_range, use_padding=False):
    """Per-pixel (ssim, cs, sigma1_sq) maps (reference loss.py:52-103)."""
    img1 = img1.float()
    img2 = img2.float()
    mu1 = gaussian_filter(img1, kernel1d, use_padding)
    mu2 = gaussian_filter(img2, kernel1d, use_padding)

    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2

    sigma1_sq = torch.clamp(
        gaussian_filter(img1 * img1, kernel1d, use_padding) - mu1_sq, min=0)
    sigma2_sq = torch.clamp(
        gaussian_filter(img2 * img2, kernel1d, use_padding) - mu2_sq, min=0)
    sigma12 = gaussian_filter(img1 * img2, kernel1d, use_padding) - mu1_mu2

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    m1 = 2.0 * mu1_mu2 + c1
    m2 = mu1_sq + mu2_sq + c1
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2

    cs = v1 / v2
    ssim = (m1 * v1) / (m2 * v2)
    return ssim, cs, sigma1_sq


def infer_data_range(img1):
    """Data-dependent range (reference loss.py:60-63), a 0-dim tensor: 255 if
    the image looks 8-bit, 2 if it looks tanh-normalized, else 1."""
    one = torch.ones((), dtype=torch.float32, device=img1.device)
    max_val = torch.where(img1.max() > 128, 255.0 * one, one)
    min_val = torch.where(img1.min() < -0.5, -one, 0.0 * one)
    return max_val - min_val


def downsample_half(img):
    """Reflect-pad odd dims to even, then 2x2 average pool (reference
    loss.py:147-153): the MS-SSIM pyramid step."""
    h, w = img.shape[1:3]
    x = img.permute(0, 3, 1, 2)
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2), mode="reflect")
    return F.avg_pool2d(x, 2).permute(0, 2, 3, 1)
