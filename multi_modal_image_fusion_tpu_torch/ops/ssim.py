"""Gaussian-window SSIM core (counterpart of multi_modal_image_fusion_tpu
ops/ssim.py:18-29, 111-140). All functions take NHWC tensors.

The 2-D window is the outer product of a 1-D Gaussian, so the filter runs as
two 1-D convolutions. `ssim_maps` here is the plain version of the SSIM
kernel (ops/cuda/ssim_kernel.py).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


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


def gaussian_filter(img, kernel1d, use_padding=False):
    """Separable Gaussian filter of an NHWC image, f32: VALID (shrinks by
    ws-1) unless use_padding (reflect, keeps the shape)."""
    k = torch.as_tensor(np.asarray(kernel1d, np.float32), device=img.device)
    ws = k.shape[0]
    c = img.shape[-1]
    x = img.float().permute(0, 3, 1, 2)
    if use_padding:
        p = ws // 2
        x = F.pad(x, (p, p, p, p), mode="reflect")
    kh = k.view(1, 1, ws, 1).expand(c, 1, ws, 1)
    kw = k.view(1, 1, 1, ws).expand(c, 1, 1, ws)
    x = F.conv2d(x, kh, groups=c)
    x = F.conv2d(x, kw, groups=c)
    return x.permute(0, 2, 3, 1)


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
