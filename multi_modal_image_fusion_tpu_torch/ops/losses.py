"""Unsupervised fusion training losses (counterpart of
multi_modal_image_fusion_tpu ops/losses.py; reference core/loss.py).
Differentiable torch on NHWC tensors, with the reference's call signatures
(`loss(img1, img2, imgf)`).

Every SSIM here runs through the plain, differentiable maps of ops/ssim.py,
never through the forward-only SSIM kernel. `mask` is an optional (N,) 0/1
batch weight: masked samples drop out of the batch average (`_wmean`).
"""

import torch

from .ssim import (MSSSIM_WEIGHTS, default_sigma, downsample_half,
                   gaussian_kernel, infer_data_range, separable_filter,
                   ssim_maps)

__all__ = [
    "calc_ssim", "calc_msssim", "SSIM", "MS_SSIM", "MSW_SSIM", "SSIMLoss",
    "PixelLoss", "GradLoss", "TVLoss", "NormLoss", "sobel_grad", "sobel_xy",
]

eps = 1e-7


def _wmean(per_sample, mask):
    """Mean of a per-sample vector, optionally weighted by a 0/1 batch mask
    (the masked samples drop out of the average)."""
    if mask is None:
        return per_sample.mean()
    mask = mask.to(per_sample.dtype)
    return (per_sample * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# SSIM family (reference loss.py:52-160)
# ---------------------------------------------------------------------------


def calc_ssim(img1, img2, win_size=11, kernel1d=None, data_range=None,
              use_padding=False, size_average=True):
    """The reference's dict {ssim, cs, sigma} (loss.py:52-110): per-sample
    vectors when size_average, else maps."""
    if kernel1d is None:
        h, w = img1.shape[1:3]
        ws = min(win_size, h, w)
        kernel1d = gaussian_kernel(ws, default_sigma(ws))
    L = infer_data_range(img1) if data_range is None else data_range

    ssim, cs, sigma1_sq = ssim_maps(img1, img2, kernel1d, L, use_padding)
    sigma = torch.clamp(sigma1_sq, min=1e-4)

    if size_average:
        ssim = ssim.mean(dim=(1, 2, 3))
        cs = cs.mean(dim=(1, 2, 3))
        sigma = sigma.mean(dim=(1, 2, 3))
    return {"ssim": ssim, "cs": cs, "sigma": sigma}


def calc_msssim(img1, img2, win_size=11, kernel1d=None, weights=None,
                data_range=None, use_padding=False, size_average=True):
    """5-level MS-SSIM with cs-product weighting (loss.py:113-160)."""
    if weights is None:
        weights = MSSSIM_WEIGHTS
    if kernel1d is None:
        h, w = img1.shape[1:3]
        ws = min(win_size, h, w)
        kernel1d = gaussian_kernel(ws, default_sigma(ws))

    im1, im2 = img1, img2
    values = []
    levels = len(weights)
    for i in range(levels):
        out = calc_ssim(im1, im2, win_size, kernel1d, data_range, use_padding,
                        size_average)
        if i < levels - 1:
            values.append(out["cs"])
            im1 = downsample_half(im1)
            im2 = downsample_half(im2)
        else:
            values.append(out["ssim"])

    result = None
    for v, wt in zip(values, weights):
        term = torch.clamp(v, min=eps) ** float(wt)
        result = term if result is None else result * term
    return result


class SSIM:
    """Structural Similarity Index (reference loss.py:163-185)."""

    def __init__(self, win_size=11, data_range=1.0, use_padding=False,
                 size_average=True):
        self.win_size = win_size
        self.data_range = data_range
        self.use_padding = use_padding
        self.size_average = size_average
        self.kernel1d = gaussian_kernel(win_size, default_sigma(win_size))

    def __call__(self, img1, img2):
        return calc_ssim(img1, img2, self.win_size, self.kernel1d,
                         self.data_range, self.use_padding, self.size_average)


class MS_SSIM(SSIM):
    """Multi-Scale SSIM (reference loss.py:188-208)."""

    def __call__(self, img1, img2):
        return calc_msssim(img1, img2, self.win_size, self.kernel1d,
                           MSSSIM_WEIGHTS, self.data_range, self.use_padding,
                           self.size_average)


class MSW_SSIM:
    """Multi-window sigma-weighted SSIM over windows 11/9/7/5/3 (reference
    loss.py:211-237)."""

    def __init__(self, win_sizes=(11, 9, 7, 5, 3), data_range=1.0,
                 use_padding=False, size_average=False):
        self.win_sizes = win_sizes
        self.ssim_fns = [
            SSIM(ws, data_range, use_padding, size_average)
            for ws in win_sizes
        ]

    def __call__(self, img1, img2, imgf, mask=None):
        ssim = 0.0
        for ssim_fn in self.ssim_fns:
            out1 = ssim_fn(img1, imgf)
            out2 = ssim_fn(img2, imgf)
            gamma = out1["sigma"] / torch.clamp(
                out1["sigma"] + out2["sigma"], min=eps)
            # size_average=False: per-pixel maps, reduced per sample before
            # the (masked) batch mean
            v1 = (gamma * out1["ssim"]).mean(dim=(1, 2, 3))
            v2 = ((1.0 - gamma) * out2["ssim"]).mean(dim=(1, 2, 3))
            ssim = ssim + _wmean(v1, mask) + _wmean(v2, mask)
        return ssim / len(self.win_sizes)


class SSIMLoss:
    """weight * (1 - ssim-family score) (reference loss.py:240-284)."""

    def __init__(self, mode="ssim", data_range=1.0, use_padding=False,
                 weight=1.0):
        if mode not in ("ssim", "w-ssim", "ms-ssim", "msw-ssim"):
            raise ValueError("only supported ['ssim', 'w-ssim', 'ms-ssim', "
                             "'msw-ssim'] mode")
        self.mode = mode
        self.data_range = data_range
        self.use_padding = use_padding
        self.weight = weight

    def __call__(self, img1, img2, imgf, mask=None):
        if self.mode == "ssim":
            fn = SSIM(11, self.data_range, self.use_padding)
            loss = (_wmean(fn(img1, imgf)["ssim"], mask) +
                    _wmean(fn(img2, imgf)["ssim"], mask)) * 0.5
        elif self.mode == "w-ssim":
            fn = SSIM(11, self.data_range, self.use_padding)
            out1 = fn(img1, imgf)
            out2 = fn(img2, imgf)
            gamma = out1["sigma"] / torch.clamp(
                out1["sigma"] + out2["sigma"], min=eps)
            loss = _wmean(gamma * out1["ssim"], mask) + \
                _wmean((1.0 - gamma) * out2["ssim"], mask)
        elif self.mode == "ms-ssim":
            fn = MS_SSIM(11, self.data_range, self.use_padding)
            loss = (_wmean(fn(img1, imgf), mask) +
                    _wmean(fn(img2, imgf), mask)) * 0.5
        else:
            fn = MSW_SSIM((11, 9, 7, 5, 3), self.data_range,
                          self.use_padding)
            loss = fn(img1, img2, imgf, mask)
        return self.weight * (1.0 - loss)


# ---------------------------------------------------------------------------
# pixel / gradient / tv / norm losses (reference loss.py:287-385)
# ---------------------------------------------------------------------------


class NormLoss:
    def __init__(self, mode="l1", weight=1.0):
        if mode not in ("l1", "l2"):
            raise ValueError("only supported ['l1', 'l2'] mode")
        self.mode = mode
        self.weight = weight

    def __call__(self, x, mask=None):
        v = torch.abs(x) if self.mode == "l1" else x * x
        if mask is None:
            return self.weight * v.mean()
        # per-sample spatial mean, then the masked batch mean
        return self.weight * _wmean(v.mean(dim=tuple(range(1, v.dim()))),
                                    mask)


class PixelLoss:
    """|imgf - max(img1, img2)| ('max') or the symmetric diffs ('avg')."""

    def __init__(self, mode="l1", weight=1.0):
        self.loss_fn = NormLoss(mode, weight)

    def __call__(self, img1, img2, imgf, mode="avg", mask=None):
        if mode == "avg":
            return (self.loss_fn(imgf - img1, mask) +
                    self.loss_fn(imgf - img2, mask)) * 0.5
        if mode == "max":
            return self.loss_fn(imgf - torch.maximum(img1, img2), mask)
        raise ValueError(mode)


def sobel_xy(img):
    """Reflect-padded Sobel x/y responses of an NHWC image (reference
    loss.py:314-328): the Sobel kernels are separable, [1, 2, 1] smoothing
    times a [-1, 0, 1] derivative."""
    gx = separable_filter(img, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0),
                          reflect=True)
    gy = separable_filter(img, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0),
                          reflect=True)
    return gx, gy


def sobel_grad(img):
    """|gx| + |gy| Sobel magnitude (reference loss.py:322-328)."""
    gx, gy = sobel_xy(img)
    return torch.abs(gx) + torch.abs(gy)


class GradLoss:
    """Pixel loss on Sobel-gradient magnitudes."""

    def __init__(self, mode="l1", weight=1.0):
        self.loss_fn = NormLoss(mode, weight)

    def __call__(self, img1, img2, imgf, mode="avg", mask=None):
        g1 = sobel_grad(img1)
        g2 = sobel_grad(img2)
        gf = sobel_grad(imgf)
        if mode == "avg":
            return (self.loss_fn(gf - g1, mask) +
                    self.loss_fn(gf - g2, mask)) * 0.5
        if mode == "max":
            return self.loss_fn(gf - torch.maximum(g1, g2), mask)
        raise ValueError(mode)


class TVLoss:
    """Total variation (reference loss.py:347-358); NHWC spatial axes 1, 2."""

    def __init__(self, mode="l1", weight=1.0):
        self.loss_fn = NormLoss(mode, weight)

    def __call__(self, x):
        tv_h = x[:, 1:, :, :] - x[:, :-1, :, :]
        tv_w = x[:, :, 1:, :] - x[:, :, :-1, :]
        return self.loss_fn(tv_h) + self.loss_fn(tv_w)
