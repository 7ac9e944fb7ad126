"""The full-reference image-quality metrics (counterpart of
multi_modal_image_fusion_tpu ops/metrics.py, reference core/metric.py) over
NHWC tensors, in 0..255 unless a data_range says otherwise.

Batching: the JAX eval CLI gets per-image values through `jax.vmap`; here
the batch dimension is written out. Every metric reduces over dims 1-3 of a
(B, H, W, C) input, never over the batch, and returns shape (B,), so one
image gives the JAX value as a 1-element tensor. `calc_ssim` and
`calc_msssim` keep the JAX contract of one mean over the whole input (the
test CLI calls them on single pairs) unless `per_image=True`.

On the card the windowed maps go through the hand-written kernels:
`ssim_maps` (ops/cuda/ssim_kernel.py) for SSIM and every MS-SSIM level, as
the JAX package runs its Pallas SSIM kernel there (metrics.py:232-236), and
`moments` (ops/cuda/moments.py) for the four VIF scales (metrics.py:
288-292). The VIF masking chain is torch, in exactly the JAX order. The
remaining filters (the VIF pyramid's downsampling Gaussian, the Sobel pair
of Qabf) are cuDNN convolutions, run in full f32 as the JAX package runs
them at HIGHEST precision: cuDNN would take TF32 by default. Histograms are
exact bincounts (ops/histogram.py).
"""

import contextlib
from math import pi

import torch

from .cuda.moments import moments
from .cuda.ssim_kernel import ssim_maps
from .histogram import histogram256_batched, joint_histogram256_batched
from .losses import sobel_xy
from .ssim import MSSSIM_WEIGHTS, downsample_half, gaussian_filter, \
    gaussian_kernel

__all__ = [
    "calc_mean", "calc_std", "calc_ag", "calc_sf", "calc_mse", "calc_psnr",
    "calc_cc", "calc_scd", "calc_entropy", "calc_cross_ent", "calc_mul_info",
    "calc_Qabf", "calc_Nabf", "calc_Labf", "calc_ssim", "calc_msssim",
    "calc_viff", "calc_Qxy", "calc_vif", "calc_joint_ent", "eval_metrics",
]

_IMAGE_DIMS = (1, 2, 3)


def _mean(x):
    return x.mean(dim=_IMAGE_DIMS)


def _sum(x):
    return x.sum(dim=_IMAGE_DIMS)


@contextlib.contextmanager
def _full_f32():
    """cuDNN's f32 convolutions without TF32 (a no-op on the CPU)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# 1. mean
def calc_mean(img):
    return _mean(img)


# 2. standard deviation
def calc_std(img):
    im = img - img.mean(dim=_IMAGE_DIMS, keepdim=True)
    return torch.sqrt(_mean(im * im))


# 3. average gradient
def calc_ag(img):
    x_grad = img[:, :-1, 1:, :] - img[:, :-1, :-1, :]
    y_grad = img[:, 1:, :-1, :] - img[:, :-1, :-1, :]
    return _mean(torch.sqrt((x_grad ** 2 + y_grad ** 2) * 0.5))


# 4. spatial frequency
def calc_sf(img):
    y_grad = img[:, 1:, :, :] - img[:, :-1, :, :]
    x_grad = img[:, :, 1:, :] - img[:, :, :-1, :]
    return torch.sqrt(_mean(y_grad ** 2) + _mean(x_grad ** 2))


# 5. mean squared error (on /255-normalized images, metric.py:63-68)
def calc_mse(img1, img2):
    err = img1 / 255.0 - img2 / 255.0
    return _mean(err * err)


# 6. peak signal-to-noise ratio
def calc_psnr(mse, L=1.0, root=False):
    if root:
        return 20.0 * torch.log10(L / torch.sqrt(mse))
    return 10.0 * torch.log10(L ** 2 / mse)


# 7. correlation coefficient
def calc_cc(img1, img2):
    im1 = img1 - img1.mean(dim=_IMAGE_DIMS, keepdim=True)
    im2 = img2 - img2.mean(dim=_IMAGE_DIMS, keepdim=True)
    return _sum(im1 * im2) / torch.sqrt(_sum(im1 * im1) * _sum(im2 * im2))


# 8. sum of correlations of differences
def calc_scd(img1, img2, imgf):
    return calc_cc(imgf - img1, img2) + calc_cc(imgf - img2, img1)


# 9-12. information metrics over exact 256-bin histograms
def calc_prob(img):
    """Per-image bin probabilities (torch.histc semantics, metric.py:
    103-116) -> (B, 256)."""
    return histogram256_batched(img) / img[0].numel()


def calc_joint_prob(img1, img2):
    """Per-image joint probabilities (np.histogram2d semantics, metric.py:
    129-145) -> (B, 65536)."""
    return joint_histogram256_batched(img1, img2).reshape(
        img1.shape[0], -1) / img1[0].numel()


def _plogp(p):
    return torch.where(p > 0, -p * torch.log2(torch.where(p > 0, p, 1.0)),
                       0.0)


def calc_entropy(img):
    return _plogp(calc_prob(img)).sum(dim=-1)


def calc_joint_ent(img1, img2):
    return _plogp(calc_joint_prob(img1, img2)).sum(dim=-1)


def calc_cross_ent(img1, img2):
    p1 = calc_prob(img1)
    p2 = calc_prob(img2)
    valid = (p1 * p2) != 0
    safe1 = torch.where(valid, p1, 1.0)
    safe2 = torch.where(valid, p2, 1.0)
    return torch.where(valid, p1 * torch.log2(safe1 / safe2), 0.0).sum(dim=-1)


def calc_mul_info(img1, img2, normalized=False):
    en1 = calc_entropy(img1)
    en2 = calc_entropy(img2)
    mi = en1 + en2 - calc_joint_ent(img1, img2)
    if normalized:
        return 2.0 * mi / (en1 + en2)
    return mi


# 13-15. edge-transfer metrics (Qabf / Nabf / Labf)
def _sobel_mag_angle(img):
    with _full_f32():
        gx, gy = sobel_xy(img)
    return torch.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx)


def calc_Qxy(img1, img2, mode="qabf", full=False):
    """Per-pixel edge-preservation map of img2 against img1, with img1's
    (and with full=True img2's) Sobel magnitude."""
    g1, a1 = _sobel_mag_angle(img1)
    g2, a2 = _sobel_mag_angle(img2)

    gmax = torch.maximum(g1, g2)
    G = torch.where(gmax != 0,
                    torch.minimum(g1, g2) / torch.where(gmax != 0, gmax, 1.0),
                    0.0)
    A = torch.abs(torch.abs(a1 - a2) - pi / 2) * 2 / pi

    if mode == "qabf":       # constants from the original paper
        Gg, kg, sg = 0.9994, 15, 0.5
        Ga, ka, sa = 0.9879, 22, 0.8
    elif mode == "nabf":     # constants from the matlab code
        Gg, kg, sg = 0.9999, 19, 0.5
        Ga, ka, sa = 0.9995, 22, 0.5
    else:
        raise ValueError(mode)

    Qg = Gg / (1 + torch.exp(-kg * (G - sg)))
    Qa = Ga / (1 + torch.exp(-ka * (A - sa)))
    if full:
        return Qg * Qa, g1, g2
    return Qg * Qa, g1


def calc_Qabf(img1, img2, imgf, L=1.5, full=False):
    Qaf, ga, gf = calc_Qxy(img1, imgf, full=True)
    Qbf, gb = calc_Qxy(img2, imgf)

    wa = ga ** L
    wb = gb ** L
    den = _sum(wa + wb)
    qabf = _sum(Qaf * wa + Qbf * wb) / den

    if full:
        gmax = torch.maximum(ga, gb)
        AM = torch.where(gf > gmax, 1.0, 0.0)
        RR = torch.where(gf <= gmax, 1.0, 0.0)
        nabf = _sum(AM * ((1.0 - Qaf) * wa + (1.0 - Qbf) * wb)) / den
        labf = _sum(RR * ((1.0 - Qaf) * wa + (1.0 - Qbf) * wb)) / den
        return qabf, nabf, labf  # qabf + nabf + labf = 1
    return qabf


def calc_Nabf(img1, img2, imgf, L=1.5, modified=True):
    Qaf, ga, gf = calc_Qxy(img1, imgf, mode="qabf", full=True)
    Qbf, gb = calc_Qxy(img2, imgf, mode="qabf")
    wa = ga ** L
    wb = gb ** L
    AM = torch.where(gf > torch.maximum(ga, gb), 1.0, 0.0)
    if modified:
        return _sum(AM * ((1.0 - Qaf) * wa + (1.0 - Qbf) * wb)) / \
            _sum(wa + wb)
    return _sum(AM * ((2.0 - Qaf - Qbf) * (wa + wb))) / _sum(wa + wb)


def calc_Labf(img1, img2, imgf, L=1.5):
    Qaf, ga, gf = calc_Qxy(img1, imgf, mode="qabf", full=True)
    Qbf, gb = calc_Qxy(img2, imgf, mode="qabf")
    wa = ga ** L
    wb = gb ** L
    RR = torch.where(gf <= torch.maximum(ga, gb), 1.0, 0.0)
    return _sum(RR * ((1.0 - Qaf) * wa + (1.0 - Qbf) * wb)) / _sum(wa + wb)


# 16-17. SSIM / MS-SSIM (metric contract: data_range 255, sigma fixed at
# 1.5, window clipped to the image, reference metric.py:290-402)
def calc_ssim(img1, img2, win_size=11, data_range=255.0, use_padding=False,
              size_average=True, full=False, per_image=False):
    """SSIM of NHWC images. Returns a 0-dim tensor (the mean over the whole
    input), (B,) with per_image=True, or the maps with size_average=False;
    the (ssim, cs) pair with full=True."""
    h, w = img1.shape[1:3]
    ws = min(win_size, h, w)
    ssim, cs, _ = ssim_maps(img1, img2, ws, float(data_range), use_padding,
                            sigma=1.5)
    if size_average:
        reduce = _mean if per_image else torch.mean
        ssim = reduce(ssim)
        cs = reduce(cs)
    if full:
        return ssim, cs
    return ssim


def calc_msssim(img1, img2, win_size=11, data_range=255.0,
                use_padding=False, per_image=False):
    """5-level MS-SSIM: the cs of levels 1-4 and the ssim of level 5, each
    clipped at 1e-7, raised to MSSSIM_WEIGHTS and multiplied."""
    im1, im2 = img1, img2
    values = []
    levels = len(MSSSIM_WEIGHTS)
    for i in range(levels):
        ssim, cs = calc_ssim(im1, im2, win_size, data_range, use_padding,
                             full=True, per_image=per_image)
        if i < levels - 1:
            values.append(cs)
            im1 = downsample_half(im1)
            im2 = downsample_half(im2)
        else:
            values.append(ssim)
    values = torch.clamp(torch.stack(values), min=1e-7)
    weights = torch.as_tensor(MSSSIM_WEIGHTS, device=values.device)
    if per_image:
        weights = weights[:, None]
    return torch.prod(values ** weights, dim=0)


# 18. visual information fidelity (VIF / VIFF)
def calc_vif(img1, img2, use_padding=False):
    """4-scale VIF pyramid (reference metric.py:406-458). Returns lists of
    (VID, VIND, G) maps per scale; the masking chain keeps the JAX order.
    An image too small for a scale's window gives empty maps there."""
    eps = 1e-10
    sn_sq = 0.005 * 255 * 255
    VID, VIND, G = [], [], []

    im1, im2 = img1, img2
    for scale in range(1, 5):
        win_size = 2 ** (4 - scale + 1) + 1
        sigma = win_size / 5

        if scale > 1:
            kernel1d = gaussian_kernel(win_size, sigma)
            with _full_f32():
                im1 = gaussian_filter(im1, kernel1d, use_padding)
                im2 = gaussian_filter(im2, kernel1d, use_padding)
            im1 = im1[:, ::2, ::2, :]
            im2 = im2[:, ::2, ::2, :]

        mu1, mu2, m11, m22, m12 = moments(im1, im2, win_size, sigma,
                                          use_padding)

        sigma1_sq = m11 - mu1 * mu1
        sigma2_sq = m22 - mu2 * mu2
        sigma12 = m12 - mu1 * mu2

        sigma1_sq = torch.clamp(sigma1_sq, min=0.0)
        sigma2_sq = torch.clamp(sigma2_sq, min=0.0)

        g = sigma12 / (sigma1_sq + eps)
        sv_sq = sigma2_sq - g * sigma12

        m1 = sigma1_sq < eps
        g = torch.where(m1, 0.0, g)
        sv_sq = torch.where(m1, sigma2_sq, sv_sq)
        sigma1_sq = torch.where(m1, 0.0, sigma1_sq)

        m2 = sigma2_sq < eps
        g = torch.where(m2, 0.0, g)
        sv_sq = torch.where(m2, 0.0, sv_sq)

        mg = g < 0
        sv_sq = torch.where(mg, sigma2_sq, sv_sq)
        g = torch.where(mg, 0.0, g)

        sv_sq = torch.where(sv_sq < eps, eps, sv_sq)

        VID.append(torch.log2(1 + g * g * sigma1_sq / (sv_sq + sn_sq)))
        VIND.append(torch.log2(1 + sigma1_sq / sn_sq))
        G.append(g)

    return VID, VIND, G


def calc_viff(img1, img2, imgf, simple=True):
    N1, D1, G1 = calc_vif(img1, imgf)
    N2, D2, G2 = calc_vif(img2, imgf)

    if simple:
        num1 = sum(_sum(n) for n in N1)
        num2 = sum(_sum(n) for n in N2)
        den1 = sum(_sum(d) for d in D1)
        den2 = sum(_sum(d) for d in D2)
        return num1 / den1 + num2 / den2

    p = torch.tensor([1.0, 0.0, 0.15, 1.0], device=imgf.device) / 2.15
    viff = []
    for i in range(4):
        sel = G1[i] < G2[i]
        viff.append(_sum(torch.where(sel, N1[i], N2[i]))
                    / _sum(torch.where(sel, D1[i], D2[i])))
    return (p[:, None] * torch.stack(viff)).sum(dim=0)


def eval_metrics(img1, img2, imgf):
    """The 16-value metric bundle of the eval CLI (reference eval.py:29-75)
    on (B, H, W, 1) stacks in 0..255: a dict of (B,) tensors. On the card
    one call launches `ssim_maps` 12 times (2 SSIM + 2 x 5 MS-SSIM levels)
    and `moments` 8 times (2 VIF pyramids x 4 scales)."""
    mse = (calc_mse(img1, imgf) + calc_mse(img2, imgf)) * 0.5
    qabf, nabf, labf = calc_Qabf(img1, img2, imgf, L=1.5, full=True)
    return {
        "sd": calc_std(imgf),
        "ag": calc_ag(imgf),
        "sf": calc_sf(imgf),
        "mse": mse,
        "psnr": calc_psnr(mse),
        "cc": (calc_cc(img1, imgf) + calc_cc(img2, imgf)) * 0.5,
        "scd": calc_scd(img1, img2, imgf),
        "en": calc_entropy(imgf),
        "ce": calc_cross_ent(img1, imgf) + calc_cross_ent(img2, imgf),
        "mi": calc_mul_info(img1, imgf, normalized=True) +
              calc_mul_info(img2, imgf, normalized=True),
        "qabf": qabf,
        "nabf": nabf,
        "labf": labf,
        "ssim": (calc_ssim(img1, imgf, per_image=True)
                 + calc_ssim(img2, imgf, per_image=True)) * 0.5,
        "msssim": (calc_msssim(img1, imgf, per_image=True)
                   + calc_msssim(img2, imgf, per_image=True)) * 0.5,
        "viff": calc_viff(img1, img2, imgf, simple=False),
    }
