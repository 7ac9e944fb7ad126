"""Image-quality metrics (counterpart of multi_modal_image_fusion_tpu
ops/metrics.py). This slice ports `calc_ssim` only; the other 16 metrics
come with the eval slice (ROADMAP.md)."""

from .cuda.ssim_kernel import ssim_maps


def calc_ssim(img1, img2, win_size=11, data_range=255.0, use_padding=False,
              size_average=True, full=False):
    """SSIM of NHWC images (metric contract: sigma fixed at 1.5, window
    clipped to the image, reference metric.py:290-364). Returns a 0-dim
    tensor, or the (ssim, cs) pair with full=True; maps when
    size_average=False."""
    h, w = img1.shape[1:3]
    ws = min(win_size, h, w)
    ssim, cs, _ = ssim_maps(img1, img2, ws, float(data_range), use_padding,
                            sigma=1.5)
    if size_average:
        ssim = ssim.mean()
        cs = cs.mean()
    if full:
        return ssim, cs
    return ssim
