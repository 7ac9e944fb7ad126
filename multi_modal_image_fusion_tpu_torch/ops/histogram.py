"""256-bin histograms for the information metrics EN, CE and MI
(counterpart of multi_modal_image_fusion_tpu ops/histogram.py).

Bins are `clip(trunc(x), 0, 255)`: the value truncated toward zero, as the
JAX package's `astype(int32)`, then clipped, so values below 0 count in bin
0 and values at 255.x or above count in bin 255. Counts are exact integers,
returned as f32.

The JAX package computes them as one-hot matmuls on the TPU's matrix unit,
a workaround for the TPU's slow scatter. Here they are `torch.bincount`,
which computes the same counts on either device; the joint histogram bins
`i1 * 256 + i2`. Each function has a per-image batched form for the eval
CLI's stacks, (B, H, W, C) -> (B, 256) or (B, 256, 256): the image index is
folded into the bin index, so one bincount serves the whole batch.
"""

import torch

__all__ = ["histogram256", "histogram256_batched", "joint_histogram256",
           "joint_histogram256_batched"]


def _bins(img):
    """(B, H*W*C) int64 bin indices."""
    return torch.clamp(img.to(torch.int32), 0, 255).reshape(
        img.shape[0], -1).long()


def histogram256_batched(img):
    """Per-image 256-bin counts of (B, ...) images -> (B, 256) f32."""
    b = img.shape[0]
    idx = _bins(img) + 256 * torch.arange(b, device=img.device)[:, None]
    return torch.bincount(idx.reshape(-1), minlength=256 * b).reshape(
        b, 256).float()


def joint_histogram256_batched(img1, img2):
    """Per-image 256x256 joint counts -> (B, 256, 256) f32, img1's bin
    first (np.histogram2d semantics)."""
    b = img1.shape[0]
    idx = (_bins(img1) * 256 + _bins(img2)
           + 65536 * torch.arange(b, device=img1.device)[:, None])
    return torch.bincount(idx.reshape(-1), minlength=65536 * b).reshape(
        b, 256, 256).float()


def histogram256(img):
    """256-bin counts over the whole input -> (256,) f32."""
    return histogram256_batched(img.reshape(1, -1))[0]


def joint_histogram256(img1, img2):
    """256x256 joint counts over the whole inputs -> (256, 256) f32."""
    return joint_histogram256_batched(img1.reshape(1, -1),
                                      img2.reshape(1, -1))[0]
