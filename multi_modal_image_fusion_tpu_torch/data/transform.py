"""Normalization (counterpart of multi_modal_image_fusion_tpu
data/transform.py:13-36). Host-side numpy on HW or HWC images. The
dihedral augmentation comes with the training slice."""

import numpy as np

eps = 1e-7


def norm(img, mode=None):
    """Normalize a float32 image (reference data/transform.py:15-29)."""
    if mode is None:
        return img / 255.0
    if mode == "min-max":
        lo = img.min()
        hi = img.max()
        return (img - lo) / np.clip(hi - lo, eps, None)
    if mode == "z-score":
        mu = img.mean()
        sd = img.std()
        return (img - mu) / np.clip(sd, eps, None)
    raise ValueError("only supported ['min-max', 'z-score'] mode")


def denorm(img):
    """[0,1] float image (HW or HWC) -> uint8 HWC image (reference
    data/transform.py:32-35; the layout is already channels-last)."""
    img = np.asarray(img)
    im = np.clip(img, 0.0, 1.0) * 255.0
    if im.ndim == 2:
        im = im[..., None]
    return im.astype(np.uint8)
