"""Normalization and the dihedral-group augmentation (counterpart of
multi_modal_image_fusion_tpu data/transform.py). Host-side numpy on HW or
HWC images."""

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


def transform(img, mode=0):
    """The 8 dihedral-group transforms (reference data/transform.py:38-66)."""
    if mode == 0:
        return img
    if mode == 1:
        return np.fliplr(img)
    if mode == 2:
        return np.rot90(img, k=2)
    if mode == 3:
        return np.flipud(img)
    if mode == 4:
        return np.rot90(img, k=1)
    if mode == 5:
        return np.flipud(np.rot90(img, k=1))
    if mode == 6:
        return np.rot90(img, k=-1)
    if mode == 7:
        return np.flipud(np.rot90(img, k=-1))
    return img
