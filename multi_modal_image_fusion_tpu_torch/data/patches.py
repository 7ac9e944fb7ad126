"""Non-overlapping patch extraction (counterpart of
multi_modal_image_fusion_tpu data/patches.py; replaces the `patchify` package, reference
data/patches.py:17, 106-123).

`patchify(img, (p, p), step=s)` tiles an HxW image into
floor((H-p)/s)+1 x floor((W-p)/s)+1 patches; trailing pixels that don't fill
a full patch are dropped. A zero-copy strided view.
"""

import numpy as np
from numpy.lib.stride_tricks import as_strided


def patchify(img, patch_size, step):
    if isinstance(patch_size, int):
        ph = pw = patch_size
    else:
        ph, pw = patch_size
    if isinstance(step, int):
        sh = sw = step
    else:
        sh, sw = step

    h, w = img.shape[-2:]
    nh = (h - ph) // sh + 1
    nw = (w - pw) // sw + 1
    if nh <= 0 or nw <= 0:
        raise ValueError(f"image {h}x{w} smaller than patch {ph}x{pw}")

    es = img.strides
    return as_strided(img, shape=(nh, nw, ph, pw),
                      strides=(es[-2] * sh, es[-1] * sw, es[-2], es[-1]),
                      writeable=False)


def extract_patches(img, patch_size, step):
    """Flattened copy: (N, ph, pw)."""
    v = patchify(img, patch_size, step)
    return np.ascontiguousarray(v).reshape(-1, v.shape[-2], v.shape[-1])
