"""File-based pair datasets (counterpart of multi_modal_image_fusion_tpu
data/dataset.py; reference data/dataset.py, data/patches.py).

Items are numpy HW float32 arrays; `Feeder` (pipeline.py) stacks them into
NHWC device batches. Semantics kept from the reference, with the same random
draws as the JAX package, so one seed gives the same items:

- images are listed from the `vis/` dir in natural order and paired by the
  filename substitution vis -> ir|po (dataset.py:92-109); train/valid is the
  80/20 split with sklearn(random_state=0) ordering (dataset.py:111-114)
- per-item augmentation: a random flip (`rng.choice(2)`, datasets) or one of
  the 8 dihedral transforms (`rng.choice(8)`, patches); `fix_size` crops a
  random 256 window (`rng.randint`) and resizes smaller images up to 256
- `FusionPatches` loads every image and tiles non-overlapping 64x64 patches
  (patches.py:26-27, 106-123), then shuffles once with python's seeded
  `random.shuffle` (patches.py:123); `AEDataset` shuffles its image list
  the same way
"""

import os
import random

import numpy as np

from ..utils.natsort import natsorted
from ..utils.split import train_test_split
from .io import imread_gray
from .patches import extract_patches
from .transform import norm, transform

img_size = 256
patch_size = 64
patch_step = 64

_IMG_EXTS = (".bmp", ".jpg", ".png")


def _list_pairs(root_dir, set_name, img_type):
    if set_name is None:
        img_dir = os.path.join(root_dir, "vis")
    else:
        img_dir = os.path.join(root_dir, set_name, "vis")

    img1_info, img2_info = [], []
    for img in natsorted(os.listdir(img_dir)):
        if img.endswith(_IMG_EXTS):
            img1_path = os.path.join(img_dir, img)
            img2_path = img1_path.replace("vis", img_type)
            if os.path.isfile(img2_path):
                img1_info.append(img1_path)
                img2_info.append(img2_path)
    return img1_info, img2_info


def _split(img1_info, img2_info, set_type):
    if set_type == "test":
        return list(zip(img1_info, img2_info))
    tr1, va1, tr2, va2 = train_test_split(img1_info, img2_info,
                                          test_size=0.2, random_state=0)
    return list(zip(tr1, tr2)) if set_type == "train" else list(zip(va1, va2))


def _axis_taps(n_in, n_out):
    """Source indices and f32 weights of one axis of cv2's INTER_LINEAR:
    half-pixel centres, and an edge tap clamped to weight 0."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    f[s < 0] = 0.0
    s[s < 0] = 0
    over = s >= n_in - 1
    f[over] = 0.0
    s[over] = n_in - 1
    return s, np.minimum(s + 1, n_in - 1), np.float32(1.0) - f, f


def _resize(img, size):
    """Bilinear resize of a float32 HW image to size x size, as
    cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR) computes
    it (rows first, then columns, in f32); the port needs no cv2."""
    img = np.asarray(img, np.float32)
    x0, x1, ax0, ax1 = _axis_taps(img.shape[1], size)
    y0, y1, ay0, ay1 = _axis_taps(img.shape[0], size)
    rows = img[:, x0] * ax0 + img[:, x1] * ax1
    return rows[y0] * ay0[:, None] + rows[y1] * ay1[:, None]


class FusionDataset:
    """Full-image pair dataset (reference data/dataset.py:29-116)."""

    def __init__(self, root_dir, set_name=None, set_type="train",
                 img_type="ir", norm=None, transform=False, fix_size=False,
                 rng=None):
        if set_type not in ("train", "valid", "test"):
            raise ValueError(f"set_type {set_type!r}")
        if img_type not in ("ir", "po"):
            raise ValueError(f"img_type {img_type!r}")
        self.root_dir = root_dir
        self.set_type = set_type
        self.norm = norm
        self.transform = transform
        self.fix_size = fix_size
        self.rng = rng if rng is not None else np.random
        self.data_info = _split(*_list_pairs(root_dir, set_name, img_type),
                                set_type)

    def __len__(self):
        if not self.data_info:
            raise ValueError(f"no image pairs under {self.root_dir}")
        return len(self.data_info)

    def __getitem__(self, index):
        pair = tuple(norm(imread_gray(p), mode=self.norm)
                     for p in self.data_info[index])
        if self.transform:
            idx = self.rng.choice(2)
            pair = tuple(transform(im, mode=idx) for im in pair)
        if self.fix_size:
            pair = self._fix_size(pair)
        return tuple(np.ascontiguousarray(im, dtype=np.float32)
                     for im in pair)

    def _fix_size(self, pair):
        h, w = pair[0].shape[-2:]
        crop = min(h, w, img_size)
        top = self.rng.randint(0, h - crop + 1)
        left = self.rng.randint(0, w - crop + 1)
        pair = tuple(im[top:top + crop, left:left + crop] for im in pair)
        if crop < img_size:
            pair = tuple(_resize(im, img_size) for im in pair)
        return pair


class AEDataset:
    """Single-image autoencoder dataset over both modality dirs, shuffled
    (reference data/dataset.py:119-186), for two-stage AE pretraining."""

    def __init__(self, root_dir, set_name=None, img_type="ir", norm=None,
                 transform=False, fix_size=False, rng=None):
        if img_type not in ("ir", "po"):
            raise ValueError(f"img_type {img_type!r}")
        self.norm = norm
        self.transform = transform
        self.fix_size = fix_size
        self.rng = rng if rng is not None else np.random

        if set_name is None:
            img1_dir = os.path.join(root_dir, "vis")
        else:
            img1_dir = os.path.join(root_dir, set_name, "vis")
        img2_dir = img1_dir.replace("vis", img_type)

        self.data_info = []
        for d in (img1_dir, img2_dir):
            for img in natsorted(os.listdir(d)):
                if img.endswith(_IMG_EXTS):
                    self.data_info.append(os.path.join(d, img))
        random.shuffle(self.data_info)

    def __len__(self):
        if not self.data_info:
            raise ValueError("no images for the autoencoder dataset")
        return len(self.data_info)

    def __getitem__(self, index):
        img = norm(imread_gray(self.data_info[index]), mode=self.norm)
        if self.transform:
            img = transform(img, mode=self.rng.choice(2))
        if self.fix_size:
            h, w = img.shape[-2:]
            crop = min(img_size, h, w)
            top = self.rng.randint(0, h - crop + 1)
            left = self.rng.randint(0, w - crop + 1)
            img = img[top:top + crop, left:left + crop]
            if crop < img_size:
                img = _resize(img, img_size)
        return np.ascontiguousarray(img, dtype=np.float32)


class FusionPatches:
    """Eager 64x64 patch-pair dataset (reference data/patches.py:30-123)."""

    def __init__(self, root_dir, set_name=None, set_type="train",
                 img_type="ir", norm=None, transform=False, rng=None):
        if set_type not in ("train", "valid", "test"):
            raise ValueError(f"set_type {set_type!r}")
        if img_type not in ("ir", "po"):
            raise ValueError(f"img_type {img_type!r}")
        self.norm = norm
        self.transform = transform
        self.rng = rng if rng is not None else np.random
        self.data_info = _split(*_list_pairs(root_dir, set_name, img_type),
                                set_type)
        self.patch_pairs = []
        for img1_path, img2_path in self.data_info:
            p1 = extract_patches(imread_gray(img1_path), patch_size,
                                 patch_step)
            p2 = extract_patches(imread_gray(img2_path), patch_size,
                                 patch_step)
            self.patch_pairs.extend(list(zip(p1, p2)))
        random.shuffle(self.patch_pairs)

    def __len__(self):
        if not self.patch_pairs:
            raise ValueError("no patches: no image pairs, or all smaller "
                             "than a patch")
        return len(self.patch_pairs)

    def __getitem__(self, index):
        pair = tuple(norm(p, mode=self.norm) for p in self.patch_pairs[index])
        if self.transform:
            idx = self.rng.choice(8)
            pair = tuple(transform(p, mode=idx) for p in pair)
        return tuple(np.ascontiguousarray(p, dtype=np.float32) for p in pair)
