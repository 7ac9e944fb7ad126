"""File-based pair dataset (counterpart of multi_modal_image_fusion_tpu
data/dataset.py:34-118).

Items are numpy HW float32 arrays. Semantics kept from the reference:
images are listed from the `vis/` dir in natural order and paired by the
filename substitution vis -> ir|po (dataset.py:92-109); train/valid is the
80/20 split with sklearn(random_state=0) ordering (dataset.py:111-114).
Patches, the feeder and augmentation come with the training slice.
"""

import os

import numpy as np

from ..utils.natsort import natsorted
from ..utils.split import train_test_split
from .io import imread_gray
from .transform import norm

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


class FusionDataset:
    """Full-image pair dataset (reference data/dataset.py:29-116)."""

    def __init__(self, root_dir, set_name=None, set_type="train",
                 img_type="ir", norm=None):
        if set_type not in ("train", "valid", "test"):
            raise ValueError(f"set_type {set_type!r}")
        if img_type not in ("ir", "po"):
            raise ValueError(f"img_type {img_type!r}")
        self.root_dir = root_dir
        self.set_type = set_type
        self.norm = norm

        img1_info, img2_info = _list_pairs(root_dir, set_name, img_type)
        if set_type in ("train", "valid"):
            tr1, va1, tr2, va2 = train_test_split(img1_info, img2_info,
                                                  test_size=0.2,
                                                  random_state=0)
            pairs = zip(tr1, tr2) if set_type == "train" else zip(va1, va2)
            self.data_info = list(pairs)
        else:
            self.data_info = list(zip(img1_info, img2_info))

    def __len__(self):
        if not self.data_info:
            raise ValueError(f"no image pairs under {self.root_dir}")
        return len(self.data_info)

    def __getitem__(self, index):
        img1_path, img2_path = self.data_info[index]
        return tuple(
            np.ascontiguousarray(norm(imread_gray(p), mode=self.norm),
                                 dtype=np.float32)
            for p in (img1_path, img2_path))
