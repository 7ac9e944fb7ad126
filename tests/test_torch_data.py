"""The port's training data path (CPU) against the JAX package's: patches,
the 8 dihedral transforms, the numpy bilinear resize against cv2, and the
items and batch order of FusionDataset (transform + fix_size), AEDataset,
FusionPatches and Feeder under the same seeds.

Everything is exact (the same numpy draws on the same data) except the
resize, held to 2.4e-7 (two f32 ulps at 1.0: cv2's vectorised loops may
fuse a multiply-add that numpy rounds twice).
"""

import os
import random

import cv2
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.data import dataset as jds
from multi_modal_image_fusion_tpu.data.patches import \
    extract_patches as jax_extract
from multi_modal_image_fusion_tpu.data.pipeline import Feeder as JFeeder
from multi_modal_image_fusion_tpu.data.transform import \
    transform as jax_transform
from multi_modal_image_fusion_tpu_torch.data import dataset as pds
from multi_modal_image_fusion_tpu_torch.data.io import imwrite
from multi_modal_image_fusion_tpu_torch.data.patches import extract_patches
from multi_modal_image_fusion_tpu_torch.data.pipeline import Feeder
from multi_modal_image_fusion_tpu_torch.data.transform import transform


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """7 pairs under train/ of assorted sizes, some below 256 (fix_size
    resizes those) and some not multiples of 64 (patches drop the rest)."""
    root = tmp_path_factory.mktemp("torch_data")
    r = np.random.RandomState(0)
    for mod in ("vis", "ir"):
        os.makedirs(root / "train" / mod)
    sizes = [(130, 200), (300, 280), (64, 64), (200, 150), (257, 333),
             (128, 96), (100, 260)]
    for i, (h, w) in enumerate(sizes):
        a = (r.rand(h, w) * 255).astype(np.uint8)
        imwrite(str(root / "train" / "vis" / f"{i + 1}.png"), a)
        imwrite(str(root / "train" / "ir" / f"{i + 1}.png"), 255 - a // 3)
    return str(root)


@pytest.mark.parametrize("h,w", [(64, 64), (130, 200), (257, 70)])
def test_patches_match_jax(h, w):
    img = np.random.RandomState(h).rand(h, w).astype(np.float32)
    np.testing.assert_array_equal(extract_patches(img, 64, 64),
                                  jax_extract(img, 64, 64))


def test_transforms_match_jax():
    img = np.random.RandomState(1).rand(5, 7).astype(np.float32)
    outs = set()
    for mode in range(8):
        got = transform(img, mode)
        np.testing.assert_array_equal(got, jax_transform(img, mode))
        outs.add(got.tobytes() + bytes(got.shape))
    assert len(outs) == 8


@pytest.mark.parametrize("h,w", [(100, 100), (57, 57), (255, 255),
                                 (1, 1), (200, 33)])
def test_resize_matches_cv2(h, w):
    img = np.random.RandomState(h * w).rand(h, w).astype(np.float32)
    want = cv2.resize(img, (256, 256), interpolation=cv2.INTER_LINEAR)
    got = pds._resize(img, 256)
    assert got.dtype == np.float32 and got.shape == (256, 256)
    np.testing.assert_allclose(got, want, atol=2.4e-7, rtol=0)


def _items(ds, n=None):
    return [ds[i] for i in range(len(ds) if n is None else n)]


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        for u, v in zip(x, y):
            assert u.shape == v.shape
            np.testing.assert_allclose(u, v, atol=2.4e-7, rtol=0)


@pytest.mark.parametrize("set_type", ["train", "valid"])
def test_fusion_dataset_matches_jax(data_root, monkeypatch, set_type):
    # the JAX package resizes with cv2: the same function as the port's
    monkeypatch.setattr(jds, "_resize", pds._resize)
    kw = dict(set_name="train", set_type=set_type, transform=True,
              fix_size=True)
    got = _items(pds.FusionDataset(data_root, rng=np.random.RandomState(5),
                                   **kw))
    want = _items(jds.FusionDataset(data_root, rng=np.random.RandomState(5),
                                    **kw))
    _assert_items_equal(got, want)
    assert all(x[0].shape == (256, 256) for x in got)


def test_ae_dataset_matches_jax(data_root, monkeypatch):
    monkeypatch.setattr(jds, "_resize", pds._resize)
    out = []
    for mod in (pds, jds):
        random.seed(3)
        ds = mod.AEDataset(data_root, set_name="train", transform=True,
                           fix_size=True, rng=np.random.RandomState(4))
        out.append((ds.data_info, _items(ds)))
    assert out[0][0] == out[1][0]
    _assert_items_equal(out[0][1], out[1][1])


def test_fusion_patches_and_feeder_order_match_jax(data_root):
    """The patch list (python random.shuffle), the per-item dihedral draws
    and two epochs of the seeded Feeder shuffle give the same batches."""
    sets = []
    for mod in (pds, jds):
        random.seed(7)
        sets.append(mod.FusionPatches(data_root, set_name="train",
                                      set_type="train", transform=True,
                                      rng=np.random.RandomState(8)))
    assert len(sets[0]) == len(sets[1]) > 20
    port = Feeder(sets[0], 8, shuffle=True, drop_last=True, seed=2)
    ref = JFeeder(sets[1], 8, shuffle=True, drop_last=True, seed=2)
    assert len(port) == len(ref)
    for _ in range(2):                         # the shuffle advances
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_feeder_mask_partial_batch_and_workers(data_root):
    ds = pds.FusionPatches(data_root, set_name="train", set_type="valid")
    n = len(ds)
    plain = list(Feeder(ds, 5, with_mask=True))
    assert len(plain) == -(-n // 5)
    batch, mask, n_true = plain[-1]
    assert n_true == n - 5 * (len(plain) - 1)
    assert batch[0].shape == (n_true, 64, 64, 1)
    assert mask.tolist() == [1.0] * n_true
    threaded = list(Feeder(ds, 5, with_mask=True, workers=3))
    for (a, _, _), (b, _, _) in zip(plain, threaded):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_feeder_stops_its_thread_when_abandoned(data_root):
    import threading
    ds = pds.FusionPatches(data_root, set_name="train", set_type="train")
    before = threading.active_count()
    it = iter(Feeder(ds, 2, prefetch=1))
    next(it)
    it.close()                 # runs the generator's finally: join
    assert threading.active_count() == before
