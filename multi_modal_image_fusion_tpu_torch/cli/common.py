"""Shared CLI plumbing (counterpart of multi_modal_image_fusion_tpu
cli/common.py:142-237): the test parser, dataset-layout mapping, data-dir
resolution and result-image assembly."""

import argparse
import os
from pathlib import Path

import numpy as np

from ..data.transform import denorm
from ..models import MODEL_ZOO

# the checkout holding the package: the CLIs' default roots live inside it
REPO_ROOT = Path(__file__).resolve().parents[2]


def get_test_parser():
    p = argparse.ArgumentParser(description="Inference")
    p.add_argument("--data", default="roadscene", type=str,
                   help="dataset folder name")
    p.add_argument("--ckpt", required=True, type=str,
                   help="checkpoint folder name (timestamp dir)")
    p.add_argument("--data_root", default=None, type=str,
                   help="folder of the datasets (default: <repo>/datasets)")
    p.add_argument("--ckpt_root", default=None, type=str,
                   help="folder of the checkpoints (default: "
                        "<repo>/checkpoints)")
    p.add_argument("--model", default=None, type=str,
                   choices=sorted(MODEL_ZOO),
                   help="zoo model name (default: from checkpoint meta)")
    p.add_argument("--pad_bucket", default=0, type=int,
                   help="reflect-pad inputs to multiples of N and crop the "
                        "outputs (a border deviation within the model's "
                        "receptive field of the pad seam; 0 [default] = "
                        "exact shapes)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; the run "
                        "fails without one unless --device cpu)")
    return p


def dataset_layout(data):
    """dataset name -> (set_name_train, set_name_test, img_type)
    (reference train.py:181-184, test.py:104-107, eval.py:127-135)."""
    if data == "tno":
        return None, None, "ir"
    if data == "polar":
        return "train", "test", "po"
    # roadscene, msrs and custom datasets share the roadscene layout
    return "train", "test", "ir"


def ckpt_root(args):
    """--ckpt_root, else <repo>/checkpoints."""
    return args.ckpt_root or str(REPO_ROOT / "checkpoints")


def resolve_data_dir(args):
    """<data_root>/<data> (default root <repo>/datasets); when that is
    missing, the bundled sample pairs (MMIF_SAMPLES_DIR or
    <repo>/data/samples) for smoke runs. Returns (path, is_sample)."""
    base = args.data_root or str(REPO_ROOT / "datasets")
    path = os.path.join(base, args.data)
    if not os.path.isdir(path):
        alt = {"roadscene": "infrared", "polar": "polar"}.get(args.data)
        for samples in (os.environ.get("MMIF_SAMPLES_DIR"),
                        str(REPO_ROOT / "data" / "samples")):
            if samples and alt and os.path.isdir(os.path.join(samples, alt)):
                return os.path.join(samples, alt), True
    return path, False


def save_result(pred, img1=None, img2=None):
    """[img1 | img2 | fused] side by side as uint8, or the fused image
    alone (reference common.py:74-81). Inputs are HWC [0,1] floats."""
    if img1 is not None and img2 is not None:
        return np.concatenate(tuple(map(denorm, (img1, img2, pred))),
                              axis=1)
    return denorm(pred)
