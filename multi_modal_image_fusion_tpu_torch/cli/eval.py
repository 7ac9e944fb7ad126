"""Batch metric-evaluation CLI (counterpart of multi_modal_image_fusion_tpu
cli/eval.py; reference eval.py): reads the source pairs and the fused
NN.bmp images that the test CLI dumped, computes the 16-metric bundle
(ops/metrics.eval_metrics) on the card, and writes an xlsx workbook with
per-image rows under mean and std rows, one sheet per method or one sheet
per metric.

Images are grouped by shape; each group is evaluated in chunks of at most
16 images, one eval_metrics call a chunk (per-image values do not depend
on the chunking). Identical fused-image folders are evaluated once, however
many method names point at them.

Runs on the CUDA card (the ssim_maps and moments kernels of ops/cuda/)
unless asked for the CPU:

    python -m multi_modal_image_fusion_tpu_torch.cli.eval --data roadscene \\
        --ckpt <timestamp-dir> --ckpt_root <dir> [--methods a,b] \\
        [--sheet method|metric] [--device cpu]
"""

import os
import time

import numpy as np
import torch

from ..data.io import imread_gray
from ..device import resolve_device
from ..ops.metrics import eval_metrics
from ..utils.natsort import natsorted
from ..utils.xlsx import Workbook
from .common import ckpt_root, dataset_layout, get_eval_parser, \
    resolve_data_dir

METRIC_KEYS = ["sd", "ag", "sf", "mse", "psnr", "cc", "scd", "en", "ce",
               "mi", "qabf", "nabf", "labf", "ssim", "msssim", "viff"]
METRIC_LABELS = ["SD", "AG", "SF", "MSE", "PSNR", "CC", "SCD", "EN", "CE",
                 "MI", "Qabf", "Nabf", "Labf", "SSIM", "MSSSIM", "VIFF"]
CHUNK = 16     # images per eval_metrics call: bounds the card's memory


def eval_method(img1_dir, img2_dir, imgf_dir, device):
    """Evaluate one method's dumped results; returns (names, rows) where
    rows[i] is the 16-metric dict of image i."""
    # the pairing filter of FusionDataset: only images whose partner exists
    # are enumerated, so the NN.bmp indices the test CLI dumped and the
    # indices read here share one index space
    files = [f for f in natsorted(os.listdir(img1_dir))
             if f.endswith((".bmp", ".jpg", ".png"))
             and os.path.isfile(os.path.join(img2_dir, f))]

    groups = {}          # shape -> [(index, name, img1, img2, imgf), ...]
    for i, img in enumerate(files):
        imgf_path = os.path.join(imgf_dir, f"{i + 1:0>2}.bmp")
        if not os.path.isfile(imgf_path):
            print(f"skipping {img}: no fused result {imgf_path}")
            continue
        img1 = imread_gray(os.path.join(img1_dir, img))
        img2 = imread_gray(os.path.join(img2_dir, img))
        imgf = imread_gray(imgf_path)
        groups.setdefault(img1.shape, []).append((i, img, img1, img2,
                                                  imgf))

    results = {}
    for items in groups.values():
        for lo in range(0, len(items), CHUNK):
            chunk = items[lo:lo + CHUNK]

            def stack(k):
                return torch.from_numpy(
                    np.stack([it[k] for it in chunk])[..., None]).to(device)
            with torch.no_grad():
                out = eval_metrics(stack(2), stack(3), stack(4))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for j, (i, img, *_rest) in enumerate(chunk):
                results[i] = (img, {k: float(v[j]) for k, v in out.items()})
                print(f"evaluating {img} ... done")

    names, rows = [], []
    for i in sorted(results):
        img, row = results[i]
        names.append(img)
        rows.append(row)
    return names, rows


def write_workbook(save_path, method_name, names, rows,
                   sheet_layout="method", book=None, method_idx=0):
    """The reference's xlsx layout (eval.py:268-361): one sheet per method
    (metric columns) or one sheet per metric (method columns); the first
    two data rows are mean and std."""
    book = book or Workbook()

    cols = {}
    for key in METRIC_KEYS:
        vals = [r[key] for r in rows]
        vals.insert(0, float(np.mean(vals)) if vals else 0.0)
        vals.insert(1, float(np.std(vals)) if vals else 0.0)
        cols[key] = vals
    name_col = ["mean", "std"] + list(names)

    if sheet_layout == "method":
        book.set_column(method_name, 0, [""] + name_col)
        for j, (key, label) in enumerate(zip(METRIC_KEYS, METRIC_LABELS)):
            book.set_column(method_name, j + 1, [label] + cols[key])
    else:  # one sheet per metric
        for key, label in zip(METRIC_KEYS, METRIC_LABELS):
            if method_idx == 0:
                book.set_column(label, 0, [""] + name_col)
            book.set_column(label, method_idx + 1,
                            [method_name] + cols[key])
    book.save(save_path)
    return book


def main(argv=None):
    args = get_eval_parser().parse_args(argv)
    if args.spatial > 1:
        raise NotImplementedError(
            "--spatial > 1 is not ported yet (ROADMAP.md queue 1 item 7b, "
            "spatial sharding)")
    device = resolve_device(args.device)

    data_dir, _ = resolve_data_dir(args)
    _, set_name_test, img_type = dataset_layout(args.data)
    if set_name_test is None:
        img1_dir = os.path.join(data_dir, "vis")
        img2_dir = os.path.join(data_dir, img_type)
    else:
        img1_dir = os.path.join(data_dir, set_name_test, "vis")
        img2_dir = os.path.join(data_dir, set_name_test, img_type)

    ckpt_dir = os.path.join(ckpt_root(args), args.ckpt)
    imgf_dir = os.path.join(ckpt_dir, args.data)

    methods = (args.methods.split(",") if args.methods
               else [args.model or "model"])
    save_path = os.path.join(ckpt_dir,
                             f"metrics_{args.data}_{methods[0]}.xlsx")

    book = Workbook()
    done = {}     # resolved fused-image dir -> (names, rows)
    for mi, method in enumerate(methods):
        method_dir = os.path.join(imgf_dir, method)
        resolved = method_dir if os.path.isdir(method_dir) else imgf_dir
        print(f"evaluating {method} ({resolved}) ...")
        start = time.time()
        if resolved not in done:
            done[resolved] = eval_method(img1_dir, img2_dir, resolved,
                                         device)
        names, rows = done[resolved]
        print(f"evaluating {method} done, cost {time.time() - start:.3f}s")
        book = write_workbook(save_path, method, names, rows, args.sheet,
                              book, mi)
    print(f"wrote {save_path}")
    return save_path


if __name__ == "__main__":
    main()
