"""Shared CLI plumbing (counterpart of multi_modal_image_fusion_tpu
cli/common.py): the train, test and eval parsers, dataset-layout mapping,
data-dir resolution and result-image assembly.

The reference's `type=bool` flags are always-true when passed (SURVEY.md
5); here, as in the JAX package, booleans are on/off flag pairs with the
same defaults.
"""

import argparse
import ast
import os
from pathlib import Path

import numpy as np

from ..data.transform import denorm
from ..models import MODEL_ZOO

# the checkout holding the package: the CLIs' default roots live inside it
REPO_ROOT = Path(__file__).resolve().parents[2]


def _bool_flag(parser, name, default, help_on):
    dest = name.replace("-", "_")
    parser.add_argument(f"--{name}", dest=dest, action="store_true",
                        help=help_on)
    parser.add_argument(f"--no-{name}", dest=dest, action="store_false")
    parser.set_defaults(**{dest: default})


def get_train_parser():
    """The JAX train CLI's flags and defaults, plus --device."""
    p = argparse.ArgumentParser(description="Training")
    p.add_argument("--lr", default=1e-4, type=float, help="learning rate")
    p.add_argument("--bs", default=16, type=int, help="batch size")
    p.add_argument("--epoch", default=12, type=int, help="num of epochs")
    _bool_flag(p, "use_patches", True, "train with 64x64 patches")
    _bool_flag(p, "fix_size", True,
               "with --no-use_patches: crop/resize pairs to 256 (reference "
               "train.py:192-201); --no-use_patches --no-fix_size trains on "
               "full-resolution pairs")
    _bool_flag(p, "warmup", False, "first-epoch lr warmup")
    p.add_argument("--warmup_method", default="linear",
                   choices=["linear", "constant"],
                   help="warmup shape (reference common.py:155-163)")
    _bool_flag(p, "clip_grad", True, "clip grad global-norm at 5")
    p.add_argument("--data", default="roadscene", type=str,
                   help="dataset folder name")
    p.add_argument("--data_root", default=None, type=str,
                   help="folder of the datasets (default: <repo>/datasets; "
                        "falls back to the bundled sample pairs)")
    p.add_argument("--model", default="deepfuse", type=str,
                   choices=sorted(MODEL_ZOO), help="zoo model name")
    p.add_argument("--ssim_mode", default="ssim",
                   choices=["ssim", "w-ssim", "ms-ssim", "msw-ssim"])
    p.add_argument("--ssim_weight", default=1.0, type=float)
    p.add_argument("--pixel_mode", default="l1", choices=["l1", "l2"])
    p.add_argument("--pixel_weight", default=0.01, type=float)
    p.add_argument("--grad_mode", default="l1", choices=["l1", "l2"])
    p.add_argument("--grad_weight", default=0.1, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--ckpt_root", default=None, type=str,
                   help="folder of the checkpoints (default: "
                        "<repo>/checkpoints)")
    _bool_flag(p, "ae", False,
               "autoencoder-reconstruction pretraining (two-stage training, "
               "single-image batches)")
    p.add_argument("--resume", default=None, type=str,
                   help="checkpoint folder name to resume from (loads "
                        "epoch_last.pth and its .optim)")
    p.add_argument("--init_from", default=None, type=str,
                   help="checkpoint folder name to initialize params from "
                        "(fresh optimizer: stage 2 after --ae pretraining)")
    _bool_flag(p, "profile", False,
               "write a torch.profiler trace of the first epoch")
    p.add_argument("--workers", default=0, type=int,
                   help="feeder item-loading threads per batch (reference "
                        "DataLoader num_workers, train.py:209); 0 [default] "
                        "keeps the augmentation draws in one order")
    _bool_flag(p, "fast_train", False,
               "route every conv of the train and valid steps through the "
               "hand-written conv_valid kernel (ops/cuda/conv_vjp.py); "
               "without it the steps run F.conv2d")
    _bool_flag(p, "multihost", False,
               "multi-host training (not ported: ROADMAP.md queue 1 item 7)")
    p.add_argument("--spatial", default=0, type=int,
                   help="height-shard each image over N devices (not "
                        "ported: ROADMAP.md queue 1 item 7); 0/1 = off")
    p.add_argument("--amp", default=None, choices=["bf16", "f32"],
                   help="bf16: f32 master params cast to bf16 at the model "
                        "boundary; loss, gradients and Adam moments stay "
                        "f32, the valid step is f32")
    p.add_argument("--steps_per_dispatch", default=1, type=int,
                   help="train steps per Trainer.train_steps call (the JAX "
                        "package chains them in one dispatch; the port runs "
                        "them one after another)")
    p.add_argument("--model_cfg", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="model constructor overrides, repeatable, e.g. "
                        "--model_cfg fusion_mode=mean, or for myfusion: "
                        "--model_cfg encoder=res2 --model_cfg decoder=plain "
                        "--model_cfg share_weight_levels=2")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; the run "
                        "fails without one unless --device cpu)")
    return p


def parse_model_cfg(pairs):
    """['k=v', ...] -> kwargs dict with literal-eval'd values."""
    out = {}
    for item in pairs:
        key, _, value = item.partition("=")
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out


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
                        "exact shapes; a negative N is the JAX CLI's auto, "
                        "exact shapes off a TPU)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; the run "
                        "fails without one unless --device cpu)")
    _bool_flag(p, "int8", False,
               "post-training int8 inference (ops/quant.py): calibrate "
               "per-layer activation scales on the first min(4, N) test "
               "pairs, then run eligible convs as int8 tensor-core dots "
               "with f32 dequant epilogues (JAX cli/common.py:177)")
    return p


def get_eval_parser():
    """The test parser plus the eval CLI's flags (JAX cli/eval.py:135-140
    adds --methods and --sheet; --spatial is the JAX test parser's)."""
    p = get_test_parser()
    p.description = "Evaluation"
    p.add_argument("--methods", default=None, type=str,
                   help="comma-separated method names (default: --model, "
                        "else 'model')")
    p.add_argument("--sheet", default="method", choices=["method", "metric"],
                   help="workbook layout: one sheet per method (metric "
                        "columns) or one sheet per metric (method columns)")
    p.add_argument("--spatial", default=0, type=int,
                   help="height-shard each image over N devices (not "
                        "ported: ROADMAP.md queue 1 item 7); 0/1 = off")
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
