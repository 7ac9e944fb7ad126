"""Checkpoints (counterpart of multi_modal_image_fusion_tpu
train/checkpoint.py) with the reference's best/last semantics (reference
train.py:362-383).

A checkpoint is the model's torch state dict, saved as the reference saves
it (`epoch_best.pth`, `epoch_last.pth`, SURVEY.md 3.1-3.2), with metadata
beside it in `<ckpt>.json` and, for resume, the trainer's optimizer state
(step and Adam moments) in `<ckpt>.optim`. The test CLI and `restore` read
the state dict alone.
"""

import json
import os

import torch

__all__ = ["checkpoint_path", "load_checkpoint_meta", "load_train_state",
           "restore", "save_checkpoint", "save_state_dict"]


def save_state_dict(path, state_dict, meta=None):
    """Write `path` (torch state dict) and `path`.json (metadata)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=1)


def save_checkpoint(path, model_state, train_state, meta=None):
    """Write `path` (model state dict), `path`.optim (the trainer's
    state_dict(): step and Adam moments) and `path`.json (metadata)."""
    save_state_dict(path, model_state, meta)
    torch.save(train_state, path + ".optim")


def load_train_state(path):
    """The optimizer state saved beside the checkpoint at `path`."""
    return torch.load(path + ".optim", map_location="cpu", weights_only=True)


def load_checkpoint_meta(path):
    meta_path = path + ".json"
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def checkpoint_path(ckpt_dir):
    """epoch_best.pth, else epoch_last.pth, under ckpt_dir."""
    for name in ("epoch_best.pth", "epoch_last.pth"):
        path = os.path.join(ckpt_dir, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")


def restore(model, path):
    """strict=False restore (reference test.py:176): tensors present in the
    checkpoint replace the model's; the model's other tensors keep their
    init (e.g. the fusion layers when testing a stage-1 autoencoder
    checkpoint); checkpoint-only tensors are dropped. Returns (missing,
    unexpected) key lists."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    result = model.load_state_dict(state, strict=False)
    return list(result.missing_keys), list(result.unexpected_keys)
