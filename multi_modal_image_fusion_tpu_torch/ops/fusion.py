"""Training-free fusion strategies (counterpart of multi_modal_image_fusion_tpu
ops/fusion.py). This slice ports `element_fusion`; the other seven
strategies come with the models that use them (ROADMAP.md)."""

import torch


def element_fusion(t1, t2, mode="sum"):
    """reference core/fusion.py:21-29"""
    if mode == "sum":
        return t1 + t2
    if mode == "mean":
        return (t1 + t2) / 2.0
    if mode == "max":
        return torch.maximum(t1, t2)
    raise ValueError("only supported ['sum', 'mean', 'max'] mode")
