"""Training-free fusion strategies (counterpart of multi_modal_image_fusion_tpu
ops/fusion.py, reference core/fusion.py) over NHWC tensors, channel axis -1.

Ported: `element_fusion`, `weighted_fusion`, `concat_fusion`,
`spatial_fusion`, the per-pixel modes of `spatial_pooling` (sum, mean, l1,
l2, linf) and `attention_fusion` with mode 'sa'. The channel modes
(`channel_fusion`, `channel_pooling`, attention modes ca/sca/wavg) and the
non-local 'nl' pooling come with the models that use them (ROADMAP.md queue
1 item 6, and queue 2 item 5 for the 'nl' kernel); they raise
NotImplementedError.
"""

import torch

__all__ = ["attention_fusion", "concat_fusion", "element_fusion",
           "spatial_fusion", "spatial_pooling", "weighted_fusion"]

eps = 1e-7

_TODO = ("not ported yet (ROADMAP.md queue 1 item 6, zoo breadth; the 'nl' "
         "kernel is queue 2 item 5)")


def element_fusion(t1, t2, mode="sum"):
    """reference core/fusion.py:21-29"""
    if mode == "sum":
        return t1 + t2
    if mode == "mean":
        return (t1 + t2) / 2.0
    if mode == "max":
        return torch.maximum(t1, t2)
    raise ValueError("only supported ['sum', 'mean', 'max'] mode")


def weighted_fusion(t1, t2, w1, w2):
    """reference core/fusion.py:32-35"""
    w = w1 / torch.clamp(w1 + w2, min=eps)
    return w * t1 + (1.0 - w) * t2


def concat_fusion(tensors, dim=-1):
    """reference core/fusion.py:38-39 (dim=1 in NCHW is -1 in NHWC)"""
    return torch.cat(tensors, dim=dim)


def attention_fusion(t1, t2, mode="sca", spatial_mode="l1",
                     channel_mode="avg"):
    """reference core/fusion.py:42-59; mode 'sa' is ported."""
    if mode != "sa":
        raise NotImplementedError(f"attention_fusion mode {mode!r} (channel "
                                  f"attention) is {_TODO}")
    return spatial_fusion(t1, t2, spatial_mode, softmax=False)


def spatial_fusion(t1, t2, mode="l1", softmax=True):
    """reference core/fusion.py:62-70"""
    s1 = spatial_pooling(t1, mode)
    s2 = spatial_pooling(t2, mode)
    if softmax:
        s1 = torch.exp(s1)
        s2 = torch.exp(s2)
    return weighted_fusion(t1, t2, s1, s2)


def spatial_pooling(t, mode="l1"):
    """Per-pixel channel pooling -> (N, H, W, 1) map (reference
    core/fusion.py:84-117)."""
    if mode == "sum":
        return t.sum(dim=-1, keepdim=True)
    if mode == "mean":
        return t.mean(dim=-1, keepdim=True)
    if mode == "l1":
        return torch.abs(t).sum(dim=-1, keepdim=True)
    if mode == "l2":
        return torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    if mode == "linf":
        return t.amax(dim=-1, keepdim=True)
    if mode == "nl":
        raise NotImplementedError(f"spatial_pooling mode 'nl' is {_TODO}")
    raise ValueError(
        "only supported ['sum', 'mean', 'l1', 'l2', 'linf', 'nl'] mode")
