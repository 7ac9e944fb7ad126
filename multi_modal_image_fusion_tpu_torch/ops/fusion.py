"""Training-free fusion strategies (counterpart of multi_modal_image_fusion_tpu
ops/fusion.py, reference core/fusion.py) over NHWC tensors, channel axis -1.

All of the JAX module is ported: `element_fusion`, `weighted_fusion`,
`concat_fusion`, `attention_fusion` (sa, ca, sca, wavg), `spatial_fusion`,
`channel_fusion`, `spatial_pooling` (sum, mean, l1, l2, linf, nl) and
`channel_pooling` (avg, max, nuclear, nl).

The non-local spatial pooling 'nl' (8x8 average pool, then attention of
every pixel over the pooled map, then + t) runs its attention through
ops/cuda/nl_attention.py: the hand-written kernels on CUDA tensors at every
size (the JAX package's 2^18-pixel switch between its dense and streamed
forms is a TPU memory choice; the function is the same), the plain two-pass
version on CPU tensors, through the autograd Function `nl_spatial_diff`
(the kernels forward, the plain version's gradients backward, as the JAX
package's custom VJP). The channel 'nl' attention is a (C, C) Gram matrix:
two torch.matmul products with f32 accumulation, as the JAX package leaves
them to XLA. Both normalise their energies by the min and max over the
whole batch of one call.
"""

import torch
import torch.nn.functional as F

from .cuda.nl_attention import nl_spatial_diff

__all__ = ["attention_fusion", "channel_fusion", "channel_pooling",
           "concat_fusion", "element_fusion", "spatial_fusion",
           "spatial_pooling", "weighted_fusion"]

eps = 1e-7


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
    """reference core/fusion.py:42-59"""
    if mode not in ("sa", "ca", "sca", "wavg"):
        raise ValueError("only supported ['sa', 'ca', 'sca', 'wavg'] mode")
    f_spatial = spatial_fusion(t1, t2, spatial_mode, softmax=False)
    if mode == "sa":
        return f_spatial
    f_channel = channel_fusion(t1, t2, channel_mode, softmax=False)
    if mode == "ca":
        return f_channel
    if mode == "sca":
        return element_fusion(f_spatial, f_channel, "mean")
    return weighted_fusion(f_spatial, f_channel, f_spatial, f_channel)


def spatial_fusion(t1, t2, mode="l1", softmax=True):
    """reference core/fusion.py:62-70"""
    s1 = spatial_pooling(t1, mode)
    s2 = spatial_pooling(t2, mode)
    if softmax:
        s1 = torch.exp(s1)
        s2 = torch.exp(s2)
    return weighted_fusion(t1, t2, s1, s2)


def channel_fusion(t1, t2, mode="avg", softmax=True):
    """reference core/fusion.py:73-81"""
    c1 = channel_pooling(t1, mode)
    c2 = channel_pooling(t2, mode)
    if softmax:
        c1 = torch.exp(c1)
        c2 = torch.exp(c2)
    return weighted_fusion(t1, t2, c1, c2)


def spatial_pooling(t, mode="l1"):
    """Per-pixel channel pooling -> (N, H, W, 1) map, or the 'nl' non-local
    spatial attention -> (N, H, W, C) (reference core/fusion.py:84-117)."""
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
        b, h, w, c = t.shape
        # VALID 8x8 average pool: the remainder rows and columns drop out
        pooled = F.avg_pool2d(t.permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1)
        attn = nl_spatial_diff(t.reshape(b, h * w, c),
                               pooled.reshape(b, -1, c).contiguous())
        return attn.reshape(b, h, w, c) + t
    raise ValueError(
        "only supported ['sum', 'mean', 'l1', 'l2', 'linf', 'nl'] mode")


def channel_pooling(t, mode="avg"):
    """Per-channel spatial pooling -> (N, 1, 1, C) vector, or the 'nuclear'
    ((1, 1, 1, C), first image only) and 'nl' ((N, H, W, C)) attention
    variants (reference core/fusion.py:120-153)."""
    b, h, w, c = t.shape
    if mode == "avg":
        return t.mean(dim=(1, 2), keepdim=True)
    if mode == "max":
        return t.amax(dim=(1, 2), keepdim=True)
    if mode == "nuclear":
        # per-channel nuclear norm (sum of singular values) of image 0
        mats = torch.clamp(t[0], min=eps).permute(2, 0, 1).float()
        vec = torch.linalg.svdvals(mats).sum(dim=-1)
        return vec.to(t.dtype).reshape(1, 1, 1, c)
    if mode == "nl":
        # Gram-matrix channel attention: energy (B, C, C) in f32
        q = t.permute(0, 3, 1, 2).reshape(b, c, h * w)
        qf = q.float()
        energy = torch.matmul(qf, qf.transpose(1, 2))
        energy = (energy - energy.min()) / (energy.max() - energy.min())
        attn_w = torch.softmax(energy, dim=-1).to(t.dtype)
        attn = torch.matmul(attn_w.float(), qf)
        return attn.to(t.dtype).reshape(b, c, h, w).permute(0, 2, 3, 1) + t
    raise ValueError("only supported ['avg', 'max', 'nuclear', 'nl'] mode")
