"""Fusion model zoo of the port (counterpart of multi_modal_image_fusion_tpu
models/zoo.py). This slice ports DeepFuse, the reference CLIs' default
model; the other 15 models are queued in ROADMAP.md.

Models take NHWC single-channel images:

    model(img1, img2)   -> fused image (B, H, W, 1)
    model(img1)         -> autoencoder reconstruction (two-stage training)
"""

from torch import nn

from ..ops.fusion import element_fusion
from ..ops.layers import ConvLayer

__all__ = ["DeepFuse", "MODEL_ZOO", "create_model"]


class DeepFuse(nn.Module):
    """2-conv (k5, k7) encoder, elementwise fusion, 3-conv decoder
    (reference core/model.py:147-162; JAX models/zoo.py:322-556).

    The two shared-weight encoder passes run as ONE pass over the
    batch-concatenated pair (the siamese fold of JAX zoo.py:62-75), in
    training too, where the JAX package runs the encoder twice
    (zoo.py:73-75): the model has no batch norm, so the fold is the same
    math with half the conv launches. The chain runs in the parameters'
    dtype: enc0 reads the images, cast to that dtype, and writes the chain
    (conv_gray_enter), 'sum' fusion is folded into dec0's input load
    (fuse_n, JAX zoo.py:457-468; on the training routes it is
    t[:n] + t[n:] in torch before dec0), 'mean'/'max' apply element_fusion
    between the convs, and dec2 writes the (B, H, W, 1) output
    (conv_gray_exit). Which conv route each layer takes is ConvLayer's
    (ops/layers.py)."""

    def __init__(self, fusion_mode="sum", generator=None):
        super().__init__()
        if fusion_mode not in ("sum", "mean", "max"):
            raise ValueError(f"DeepFuse fusion_mode {fusion_mode!r} not in "
                             f"sum/mean/max")
        self.fusion_mode = fusion_mode
        g = generator
        self.encode = nn.ModuleList([
            ConvLayer(1, 16, ksize=5, generator=g),
            ConvLayer(16, 32, ksize=7, generator=g),
        ])
        self.decode = nn.ModuleList([
            ConvLayer(32, 32, ksize=7, generator=g),
            ConvLayer(32, 16, ksize=5, generator=g),
            ConvLayer(16, 1, ksize=5, act=None, generator=g),
        ])

    def forward(self, img1, img2=None):
        enc0, enc1 = self.encode
        dec0, dec1, dec2 = self.decode
        t = enc1(enc0.enter(img1, img2))
        if img2 is None:
            t = dec0(t)
        elif self.fusion_mode == "sum":
            t = dec0(t, fuse_n=img1.shape[0])
        else:
            n = img1.shape[0]
            t = dec0(element_fusion(t[:n], t[n:], self.fusion_mode))
        return dec2(dec1(t))


MODEL_ZOO = {"deepfuse": DeepFuse}


def create_model(name, **kwargs):
    """Instantiate a ported zoo model by (case-insensitive) name."""
    key = name.lower()
    if key not in MODEL_ZOO:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {sorted(MODEL_ZOO)}); "
            f"the queue of models to port is in ROADMAP.md")
    return MODEL_ZOO[key](**kwargs)
