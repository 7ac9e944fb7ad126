"""Network blocks of the port (counterpart of multi_modal_image_fusion_tpu
ops/blocks.py, reference core/block.py). Ported: `DenseBlock`, for DenseFuse
and VIFNet; the other blocks come with the models that use them (ROADMAP.md
queue 1 item 6)."""

from torch import nn

from .layers import ConvLayer

__all__ = ["DenseBlock"]


class DenseBlock(nn.Module):
    """DenseNet-style growth (reference core/block.py:137-151; JAX
    ops/blocks.py:66-90): `num_convs` k3 relu convs of `out_ch` channels,
    conv i over the concat of the block's input and every earlier conv's
    output, so the block's output has in_ch + num_convs * out_ch channels.

    `forward` returns that output as its legs, [x, y1, ..., y_num_convs],
    whose channel concat is the reference block's output: the concat is
    never built, each conv reads the legs so far through ConvLayer's
    multi-leg route (the JAX serving path's `_hiw_dense_legs`, models/
    zoo.py:127-136). State-dict names are the reference's
    (`layers.<i>.layers.0.weight`)."""

    def __init__(self, in_ch, out_ch, num_convs=3, generator=None):
        super().__init__()
        self.layers = nn.ModuleList([
            ConvLayer(in_ch + i * out_ch, out_ch, ksize=3,
                      generator=generator) for i in range(num_convs)])

    def forward(self, x):
        legs = [x]
        for conv in self.layers:
            legs.append(conv([(t, 0) for t in legs]))
        return legs
