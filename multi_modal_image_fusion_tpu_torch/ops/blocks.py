"""Network blocks of the port (counterpart of multi_modal_image_fusion_tpu
ops/blocks.py, reference core/block.py). Ported: `DenseBlock`, for DenseFuse
and VIFNet, and `Res2ConvBlock`, for Res2Fusion; the other blocks come with
the models that use them (ROADMAP.md queue 1 item 6)."""

import torch
from torch import nn

from .cuda.conv_multi import concat_legs
from .layers import ConvLayer

__all__ = ["DenseBlock", "Res2ConvBlock"]


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


class Res2ConvBlock(nn.Module):
    """Res2Net-style hierarchical depthwise block (reference core/block.py:
    229-352; JAX ops/blocks.py:226-342), in the JAX package's H-major
    serving topology (:240-303), without bias and with relu6:

        hexp = pwconv1(x)                       k1, in_ch -> scale * in_ch
        y_i  = dwconvs[i](hexp_i (+ y_{i-1}))   depthwise, k1 for i = 0,
                                                k3 after; the add for i >= 2
        out  = relu6(pwconv2([y_0, ..., y_{scale-1}]) + shortcut(x))

    where hexp_i is group i's in_ch channels of hexp. x is one tensor or a
    list of legs [(tensor, b_off), ...] (ConvLayer's multi-leg route), so a
    dense concat feeding the block is never built. Each dwconvs[i] reads its
    group of hexp in place (ConvLayer.depthwise, conv_dw on the card) and
    pwconv2 reads the groups' outputs as legs (conv_multi). The `dwconv`
    parameters exist for the reference state dict and never run (the
    reference block builds and ignores them). The shortcut is an identity
    when in_ch == out_ch. State-dict names are the reference's."""

    def __init__(self, in_ch, out_ch, scale=4, generator=None):
        super().__init__()
        g = generator
        hid = in_ch * scale
        self.in_ch, self.scale = in_ch, scale
        self.pwconv1 = ConvLayer(in_ch, hid, 1, act="relu6", use_bias=False,
                                 generator=g)
        self.dwconv = ConvLayer(hid, hid, 3, act=None, groups=hid,
                                use_bias=False, generator=g)
        self.pwconv2 = ConvLayer(hid, out_ch, 1, act=None, use_bias=False,
                                 generator=g)
        self.shortcut = (ConvLayer(in_ch, out_ch, 1, act=None, use_bias=False,
                                   generator=g) if in_ch != out_ch else None)
        self.dwconvs = nn.ModuleList([
            ConvLayer(in_ch, in_ch, 1 if i == 0 else 3, act=None,
                      groups=in_ch, use_bias=False, generator=g)
            for i in range(scale)])

    def forward(self, x):
        hexp = self.pwconv1(x)
        outs, y = [], None
        for i, conv in enumerate(self.dwconvs):
            y = conv.depthwise(hexp, lo=i * self.in_ch,
                               add=y if i > 1 else None)
            outs.append(y)
        out = self.pwconv2([(o, 0) for o in outs])
        if self.shortcut is not None:
            res = self.shortcut(x)
        else:
            res = concat_legs(x) if isinstance(x, list) else x
        return torch.clamp(out + res, 0.0, 6.0)
