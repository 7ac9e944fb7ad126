"""Network blocks of the port (counterpart of multi_modal_image_fusion_tpu
ops/blocks.py, reference core/block.py). Ported: `DenseBlock`, for DenseFuse,
VIFNet, DBNet, PFNetv1 and PFNetv2; `Res2ConvBlock`, for Res2Fusion;
`ConvBlock`, `ECB`, `DCB`, `NestEncoder`, `NestDecoder`, `upsample` and
`pad_to`, for UNFusion (and DBNet's x8 upsample); `nest_block`,
`wide_block`, `RFN`, `downsample` and `FSDecoder` (and `NestDecoder` over
`ConvBlock`), for NestFuse, RFNNest and MAFusion; `ResBlock`, for DIFNet
and SEDRFuse; `TransitionBlock`, `SepConvBlock`, `DCBlock`, `Decoder` and
`LSDecoder` (and `NestDecoder` and `FSDecoder` over `DCBlock`), and the
encoder blocks `MixConvBlock`, `Attention` (with `attention`), `FFN`,
`Scale`, `MetaFormerBlock`, `ConvFormerBlock`, `MixFormerBlock`,
`Res2FormerBlock` and `TransformerBlock`, for MyFusion."""

import torch
import torch.nn.functional as F
from torch import nn

from .cuda.conv_chain import CO_TILE, relu6
from .cuda.conv_multi import concat_legs
from .layers import (ACT_CODES, ACTS, BatchNormNHWC, ChannelLayerNorm,
                     ConvLayer, activation, interpolate)
from .quant import record

__all__ = ["Attention", "ConvBlock", "ConvFormerBlock", "DCB", "DCBlock",
           "Decoder", "DenseBlock", "ECB", "FFN", "FSDecoder", "LSDecoder",
           "MetaFormerBlock", "MixConvBlock", "MixFormerBlock",
           "NestDecoder", "NestEncoder", "RFN", "Res2ConvBlock",
           "Res2FormerBlock", "ResBlock", "Scale", "SepConvBlock",
           "TransformerBlock", "TransitionBlock", "attention",
           "attention_plain", "downsample", "nest_block", "pad_to",
           "upsample", "wide_block"]


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


class ResBlock(nn.Module):
    """Two k3 convs and an identity add (reference core/block.py:121-134;
    JAX ops/blocks.py:38): conv1 (`norm1`, relu), conv2 (`norm2`, no
    activation), then + x, with no activation after the add; `ch` channels
    in and out. Serving runs conv1 on conv_chain and conv2 with the residual
    as an identity leg of one conv_multi (ConvLayer.plus_identity: the JAX
    package's `_hiw_resblock`, models/zoo.py:115-124), so the add is no
    pass of its own; with a group norm on conv2 (SEDRFuse), which sits
    between the conv and the add, conv2 runs conv_chain and its norm, then
    the add. State-dict names are the reference's (`layers.{0,1}.layers.*`)."""

    def __init__(self, ch, norm1=None, norm2=None, generator=None):
        super().__init__()
        self.layers = nn.ModuleList([
            ConvLayer(ch, ch, 3, norm=norm1, generator=generator),
            ConvLayer(ch, ch, 3, act=None, norm=norm2, generator=generator)])

    def forward(self, x):
        return self.layers[1].plus_identity(self.layers[0](x), x)


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
        # the reference computes the dead dwconv on hexp: calibration
        # records its input as the JAX package's eager route does
        record(self.dwconv.qpath, hexp)
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
        return relu6(out + res)


def pad_to(feat, hw):
    """Reflect-pad (or crop) NHWC `feat` to (h, w) (JAX ops/blocks.py:813,
    reference block.py:954-962): the size difference splits as torch
    ReflectionPad2d's (lo = d // 2), a negative pad crops, crop first, then
    pad. DBNet's x8 upsample at odd sizes crops (6 x 8 = 48 -> 45)."""
    th, tw = hw
    fh, fw = feat.shape[1:3]
    if (fh, fw) == (th, tw):
        return feat

    def split(d, size):
        lo, hi = d // 2, d - d // 2
        crop_lo, crop_hi = max(-lo, 0), max(-hi, 0)
        return crop_lo, size - crop_hi, max(lo, 0), max(hi, 0)
    h0, h1, ph_lo, ph_hi = split(th - fh, fh)
    w0, w1, pw_lo, pw_hi = split(tw - fw, fw)
    feat = feat[:, h0:h1, w0:w1]
    if ph_lo or ph_hi or pw_lo or pw_hi:
        feat = F.pad(feat.permute(0, 3, 1, 2), (pw_lo, pw_hi, ph_lo, ph_hi),
                     mode="reflect").permute(0, 2, 3, 1)
    return feat.contiguous()


def upsample(feat, scale, mode="bilinear", hw=None):
    """The Upsample block (JAX ops/blocks.py:797): interpolate by `scale`,
    then pad_to `hw` when given (the shape repair of odd sizes)."""
    out = interpolate(feat, scale, mode)
    return out if hw is None else pad_to(out, hw)


def downsample(feat, window, hw):
    """The Downsample block (JAX ops/blocks.py:785): a `window` x `window`
    max pool, stride `window`, VALID, NHWC, then pad_to `hw` (the shape
    repair of odd sizes)."""
    out = F.max_pool2d(feat.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)
    return pad_to(out.contiguous(), hw)


class ConvBlock(nn.Module):
    """Two-conv block, hidden width in_ch // 2 (reference block.py:708-722;
    JAX ops/blocks.py:640): conv1 (`ksize1`) then conv2 (`ksize2`), relu
    both. The first conv takes one tensor or a list of legs (the parts of a
    concat, never built). `wide` = (conv1, conv2): which of them take the
    conv_wide route (ops/layers.py). State-dict names are the reference's
    (`layers.{0,1}.layers.0.*`)."""

    def __init__(self, in_ch, out_ch, ksize1=3, ksize2=1, wide=(False, False),
                 generator=None):
        super().__init__()
        hid = in_ch // 2
        self.layers = nn.ModuleList([
            ConvLayer(in_ch, hid, ksize1, wide=wide[0], generator=generator),
            ConvLayer(hid, out_ch, ksize2, wide=wide[1], generator=generator)])

    def forward(self, x):
        return self.layers[1](self.layers[0](x))


class ECB(ConvBlock):
    """1x1 -> 3x3 (UNFusion's encoder block, JAX ops/blocks.py:678): the k1
    conv over the legs takes conv_wide's k1 instance, the k3 conv over its
    one tensor keeps ConvLayer's chain route."""

    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__(in_ch, out_ch, 1, 3, (True, False), generator)


class DCB(ConvBlock):
    """3x3 -> 3x3 (UNFusion's decoder block, JAX ops/blocks.py:684): both
    convs take conv_wide (the JAX chain route's conv_tlane_chain)."""

    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__(in_ch, out_ch, 3, 3, (True, True), generator)


def nest_block(in_ch, out_ch, generator=None):
    """NestFuse's and RFNNest's ConvBlock (k3 -> k1), each conv's serving
    route decided here, where the block is built: a conv whose c_out is not
    a multiple of CO_TILE (conv_chain's and conv_multi's 16 output
    channels a block) takes conv_wide, which takes any multiple of 4 (the
    hidden width in_ch // 2 is 8 mod 16 at CB1_0, CB3_0 and five of the six
    decoder blocks); the others take ConvLayer's route (conv_chain on one
    tensor, conv_multi on legs)."""
    return ConvBlock(in_ch, out_ch, 3, 1,
                     ((in_ch // 2) % CO_TILE != 0, out_ch % CO_TILE != 0),
                     generator)


def wide_block(in_ch, out_ch, generator=None):
    """MAFusion's ConvBlock (k3 -> k1): both convs take conv_wide, as the
    JAX package runs MAFusion on its C-major chain conv conv_tlane_chain
    (MAFusion is in HIW_MULTI_BLOCKLIST, ops/pallas/hiw_kernel.py:72)."""
    return ConvBlock(in_ch, out_ch, 3, 1, (True, True), generator)


def _legs(*tensors):
    return [(t, 0) for t in tensors]


class NestEncoder(nn.Module):
    """UNFusion's dense multi-scale encoder grid (JAX ops/blocks.py:748,
    reference block.py:762-797): ECB blocks EB2_1 ... EB4_3 over concats of
    the scale's features and stride-2 (or max-pooled) features of the scale
    above. Every concat is a list of legs, never built. `in_ch` / `out_ch`
    are UNFusion's (16, 32, 48, 64) / (16, 64, 256, 1024). forward takes
    (x1_0, (x2_0, d1_0), (x3_0, d2_0), (x4_0, d3_0)) and returns the
    per-scale features (x1_0, x2_1, x3_2, x4_3)."""

    def __init__(self, in_ch, out_ch, down_mode="stride", generator=None):
        super().__init__()
        g = generator
        self.down_mode = down_mode
        self.EB2_1 = ECB(in_ch[1] + in_ch[0], out_ch[1], g)
        self.EB3_1 = ECB(in_ch[2] + in_ch[1], in_ch[2] * 2, g)
        self.EB4_1 = ECB(in_ch[3] + in_ch[2], in_ch[3] * 2, g)
        self.EB3_2 = ECB(in_ch[2] + in_ch[2] * 2 + out_ch[1], out_ch[2], g)
        self.EB4_2 = ECB(in_ch[3] + in_ch[3] * 2 + in_ch[2] * 2,
                         in_ch[3] * 4 + in_ch[2], g)
        self.EB4_3 = ECB(in_ch[3] + in_ch[3] * 2 + in_ch[3] * 4 + in_ch[2]
                         + out_ch[2], out_ch[3], g)
        if down_mode == "stride":
            self.down1 = ConvLayer(out_ch[1], out_ch[1], stride=2, generator=g)
            self.down2 = ConvLayer(in_ch[2] * 2, in_ch[2] * 2, stride=2,
                                   generator=g)
            self.down3 = ConvLayer(out_ch[2], out_ch[2], stride=2, generator=g)

    def forward(self, feats):
        x1_0, f2, f3, f4 = feats
        x2_1 = self.EB2_1(_legs(*f2))
        x3_1 = self.EB3_1(_legs(*f3))
        x4_1 = self.EB4_1(_legs(*f4))
        x3_2 = self.EB3_2(_legs(f3[0], x3_1, down(self, 1, x2_1)))
        x4_2 = self.EB4_2(_legs(f4[0], x4_1, down(self, 2, x3_1)))
        x4_3 = self.EB4_3(_legs(f4[0], x4_1, x4_2, down(self, 3, x3_2)))
        return x1_0, x2_1, x3_2, x4_3


def down(owner, which, x):
    """UNFusion's downsample `which` of `owner` (the model or its
    NestEncoder): its stride-2 conv `down{which}`, or with down_mode
    'maxpool' a 2x2 max pool, stride 2, VALID, NHWC (JAX
    ops/layers.max_pool(x, 2, 2))."""
    if owner.down_mode == "maxpool":
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(
            0, 2, 3, 1).contiguous()
    return getattr(owner, f"down{which}")(x)


class NestDecoder(nn.Module):
    """The U-Net++ nested decoder (JAX ops/blocks.py:882, its H-major and
    chain routes :897-966; reference block.py:836-867): blocks DB1_1 ...
    DB1_3, each over the legs of its concat (never built), each scale
    change an x2 upsample of the coarser feature repaired to the finer
    one's size (`upsample`, the chain routes' hiw_upsample and
    chain_upsample). `block(in_ch, out_ch, generator)` builds each block,
    as the JAX decoder takes its block class: DCB for UNFusion at (16, 64,
    256, 1024), `nest_block` (ConvBlock) for NestFuse and RFNNest at (64,
    112, 160, 208)."""

    def __init__(self, num_ch, up_mode="bilinear", generator=None,
                 block=DCB):
        super().__init__()
        g, c = generator, num_ch
        self.up_mode = up_mode
        self.DB1_1 = block(c[0] + c[1], c[0], g)
        self.DB2_1 = block(c[1] + c[2], c[1], g)
        self.DB3_1 = block(c[2] + c[3], c[2], g)
        self.DB1_2 = block(c[0] * 2 + c[1], c[0], g)
        self.DB2_2 = block(c[1] * 2 + c[2], c[1], g)
        self.DB1_3 = block(c[0] * 3 + c[1], c[0], g)

    def forward(self, feats):
        f0, f1, f2, f3 = feats

        def up(x, like):
            return upsample(x, 2, self.up_mode, like.shape[1:3])
        x1_1 = self.DB1_1(_legs(f0, up(f1, f0)))
        x2_1 = self.DB2_1(_legs(f1, up(f2, f1)))
        x3_1 = self.DB3_1(_legs(f2, up(f3, f2)))
        x1_2 = self.DB1_2(_legs(f0, x1_1, up(x2_1, f0)))
        x2_2 = self.DB2_2(_legs(f1, x2_1, up(x3_1, f1)))
        return self.DB1_3(_legs(f0, x1_1, x1_2, up(x2_2, f0)))


class FSDecoder(nn.Module):
    """The U-Net3+ full-scale decoder (JAX ops/blocks.py:986, its chain
    route :1042-1069; reference block.py FSDecoder): DB3, DB2 and DB1, each
    over four legs (never concatenated), one from every scale, each moved
    to the block's scale and repaired to its size: max pools x4 and x2
    (`downsample`) from the finer scales, x2, x4 and x8 upsamples
    (`upsample`, `up_mode`) from the coarser ones. `block(in_ch, out_ch,
    generator)` builds each block; MAFusion's is `wide_block` at (64, 128,
    256, 512), whose blocks read 960 channels."""

    def __init__(self, num_ch, block, up_mode="bilinear", generator=None):
        super().__init__()
        g, c = generator, num_ch
        self.up_mode = up_mode
        cat = sum(c)
        self.DB3 = block(cat, c[2], g)
        self.DB2 = block(cat, c[1], g)
        self.DB1 = block(cat, c[0], g)

    def forward(self, feats):
        f0, f1, f2, f3 = feats
        hw0, hw1, hw2 = (f.shape[1:3] for f in (f0, f1, f2))

        def up(x, scale, hw):
            return upsample(x, scale, self.up_mode, hw)
        y3 = self.DB3(_legs(downsample(f0, 4, hw2), downsample(f1, 2, hw2),
                            f2, up(f3, 2, hw2)))
        y2 = self.DB2(_legs(downsample(f0, 2, hw1), f1, up(y3, 2, hw1),
                            up(f3, 4, hw1)))
        return self.DB1(_legs(f0, up(y2, 2, hw0), up(y3, 4, hw0),
                              up(f3, 8, hw0)))


class RFN(nn.Module):
    """Residual fusion network of RFN-Nest (JAX ops/blocks.py:690, its
    H-major multi-leg route :699-727; reference block.py RFN_block): the
    learned fusion of one scale's two feature batches, `num_ch` channels
    each, all convs reflect-SAME relu:

        f_res = res([f1, f2])                   k3, 2c -> c
        y     = fuse1([conv1(f1), conv2(f2)])   k3 each, then k1 2c -> c
        out   = fuse3(fuse2(y)) + f_res         k3, k3

    forward(f, n) takes the encoder's 2n-image batch f = [f1; f2]: `res`
    reads f's two halves as legs [(f, 0), (f, n)] (conv_multi, no concat
    and no copy of a half), conv1 and conv2 run on f[:n] and f[n:]
    (conv_chain), `fuse1` reads their outputs as legs. State-dict names
    are the reference's (`res`, `conv1`, `conv2`, `layers.{0,1,2}` for
    fuse1-3)."""

    def __init__(self, num_ch, generator=None):
        super().__init__()
        g, c = generator, num_ch
        self.res = ConvLayer(2 * c, c, 3, generator=g)
        self.conv1 = ConvLayer(c, c, 3, generator=g)
        self.conv2 = ConvLayer(c, c, 3, generator=g)
        self.layers = nn.ModuleList([ConvLayer(2 * c, c, 1, generator=g),
                                     ConvLayer(c, c, 3, generator=g),
                                     ConvLayer(c, c, 3, generator=g)])

    def forward(self, f, n):
        return self.pair(f[:n], f[n:])

    def pair(self, f1, f2):
        """The fusion of two feature batches of n images each, read in
        place (views of one 2n batch, or two tensors: MyFusion's levels
        whose weights the branches do not share)."""
        f_res = self.res(_legs(f1, f2))
        fuse1, fuse2, fuse3 = self.layers
        y = fuse1(_legs(self.conv1(f1), self.conv2(f2)))
        return fuse3(fuse2(y)) + f_res


class TransitionBlock(nn.Module):
    """MyFusion's down between scales (reference block.py:620-664; JAX
    ops/blocks.py:531-585): with down_mode 'stride' a depthwise ConvLayer
    of kernel size and stride `stride`, VALID (layers.0: at stride 2
    F.conv2d(groups=C) on every route, as the JAX package runs it on XLA's
    grouped conv; at stride 1 a k1 conv_dw), with 'maxpool' a `stride` x
    `stride` max pool (layers.0, no parameters); then the
    pw k1 conv to `out_ch` (layers.1, conv_chain). Both convs take the
    block's activation, norm and bias. Odd sizes floor (45 -> 22), as VALID
    does; the decoder's `pad_to` repairs them."""

    def __init__(self, in_ch, out_ch, stride=2, down_mode="stride",
                 act="relu6", norm=None, use_bias=False, generator=None):
        super().__init__()
        if down_mode not in ("stride", "maxpool"):
            raise ValueError(f"down_mode {down_mode!r} not in stride/maxpool")
        kw = dict(act=act, norm=norm, use_bias=use_bias, generator=generator)
        if down_mode == "stride":
            down = ConvLayer(in_ch, in_ch, stride, groups=in_ch,
                             stride=stride, padding=0, **kw)
        else:
            down = nn.MaxPool2d(stride)
        self.layers = nn.ModuleList([down, ConvLayer(in_ch, out_ch, 1,
                                                     **kw)])

    def forward(self, x):
        down, pw = self.layers
        if isinstance(down, ConvLayer):
            return pw(down(x))
        x = down(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
        return pw(x)


class SepConvBlock(nn.Module):
    """The inverted bottleneck (reference block.py:154-227; JAX
    ops/blocks.py:93-169), MyFusion's 'sep' encoder block, relu6, no bias:

        out = dwconv(pwconv1(x))        k1 in -> scale * in (relu6), k3
                                        depthwise (no activation)
        out = out * pwconv(x)           with `attention` (k1, relu6)
        out = relu6(pwconv2(out) + shortcut(x))

    the shortcut an identity when in_ch == out_ch (MyFusion's), else k1.
    pwconv1 runs conv_chain, dwconv conv_dw; pwconv2 with the identity
    shortcut is one conv_multi whose identity leg carries the add and whose
    epilogue the relu6 (`ConvLayer.plus_identity`); with a k1 shortcut,
    pwconv2 and the shortcut run conv_chain, the add and relu6 torch ops.
    The reference's `residual` switch is not ported (MyFusion keeps it
    on). State-dict names are the reference's."""

    def __init__(self, in_ch, out_ch, scale=4, ksize=3, attention=False,
                 generator=None):
        super().__init__()
        g, hid = generator, in_ch * scale
        self.pwconv1 = ConvLayer(in_ch, hid, 1, act="relu6", use_bias=False,
                                 generator=g)
        self.dwconv = ConvLayer(hid, hid, ksize, act=None, groups=hid,
                                use_bias=False, generator=g)
        self.pwconv2 = ConvLayer(hid, out_ch, 1, act=None, use_bias=False,
                                 generator=g)
        self.shortcut = (ConvLayer(in_ch, out_ch, 1, act=None, use_bias=False,
                                   generator=g) if in_ch != out_ch else None)
        self.pwconv = (ConvLayer(in_ch, hid, 1, act="relu6", use_bias=False,
                                 generator=g) if attention else None)

    def forward(self, x):
        out = self.dwconv(self.pwconv1(x))
        if self.pwconv is not None:
            out = out * self.pwconv(x)
        if self.shortcut is None:
            return self.pwconv2.plus_identity(out, x, "relu6")
        return relu6(self.pwconv2(out) + self.shortcut(x))


class DCBlock(nn.Module):
    """MyFusion's decoder block (reference block.py:667-705; JAX
    ops/blocks.py:588-637), hid = in_ch // 2, relu6, no bias:

        y = dw(pw1(x))                  k1 over the concat's legs (never
                                        built), k3 depthwise, relu6 both
        out = relu6(pw2(y) (+ shortcut(x)))

    pw1 runs conv_multi over legs (conv_chain on one tensor), or conv_wide
    where the hidden width is not a multiple of CO_TILE (24 at DB1_1, 40 at
    DB1_3, 120 in the 'fs' decoder), decided here as `nest_block` decides;
    dw runs conv_dw. Without `residual`, the final relu6 is pw2's epilogue
    (the layer keeps the reference's act None for its init); with it, pw2
    with an identity shortcut (in_ch == out_ch) is one conv_multi
    (`plus_identity`), a k1 shortcut runs apart and the add and relu6 are
    torch ops. `block(in_ch, out_ch, generator)` as the decoders build
    their blocks. State-dict names are the reference's (`layers.{0,1,2}`,
    `shortcut`)."""

    def __init__(self, in_ch, out_ch, generator=None, residual=False):
        super().__init__()
        g, hid = generator, in_ch // 2
        pw2 = ConvLayer(hid, out_ch, 1, act=None, use_bias=False,
                        wide=out_ch % CO_TILE != 0, generator=g)
        if not residual:
            pw2.act = "relu6"
        self.layers = nn.ModuleList([
            ConvLayer(in_ch, hid, 1, act="relu6", use_bias=False,
                      wide=hid % CO_TILE != 0, generator=g),
            ConvLayer(hid, hid, 3, act="relu6", groups=hid, use_bias=False,
                      generator=g),
            pw2])
        self.residual = residual
        self.shortcut = (ConvLayer(in_ch, out_ch, 1, act=None, use_bias=False,
                                   generator=g)
                         if residual and in_ch != out_ch else None)

    def forward(self, x):
        pw1, dw, pw2 = self.layers
        y = dw(pw1(x))
        if not self.residual:
            return pw2(y)
        if self.shortcut is None:
            res = concat_legs(x) if isinstance(x, list) else x
            return pw2.plus_identity(y, res, "relu6")
        return relu6(pw2(y) + self.shortcut(x))


class Decoder(nn.Module):
    """MyFusion's plain up path (reference block.py:800-814; JAX
    ops/blocks.py:844-858): DB3, DB2 and DB1 on the x2 upsample of the
    coarser output, repaired to the finer scale's size. As the reference,
    it reads only the coarsest feature and its own outputs."""

    long_skip = False

    def __init__(self, num_ch, block=DCBlock, up_mode="bilinear",
                 generator=None):
        super().__init__()
        g, c, s = generator, num_ch, int(self.long_skip)
        self.up_mode = up_mode
        self.DB3 = block(c[3] + s * c[2], c[2], g)
        self.DB2 = block(c[2] + s * c[1], c[1], g)
        self.DB1 = block(c[1] + s * c[0], c[0], g)

    def forward(self, feats):
        y = feats[3]
        for blk, f in ((self.DB3, feats[2]), (self.DB2, feats[1]),
                       (self.DB1, feats[0])):
            up = upsample(y, 2, self.up_mode, f.shape[1:3])
            y = blk(_legs(f, up) if self.long_skip else up)
        return y


class LSDecoder(Decoder):
    """The U-Net long-skip decoder (reference block.py:817-833; JAX
    ops/blocks.py:861-880): each block over the legs [skip, x2 upsample of
    the coarser output] (never concatenated)."""

    long_skip = True


class MixConvBlock(nn.Module):
    """MixConv (reference block.py:229-283; JAX ops/blocks.py:172-223),
    MyFusion's 'mix' encoder block and the MixFormer's mixer, `ch` channels
    in and out, relu6, no bias:

        hexp = pwconv1(x)               k1, ch -> 4 ch (relu6)
        y_i  = dwconvs[i](hexp_i)       depthwise, kernel 2 i + 1 (k1, k3,
                                        k5, k7), no activation
        out  = relu6(pwconv2([y_0, ..., y_3]) + x)

    hexp_i is window i's ch channels of hexp, read in place by its conv_dw
    launch (ConvLayer.depthwise); pwconv2 reads the windows' outputs as
    legs, with x as one more identity leg of the same conv_multi whose
    epilogue is the relu6 (`ConvLayer.plus_identity`). The `dwconv`
    parameters (k3 over the whole expansion) exist for the reference state
    dict and never run (the reference block builds and ignores them).
    State-dict names are the reference's (`dwconvs.{i}`)."""

    def __init__(self, ch, generator=None):
        super().__init__()
        g, hid = generator, 4 * ch
        self.ch = ch
        self.pwconv1 = ConvLayer(ch, hid, 1, act="relu6", use_bias=False,
                                 generator=g)
        self.dwconv = ConvLayer(hid, hid, 3, act=None, groups=hid,
                                use_bias=False, generator=g)
        self.pwconv2 = ConvLayer(hid, ch, 1, act=None, use_bias=False,
                                 generator=g)
        self.dwconvs = nn.ModuleList([
            ConvLayer(ch, ch, 2 * i + 1, act=None, groups=ch,
                      use_bias=False, generator=g) for i in range(4)])

    def forward(self, x):
        hexp = self.pwconv1(x)
        record(self.dwconv.qpath, hexp)   # the reference computes it
        legs = [(conv.depthwise(hexp, lo=i * self.ch), 0)
                for i, conv in enumerate(self.dwconvs)]
        return self.pwconv2.plus_identity(legs, x, "relu6")


def attention_plain(q, k, v, num_heads):
    """Plain version of `attention`: the JAX package's einsum, softmax and
    einsum (ops/blocks.py:402-407) in f32 (float64 for float64 inputs),
    cast back to q's dtype."""
    b, n, c = q.shape
    ct = torch.promote_types(q.dtype, torch.float32)
    qh, kh, vh = (t.to(ct).reshape(b, -1, num_heads, c // num_heads)
                  for t in (q, k, v))
    scale = (c // num_heads) ** -0.5
    att = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale, -1)
    return torch.einsum("bhnm,bmhd->bnhd", att, vh).reshape(
        b, n, c).to(q.dtype)


def attention(q, k, v, num_heads):
    """Multi-head softmax(q k^T / sqrt(d)) v over tokens: q (B, N, C), k
    and v (B, M, C), the channel vector c = head * d + i (the JAX
    package's reshape, ops/blocks.py:397-400) -> (B, N, C). On CUDA
    tensors torch's scaled_dot_product_attention restricted to its flash
    and memory-efficient backends (a library call, not a kernel of the
    port; the JAX package runs XLA's einsums, no Pallas kernel): at
    MyFusion's level 1 a head's score matrix of one image holds 6.1e9
    entries, which the math backend would build, so a shape neither
    backend takes (a float64 one among them) raises. Both backends have a
    backward (the training routes). CPU tensors take `attention_plain`."""
    if not q.is_cuda:
        return attention_plain(q, k, v, num_heads)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, n, c = q.shape
    # both backends read the head dim with stride 1: a training route's
    # q, k and v are NHWC views of NCHW convs (serving's are contiguous)
    qh, kh, vh = (t.contiguous().reshape(b, -1, num_heads, c // num_heads)
                  .transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(qh, kh, vh)
    return out.transpose(1, 2).reshape(b, n, c)


class Attention(nn.Module):
    """PVT spatial-reduction multi-head self-attention (reference
    block.py:355-434; JAX ops/blocks.py:345-411), the Transformer's mixer:
    q = q(x); keys and values from the map pooled by sr (`pool`, a VALID
    depthwise conv of kernel and stride sr, F.conv2d(groups=C) as the JAX
    package runs XLA's grouped conv; or 'avgpool', a VALID sr x sr mean),
    k = k(pool(x)), v = v(pool(x)); `attention` over the H W tokens of q
    and the pooled tokens; proj. q, k, v and proj are k1 convs (conv_chain)
    without activation or norm, as the MetaFormer builds them. ch // 16
    heads of 16 channels; sr = 16 // (ch // 16): 16, 8, 4, 2 at
    MyFusion's 16-128 channels, so every level has the same number of
    keys. At sr 1 the pool's parameters exist (the reference builds the
    layer in 'stride' mode) and do not run. `ch` channels in and out (the
    MetaFormer's). State-dict names are the reference's."""

    def __init__(self, ch, qkv_bias=False, proj_bias=False,
                 down_mode="stride", generator=None):
        super().__init__()
        if down_mode not in ("stride", "avgpool"):
            raise ValueError(f"down_mode {down_mode!r} not in stride/avgpool")
        g = generator
        self.num_heads = ch // 16
        self.sr = 16 // self.num_heads
        kw = dict(act=None, generator=g)
        self.q = ConvLayer(ch, ch, 1, use_bias=qkv_bias, **kw)
        self.k = ConvLayer(ch, ch, 1, use_bias=qkv_bias, **kw)
        self.v = ConvLayer(ch, ch, 1, use_bias=qkv_bias, **kw)
        self.proj = ConvLayer(ch, ch, 1, use_bias=proj_bias, **kw)
        self.pool = (ConvLayer(ch, ch, self.sr, groups=ch,
                               stride=self.sr, padding=0, use_bias=False,
                               **kw) if down_mode == "stride" else None)

    def forward(self, x):
        b, h, w, _ = x.shape
        q = self.q(x)
        if self.sr == 1:
            xp = x
        elif self.pool is not None:
            xp = self.pool(x)
        else:
            xp = F.avg_pool2d(x.permute(0, 3, 1, 2), self.sr).permute(
                0, 2, 3, 1).contiguous()
        k, v = self.k(xp), self.v(xp)
        c = q.shape[-1]
        out = attention(q.reshape(b, h * w, c), k.reshape(b, -1, c),
                        v.reshape(b, -1, c), self.num_heads)
        return self.proj(out.reshape(b, h, w, c))


class FFN(nn.Module):
    """The conv FFN (reference block.py:437-457; JAX ops/blocks.py:414-
    433), no bias: pw1 (k1, ch -> 4 ch, relu6; conv_chain), dw (k3
    depthwise **with** relu6, unlike SepConvBlock's; conv_dw), pw2 (k1
    back to ch, no activation). forward(x, res, act) returns act(pw2(...)
    + res) with res an identity leg of pw2's conv_multi
    (`ConvLayer.plus_identity`): the MetaFormer's second residual without
    its scales. State-dict names are the reference's (`layers.{0,1,2}`)."""

    def __init__(self, ch, generator=None):
        super().__init__()
        hid = 4 * ch
        kw = dict(use_bias=False, generator=generator)
        self.layers = nn.ModuleList([
            ConvLayer(ch, hid, 1, act="relu6", **kw),
            ConvLayer(hid, hid, 3, act="relu6", groups=hid, **kw),
            ConvLayer(hid, ch, 1, act=None, **kw)])

    def forward(self, x, res=None, act=None):
        pw1, dw, pw2 = self.layers
        y = dw(pw1(x))
        return pw2(y) if res is None else pw2.plus_identity(y, res, act)


class Scale(nn.Module):
    """A learnable per-channel scale (reference block.py:460-469; JAX
    ops/blocks.py:436-448), `scale` (C,) f32 over the last (channel) dim;
    the product in f32."""

    def __init__(self, ch, init_value=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((ch,), float(init_value)))

    def forward(self, x):
        return x * self.scale


def _standalone_norm(kind, ch):
    if kind is None:
        return None
    if kind == "batch":
        return BatchNormNHWC(ch)
    if kind == "layer":
        return ChannelLayerNorm(ch)
    raise ValueError(f"MetaFormer norm {kind!r} not in None/batch/layer")


class MetaFormerBlock(nn.Module):
    """The MetaFormer skeleton (reference block.py:503-540; JAX
    ops/blocks.py:451-507), `ch` channels in and out:

        h   = mixer(norm1(x))
        out = act(layer_scale1(h) + res_scale1(x))
        h2  = ffn(norm2(out))
        out = act(layer_scale2(h2) + res_scale2(out))

    `mixer` 'sep' (SepConvBlock), 'mix' (MixConvBlock), 'res2'
    (Res2ConvBlock), 'attn' (Attention) or None (the identity); `norm`
    'layer' (ChannelLayerNorm), 'batch' (BatchNormNHWC, eval mode) or None;
    a scale is used only when its value is truthy (JAX :487-490). The
    first add is a torch op (the mixer ends in its own activation); without
    scales, and with an activation a kernel fuses, the second rides the
    FFN's pw2 as an identity leg. The Former blocks fix the mixer, the
    batch norm and relu6 (reference :543-617). State-dict names are the
    reference's (`norm1`, `token_mixer`, `layer_scale1.scale`, `ffn`)."""

    def __init__(self, ch, mixer=None, norm="layer", act=None,
                 layer_scale=None, res_scale=None, generator=None):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"MetaFormer act {act!r} not in {ACTS}")
        g = generator
        mixers = {None: lambda: None,
                  "sep": lambda: SepConvBlock(ch, ch, generator=g),
                  "mix": lambda: MixConvBlock(ch, generator=g),
                  "res2": lambda: Res2ConvBlock(ch, ch, generator=g),
                  "attn": lambda: Attention(ch, generator=g)}
        if mixer not in mixers:
            raise ValueError(f"unknown mixer {mixer!r}")
        self.act = act
        self.norm1 = _standalone_norm(norm, ch)
        self.token_mixer = mixers[mixer]()
        self.layer_scale1 = Scale(ch, layer_scale) if layer_scale else None
        self.res_scale1 = Scale(ch, res_scale) if res_scale else None
        self.norm2 = _standalone_norm(norm, ch)
        self.ffn = FFN(ch, generator=g)
        self.layer_scale2 = Scale(ch, layer_scale) if layer_scale else None
        self.res_scale2 = Scale(ch, res_scale) if res_scale else None

    def _add(self, h, x, ls, rs):
        """act(ls(h) + rs(x)); with a scale in f32, then the cast."""
        if ls is None and rs is None:
            return activation(h + x, self.act)
        y = ((h if ls is None else ls(h)) + (x if rs is None else rs(x)))
        return activation(y, self.act).to(x.dtype)

    def forward(self, x):
        h = x if self.norm1 is None else self.norm1(x)
        if self.token_mixer is not None:
            h = self.token_mixer(h)
        out = self._add(h, x, self.layer_scale1, self.res_scale1)
        h2 = out if self.norm2 is None else self.norm2(out)
        if (self.layer_scale2 is None and self.res_scale2 is None
                and self.act in ACT_CODES):
            return self.ffn(h2, out, self.act)
        return self._add(self.ffn(h2), out, self.layer_scale2,
                         self.res_scale2)


class ConvFormerBlock(MetaFormerBlock):
    """MetaFormer with the SepConvBlock mixer, batch norms, relu6."""

    def __init__(self, ch, generator=None):
        super().__init__(ch, "sep", "batch", "relu6", generator=generator)


class MixFormerBlock(MetaFormerBlock):
    """MetaFormer with the MixConvBlock mixer, batch norms, relu6."""

    def __init__(self, ch, generator=None):
        super().__init__(ch, "mix", "batch", "relu6", generator=generator)


class Res2FormerBlock(MetaFormerBlock):
    """MetaFormer with the Res2ConvBlock mixer, batch norms, relu6."""

    def __init__(self, ch, generator=None):
        super().__init__(ch, "res2", "batch", "relu6", generator=generator)


class TransformerBlock(MetaFormerBlock):
    """MetaFormer with the Attention mixer, batch norms, relu6."""

    def __init__(self, ch, generator=None):
        super().__init__(ch, "attn", "batch", "relu6", generator=generator)
