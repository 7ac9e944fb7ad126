"""Fusion model zoo of the port (counterpart of multi_modal_image_fusion_tpu
models/zoo.py). Ported: DeepFuse (the reference CLIs' default model),
DenseFuse, VIFNet, DBNet, UNFusion, Res2Fusion, NestFuse, RFNNest and
MAFusion; the other 7 models are queued in ROADMAP.md.

Models take NHWC single-channel images:

    model(img1, img2)   -> fused image (B, H, W, 1)
    model(img1)         -> autoencoder reconstruction (two-stage training)
"""

import torch
from torch import nn

from ..ops.blocks import (RFN, DenseBlock, FSDecoder, NestDecoder,
                          NestEncoder, Res2ConvBlock, down, nest_block,
                          upsample, wide_block)
from ..ops.cuda.conv_pair import conv_pair_enter, conv_pair_exit
from ..ops.cuda.s2d_io import s2d_enter, s2d_exit
from ..ops.fusion import attention_fusion, element_fusion
from ..ops.layers import ConvLayer, int8_ctx
from ..ops.quant import (calibrating, chain_hop_ok, chain_leg_ok,
                         hiw_int8_enabled, hiw_res_enabled, name_layers,
                         quant_off, quant_skipped)
from ..ops.s2d import (chain_pair_enabled, hiw_enabled, s2d_enabled,
                       s2d_io_enabled, s2d_io_ok, s2d_pack, s2d_unpack)

__all__ = ["DBNet", "DeepFuse", "DenseFuse", "MAFusion", "MODEL_ZOO",
           "NestFuse", "RFNNest", "Res2Fusion", "UNFusion", "VIFNet",
           "create_model"]


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
    (ops/layers.py).

    Under ops/quant.quantized_inference a fused pair runs the int8 chain
    (JAX zoo.py:348-468, ops/pallas/hiw_int8.py): the legs that
    `chain_leg_ok` admits and that have a calibrated amax (enc1, dec0 and
    dec1) run conv_int8_chain, the gray entry and exit stay on their float
    kernels; the hops enc1 -> dec0 ('sum' only: the siamese sum then rides
    the int8 grid in dec0's load) and dec0 -> dec1 stay int8 between the
    legs unless MMIF_HIW_INT8_RES=0. MMIF_HIW_INT8=0, and autoencoder
    mode, send every layer to ConvLayer's int8 route instead.

    A fused pair served outside a trainer scope, with no gradient needed and
    outside `calibrate`, takes a route in the JAX package's order
    (zoo.py:352-540), each switch read at call time (ops/s2d.py):

    1. int8 (above): the int8 chain unless MMIF_CHAIN_PAIR is set;
    2. MMIF_CHAIN_PAIR set (any non-empty value): the fused conv pairs
       (ops/cuda/conv_pair.py): conv_pair_enter (enc0 + enc1 on the gray
       pair), dec0 on conv_chain (fuse_n for 'sum', element_fusion first
       for 'mean'/'max'), conv_pair_exit (dec1 + dec2). The route is float
       even under int8, as the JAX pair route has no int8 dispatch;
    3. MMIF_CHAIN_HIW on (the default), or int8: the default route;
    4. MMIF_S2D on and H, W even: the packed chain, every layer on
       conv_wide's s2d mode at (H/2, W/2) on 4x the channels (ConvLayer.
       packed), entered and left through s2d_enter / s2d_exit
       (ops/cuda/s2d_io.py) when MMIF_S2D_IO is on and `s2d_io_ok` holds
       on the chain dtype, else through the torch pack; 'sum' is dec0's
       fuse_n on the packed legs, 'mean'/'max' fuse the packed halves;
    5. otherwise the default route.

    In training, with a gradient and during calibration every layer is
    recorded or differentiated on the default route."""

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
        qc = int8_ctx()
        route = self.route(img1, img2)
        if route == "int8_chain":
            return self._int8_chain(img1, img2, qc)
        if route == "pair":
            with quant_off():
                return self._pair_chain(img1, img2)
        if route == "s2d":
            return self._packed_chain(img1, img2)
        t = enc1(enc0.enter(img1, img2))
        if img2 is None:
            t = dec0(t)
        elif self.fusion_mode == "sum":
            t = dec0(t, fuse_n=img1.shape[0])
        else:
            n = img1.shape[0]
            t = dec0(element_fusion(t[:n], t[n:], self.fusion_mode))
        return dec2(dec1(t))

    def route(self, img1, img2=None):
        """The route forward takes now (class docstring): 'int8_chain',
        'pair', 's2d' or 'default'."""
        layers = [*self.encode, *self.decode]
        if (img2 is None or calibrating()
                or any(m._training_route(img1, img2) for m in layers)):
            return "default"
        if int8_ctx() is not None:
            if not hiw_int8_enabled():
                return "default"        # ConvLayer's int8 route
            return "pair" if chain_pair_enabled() else "int8_chain"
        if chain_pair_enabled():
            return "pair"
        h, w = img1.shape[1:3]
        if not hiw_enabled() and s2d_enabled() and h % 2 == 0 and w % 2 == 0:
            return "s2d"
        return "default"

    def _pair_chain(self, img1, img2):
        """The MMIF_CHAIN_PAIR route (JAX zoo.py:510-540)."""
        enc0, enc1 = self.encode
        dec0, dec1, dec2 = self.decode
        n = img1.shape[0]
        wa, ba, _, aa = enc0.pair_args()
        wb, bb, _, ab = enc1.pair_args()
        t = conv_pair_enter(img1, img2, wa, ba, aa, wb, bb, ab)
        if self.fusion_mode == "sum":
            t = dec0(t, fuse_n=n)
        else:
            t = dec0(element_fusion(t[:n], t[n:], self.fusion_mode))
        wa, ba, _, aa = dec1.pair_args()
        wb, bb, _, ab = dec2.pair_args()
        return conv_pair_exit(t, wa, ba, aa, wb, bb, ab)

    def _packed_chain(self, img1, img2):
        """The MMIF_S2D route (JAX zoo.py:470-508)."""
        n, h, w = img1.shape[:3]
        dt = self.encode[0].weight.dtype
        use_io = s2d_io_enabled() and s2d_io_ok(h, w, dt)
        if use_io:
            t = s2d_enter(img1, img2, dt)
        else:
            t = s2d_pack(torch.cat([img1, img2], 0).to(dt)).contiguous()
        for layer in self.encode:
            t = layer.packed(t)
        dec0, *rest = self.decode
        if self.fusion_mode == "sum":
            t = dec0.packed(t, fuse_n=n)
        else:
            t = dec0.packed(element_fusion(t[:n], t[n:], self.fusion_mode))
        for layer in rest:
            t = layer.packed(t)
        return s2d_exit(t) if use_io else s2d_unpack(t).contiguous()

    def _int8_chain(self, img1, img2, qc):
        enc0, enc1 = self.encode
        dec0, dec1, dec2 = self.decode
        n = img1.shape[0]

        def leg_amax(layer):
            """The calibrated amax if this leg runs int8, else None."""
            a = qc.amax.get(layer.qpath)
            if (a is None or not chain_leg_ok(layer.in_ch, layer.out_ch)
                    or quant_skipped(layer.qpath)):
                return None
            a = torch.as_tensor(a, dtype=torch.float32)
            return a if a.shape == (layer.in_ch,) and a.max() > 0 else None
        amax = {m: leg_amax(m) for m in (enc0, enc1, dec0, dec1, dec2)}

        def hop(prod, cons):
            """cons, if prod's output stays int8 on cons's fold grid."""
            if (hiw_res_enabled() and amax[prod] is not None
                    and amax[cons] is not None and chain_hop_ok(prod.act)):
                return cons
            return None

        def leg(layer, t, fuse_n=0, out_to=None):
            if amax[layer] is None:
                with quant_off():
                    return layer(t, fuse_n)
            return layer.chain_int8(
                t, amax[layer], fuse_n, out_to,
                None if out_to is None else amax[out_to])

        with quant_off():
            t = enc0.enter(img1, img2)
        if self.fusion_mode == "sum":
            t = leg(enc1, t, out_to=hop(enc1, dec0))
            t = leg(dec0, t, n, out_to=hop(dec0, dec1))
        else:
            t = leg(enc1, t)
            t = leg(dec0, element_fusion(t[:n], t[n:], self.fusion_mode),
                    out_to=hop(dec0, dec1))
        return leg(dec2, leg(dec1, t))


def _dense_encoder(generator):
    """conv_in (1 -> 16, k3) and a 3-conv DenseBlock: the shared encoder of
    DenseFuse and VIFNet, at the reference's `encode.0` / `encode.1`."""
    return nn.ModuleList([ConvLayer(1, 16, generator=generator),
                          DenseBlock(16, 16, generator=generator)])


class DenseFuse(nn.Module):
    """Dense encoder (64 channels), 'sum' or 'l1' spatial-attention fusion,
    4-conv k3 decoder (reference core/model.py:165-186; JAX models/zoo.py:
    558-631).

    Serving follows the JAX package's multi-leg path (`_hiw_forward`,
    zoo.py:615-631): the siamese fold runs conv_in (conv_gray_enter) and the
    dense block once over the batch-concatenated pair, the dense growth stays
    a list of four 16-channel legs that is never concatenated (conv_multi),
    and 'sum' fusion is dec0's fuse_n load over the legs. 'l1' has no
    multi-leg path in the JAX package either (it runs the C-major chain,
    zoo.py:597-612): the legs are concatenated per half and fused by
    attention_fusion('sa', 'l1') in torch, and dec0 runs conv_chain. dec1
    and dec2 run conv_chain, dec3 conv_gray_exit. Autoencoder mode
    (`model(img1)`) decodes one image batch's legs. The conv routes are
    ConvLayer's (ops/layers.py): on the training routes the legs are
    concatenated."""

    def __init__(self, fusion_mode="sum", generator=None):
        super().__init__()
        if fusion_mode not in ("sum", "l1"):
            raise ValueError(f"DenseFuse fusion_mode {fusion_mode!r} not in "
                             f"sum/l1")
        self.fusion_mode = fusion_mode
        g = generator
        self.encode = _dense_encoder(g)
        self.decode = nn.ModuleList([
            ConvLayer(64, 64, generator=g),
            ConvLayer(64, 32, generator=g),
            ConvLayer(32, 16, generator=g),
            ConvLayer(16, 1, act=None, generator=g),
        ])

    def forward(self, img1, img2=None):
        conv_in, dense = self.encode
        dec0, *rest = self.decode
        legs = dense(conv_in.enter(img1, img2))
        n = img1.shape[0]
        if img2 is None:
            t = dec0([(x, 0) for x in legs])
        elif self.fusion_mode == "sum":
            t = dec0([(x, 0) for x in legs], fuse_n=n)
        else:
            feat = torch.cat(legs, dim=-1)
            t = dec0(attention_fusion(feat[:n], feat[n:], "sa",
                                      spatial_mode="l1"))
        for layer in rest:
            t = layer(t)
        return t


class VIFNet(nn.Module):
    """DenseFuse's encoder, concat fusion, 5-conv k3 decoder from 128
    channels (reference core/model.py:189-206; JAX models/zoo.py:634-696).

    Serving follows the JAX multi-leg path (zoo.py:678-696): the 128-channel
    concat fusion is dec0 reading the same four dense legs at batch offsets
    0 and n (8 legs, conv_multi); dec1-dec3 run conv_chain, dec4
    conv_gray_exit. The model has no autoencoder mode: its decoder takes
    both images' features."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.encode = _dense_encoder(g)
        self.decode = nn.ModuleList([
            ConvLayer(128, 128, generator=g),
            ConvLayer(128, 64, generator=g),
            ConvLayer(64, 32, generator=g),
            ConvLayer(32, 16, generator=g),
            ConvLayer(16, 1, act=None, generator=g),
        ])

    def forward(self, img1, img2=None):
        if img2 is None:
            raise ValueError("VIFNet has no autoencoder mode: its decoder "
                             "takes the concat of both images' features")
        conv_in, dense = self.encode
        dec0, *rest = self.decode
        n = img1.shape[0]
        legs = dense(conv_in.enter(img1, img2))
        t = dec0([(x, 0) for x in legs] + [(x, n) for x in legs])
        for layer in rest:
            t = layer(t)
        return t


class Res2Fusion(nn.Module):
    """conv_in and two Res2 blocks with dense growth (112 channels),
    double non-local attention fusion, 4-conv k3 decoder (reference
    core/model.py Res2Fusion; JAX models/zoo.py:1131-1234).

    Serving follows the JAX package's H-major path (`_hiw_forward`,
    zoo.py:1193-1234): the siamese fold runs conv_in (conv_gray_enter), RB1
    (16 -> 32) and RB2 (the legs [x16, r1], 48 -> 64) once over the
    batch-concatenated pair; the encoder's output stays the legs [x16, r1,
    r2]. 'attn' fusion concatenates them to 112 channels and fuses each
    modality's half with attention_fusion('sca', spatial_mode,
    channel_mode), by default the non-local 'nl' pair; the spatial 'nl'
    runs once per modality, so each normalises by its own batch's energy
    range. dec0-dec2 run conv_chain, dec3 conv_gray_exit with relu (the
    reference keeps ConvLayer's default activation there). 'elem' fusion
    averages each leg's halves and dec0 reads the three means as legs
    (conv_multi); autoencoder mode (`model(img1)`) decodes one batch's legs
    the same way. The conv routes are ConvLayer's (ops/layers.py)."""

    def __init__(self, fusion_method="attn", spatial_mode="nl",
                 channel_mode="nl", generator=None):
        super().__init__()
        if fusion_method not in ("elem", "attn"):
            raise ValueError("only supported ['elem', 'attn'] mode")
        self.fusion_method = fusion_method
        self.spatial_mode, self.channel_mode = spatial_mode, channel_mode
        g = generator
        self.conv_in = ConvLayer(1, 16, generator=g)
        self.RB1 = Res2ConvBlock(16, 32, scale=4, generator=g)
        self.RB2 = Res2ConvBlock(48, 64, scale=8, generator=g)
        self.decode = nn.ModuleList([
            ConvLayer(112, 64, generator=g),
            ConvLayer(64, 32, generator=g),
            ConvLayer(32, 16, generator=g),
            ConvLayer(16, 1, generator=g),
        ])

    def forward(self, img1, img2=None):
        x16 = self.conv_in.enter(img1, img2)
        r1 = self.RB1(x16)
        r2 = self.RB2([(x16, 0), (r1, 0)])
        legs = [x16, r1, r2]
        dec0, *rest = self.decode
        n = img1.shape[0]
        if img2 is None:
            t = dec0([(x, 0) for x in legs])
        elif self.fusion_method == "elem":
            t = dec0([(element_fusion(x[:n], x[n:], "mean"), 0)
                      for x in legs])
        else:
            feat = torch.cat(legs, dim=-1)
            t = dec0(attention_fusion(feat[:n], feat[n:], "sca",
                                      self.spatial_mode, self.channel_mode))
        for layer in rest:
            t = layer(t)
        return t


class DBNet(nn.Module):
    """Dual-branch encoder: a detail branch (conv + dense block) and a
    semantic branch (three stride-2 convs, x8 bilinear upsample repaired to
    the input size), 'sum' or 'avg' fusion, 4-conv k3 decoder (reference
    core/model.py:209-244; JAX models/zoo.py:699-772).

    Serving follows the JAX package's chain route (zoo.py:753-772): the
    encoder runs once over the batch-concatenated pair (conv_in through
    conv_gray_enter, detail0 conv_chain, the dense growth conv_multi, the
    stride-2 convs F.conv2d) and its output stays the legs [x, y1, y2, y3,
    s]; 'sum' fusion is dec0's fuse_n load over the legs; 'avg' concatenates
    them and fuses the halves with attention_fusion('ca', channel_mode=
    'avg'). dec0-dec2 are the chain's conv_tlane_chain call sites and run
    conv_wide, dec3 conv_gray_exit. Autoencoder mode (`model(img1)`)
    decodes one batch's legs."""

    def __init__(self, fusion_mode="sum", generator=None):
        super().__init__()
        if fusion_mode not in ("sum", "avg"):
            raise ValueError("only supported ['sum', 'avg'] mode")
        self.fusion_mode = fusion_mode
        g = generator
        self.encode = ConvLayer(1, 32, generator=g)
        self.detail = nn.ModuleList([ConvLayer(32, 16, generator=g),
                                     DenseBlock(16, 16, generator=g)])
        self.semantic = nn.ModuleList([
            ConvLayer(32, 64, stride=2, generator=g),
            ConvLayer(64, 128, stride=2, generator=g),
            ConvLayer(128, 64, stride=2, generator=g)])
        self.decode = nn.ModuleList([
            ConvLayer(128, 64, wide=True, generator=g),
            ConvLayer(64, 32, wide=True, generator=g),
            ConvLayer(32, 16, wide=True, generator=g),
            ConvLayer(16, 1, act=None, generator=g)])

    def forward(self, img1, img2=None):
        feat = self.encode.enter(img1, img2)
        legs = self.detail[1](self.detail[0](feat))
        s = feat
        for layer in self.semantic:
            s = layer(s)
        legs.append(upsample(s, 8, "bilinear", feat.shape[1:3]))
        dec0, *rest = self.decode
        n = img1.shape[0]
        if img2 is None:
            t = dec0([(x, 0) for x in legs])
        elif self.fusion_mode == "sum":
            t = dec0([(x, 0) for x in legs], fuse_n=n)
        else:
            f = torch.cat(legs, dim=-1)
            t = dec0(attention_fusion(f[:n], f[n:], "ca", channel_mode="avg"))
        for layer in rest:
            t = layer(t)
        return t


class UNFusion(nn.Module):
    """Dense multi-scale encoder grid, per-scale attention fusion, U-Net++
    nested decoder (reference core/model.py:387-439; JAX models/zoo.py:
    1024-1100).

    Serving follows the JAX package's chain route (zoo.py:1081-1100): the
    encoder runs once over the batch-concatenated pair (CB1_0 through
    conv_gray_enter, CB2_0-CB4_0 and the ECBs' k3 convs conv_chain, the
    ECBs' k1 convs over their legs conv_wide, the stride-2 downs F.conv2d);
    each scale's halves are fused by attention_fusion (`fusion_mode`,
    'wavg' by default); the nested decoder's 12 k3 convs, the chain's
    conv_tlane_chain call sites, run conv_wide over their legs; conv_out
    (k1, 16 -> 1) runs conv_gray_exit. `down_mode` 'stride' or 'maxpool',
    `up_mode` 'bilinear' or 'nearest'. Autoencoder mode (`model(img1)`)
    decodes one batch's features."""

    enc_ch = (16, 32, 48, 64)
    dec_ch = (16, 64, 256, 1024)

    def __init__(self, down_mode="stride", up_mode="bilinear",
                 fusion_mode="wavg", generator=None):
        super().__init__()
        if down_mode not in ("stride", "maxpool"):
            raise ValueError(f"down_mode {down_mode!r} not in stride/maxpool")
        if up_mode not in ("bilinear", "nearest"):
            raise ValueError(f"up_mode {up_mode!r} not in bilinear/nearest")
        if fusion_mode not in ("sa", "ca", "sca", "wavg"):
            raise ValueError("only supported ['sa', 'ca', 'sca', 'wavg'] "
                             "mode")
        self.down_mode, self.fusion_mode = down_mode, fusion_mode
        g, e = generator, self.enc_ch
        self.CB1_0 = ConvLayer(1, e[0], generator=g)
        self.CB2_0 = ConvLayer(e[0], e[1], generator=g)
        self.CB3_0 = ConvLayer(e[1], e[2], generator=g)
        self.CB4_0 = ConvLayer(e[2], e[3], generator=g)
        if down_mode == "stride":
            for i in (1, 2, 3):
                setattr(self, f"down{i}", ConvLayer(e[i - 1], e[i - 1],
                                                    stride=2, generator=g))
        self.encode = NestEncoder(e, self.dec_ch, down_mode, g)
        self.decode = NestDecoder(self.dec_ch, up_mode, g)
        self.conv_out = ConvLayer(self.dec_ch[0], 1, ksize=1, generator=g)

    def forward(self, img1, img2=None):
        x1_0 = self.CB1_0.enter(img1, img2)
        d1_0 = down(self, 1, x1_0)
        x2_0 = self.CB2_0(d1_0)
        d2_0 = down(self, 2, x2_0)
        x3_0 = self.CB3_0(d2_0)
        d3_0 = down(self, 3, x3_0)
        x4_0 = self.CB4_0(d3_0)
        feats = self.encode((x1_0, (x2_0, d1_0), (x3_0, d2_0), (x4_0, d3_0)))
        if img2 is not None:
            n = img1.shape[0]
            feats = [attention_fusion(f[:n], f[n:], self.fusion_mode)
                     for f in feats]
        return self.conv_out(self.decode(feats))


class NestFuse(nn.Module):
    """4-scale ConvBlock encoder, per-scale attention fusion, U-Net++
    nested decoder of ConvBlocks (reference core/model.py NestFuse; JAX
    models/zoo.py:853-991).

    Serving follows the JAX package's H-major multi-leg path
    (`_hiw_forward`, zoo.py:940-984): the encoder runs once over the
    batch-concatenated pair: conv_in (1 -> 16, k1) through
    conv_gray_enter, then CB1_0-CB4_0 with a 2x2 max pool (or, with
    down_mode 'stride', the stride-2 convs down1-down3 on F.conv2d) between
    scales; each scale's halves are fused by `fusion` (attention_fusion,
    `fusion_mode` 'sca' by default; sa, ca, sca and wavg, the modes of the
    JAX fast route, zoo.py:906-909); the nested decoder's blocks read their
    concats as legs; conv_out (64 -> 1, k1) runs conv_gray_exit. Each
    ConvBlock's convs take the route `nest_block` fixes (ops/blocks.py):
    conv_wide where the output width is 8 mod 16, else conv_chain on one
    tensor and conv_multi on legs. `up_mode` 'nearest' (the default) or
    'bilinear'; `num_ch` the encoder's widths (64, 112, 160, 208).
    Autoencoder mode (`model(img1)`) decodes one batch's features."""

    num_ch = (64, 112, 160, 208)
    up_mode = "nearest"
    block = staticmethod(nest_block)

    def __init__(self, down_mode="maxpool", up_mode=None, fusion_mode="sca",
                 num_ch=None, generator=None):
        super().__init__()
        up_mode = up_mode or self.up_mode
        if down_mode not in ("stride", "maxpool"):
            raise ValueError(f"down_mode {down_mode!r} not in stride/maxpool")
        if up_mode not in ("bilinear", "nearest"):
            raise ValueError(f"up_mode {up_mode!r} not in bilinear/nearest")
        if fusion_mode not in ("sa", "ca", "sca", "wavg"):
            raise ValueError("only supported ['sa', 'ca', 'sca', 'wavg'] "
                             "mode")
        self.down_mode, self.fusion_mode = down_mode, fusion_mode
        g = generator
        c = self.num_ch = tuple(num_ch or self.num_ch)
        self.conv_in = ConvLayer(1, 16, ksize=1, generator=g)
        self.CB1_0 = self.block(16, c[0], g)
        self.CB2_0 = self.block(c[0], c[1], g)
        self.CB3_0 = self.block(c[1], c[2], g)
        self.CB4_0 = self.block(c[2], c[3], g)
        if down_mode == "stride":
            for i in (1, 2, 3):
                setattr(self, f"down{i}", ConvLayer(c[i - 1], c[i - 1],
                                                    stride=2, generator=g))
        self.decode = self.decoder(up_mode, g)
        self.conv_out = ConvLayer(c[0], 1, ksize=1, generator=g)

    def decoder(self, up_mode, generator):
        return NestDecoder(self.num_ch, up_mode, generator, self.block)

    def encoder(self, img1, img2=None):
        x1_0 = self.CB1_0(self.conv_in.enter(img1, img2))
        x2_0 = self.CB2_0(down(self, 1, x1_0))
        x3_0 = self.CB3_0(down(self, 2, x2_0))
        x4_0 = self.CB4_0(down(self, 3, x3_0))
        return x1_0, x2_0, x3_0, x4_0

    def fusion(self, feats, n):
        """Each scale's halves (the 2n-image encoder batch) fused."""
        return [attention_fusion(f[:n], f[n:], self.fusion_mode)
                for f in feats]

    def forward(self, img1, img2=None):
        feats = self.encoder(img1, img2)
        if img2 is not None:
            feats = self.fusion(feats, img1.shape[0])
        return self.conv_out(self.decode(feats))


class RFNNest(NestFuse):
    """NestFuse with a learned residual fusion network (`RFN`, ops/blocks.
    py) at each scale in place of the attention fusion (reference
    core/model.py RFN_Nest; JAX models/zoo.py:993-1021). Serving follows the
    JAX H-major route (`_hiw_fuse`, zoo.py:1017-1021): RFN{i} reads the
    2n-image encoder batch of scale i in place (its 2c-input convs over the
    two halves as legs). Autoencoder mode has no fusion, as NestFuse's."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(generator=generator, **kwargs)
        for i, c in enumerate(self.num_ch):
            setattr(self, f"RFN{i + 1}", RFN(c, generator))

    def fusion(self, feats, n):
        return [getattr(self, f"RFN{i + 1}")(f, n)
                for i, f in enumerate(feats)]


class MAFusion(NestFuse):
    """NestFuse's encoder at (64, 128, 256, 512), per-scale attention
    fusion, U-Net3+ full-scale decoder (`FSDecoder`, ops/blocks.py;
    reference core/model.py MAFusion; JAX models/zoo.py:1237-1257).

    Serving follows the JAX package's C-major chain route (zoo.py:910-935;
    MAFusion is in HIW_MULTI_BLOCKLIST, ops/pallas/hiw_kernel.py:72): every
    ConvBlock conv is a conv_tlane_chain call site and runs conv_wide
    (`wide_block`), over its legs in the decoder; conv_in and conv_out run
    conv_gray_enter and conv_gray_exit. `up_mode` 'bilinear' by default."""

    num_ch = (64, 128, 256, 512)
    up_mode = "bilinear"
    block = staticmethod(wide_block)

    def decoder(self, up_mode, generator):
        return FSDecoder(self.num_ch, self.block, up_mode, generator)


MODEL_ZOO = {"dbnet": DBNet, "deepfuse": DeepFuse, "densefuse": DenseFuse,
             "mafusion": MAFusion, "nestfuse": NestFuse, "res2fusion":
             Res2Fusion, "rfnnest": RFNNest, "unfusion": UNFusion,
             "vifnet": VIFNet}


def create_model(name, **kwargs):
    """Instantiate a ported zoo model by (case-insensitive) name."""
    key = name.lower()
    if key not in MODEL_ZOO:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {sorted(MODEL_ZOO)}); "
            f"the queue of models to port is in ROADMAP.md")
    return name_layers(MODEL_ZOO[key](**kwargs))
