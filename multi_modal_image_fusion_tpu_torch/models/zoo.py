"""Fusion model zoo of the port (counterpart of multi_modal_image_fusion_tpu
models/zoo.py). Ported: DeepFuse (the reference CLIs' default model),
DenseFuse, VIFNet, DBNet, UNFusion, Res2Fusion, NestFuse, RFNNest,
MAFusion, PFNetv1, PFNetv2, IFCNN, DIFNet, PMGI, SEDRFuse and MyFusion
with its whole design space (every encoder, decoder, fusion, norm and
activation of the JAX package's MyFusion).

Models take NHWC single-channel images:

    model(img1, img2)   -> fused image (B, H, W, 1)
    model(img1)         -> autoencoder reconstruction (two-stage training)
"""

import contextlib

import torch
from torch import nn

from ..ops.blocks import (RFN, ConvFormerBlock, DCBlock, Decoder,
                          DenseBlock, FSDecoder, LSDecoder, MixConvBlock,
                          MixFormerBlock, NestDecoder, NestEncoder,
                          Res2ConvBlock, Res2FormerBlock, ResBlock,
                          SepConvBlock, TransformerBlock, TransitionBlock,
                          down, nest_block, upsample, wide_block)
from ..ops.cuda.conv_pair import conv_pair_enter, conv_pair_exit
from ..ops.cuda.s2d_io import s2d_enter, s2d_exit
from ..ops.fusion import (attention_fusion, element_fusion, spatial_pooling,
                          weighted_fusion)
from ..ops import layers
from ..ops.layers import (ACTS, NORMS, ConvLayer, batch_stats_route,
                          fast_training, in_training_scope, int8_ctx)
from ..ops.quant import (calibrating, chain_hop_ok, chain_leg_ok,
                         hiw_int8_enabled, hiw_res_enabled, name_layers,
                         quant_off, quant_skipped)
from ..ops.s2d import (chain_pair_enabled, hiw_enabled, s2d_enabled,
                       s2d_io_enabled, s2d_io_ok, s2d_pack, s2d_unpack)

__all__ = ["DBNet", "DIFNet", "DeepFuse", "DenseFuse", "IFCNN", "MAFusion",
           "MODEL_ZOO", "MyFusion", "NestFuse", "PFNetv1", "PFNetv2", "PMGI",
           "RFNNest", "Res2Fusion", "SEDRFuse", "UNFusion", "VIFNet",
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
    the same way. The conv routes are ConvLayer's (ops/layers.py). forward
    is `encoder`, `fusion` and `decode_feats`, the parts that
    parallel/tiling.py runs apart."""

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

    def encoder(self, img1, img2=None):
        """The legs [x16, r1, r2] of img1, or of the batch-concatenated
        pair."""
        x16 = self.conv_in.enter(img1, img2)
        r1 = self.RB1(x16)
        r2 = self.RB2([(x16, 0), (r1, 0)])
        return [x16, r1, r2]

    def fusion(self, legs, n):
        """The 2n-image encoder legs fused: 'attn' one 112-channel tensor,
        'elem' the legs' means."""
        if self.fusion_method == "elem":
            return [element_fusion(x[:n], x[n:], "mean") for x in legs]
        feat = torch.cat(legs, dim=-1)
        return attention_fusion(feat[:n], feat[n:], "sca", self.spatial_mode,
                                self.channel_mode)

    def decode_feats(self, feat):
        """The decoder over one tensor, or over legs that dec0 reads in
        place."""
        dec0, *rest = self.decode
        t = dec0([(x, 0) for x in feat] if isinstance(feat, list) else feat)
        for layer in rest:
            t = layer(t)
        return t

    def forward(self, img1, img2=None):
        legs = self.encoder(img1, img2)
        return self.decode_feats(legs if img2 is None
                                 else self.fusion(legs, img1.shape[0]))


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
    decodes one batch's features. forward is `encoder`, `fusion` and
    `decode_feats`, the parts that parallel/tiling.py runs apart."""

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

    def encoder(self, img1, img2=None):
        """The four scales' features (x1_0, x2_1, x3_2, x4_3) of img1, or
        of the batch-concatenated pair."""
        x1_0 = self.CB1_0.enter(img1, img2)
        d1_0 = down(self, 1, x1_0)
        x2_0 = self.CB2_0(d1_0)
        d2_0 = down(self, 2, x2_0)
        x3_0 = self.CB3_0(d2_0)
        d3_0 = down(self, 3, x3_0)
        x4_0 = self.CB4_0(d3_0)
        return self.encode((x1_0, (x2_0, d1_0), (x3_0, d2_0), (x4_0, d3_0)))

    def fusion(self, feats, n):
        """Each scale's halves (the 2n-image encoder batch) fused."""
        return [attention_fusion(f[:n], f[n:], self.fusion_mode)
                for f in feats]

    def decode_feats(self, feats):
        """The nested decoder and conv_out over (fused) features."""
        return self.conv_out(self.decode(feats))

    def forward(self, img1, img2=None):
        feats = self.encoder(img1, img2)
        if img2 is not None:
            feats = self.fusion(feats, img1.shape[0])
        return self.decode_feats(feats)


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
    Autoencoder mode (`model(img1)`) decodes one batch's features. forward
    is `encoder`, `fusion` and `decode_feats`, the parts that
    parallel/tiling.py runs apart (RFNNest and MAFusion too)."""

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

    def decode_feats(self, feats):
        """The decoder and conv_out over (fused) features."""
        return self.conv_out(self.decode(feats))

    def forward(self, img1, img2=None):
        feats = self.encoder(img1, img2)
        if img2 is not None:
            feats = self.fusion(feats, img1.shape[0])
        return self.decode_feats(feats)


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


def _legs(*tensors):
    return [(t, 0) for t in tensors]


class PFNetv1(nn.Module):
    """Two unshared dense encoders (conv_in + 3-conv DenseBlock each),
    concat fusion, 5-conv k3 decoder from 128 channels (reference
    core/model.py:69-111; JAX models/zoo.py:144-197).

    Serving follows the JAX package's H-major path (zoo.py:156-178): each
    encoder runs on its own image (conv_gray_enter, then conv_multi over
    the dense growth) and yields four 16-channel legs; the 128-channel
    concat fusion is decode0 reading the eight legs (conv_multi), never
    built; decode1-decode3 run conv_chain, decode4 conv_gray_exit. The
    model takes two images only, as in the JAX package."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.encode1 = _dense_encoder(g)
        self.encode2 = _dense_encoder(g)
        self.decode = nn.ModuleList([
            ConvLayer(128, 128, generator=g),
            ConvLayer(128, 64, generator=g),
            ConvLayer(64, 32, generator=g),
            ConvLayer(32, 16, generator=g),
            ConvLayer(16, 1, act=None, generator=g),
        ])

    def forward(self, img1, img2=None):
        if img2 is None:
            raise ValueError("PFNetv1 has no autoencoder mode: its decoder "
                             "takes the concat of both encoders' features")
        legs = []
        for (conv_in, dense), img in ((self.encode1, img1),
                                      (self.encode2, img2)):
            legs += dense(conv_in.enter(img))
        dec0, *rest = self.decode
        t = dec0(_legs(*legs))
        for layer in rest:
            t = layer(t)
        return t


def _group_weights(w, groups):
    """Shared per-group OIHW weights (cg_out, cg_in, k, k) -> the
    block-diagonal (groups * cg_out, groups * cg_in, k, k): group g's output
    channels g * cg_out + o read its input channels g * cg_in + i (the JAX
    package's `hiw_group_weights`, ops/pallas/hiw_scale.py:79)."""
    cgo, cgi, k, _ = w.shape
    eye = torch.eye(groups, dtype=w.dtype, device=w.device)
    return (eye[:, None, :, None, None, None]
            * w[None, :, None, :, :, :]).reshape(groups * cgo, groups * cgi,
                                                 k, k)


class PFNetv2(nn.Module):
    """Shared dense encoder (64 channels), a learned per-channel fusion net
    (2 -> 2 -> 2 -> 1, k3, shared by the 64 channels) plus both features,
    4-conv k3 decoder (reference core/model.py:114-141; JAX models/zoo.py:
    200-314).

    Serving follows the JAX package's H-major path (`_hiw_forward`,
    zoo.py:272-314): conv_in (conv_gray_enter) and the dense block run once
    over the batch-concatenated pair, the growth a list of four legs. The
    fuse net runs as dense block-diagonal convs of 64 groups, their
    weights built once from the shared ones (`fuse_weights`): fuse0 is one
    conv_multi over the eight legs (f1's four at offset 0, f2's at n), its
    weight mapping input channel c of f1 and of f2 to outputs 2c and 2c + 1,
    so no interleaved copy of the features is built; fuse1 (128 -> 128)
    and fuse2 (128 -> 64, no activation) run conv_chain. The residual
    + (f1 + f2) is a torch add a leg, into fuse2's output (nine legs would
    pass conv_multi's eight). decode0-decode2 run conv_chain, decode3
    conv_gray_exit.

    On a training route and during calibration or int8 the fuse net is the
    JAX package's channels-into-batch fold (zoo.py:226-235) on F.conv2d.
    Autoencoder mode (`model(img1)`) has no fuse net: decode0 reads the
    legs (conv_multi)."""

    groups = 64

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.encode = _dense_encoder(g)
        self.fuse = nn.ModuleList([
            ConvLayer(2, 2, generator=g),
            ConvLayer(2, 2, generator=g),
            ConvLayer(2, 1, act=None, generator=g),
        ])
        self.decode = nn.ModuleList([
            ConvLayer(64, 64, generator=g),
            ConvLayer(64, 32, generator=g),
            ConvLayer(32, 16, generator=g),
            ConvLayer(16, 1, act=None, generator=g),
        ])
        self._fuse_cache = (None, None)

    def fuse_weights(self):
        """[(weight, bias)] of the block-diagonal fuse0, fuse1, fuse2 from
        the layers' folded (2, 2, 3, 3), (2, 2, 3, 3) and (1, 2, 3, 3)
        weights, built once a set of parameter values: fuse0 reads f1's 64
        channels, then f2's."""
        key = tuple((p.data_ptr(), p._version, p.dtype, p.device)
                    for p in (*self.fuse.parameters(), *self.fuse.buffers()))
        if self._fuse_cache[0] != key:
            gr = self.groups
            out = []
            for i, layer in enumerate(self.fuse):
                w, b = (p.detach() for p in layer.folded())
                if i == 0:
                    eye = torch.eye(gr, dtype=w.dtype, device=w.device)
                    wf = (eye[:, None, None, :, None, None]
                          * w[None, :, :, None, :, :]).reshape(
                              2 * gr, 2 * gr, *w.shape[2:])
                else:
                    wf = _group_weights(w, gr)
                out.append((wf, b.repeat(gr)))
            self._fuse_cache = (key, out)
        return self._fuse_cache[1]

    def fusion(self, legs, n):
        """The fused 64-channel feature of the encoder's legs (2n images)."""
        fuse0 = self.fuse[0]
        if fuse0._training_route(*legs) or fuse0._whole_input():
            return self._fold(torch.cat(legs, dim=-1), n)
        (w0, b0), (w1, b1), (w2, b2) = self.fuse_weights()
        acts = [layer.act for layer in self.fuse]
        # through the layers module's names, as ConvLayer's own routes
        z = layers.conv_multi(_legs(*legs) + [(t, n) for t in legs], w0, b0,
                              acts[0])
        z = layers.conv_chain(z, w1, b1, acts[1])
        z = layers.conv_chain(z, w2, b2, acts[2])
        c = 0
        for t in legs:
            z[..., c:c + t.shape[-1]] += t[:n] + t[n:]
            c += t.shape[-1]
        return z

    def _fold(self, f, n):
        """The channels-into-batch fold (JAX zoo.py:226-235): each channel's
        (f1, f2) pair an image of the shared 2 -> 2 -> 2 -> 1 net, on the
        training route's F.conv2d (a trainer's scope is kept; outside one,
        fast_training(False)); under int8 a layer that the gate admits runs
        conv_int8 on the folded batch, as the JAX package's fold runs its
        int8 route."""
        f1, f2 = f[:n], f[n:]
        b, h, w, c = f1.shape
        z = torch.stack([f1, f2], dim=-1).permute(0, 3, 1, 2, 4).reshape(
            b * c, h, w, 2).contiguous()     # a view at b == 1
        for layer in self.fuse:
            scope = (contextlib.nullcontext() if in_training_scope()
                     or layer._int8_route() is not None
                     else fast_training(False))
            with scope:
                z = layer(z)
        return (z.reshape(b, c, h, w).permute(0, 2, 3, 1) + f1
                + f2).contiguous()

    def forward(self, img1, img2=None):
        conv_in, dense = self.encode
        legs = dense(conv_in.enter(img1, img2))
        dec0, *rest = self.decode
        if img2 is None:
            t = dec0(_legs(*legs))
        else:
            t = dec0(self.fusion(legs, img1.shape[0]))
        for layer in rest:
            t = layer(t)
        return t


class IFCNN(nn.Module):
    """k7 conv and a conv + batch norm encoder, elementwise-max fusion,
    conv + batch norm and k1 decoder (reference core/model.py:514-528; JAX
    models/zoo.py:1265-1330).

    Serving follows the JAX package's H-major path (`_hiw_forward`,
    zoo.py:1312-1330): the batch norms fold into their convs (ConvLayer.
    folded); enc0 (1 -> 64, k7, no activation) runs the k7 conv_gray_enter
    over both images in one launch, enc1 and dec0 conv_chain, dec1 (64 ->
    1, k1) conv_gray_exit. `norm` None or "batch" (the JAX field). When its
    batch norms take batch statistics (`batch_stats_route`: train mode on
    a training route) the encoder runs once per modality, as in the JAX
    package, else once over the batch-concatenated pair. Autoencoder mode
    (`model(img1)`) decodes one image batch."""

    def __init__(self, norm="batch", generator=None):
        super().__init__()
        g = generator
        self.encode = nn.ModuleList([
            ConvLayer(1, 64, ksize=7, act=None, generator=g),
            ConvLayer(64, 64, norm=norm, generator=g),
        ])
        self.decode = nn.ModuleList([
            ConvLayer(64, 64, norm=norm, generator=g),
            ConvLayer(64, 1, ksize=1, act=None, generator=g),
        ])

    def forward(self, img1, img2=None):
        enc0, enc1 = self.encode
        if img2 is not None and batch_stats_route(self, img1, img2):
            t = torch.cat([enc1(enc0.enter(img)) for img in (img1, img2)])
        else:
            t = enc1(enc0.enter(img1, img2))
        if img2 is not None:
            n = img1.shape[0]
            t = element_fusion(t[:n], t[n:], "max")
        for layer in self.decode:
            t = layer(t)
        return t


class DIFNet(nn.Module):
    """conv_in and two ResBlocks (batch norm on their first conv), a learned
    concat fusion conv (32 -> 16, no activation), three ResBlocks and a k3
    exit (reference core/model.py:531-552; JAX models/zoo.py:1333-1414).

    Serving follows the JAX package's H-major path (`_hiw_forward`,
    zoo.py:1389-1414): the encoder runs once over the batch-concatenated
    pair (enc0 conv_gray_enter); each ResBlock runs its first conv on
    conv_chain and its second with the residual as an identity leg on
    conv_multi; `fuse` reads the encoder batch's two halves as the legs
    [(t, 0), (t, n)] of one conv_multi, no concat built; dec3 runs
    conv_gray_exit. When its batch norms take batch statistics
    (`batch_stats_route`) the encoder runs once per modality, as in the
    JAX package. Autoencoder mode (`model(img1)`) has no fusion."""

    def __init__(self, norm="batch", generator=None):
        super().__init__()
        g = generator
        self.encode = nn.ModuleList([
            ConvLayer(1, 16, generator=g),
            ResBlock(16, norm1=norm, generator=g),
            ResBlock(16, norm1=norm, generator=g),
        ])
        self.fuse = ConvLayer(32, 16, act=None, generator=g)
        self.decode = nn.ModuleList([
            ResBlock(16, norm1=norm, generator=g),
            ResBlock(16, norm1=norm, generator=g),
            ResBlock(16, norm1=norm, generator=g),
            ConvLayer(16, 1, act=None, generator=g),
        ])

    def encoder(self, img1, img2=None):
        enc0, *blocks = self.encode
        t = enc0.enter(img1, img2)
        for block in blocks:
            t = block(t)
        return t

    def forward(self, img1, img2=None):
        if img2 is not None and batch_stats_route(self, img1, img2):
            t = torch.cat([self.encoder(img1), self.encoder(img2)])
        else:
            t = self.encoder(img1, img2)
        if img2 is not None:
            t = self.fuse([(t, 0), (t, img1.shape[0])])
        for layer in self.decode:
            t = layer(t)
        return t


class PMGI(nn.Module):
    """Gradient and intensity paths of four convs (batch norm, lrelu 0.2),
    cross-path k1 transfer convs, a k1 tanh head, out / 2 + 0.5 (reference
    core/model.py:555-624; JAX models/zoo.py:1417-1551).

    Serving follows the JAX package's H-major path (`_hiw_forward`,
    zoo.py:1510-1551): the entry convs over concat(i, i, j) run the two-leg
    conv_gray_enter over (img1, img2) and (img2, img1), the repeated
    image's weights summed (ConvLayer.enter_stacked); gradient1 and
    intensity1 run conv_chain; every cross-path concat is a list of legs on
    conv_multi; `decode` is conv_gray_exit over the eight legs, tanh in its
    epilogue; then out / 2 + 0.5 in torch. Reference quirks kept:
    `f1_conv2` is transfer2[1] of f1, and transfer1[1] holds parameters but
    its output is never used (model.py:591); when the batch norms take
    batch statistics, and in calibration, it runs all the same, as the JAX
    package's eager route runs it, so its running statistics move and its
    amax is recorded as there. `norm` and
    `act` are the JAX fields. The model takes two images only, as in the
    JAX package."""

    def __init__(self, norm="batch", act="lrelu", generator=None):
        super().__init__()
        kw = dict(norm=norm, act=act, generator=generator)
        self.gradient = nn.ModuleList([
            ConvLayer(3, 16, ksize=5, **kw), ConvLayer(16, 16, **kw),
            ConvLayer(48, 16, **kw), ConvLayer(64, 16, **kw)])
        self.intensity = nn.ModuleList([
            ConvLayer(3, 16, ksize=5, **kw), ConvLayer(16, 16, **kw),
            ConvLayer(48, 16, **kw), ConvLayer(64, 16, **kw)])
        self.transfer1 = nn.ModuleList([ConvLayer(32, 16, ksize=1, **kw),
                                        ConvLayer(32, 16, ksize=1, **kw)])
        self.transfer2 = nn.ModuleList([ConvLayer(32, 16, ksize=1, **kw),
                                        ConvLayer(32, 16, ksize=1, **kw)])
        self.decode = ConvLayer(128, 1, ksize=1, act="tanh",
                                generator=generator)

    def forward(self, img1, img2=None):
        if img2 is None:
            raise ValueError("PMGI has no autoencoder mode: both paths take "
                             "both images")
        gr, it = self.gradient, self.intensity
        f0_1 = gr[0].enter_stacked([img1, img1, img2])
        f0_2 = it[0].enter_stacked([img2, img2, img1])
        f1_1, f1_2 = gr[1](f0_1), it[1](f0_2)
        f1_conv1 = self.transfer1[0](_legs(f1_1, f1_2))
        f1_conv2 = self.transfer2[1](_legs(f1_1, f1_2))   # quirk
        if batch_stats_route(self, img1, img2) or calibrating():
            # the JAX package's eager route runs the dead transfer1[1] (to
            # create its parameters), which moves its running statistics
            # in training and records its input in calibration; its output
            # is unused
            self.transfer1[1](_legs(f1_1, f1_2))
        f2_1 = gr[2](_legs(f0_1, f1_1, f1_conv1))
        f2_2 = it[2](_legs(f0_2, f1_2, f1_conv2))
        f2_conv1 = self.transfer2[0](_legs(f2_1, f2_2))
        f2_conv2 = self.transfer2[1](_legs(f2_1, f2_2))
        f3_1 = gr[3](_legs(f0_1, f1_1, f2_1, f2_conv1))
        f3_2 = it[3](_legs(f0_2, f1_2, f2_2, f2_conv2))
        out = self.decode(_legs(f0_1, f0_2, f1_1, f1_2, f2_1, f2_2, f3_1,
                                f3_2))
        return out / 2.0 + 0.5


class SEDRFuse(nn.Module):
    """Symmetric encoder-decoder with a residual block, group norms, max
    fusion of the shallow features, softmax-attention fusion of the deep
    one and cross encode/decode skips (reference core/model.py:247-316;
    JAX models/zoo.py:801-850).

        f_conv1 = enc0(img)      k3, 1 -> 64, norm, relu
        f_conv2 = enc1(f_conv1)  k3 stride 2, 64 -> 128, norm, relu
        f_conv3 = enc2(f_conv2)  k3 stride 2, 128 -> 256, norm, relu
        f_res   = res(f_conv3)   ResBlock(256), norms on both convs
        out = dec2(relu(f_conv1 + dec1(relu(f_conv2 + dec0(f_res)))))

    dec0 and dec1 are k3 stride-2 transpose convs (256 -> 128 -> 64, norm,
    relu), dec2 a k3 64 -> 1 relu conv. A fused pair takes the element max
    of the two f_conv1 and of the two f_conv2 and `fusion` of the two
    f_res; autoencoder mode (`model(img1)`) decodes one image's features.
    The encoder runs once over the batch-concatenated pair (the JAX
    package runs it twice, zoo.py:845-846): a group norm's statistics are
    per image, so this is the same function.

    Routes (ConvLayer): enc0 conv_gray_enter, the ResBlock's two convs
    conv_chain, dec2 conv_gray_exit, each kernel without activation where a
    group norm follows it; the stride-2 and transpose convs F.conv2d and
    F.conv_transpose2d; the norms, the fusion and the skips torch ops. H
    and W must be multiples of 4 (two stride-2 levels and back)."""

    def __init__(self, norm="group", generator=None):
        super().__init__()
        g = generator
        self.encode = nn.ModuleList([
            ConvLayer(1, 64, norm=norm, generator=g),
            ConvLayer(64, 128, stride=2, norm=norm, generator=g),
            ConvLayer(128, 256, stride=2, norm=norm, generator=g),
            ResBlock(256, norm1=norm, norm2=norm, generator=g),
        ])
        self.decode = nn.ModuleList([
            ConvLayer(256, 128, stride=2, norm=norm, transpose=True,
                      generator=g),
            ConvLayer(128, 64, stride=2, norm=norm, transpose=True,
                      generator=g),
            ConvLayer(64, 1, generator=g),
        ])

    @staticmethod
    def fusion(feat1, feat2):
        """The softmax-attention fusion of the deep features (JAX zoo.py:
        827-834): a = |f|, each pixel's channel softmax of a times a, summed
        over channels, weights the two features (weighted_fusion). In f32
        (float64 for float64 features) whatever the features' dtype, the
        256-way softmax among it; the fused feature cast back."""
        ct = torch.promote_types(feat1.dtype, torch.float32)
        f1, f2 = feat1.to(ct), feat2.to(ct)
        s1, s2 = (spatial_pooling(torch.softmax(t.abs(), dim=-1) * t.abs(),
                                  "sum") for t in (f1, f2))
        return weighted_fusion(f1, f2, s1, s2).to(feat1.dtype)

    def forward(self, img1, img2=None):
        h, w = img1.shape[1:3]
        if h % 4 or w % 4:
            raise ValueError(f"SEDRFuse needs H and W multiples of 4, got "
                             f"{h}x{w}")
        enc0, enc1, enc2, res = self.encode
        dec0, dec1, dec2 = self.decode
        f_conv1 = enc0.enter(img1, img2)
        f_conv2 = enc1(f_conv1)
        f_res = res(enc2(f_conv2))
        if img2 is not None:
            n = img1.shape[0]
            f_conv1 = element_fusion(f_conv1[:n], f_conv1[n:], "max")
            f_conv2 = element_fusion(f_conv2[:n], f_conv2[n:], "max")
            f_res = self.fusion(f_res[:n], f_res[n:])
        t = torch.relu(f_conv2 + dec0(f_res))
        t = torch.relu(f_conv1 + dec1(t))
        return dec2(t)


# MyFusion's encoder blocks (JAX models/zoo.py:1558-1566 _ENCODERS), each
# built as block(ch, ch, generator) or block(ch, generator)
_ENCODERS = {"sep": SepConvBlock, "mix": MixConvBlock, "res2": Res2ConvBlock,
             "conv_former": ConvFormerBlock, "mix_former": MixFormerBlock,
             "res2_former": Res2FormerBlock, "transformer": TransformerBlock}
_FUSION_MODES = {"elem": ("sum", "mean", "max"),
                 "attn": ("sa", "ca", "sca", "wavg"),
                 "concat": None, "rfn": None}
_DECODERS = {"plain": Decoder, "ls": LSDecoder, "nest": NestDecoder,
             "fs": FSDecoder}


def _encoder_block(kind, ch, generator):
    if kind in ("sep", "res2"):
        return _ENCODERS[kind](ch, ch, generator=generator)
    return _ENCODERS[kind](ch, generator=generator)


class MyFusion(nn.Module):
    """The configurable 4-scale meta-model (reference core/model.py:630-842;
    JAX models/zoo.py:1576-1759): a per-branch encoder of conv_in (k1, 1 ->
    8) and four levels of TransitionBlock + encoder block at `num_ch`, the
    two branches' features fused per scale, a decoder of DCBlocks, conv_out
    (k1, num_ch[0] -> 1).

    - `encoder`: 'sep' (SepConvBlock), 'mix' (MixConvBlock), 'res2'
      (Res2ConvBlock), 'conv_former', 'mix_former', 'res2_former' or
      'transformer' (the MetaFormer blocks: batch norms, relu6, and the
      Sep, Mix, Res2 or Attention mixer), or a list of four, one a level.
    - `share_weight_levels` (4, 3, 2, 1 or 0): the levels from 4 -
      share_weight_levels on share the first branch's modules and run both
      images as one 2n batch; the levels below it run each image through
      its branch's own modules (conv_in_2, down{i}_2, EB{i}_2), then the
      first shared level's input is the two branches' concat. When its
      batch norms take batch statistics (`batch_stats_route`: train mode
      on a training route) every level runs per branch, the shared ones on
      the first branch's modules, as the JAX package's `encoder_fn` runs
      them, so each modality's norms see their own statistics.
    - `fusion_method` 'elem' (`fusion_mode` sum, mean, max), 'attn' (sa,
      ca, sca, wavg: ops/fusion.attention_fusion), 'concat' (fuse1-4, k3
      2c -> c without activation, over the legs of the two features) or
      'rfn' (`RFN` a scale).
    - `decoder` 'plain', 'ls', 'nest' or 'fs', each of DCBlocks (pw1 over
      the legs of its concat, conv_wide where the hidden width is 8 mod 16).
    - `down_mode` 'stride' (a depthwise k2 stride-2 VALID conv, cuDNN's
      grouped conv as the JAX package runs XLA's) or 'maxpool'; level 1's
      TransitionBlock is always a k1 stride-1 depthwise conv.
    - `up_mode` 'bilinear' (align_corners=True) or 'nearest'.
    - `act` (relu6 by default; relu, lrelu, tanh and None fused in the
      kernels, hswish, silu and gelu torch ops after them), `norm` (None,
      'batch' folded into the serving convs, 'group', 'layer') and
      `use_bias` apply to conv_in, the TransitionBlocks and conv_out; the
      encoder and decoder blocks keep their own (relu6, no bias; the
      Formers' standalone batch norms), as in the reference. With 'layer',
      conv_out's one-channel layer norm makes the fused image 0, in the
      reference and the JAX package alike.

    Serving routes: conv_in on conv_gray_enter (one launch over the pair
    when conv_in is shared, else one a branch; its 8-channel k1 pass),
    conv_out on conv_gray_exit; every other conv as its block routes it
    (conv_chain, conv_multi, conv_wide, conv_dw: MixConvBlock's k1-k7
    windows); the Attention's pools on cuDNN's grouped conv, its attention
    on torch's scaled_dot_product_attention (flash or memory-efficient).
    MyFusion is in the JAX package's HIW_MULTI_BLOCKLIST, so its TPU
    default is its eager route; every conv of the port's serving path
    takes a hand-written kernel all the same (the JAX H-major route
    `_hiw_forward`, zoo.py:1761-1822, is the same function). There is no
    autoencoder mode (the model needs two images)."""

    def __init__(self, encoder="sep", decoder="nest", use_bias=False,
                 norm=None, act="relu6", fusion_method="attn",
                 fusion_mode="sca", down_mode="stride", up_mode="bilinear",
                 share_weight_levels=4, num_ch=(16, 32, 64, 128),
                 generator=None):
        super().__init__()
        enc = [encoder] * 4 if isinstance(encoder, str) else list(encoder)
        if len(enc) != 4:
            raise ValueError(f"encoder: one kind or four, got {encoder!r}")
        for kind in enc:
            if kind not in _ENCODERS:
                raise ValueError(f"unknown MyFusion encoder {kind!r}; one "
                                 f"of {sorted(_ENCODERS)}")
        if norm not in NORMS:
            raise ValueError(f"norm {norm!r} not in {NORMS}")
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}")
        if fusion_method not in _FUSION_MODES:
            raise ValueError("only supported ['elem', 'attn', 'concat', "
                             "'rfn'] method")
        modes = _FUSION_MODES[fusion_method]
        if modes is not None and fusion_mode not in modes:
            raise ValueError(f"fusion_mode {fusion_mode!r} not in {modes}")
        if decoder not in _DECODERS:
            raise ValueError(f"decoder {decoder!r} not in {sorted(_DECODERS)}")
        if up_mode not in ("bilinear", "nearest"):
            raise ValueError(f"up_mode {up_mode!r} not in bilinear/nearest")
        if share_weight_levels not in range(5):
            raise ValueError(f"share_weight_levels {share_weight_levels!r} "
                             f"not in 0-4")
        g, c = generator, tuple(num_ch)
        self.num_ch, self.fusion_method = c, fusion_method
        self.fusion_mode = fusion_mode
        self.share_weight_levels = share_weight_levels
        # what the weight carry and the flax paths need (utils/jax_convert)
        self.layout_cfg = dict(encoder=enc, decoder=decoder,
                               fusion_method=fusion_method,
                               share_weight_levels=share_weight_levels,
                               norm=norm)
        kw = dict(act=act, norm=norm, use_bias=use_bias, generator=g)
        for br in (1, 2) if share_weight_levels < 4 else (1,):
            setattr(self, f"conv_in_{br}", ConvLayer(1, 8, 1, **kw))
        for lv in range(4):
            for br in (1, 2) if lv < 4 - share_weight_levels else (1,):
                setattr(self, f"down{lv + 1}_{br}", TransitionBlock(
                    c[lv - 1] if lv else 8, c[lv], 2 if lv else 1,
                    down_mode if lv else "stride", **kw))
                setattr(self, f"EB{lv + 1}_{br}",
                        _encoder_block(enc[lv], c[lv], g))
        for i, ch in enumerate(c):
            if fusion_method == "concat":
                setattr(self, f"fuse{i + 1}",
                        ConvLayer(2 * ch, ch, 3, act=None, generator=g))
            elif fusion_method == "rfn":
                setattr(self, f"RFN{i + 1}", RFN(ch, g))
        self.decode = _DECODERS[decoder](c, block=DCBlock, up_mode=up_mode,
                                         generator=g)
        self.conv_out = ConvLayer(c[0], 1, 1, **kw)

    def _level(self, lv, br, x):
        down = getattr(self, f"down{lv + 1}_{br}")
        return getattr(self, f"EB{lv + 1}_{br}")(down(x))

    def encoder(self, img1, img2):
        """The four levels' features as pairs (branch 1, branch 2) of n
        images each: views of one 2n batch at shared levels."""
        n, split = img1.shape[0], 4 - self.share_weight_levels
        apart = batch_stats_route(self, img1, img2)
        if split or apart:
            conv_in_2 = self.conv_in_2 if split else self.conv_in_1
            t = (self.conv_in_1.enter(img1), conv_in_2.enter(img2))
        else:
            t = self.conv_in_1.enter(img1, img2)
        feats = []
        for lv in range(4):
            if lv < split or apart:
                t = tuple(self._level(lv, br if lv < split else 1, x)
                          for br, x in zip((1, 2), t))
                feats.append(t)
            else:
                if isinstance(t, tuple):
                    t = torch.cat(t)
                t = self._level(lv, 1, t)
                feats.append((t[:n], t[n:]))
        return feats

    def fusion(self, feats):
        m = self.fusion_method
        out = []
        for i, (a, b) in enumerate(feats):
            if m == "elem":
                out.append(element_fusion(a, b, self.fusion_mode))
            elif m == "attn":
                out.append(attention_fusion(a, b, self.fusion_mode))
            elif m == "concat":
                out.append(getattr(self, f"fuse{i + 1}")(_legs(a, b)))
            else:
                out.append(getattr(self, f"RFN{i + 1}").pair(a, b))
        return out

    def forward(self, img1, img2):
        return self.conv_out(self.decode(self.fusion(
            self.encoder(img1, img2))))


MODEL_ZOO = {"dbnet": DBNet, "deepfuse": DeepFuse, "densefuse": DenseFuse,
             "difnet": DIFNet, "ifcnn": IFCNN, "mafusion": MAFusion,
             "myfusion": MyFusion, "nestfuse": NestFuse, "pfnetv1": PFNetv1,
             "pfnetv2": PFNetv2, "pmgi": PMGI, "res2fusion": Res2Fusion,
             "rfnnest": RFNNest, "sedrfuse": SEDRFuse, "unfusion": UNFusion,
             "vifnet": VIFNet}


def create_model(name, **kwargs):
    """Instantiate a ported zoo model by (case-insensitive) name, in eval
    mode (the JAX package's `train=False` default): a caller that trains
    sets train mode, as the Trainer does around its steps."""
    key = name.lower()
    if key not in MODEL_ZOO:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(MODEL_ZOO)}")
    return name_layers(MODEL_ZOO[key](**kwargs)).eval()
