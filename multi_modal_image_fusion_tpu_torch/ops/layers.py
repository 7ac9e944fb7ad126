"""Conv layer of the port (counterpart of multi_modal_image_fusion_tpu
ops/layers.py:339-360 ConvLayer, 195-215 activations, 237 pad2d, 842-898
interpolate, and the fast-training scope and routes, :34-56 and :695-755).

The port carries the part the ported models use: reflect-SAME k x k convs,
dense or depthwise (groups == in_ch == out_ch), stride 1 or (dense) 2, the
VALID depthwise conv with ksize == stride (MyFusion's TransitionBlock), the
k3 stride-2 transpose conv (zero padding 1, output padding 1: exactly 2x,
SEDRFuse's decoder), with or without bias, an optional batch or group norm
after the conv, and one of the kernel-fusable activations (relu, relu6,
lrelu 0.2, tanh, none). Tensors are NHWC at the boundary. Parameters are
named as in the reference state dict (`layers.0.weight` OIHW, IOHW for a
transpose conv, `layers.0.bias`; no bias key when use_bias=False; the
norm's `layers.1.weight`, `bias` and, for a batch norm, `running_mean`,
`running_var` and `num_batches_tracked`), so reference `.pth` files load
directly.

A batch norm (`norm="batch"`, the JAX package's `make_norm('batch')`,
ops/layers.py:284: eps 1e-5, flax momentum 0.9 = torch momentum 0.1) is
folded into the conv on every serving route, as the JAX chain routes fold
it (`_BNParams`, ops/layers.py:320, :417-423): `folded()` is the one
accessor of the weight and bias that every kernel and plain version
convolves with. Its training route (batch statistics) and its int8 route
are not ported (ROADMAP.md queue 1 item 5) and raise NotImplementedError.

A group norm (`norm="group"`, the JAX package's `make_norm('group')`,
ops/layers.py:299: torch GroupNorm(C, C), eps 1e-5, an instance norm with
statistics per image and channel) cannot fold: every route runs the conv
and its bias (a kernel with no activation), then `group_norm` (torch ops,
statistics in f32, in batch chunks), then the activation, as the JAX
package runs the norm on XLA after its conv. It has no running statistics,
so its training route computes the serving route's function. Its int8
route is not ported and raises NotImplementedError.

A layer takes one tensor, or a list of legs `[(tensor, b_off), ...]` whose
channels concatenate to its input (the JAX package's multi-leg convs,
models/zoo.py:103 `_hiw_mconv`): dense growth and concat fusion without
building the concat.

Routes of a conv:

- a stride-2 layer: reflect pad (NHWC), then F.conv2d(stride=2) on every
  route, as the JAX package runs it on XLA's conv (ops/layers.py:747-755);
  the VALID depthwise k2 stride-2 layer unpadded, F.conv2d(groups=C), as
  the JAX package runs it on XLA's grouped conv (ops/blocks.py:575-583); a
  transpose layer F.conv_transpose2d on every route (the JAX package's
  lhs-dilated XLA conv, ops/layers.py:769-783); both in batch chunks;
- serving (no `fast_training` scope and no gradient needed): the forward-only
  kernels of ops/cuda/ on CUDA tensors, their plain versions on CPU tensors.
  A `wide` layer (a call site of the JAX package's C-major chain conv
  conv_tlane_chain: UNFusion's nested decoder and encoder k1 convs, DBNet's
  decoder) runs `conv_wide` on one tensor or a list of legs. `packed`
  (the JAX package's `chain_s2d=2`) runs a layer on an f = 2 space-to-depth
  packed tensor: the weight and bias packed by ops/s2d.py, conv_wide's s2d
  mode. `pair_args` hands a layer's (weight, bias, k, act) to a model that
  fuses two layers in one kernel (ops/cuda/conv_pair.py; the JAX package's
  `chain_defer_in_ch`). Otherwise a
  list of legs runs `conv_multi`; on one tensor the c_in=1 layer runs
  `conv_gray_enter`, the c_out=1 layer `conv_gray_exit`, every other layer
  `conv_chain`; a depthwise layer runs `conv_dw`, which reads a channel
  window of a wider tensor in place (`depthwise`);
- training (inside a `fast_training` scope, which the trainer opens around
  its steps, or whenever a gradient is needed): reflect pad, then
  - with `fast_training(True)`, for the layers the JAX package's gate
    admits to its kernel (dense k3, k5 and k7, `_valid_eligible`):
    `conv_valid_fast` (kernel forward and dx, bias and activation as torch
    ops) when a gradient is needed, else `conv_valid` with bias and
    activation fused (the valid step); a shape the kernel does not take
    raises, there is no quiet F.conv2d;
  - otherwise F.conv2d (groups=C for a depthwise layer), the counterpart
    of the JAX package's XLA conv: every conv outside fast training, and
    depthwise and k1 layers inside it, as the JAX package routes them.
  On CPU tensors the kernels' plain versions run in their place. A list of
  legs is concatenated first (`concat_legs`), a depthwise window sliced,
  then takes the same route;
- int8 (inside ops/quant.quantized_inference, outside a `fast_training`
  scope): a stride-1 dense layer that the skip set does not name runs
  `conv_int8` (the JAX package's `ops/layers.py:624-691`): its effective
  input (a list of legs concatenated, a fuse_n sum taken in the input's
  dtype) is quantized on the fold of its calibrated amax, or of the
  dynamic per-channel max of that input when the layer was not
  calibrated. A calibrated layer hands conv_int8 its legs and fuse_n,
  which the kernel reads in place (the same function); the dynamic max
  needs the whole input, so an uncalibrated layer builds it first.
  Depthwise and stride-2 layers keep their float routes. The route is
  forward-only: it raises when a gradient is needed.

During ops/quant.calibrate every layer records the per-channel max |x| of
its effective input under its flax path (`qpath`, set by
ops/quant.name_layers).
"""

import contextlib
import contextvars
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from .cuda.conv_chain import (ACT_CODES, apply_act, batch_step, conv_chain,
                              conv_gray_enter, conv_gray_exit)
from .cuda.conv_dw import conv_dw
from .cuda.conv_int8 import Int8Weights, conv_int8, conv_int8_chain
from .cuda.conv_multi import (concat_legs, conv_multi, identity_weights,
                              legs_n_out)
from .cuda.conv_valid import conv_valid
from .cuda.conv_vjp import conv_valid_fast
from .cuda.conv_wide import conv_wide
from .quant import (calibrating, choose_fold, fold_weights, hiw_fold_scale,
                    quant_ctx, quant_skipped, quantize_weights, record)
from .s2d import s2d_pack_bias, s2d_pack_weights

__all__ = ["ACT_CODES", "BN_EPS", "ConvLayer", "NORMS", "apply_act",
           "fast_training", "group_norm", "in_training_scope", "init_conv_",
           "int8_ctx", "interpolate"]

INT32_ELEMS = 2 ** 31 - 1   # largest output of torch's NHWC bilinear kernel
NORMS = (None, "batch", "group")    # the norms ConvLayer ports
BN_EPS = 1e-5
GN_CHUNK_ELEMS = 2 ** 28    # elements a batch chunk of group_norm (1 GB f32)
_NORM_QUEUE = "ROADMAP.md queue 1 item 5"

# None: no trainer scope (serving); False / True: the trainer's steps, on
# F.conv2d / on the conv_valid kernels
_FAST_TRAINING = contextvars.ContextVar("mmif_fast_training", default=None)


@contextlib.contextmanager
def fast_training(enable=True):
    """Scope of a train or valid step: every conv takes a training route,
    through the conv_valid kernels when `enable` (the dense k3, k5 and k7
    layers; the others on F.conv2d), else through F.conv2d."""
    token = _FAST_TRAINING.set(bool(enable))
    try:
        yield
    finally:
        _FAST_TRAINING.reset(token)


def in_training_scope():
    """True inside a `fast_training` scope (a trainer's step)."""
    return _FAST_TRAINING.get() is not None


def int8_ctx():
    """The active quantized_inference, unless a trainer scope is open (the
    JAX package's int8 route is for train=False only)."""
    return quant_ctx() if _FAST_TRAINING.get() is None else None


def concat_sum(legs, fuse_n, n_out):
    """The effective input of a layer over legs: their channel concat at
    their batch offsets, with fuse_n each leg's sum with its sibling taken
    in its dtype. Written leg by leg into one tensor (copies and adds split
    past 2^31 elements, so no batch chunks are needed)."""
    t0 = legs[0][0]
    out = t0.new_empty((n_out, *t0.shape[1:3],
                        sum(t.shape[-1] for t, _ in legs)))
    ofs = 0
    for t, off in legs:
        dst = out[..., ofs:ofs + t.shape[-1]]
        if fuse_n:
            torch.add(t[off:off + n_out], t[off + fuse_n:off + fuse_n + n_out],
                      out=dst)
        else:
            dst.copy_(t[off:off + n_out])
        ofs += t.shape[-1]
    return out


def group_norm(x, weight, bias, act=None, eps=BN_EPS):
    """GroupNorm(C, C) then `act` on an NHWC tensor (the JAX package's
    `make_norm('group')`, flax GroupNorm with one channel a group): in f32
    (float64 for a float64 x), the mean and biased variance of each image's
    channel over H and W (`var_mean`), then (x - mean) * weight / sqrt(var
    + eps) + bias and the activation, the cast back to x's dtype. Centred
    before the scale, the backward's sums stay well conditioned where a
    channel's mean is large against its spread (x * a + (bias - mean * a)
    lost 10x more of SEDRFuse's f32 gradients against float64). In batch
    chunks of GN_CHUNK_ELEMS elements (exact: the statistics are per
    image), which bounds the f32 temporaries of a full-resolution batch."""
    b = x.shape[0]
    step = max(1, GN_CHUNK_ELEMS // max(1, x[0].numel()))
    ct = torch.promote_types(x.dtype, torch.float32)
    wf, bf = weight.to(ct), bias.to(ct)
    out = None if b <= step else x.new_empty(x.shape)
    for i in range(0, b, step):
        xf = x[i:i + step].to(ct)
        var, mean = torch.var_mean(xf, dim=(1, 2), correction=0,
                                   keepdim=True)
        y = apply_act(torch.addcmul(bf, xf - mean,
                                    wf * torch.rsqrt(var + eps)),
                      act).to(x.dtype)
        if out is None:
            return y
        out[i:i + step] = y
    return out


def reflect_pad_nhwc(x, p):
    """Reflect padding of H and W by p, written NHWC: the values of
    F.pad(mode="reflect") on the NCHW view, without its copy of the
    tensor into NCHW and back (a stride-2 conv's input of 32 images of 64
    channels at 1224x1024 took 75.8 ms that way on an H100)."""
    b, h, w, c = x.shape
    xp = x.new_empty((b, h + 2 * p, w + 2 * p, c))
    xp[:, p:p + h, p:p + w] = x
    xp[:, :p, p:p + w] = x[:, 1:p + 1].flip(1)
    xp[:, p + h:, p:p + w] = x[:, h - 1 - p:h - 1].flip(1)
    xp[:, :, :p] = xp[:, :, p + 1:2 * p + 1].flip(2)
    xp[:, :, p + w:] = xp[:, :, w - 1:w - 1 + p].flip(2)
    return xp


_KAIMING_FAMILY = ("relu", "relu6")


def init_conv_(weight, bias, act, generator=None):
    """Activation-keyed init (reference core/block.py:101-111): Kaiming
    normal for relu/relu6 (gain^2 2) and lrelu 0.2 (gain^2 2/1.04), Xavier
    normal with gain 5/3 for tanh, torch's Conv2d default U(+-1/sqrt(fan_in))
    otherwise; bias zeros."""
    out_ch, in_ch, kh, kw = weight.shape
    fan_in, fan_out = in_ch * kh * kw, out_ch * kh * kw
    with torch.no_grad():
        if act in _KAIMING_FAMILY or act == "lrelu":
            gain2 = 2.0 if act != "lrelu" else 2.0 / (1.0 + 0.2 ** 2)
            std = math.sqrt(gain2 / fan_in)
            weight.copy_(torch.randn(weight.shape, generator=generator) * std)
        elif act == "tanh":
            std = (5.0 / 3.0) * math.sqrt(2.0 / (fan_in + fan_out))
            weight.copy_(torch.randn(weight.shape, generator=generator) * std)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            weight.copy_((torch.rand(weight.shape, generator=generator) * 2.0
                          - 1.0) * bound)
        if bias is not None:
            bias.zero_()


class _Conv(nn.Module):
    """Parameter holder of one conv: weight (O, I / groups, K, K), or (I, O,
    K, K) for a transpose conv (torch's ConvTranspose2d layout), bias (O,)
    or None."""

    def __init__(self, in_ch, out_ch, ksize, groups=1, use_bias=True,
                 transpose=False):
        super().__init__()
        shape = ((in_ch, out_ch) if transpose
                 else (out_ch, in_ch // groups))
        self.weight = nn.Parameter(torch.empty(*shape, ksize, ksize))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None


class ConvLayer(nn.Module):
    """Reflect-SAME conv (+ bias) (+ batch or group norm) + activation,
    NHWC. groups is 1 or, for a depthwise layer, in_ch == out_ch; stride 1,
    or 2 for a dense layer; `transpose` the k3 stride-2 transpose conv;
    `wide` sends the serving route to conv_wide; `norm` None, "batch" or
    "group" (module docstring). `padding` None is reflect-SAME; 0 is VALID,
    ported for TransitionBlock's strided depthwise down only (ksize ==
    stride, groups == in_ch: a k2 stride-2 window per output pixel, odd
    sizes floored; at k1 stride 1 it is the SAME conv)."""

    def __init__(self, in_ch, out_ch, ksize=3, act="relu", groups=1,
                 use_bias=True, generator=None, stride=1, wide=False,
                 norm=None, transpose=False, padding=None):
        super().__init__()
        if act not in ACT_CODES:
            raise ValueError(f"activation {act!r} not ported (one of "
                             f"{sorted(a for a in ACT_CODES if a)} or None)")
        if norm not in NORMS:
            raise ValueError(f"norm {norm!r} not ported (one of {NORMS})")
        dw = groups != 1 and groups == in_ch == out_ch
        if padding not in (None, 0) or (padding == 0 and not (
                dw and ksize == stride and not wide)):
            raise ValueError(f"padding={padding}: only reflect-SAME (None), "
                             f"or 0 for a depthwise layer with ksize == "
                             f"stride, is ported")
        if ksize % 2 == 0 and padding is None:
            raise ValueError("reflect-SAME needs an odd kernel size")
        if groups != 1 and not dw:
            raise ValueError(f"groups={groups}: only dense (1) or depthwise "
                             f"(groups == in_ch == out_ch) convs are ported")
        if stride not in (1, 2) or (stride == 2 and (
                wide or (groups != 1 and padding is None))):
            raise ValueError(f"stride={stride}: only stride 1, or 2 for a "
                             f"dense layer off the wide route or a VALID "
                             f"depthwise one, is ported")
        if transpose and (stride, ksize) != (2, 3):
            raise ValueError("transpose: only the k3 stride-2 transpose conv "
                             "is ported")
        self.in_ch, self.out_ch, self.ksize, self.act = in_ch, out_ch, ksize, act
        self.groups, self.stride, self.wide = groups, stride, wide
        self.norm, self.transpose, self.padding = norm, transpose, padding
        self.qpath = None     # flax path (ops/quant.name_layers)
        mods = [_Conv(in_ch, out_ch, ksize, groups, use_bias, transpose)]
        if norm == "batch":
            mods.append(nn.BatchNorm2d(out_ch, eps=BN_EPS, momentum=0.1))
        elif norm == "group":
            mods.append(nn.GroupNorm(out_ch, out_ch, eps=BN_EPS))
        self.layers = nn.ModuleList(mods)
        init_conv_(self.layers[0].weight, self.layers[0].bias, act, generator)

    @property
    def weight(self):
        return self.layers[0].weight

    @property
    def bias(self):
        return self.layers[0].bias

    def folded(self, dtype=None):
        """(weight, bias) of every serving route, in `dtype` (default the
        weight's): the conv's own (also with a group norm, which runs after
        the conv: `_normed`) or, with a batch norm, its eval-mode fold
        (JAX ops/layers.py:417-423): w * g and (b - mean) * g + beta with
        g = scale / sqrt(var + 1e-5), computed in f32, then cast."""
        dtype = dtype or self.weight.dtype
        w, b = self.weight, self.bias
        if self.norm != "batch":
            return w.to(dtype), None if b is None else b.to(dtype)
        bn = self.layers[1]
        g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
        b0 = 0.0 if b is None else b.float()
        bf = (b0 - bn.running_mean.float()) * g + bn.bias.float()
        return ((w.float() * g[:, None, None, None]).to(dtype),
                bf.to(dtype))

    def _no_norm(self, route):
        if self.norm is not None:
            raise NotImplementedError(
                f"the {route} route of a conv with a {self.norm} norm is not "
                f"ported ({_NORM_QUEUE}); its serving route "
                f"{'folds' if self.norm == 'batch' else 'applies'} the norm")

    def _kernel_act(self):
        """The activation a kernel fuses: the layer's, or None where a group
        norm sits between the conv and the activation (`_normed`)."""
        return None if self.norm == "group" else self.act

    def _normed(self, y):
        """A conv's output with its bias and `_kernel_act` -> the layer's:
        with a group norm, the norm and the activation after it."""
        if self.norm != "group":
            return y
        gn = self.layers[1]
        return group_norm(y, gn.weight, gn.bias, self.act, gn.eps)

    def _needs_grad(self, *xs):
        return torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (self.weight, self.bias, *xs,
                      *self.layers[1:].parameters()))

    def _train_conv(self, x):
        """The training routes (module docstring) on an NHWC tensor, in
        batch chunks of `batch_step` images: torch's reflect pad refuses a
        padded tensor of 2^31 elements or more ("input tensor must fit
        into 32-bit index math", e.g. DenseFuse's 64-channel concat of 32
        full-resolution images). A group norm follows the conv and its bias
        (per image, so the chunks are exact); a batch norm raises."""
        if self.norm == "batch":
            self._no_norm("training")
        step = batch_step(*x.shape[1:3], max(x.shape[-1], self.out_ch),
                          self.ksize)
        if x.shape[0] > step:
            return torch.cat([self._train_conv(x[i:i + step])
                              for i in range(0, x.shape[0], step)])
        p = self.ksize // 2
        xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
        kact = self._kernel_act()
        if not (_FAST_TRAINING.get() and self._valid_eligible()):
            y = F.conv2d(xp, self.weight, self.bias, groups=self.groups)
            return self._normed(apply_act(y, kact).permute(0, 2, 3, 1))
        xp = xp.permute(0, 2, 3, 1).contiguous()
        if self._needs_grad(xp):
            y = conv_valid_fast(xp, self.weight)
            return self._normed(apply_act(
                y if self.bias is None else y + self.bias, kact))
        return self._normed(conv_valid(xp, self.weight, self.bias, kact))

    def _valid_eligible(self):
        """The layers the JAX package's gate lets take the conv_valid kernel
        under fast training (ops/layers.py:165-176 `_pallas_conv_eligible`):
        dense k3, k5 and k7 (stride 2 never reaches a training route). A
        depthwise or k1 layer trains on F.conv2d there, as the JAX package
        trains it on XLA's conv."""
        return self.groups == 1 and self.ksize in (3, 5, 7)

    def _training_route(self, *xs):
        return _FAST_TRAINING.get() is not None or self._needs_grad(*xs)

    def _whole_input(self):
        """True when the layer needs its effective input as one tensor: to
        record it (calibration) or to quantize it (an int8 context)."""
        return calibrating() or int8_ctx() is not None

    def enter(self, img1, img2=None):
        """c_in=1 layer on a grayscale image or pair: (B, H, W, 1) ->
        (B or 2B, H, W, out_ch) in the layer's parameter dtype (the images
        are cast to it first)."""
        dt = self.weight.dtype
        img1 = img1.to(dt)
        img2 = None if img2 is None else img2.to(dt)
        if self._training_route(img1, img2) or self._whole_input():
            return self(img1 if img2 is None
                        else torch.cat([img1, img2], dim=0))
        return self._normed(conv_gray_enter(img1, img2, *self.folded(),
                                            self._kernel_act()))

    def enter_stacked(self, imgs):
        """A c_in = len(imgs) layer over the channel concat of gray images
        (B, H, W, 1), one of them repeated (PMGI's concat(i, i, j)): the
        serving route sums the weights of a repeated image and runs the
        two-leg conv_gray_enter over the two distinct images, read once
        each (the JAX package's H-major entry, models/zoo.py:1521-1526;
        the sum in f32 over the folded weight); the other routes convolve
        the concat, the images cast to the parameters' dtype."""
        uniq, which = [], []   # the distinct images; each channel's index
        for t in imgs:
            if not any(t is u for u in uniq):
                uniq.append(t)
            which.append(next(i for i, u in enumerate(uniq) if t is u))
        if len(imgs) != self.in_ch or len(uniq) != 2:
            raise ValueError(f"enter_stacked: {len(imgs)} images with two "
                             f"distinct ones for {self.in_ch} input channels")
        cast = [u.to(self.weight.dtype) for u in uniq]
        if self._training_route(*cast) or self._whole_input():
            return self(torch.cat([cast[i] for i in which], dim=-1))
        w, b = self.folded(torch.float32)
        wf = torch.stack([sum(w[:, j] for j, i in enumerate(which) if i == u)
                          for u in range(2)], dim=1)
        return self._normed(conv_gray_enter(cast[0], cast[1], wf, b,
                                            self._kernel_act()))

    def forward(self, x, fuse_n=0):
        """(B, H, W, in_ch) -> (B, H, W, out_ch). fuse_n > 0: x holds two
        halves of fuse_n images and the layer convolves their sum.

        x may be a list of legs [(tensor, b_off), ...] (ops/cuda/
        conv_multi.py): output image b convolves the channel concat of the
        legs at batch b + b_off (plus their siblings at b + b_off + fuse_n
        when fuse_n > 0), for as many images as every leg can feed."""
        if isinstance(x, list):
            return self._forward_legs(x, fuse_n)
        if self.groups != 1 and self.stride == 1:
            return self.depthwise(x)
        qc = self._int8_in_place()
        if qc is not None:
            return self._int8(x, qc, fuse_n)
        if fuse_n and (self.stride != 1 or self._training_route(x)
                       or self._whole_input()):
            x, fuse_n = x[:fuse_n] + x[fuse_n:], 0
        record(self.qpath, x)
        qc = self._int8_route()
        if qc is not None:
            return self._int8(x, qc)
        if self.stride != 1:
            return self._strided(x)
        if self._training_route(x):
            return self._train_conv(x)
        w, b = self.folded()
        act = self._kernel_act()
        if self.wide:
            y = conv_wide([(x, 0)], w, b, act, fuse_n)
        elif self.in_ch == 1 and not fuse_n:
            y = conv_gray_enter(x.to(w.dtype), None, w, b, act)
        elif self.out_ch == 1 and not fuse_n:
            y = conv_gray_exit(x, w, b, act)
        else:
            y = conv_chain(x, w, b, act, fuse_n)
        return self._normed(y)

    def plus_identity(self, x, res, act=None):
        """act(conv(x) + res), res of out_ch channels (ResBlock's second
        conv and its residual add, no activation between; SepConvBlock's
        pwconv2, its identity shortcut and the relu6 after the add): on the
        serving route one conv_multi over the legs [(x, 0), (res, 0)] whose
        weight is the layer's (folded) weight beside a centre-tap identity,
        so the add rides the conv and `act` its epilogue (the JAX package's
        `_hiw_resblock`, models/zoo.py:115-124); on the other routes, and
        with a group norm (which sits between the conv and the add), the
        conv, then the add and `act`."""
        if self.act is not None or self.stride != 1 or self.groups != 1:
            raise ValueError("plus_identity: a stride-1 dense conv without "
                             "activation")
        if (self.wide or self.norm == "group"
                or self._training_route(x, res) or self._whole_input()):
            return apply_act(self(x) + res, act)
        w, b = self.folded()
        eye = identity_weights(self.ksize, self.out_ch).to(w)
        return conv_multi([(x, 0), (res, 0)], torch.cat([w, eye], 1), b,
                          act)

    def packed(self, x, fuse_n=0):
        """The packed route (JAX ops/layers.py:409-437, `chain_s2d=2`): x
        (B, H/2, W/2, 4 in_ch) space-to-depth packed (ops/s2d.py) ->
        (B or fuse_n, H/2, W/2, 4 out_ch), the weight and bias packed at
        call time, conv_wide's s2d mode (a k5 or k7 layer runs as a k3 or
        k5 conv). Serving only: a stride-1 dense layer, no gradient."""
        if self.stride != 1 or self.groups != 1:
            raise ValueError("packed route: stride-1 dense layers only")
        w, b = self.folded()
        w = s2d_pack_weights(w.detach())
        b = None if b is None else s2d_pack_bias(b.detach())
        return conv_wide([(x, 0)], w, b, self.act, fuse_n, s2d_f=2)

    def pair_args(self):
        """(weight, bias, k, act) for a model that runs this layer inside a
        fused pair (ops/cuda/conv_pair.py): the counterpart of the JAX
        package's `chain_defer_in_ch` (ops/layers.py:443-452)."""
        return (*self.folded(), self.ksize, self.act)

    def _int8_route(self):
        """The quantized_inference this layer runs int8 under now, or None:
        a stride-1 dense layer that the skip set does not name."""
        qc = int8_ctx()
        if (qc is None or self.stride != 1 or self.groups != 1
                or quant_skipped(self.qpath)):
            return None
        return qc

    def _int8_in_place(self):
        """The int8 route of a calibrated layer outside calibration, whose
        legs and fuse_n conv_int8 reads in place, or None."""
        qc = None if calibrating() else self._int8_route()
        return qc if qc is not None and self.qpath in qc.amax else None

    def _forward_only(self, *xs):
        if self._needs_grad(*xs):
            raise RuntimeError(
                "int8 inference is forward-only: run the model under "
                "torch.no_grad() inside quantized_inference")

    def _int8(self, x, qc, fuse_n=0):
        """The int8 route: the fold of the calibrated (else the dynamic)
        per-channel amax, the folded weights quantized per output channel,
        then conv_int8 (JAX ops/layers.py:644-691) on x, a tensor or, for a
        calibrated layer, a list of legs, with fuse_n. The weights are
        packed for the kernel once per context (Int8Weights)."""
        self._no_norm("int8")
        self._forward_only(*([t for t, _ in x] if isinstance(x, list)
                             else [x]))
        amax = qc.amax.get(self.qpath)

        def prepare(a_in):
            f = choose_fold(a_in, self.weight,
                            mode=os.environ.get("MMIF_INT8_FOLD", "smooth"))
            qw, sw = quantize_weights(fold_weights(self.weight, f))
            return f, qw, sw, Int8Weights(qw, sw, self.bias, f)
        if amax is None:
            f, qw, sw, wts = prepare(x.abs().amax(dim=(0, 1, 2)).float())
        else:
            f, qw, sw, wts = qc.cached((id(self), "conv_int8"),
                                       lambda: prepare(amax))
        return conv_int8(x, qw, sw, f, self.bias, self.act, fuse_n,
                         weights=wts)

    def chain_int8(self, x, amax, fuse_n=0, out_to=None, out_amax=None):
        """DeepFuse's int8 chain leg (JAX ops/pallas/hiw_int8.py:260-365):
        the smooth fold of `amax`, x quantized by the reciprocal in the
        kernel (or int8-resident), fuse_n on the int8 grid for an int8 x.
        With `out_to` (the next leg, its amax `out_amax`) the output is
        int8 on that leg's fold grid: the dequant scale and the bias are
        divided by its fold in f32 before the kernel. Otherwise the output
        is in the chain dtype (the parameters')."""
        qc = quant_ctx()
        self._no_norm("int8")
        self._forward_only(x)

        def prepare():
            f = choose_fold(amax, self.weight, "smooth")
            qw, sw = quantize_weights(fold_weights(self.weight, f))
            b = None if self.bias is None else self.bias.detach().float()
            if out_to is not None:
                f_next = hiw_fold_scale(out_amax, out_to.weight)
                sw = sw / f_next
                b = None if b is None else b / f_next
            invf = 1.0 / f
            return qw, sw, b, invf, Int8Weights(qw, sw, b, invf)
        qw, dq, b, invf, wts = qc.cached((id(self), "chain", id(out_to)),
                                         prepare)
        return conv_int8_chain(x, qw, dq, b, self.act, invf, fuse_n,
                               out_int8=out_to is not None,
                               out_dtype=self.weight.dtype, weights=wts)

    def depthwise(self, x, lo=0, add=None):
        """Depthwise layer over channels [lo, lo + in_ch) of x (B, H, W,
        Cx), read in place, with `add` (B, H, W, in_ch) summed into its
        input first: (B, H, W, in_ch)."""
        if calibrating():
            xw = x[..., lo:lo + self.in_ch]
            record(self.qpath, xw if add is None else xw + add)
        if self._training_route(x, add):
            xw = x[..., lo:lo + self.in_ch]
            return self._train_conv(xw if add is None else xw + add)
        return self._normed(conv_dw(x, *self.folded(), self._kernel_act(),
                                    lo, add))

    def _strided(self, x):
        """The stride-2 conv: reflect pad k // 2 (`reflect_pad_nhwc`),
        F.conv2d in x's dtype on the channels-last view; the VALID
        depthwise one (padding 0: TransitionBlock's down, the JAX package's
        XLA grouped conv) F.conv2d(groups=C) on the view, unpadded; or
        the transpose conv: F.conv_transpose2d (zero padding 1, output
        padding 1); then bias, the group norm if any and the activation,
        in batch chunks whose padded input and output stay under 2^31
        elements (`batch_step`; the transpose's output is 4x its input)."""
        p = self.ksize // 2 if self.padding is None else self.padding
        b, h, w, c = x.shape
        up = 2 if self.transpose else 1
        step = batch_step(h * up, w * up, max(c, self.out_ch), self.ksize)
        wt, bias = self.folded(x.dtype)
        kact = self._kernel_act()
        outs = []
        for i in range(0, b, step):
            if self.transpose:
                y = F.conv_transpose2d(x[i:i + step].permute(0, 3, 1, 2),
                                       wt, bias, stride=2, padding=p,
                                       output_padding=1)
            else:
                xi = reflect_pad_nhwc(x[i:i + step], p) if p else x[i:i + step]
                y = F.conv2d(xi.permute(0, 3, 1, 2), wt, bias,
                             stride=self.stride, groups=self.groups)
            outs.append(self._normed(apply_act(y, kact).permute(0, 2, 3, 1)))
        return (torch.cat(outs) if len(outs) > 1 else outs[0]).contiguous()

    def _forward_legs(self, legs, fuse_n):
        n_out = legs_n_out(legs, fuse_n)
        qc = self._int8_in_place()
        if qc is not None:
            return self._int8(legs, qc, fuse_n)
        if self._whole_input():
            return self(concat_sum(legs, fuse_n, n_out))
        if self.stride != 1 or self._training_route(*[t for t, _ in legs]):
            x = concat_legs(legs, fuse_n, n_out)
            return self(x[:n_out] + x[n_out:] if fuse_n else x)
        w, b = self.folded()
        act = self._kernel_act()
        if self.out_ch == 1 and not (fuse_n or self.wide):
            return self._normed(conv_gray_exit([(t, off) for t, off in legs],
                                               w, b, act))
        kernel = conv_wide if self.wide else conv_multi
        return self._normed(kernel(legs, w, b, act, fuse_n, n_out))

    def extra_repr(self):
        return (f"{self.in_ch}, {self.out_ch}, ksize={self.ksize}, "
                f"act={self.act!r}, groups={self.groups}, "
                f"stride={self.stride}, padding={self.padding}, "
                f"transpose={self.transpose}, "
                f"wide={self.wide}, bias={self.bias is not None}, "
                f"norm={self.norm!r}")


def interpolate(x, scale_factor, mode="nearest"):
    """torch nn.Upsample on NHWC: 'nearest' (each pixel repeated) or
    'bilinear' with align_corners=True (JAX ops/layers.py:842-898, reference
    core/block.py:965-973). The bilinear weights stay f32 whatever x's dtype
    (the JAX package rounds them to it)."""
    if mode == "nearest":
        return x.repeat_interleave(scale_factor, dim=1).repeat_interleave(
            scale_factor, dim=2)
    if mode == "bilinear":
        # torch's NHWC bilinear kernel takes outputs under 2^31 elements:
        # batch chunks (DBNet's x8 upsample of 32 images is 2.6e9)
        b, h, w, c = x.shape
        step = max(1, INT32_ELEMS // (h * w * c * scale_factor ** 2))
        outs = [F.interpolate(x[i:i + step].permute(0, 3, 1, 2),
                              scale_factor=scale_factor, mode="bilinear",
                              align_corners=True).permute(0, 2, 3, 1)
                for i in range(0, b, step)]
        return (torch.cat(outs) if len(outs) > 1 else outs[0]).contiguous()
    raise ValueError(f"unknown interpolate mode {mode!r}")
