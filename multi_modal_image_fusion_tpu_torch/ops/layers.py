"""Conv layer of the port (counterpart of multi_modal_image_fusion_tpu
ops/layers.py:339-360 ConvLayer, 195-215 activations, 237 pad2d, 842-898
interpolate, and the fast-training scope and routes, :34-56 and :695-755).

The port carries the part the ported models use: reflect-SAME k x k convs,
dense or depthwise (groups == in_ch == out_ch), stride 1 or (dense) 2, with
or without bias, and one of the kernel-fusable activations (relu, relu6,
lrelu 0.2, tanh, none). Tensors are NHWC at the boundary. Parameters are
named as in the reference state dict (`layers.0.weight` OIHW,
`layers.0.bias`; no bias key when use_bias=False), so reference `.pth`
files load directly.

A layer takes one tensor, or a list of legs `[(tensor, b_off), ...]` whose
channels concatenate to its input (the JAX package's multi-leg convs,
models/zoo.py:103 `_hiw_mconv`): dense growth and concat fusion without
building the concat.

Routes of a conv:

- a stride-2 layer: reflect pad, then F.conv2d(stride=2) on every route,
  as the JAX package runs it on XLA's conv (ops/layers.py:747-755);
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
from .cuda.conv_multi import concat_legs, conv_multi, legs_n_out
from .cuda.conv_valid import conv_valid
from .cuda.conv_vjp import conv_valid_fast
from .cuda.conv_wide import conv_wide
from .quant import (calibrating, choose_fold, fold_weights, hiw_fold_scale,
                    quant_ctx, quant_skipped, quantize_weights, record)
from .s2d import s2d_pack_bias, s2d_pack_weights

__all__ = ["ACT_CODES", "ConvLayer", "apply_act", "fast_training",
           "init_conv_", "int8_ctx", "interpolate"]

INT32_ELEMS = 2 ** 31 - 1   # largest output of torch's NHWC bilinear kernel

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
    """Parameter holder of one conv: weight (O, I / groups, K, K), bias (O,)
    or None."""

    def __init__(self, in_ch, out_ch, ksize, groups=1, use_bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, ksize,
                                               ksize))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None


class ConvLayer(nn.Module):
    """Reflect-SAME conv (+ bias) + activation, NHWC. groups is 1 or, for a
    depthwise layer, in_ch == out_ch; stride 1, or 2 for a dense layer;
    `wide` sends the serving route to conv_wide (module docstring)."""

    def __init__(self, in_ch, out_ch, ksize=3, act="relu", groups=1,
                 use_bias=True, generator=None, stride=1, wide=False):
        super().__init__()
        if act not in ACT_CODES:
            raise ValueError(f"activation {act!r} not ported (one of "
                             f"{sorted(a for a in ACT_CODES if a)} or None)")
        if ksize % 2 == 0:
            raise ValueError("reflect-SAME needs an odd kernel size")
        if groups != 1 and not groups == in_ch == out_ch:
            raise ValueError(f"groups={groups}: only dense (1) or depthwise "
                             f"(groups == in_ch == out_ch) convs are ported")
        if stride not in (1, 2) or (stride == 2 and (groups != 1 or wide)):
            raise ValueError(f"stride={stride}: only stride 1, or 2 for a "
                             f"dense layer off the wide route, is ported")
        self.in_ch, self.out_ch, self.ksize, self.act = in_ch, out_ch, ksize, act
        self.groups, self.stride, self.wide = groups, stride, wide
        self.qpath = None     # flax path (ops/quant.name_layers)
        self.layers = nn.ModuleList([_Conv(in_ch, out_ch, ksize, groups,
                                           use_bias)])
        init_conv_(self.layers[0].weight, self.layers[0].bias, act, generator)

    @property
    def weight(self):
        return self.layers[0].weight

    @property
    def bias(self):
        return self.layers[0].bias

    def _needs_grad(self, *xs):
        return torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (self.weight, self.bias, *xs))

    def _train_conv(self, x):
        """The training routes (module docstring) on an NHWC tensor, in
        batch chunks of `batch_step` images: torch's reflect pad refuses a
        padded tensor of 2^31 elements or more ("input tensor must fit
        into 32-bit index math", e.g. DenseFuse's 64-channel concat of 32
        full-resolution images)."""
        step = batch_step(*x.shape[1:3], max(x.shape[-1], self.out_ch),
                          self.ksize)
        if x.shape[0] > step:
            return torch.cat([self._train_conv(x[i:i + step])
                              for i in range(0, x.shape[0], step)])
        p = self.ksize // 2
        xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
        if not (_FAST_TRAINING.get() and self._valid_eligible()):
            y = F.conv2d(xp, self.weight, self.bias, groups=self.groups)
            return apply_act(y, self.act).permute(0, 2, 3, 1)
        xp = xp.permute(0, 2, 3, 1).contiguous()
        if self._needs_grad(xp):
            y = conv_valid_fast(xp, self.weight)
            return apply_act(y if self.bias is None else y + self.bias,
                             self.act)
        return conv_valid(xp, self.weight, self.bias, self.act)

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
        return conv_gray_enter(img1, img2, self.weight, self.bias, self.act)

    def forward(self, x, fuse_n=0):
        """(B, H, W, in_ch) -> (B, H, W, out_ch). fuse_n > 0: x holds two
        halves of fuse_n images and the layer convolves their sum.

        x may be a list of legs [(tensor, b_off), ...] (ops/cuda/
        conv_multi.py): output image b convolves the channel concat of the
        legs at batch b + b_off (plus their siblings at b + b_off + fuse_n
        when fuse_n > 0), for as many images as every leg can feed."""
        if isinstance(x, list):
            return self._forward_legs(x, fuse_n)
        if self.groups != 1:
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
        if self.wide:
            return conv_wide([(x, 0)], self.weight, self.bias, self.act,
                             fuse_n)
        if self.in_ch == 1 and not fuse_n:
            return conv_gray_enter(x.to(self.weight.dtype), None,
                                   self.weight, self.bias, self.act)
        if self.out_ch == 1 and not fuse_n:
            return conv_gray_exit(x, self.weight, self.bias, self.act)
        return conv_chain(x, self.weight, self.bias, self.act, fuse_n)

    def packed(self, x, fuse_n=0):
        """The packed route (JAX ops/layers.py:409-437, `chain_s2d=2`): x
        (B, H/2, W/2, 4 in_ch) space-to-depth packed (ops/s2d.py) ->
        (B or fuse_n, H/2, W/2, 4 out_ch), the weight and bias packed at
        call time, conv_wide's s2d mode (a k5 or k7 layer runs as a k3 or
        k5 conv). Serving only: a stride-1 dense layer, no gradient."""
        if self.stride != 1 or self.groups != 1:
            raise ValueError("packed route: stride-1 dense layers only")
        w = s2d_pack_weights(self.weight.detach())
        b = None if self.bias is None else s2d_pack_bias(self.bias.detach())
        return conv_wide([(x, 0)], w, b, self.act, fuse_n, s2d_f=2)

    def pair_args(self):
        """(weight, bias, k, act) for a model that runs this layer inside a
        fused pair (ops/cuda/conv_pair.py): the counterpart of the JAX
        package's `chain_defer_in_ch` (ops/layers.py:443-452)."""
        return self.weight, self.bias, self.ksize, self.act

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
        return conv_dw(x, self.weight, self.bias, self.act, lo, add)

    def _strided(self, x):
        """The stride-2 conv: reflect pad k // 2, F.conv2d in x's dtype,
        bias and activation, in batch chunks of `batch_step` images."""
        p = self.ksize // 2
        b, h, w, c = x.shape
        step = batch_step(h, w, max(c, self.out_ch), self.ksize)
        wt = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        outs = []
        for i in range(0, b, step):
            xp = F.pad(x[i:i + step].permute(0, 3, 1, 2), (p, p, p, p),
                       mode="reflect")
            y = F.conv2d(xp, wt, bias, stride=self.stride)
            outs.append(apply_act(y, self.act).permute(0, 2, 3, 1))
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
        kernel = conv_wide if self.wide else conv_multi
        return kernel(legs, self.weight, self.bias, self.act, fuse_n, n_out)

    def extra_repr(self):
        return (f"{self.in_ch}, {self.out_ch}, ksize={self.ksize}, "
                f"act={self.act!r}, groups={self.groups}, "
                f"stride={self.stride}, wide={self.wide}, "
                f"bias={self.bias is not None}")


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
