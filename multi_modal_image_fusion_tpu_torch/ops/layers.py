"""Conv layer of the port (counterpart of multi_modal_image_fusion_tpu
ops/layers.py:339-360 ConvLayer, 195-215 activations, 237 pad2d, and the
fast-training scope and routes, :34-56 and :695-755).

This slice carries the part DeepFuse uses: stride-1 reflect-SAME k x k
convs with bias and one of the kernel-fusable activations (relu, relu6,
lrelu 0.2, tanh, none). Tensors are NHWC at the boundary. Parameters are
named as in the reference state dict (`layers.0.weight` OIHW,
`layers.0.bias`), so reference `.pth` files load directly.

Routes of a conv:

- serving (no `fast_training` scope and no gradient needed): the forward-only
  kernels of ops/cuda/conv_chain.py on CUDA tensors (the c_in=1 layer runs
  `conv_gray_enter`, the c_out=1 layer `conv_gray_exit`, every other layer
  `conv_chain`), their plain versions on CPU tensors;
- training (inside a `fast_training` scope, which the trainer opens around
  its steps, or whenever a gradient is needed): reflect pad, then
  - with `fast_training(True)`: `conv_valid_fast` (kernel forward and dx,
    bias and activation as torch ops) when a gradient is needed, else
    `conv_valid` with bias and activation fused (the valid step); a shape
    the kernel does not take raises, there is no quiet F.conv2d;
  - otherwise F.conv2d, the counterpart of the JAX package's XLA conv.
  On CPU tensors the kernels' plain versions run in their place.
"""

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from .cuda.conv_chain import (ACT_CODES, apply_act, conv_chain,
                              conv_gray_enter, conv_gray_exit)
from .cuda.conv_valid import conv_valid
from .cuda.conv_vjp import conv_valid_fast

__all__ = ["ACT_CODES", "ConvLayer", "apply_act", "fast_training",
           "init_conv_"]

# None: no trainer scope (serving); False / True: the trainer's steps, on
# F.conv2d / on the conv_valid kernels
_FAST_TRAINING = contextvars.ContextVar("mmif_fast_training", default=None)


@contextlib.contextmanager
def fast_training(enable=True):
    """Scope of a train or valid step: every conv takes a training route,
    through the conv_valid kernels when `enable`, else through F.conv2d."""
    token = _FAST_TRAINING.set(bool(enable))
    try:
        yield
    finally:
        _FAST_TRAINING.reset(token)

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
    """Parameter holder of one conv: weight (O, I, K, K), bias (O,)."""

    def __init__(self, in_ch, out_ch, ksize):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, ksize, ksize))
        self.bias = nn.Parameter(torch.empty(out_ch))


class ConvLayer(nn.Module):
    """Stride-1 reflect-SAME conv + bias + activation, NHWC."""

    def __init__(self, in_ch, out_ch, ksize=3, act="relu", generator=None):
        super().__init__()
        if act not in ACT_CODES:
            raise ValueError(f"activation {act!r} not ported (one of "
                             f"{sorted(a for a in ACT_CODES if a)} or None)")
        if ksize % 2 == 0:
            raise ValueError("reflect-SAME needs an odd kernel size")
        self.in_ch, self.out_ch, self.ksize, self.act = in_ch, out_ch, ksize, act
        self.layers = nn.ModuleList([_Conv(in_ch, out_ch, ksize)])
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
        """The training routes (module docstring) on an NHWC tensor."""
        p = self.ksize // 2
        xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
        if not _FAST_TRAINING.get():
            y = F.conv2d(xp, self.weight, self.bias)
            return apply_act(y, self.act).permute(0, 2, 3, 1)
        xp = xp.permute(0, 2, 3, 1).contiguous()
        if self._needs_grad(xp):
            return apply_act(conv_valid_fast(xp, self.weight) + self.bias,
                             self.act)
        return conv_valid(xp, self.weight, self.bias, self.act)

    def _training_route(self, *xs):
        return _FAST_TRAINING.get() is not None or self._needs_grad(*xs)

    def enter(self, img1, img2=None):
        """c_in=1 layer on a grayscale image or pair: (B, H, W, 1) ->
        (B or 2B, H, W, out_ch) in the layer's parameter dtype (the images
        are cast to it first)."""
        dt = self.weight.dtype
        img1 = img1.to(dt)
        img2 = None if img2 is None else img2.to(dt)
        if self._training_route(img1, img2):
            return self._train_conv(
                img1 if img2 is None else torch.cat([img1, img2], dim=0))
        return conv_gray_enter(img1, img2, self.weight, self.bias, self.act)

    def forward(self, x, fuse_n=0):
        """(B, H, W, in_ch) -> (B, H, W, out_ch). fuse_n > 0: x holds two
        halves of fuse_n images and the layer convolves their sum."""
        if self._training_route(x):
            return self._train_conv(x[:fuse_n] + x[fuse_n:] if fuse_n else x)
        if self.in_ch == 1 and not fuse_n:
            return self.enter(x)
        if self.out_ch == 1 and not fuse_n:
            return conv_gray_exit(x, self.weight, self.bias, self.act)
        return conv_chain(x, self.weight, self.bias, self.act, fuse_n)

    def extra_repr(self):
        return (f"{self.in_ch}, {self.out_ch}, ksize={self.ksize}, "
                f"act={self.act!r}")
