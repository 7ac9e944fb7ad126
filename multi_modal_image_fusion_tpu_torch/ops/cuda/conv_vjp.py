"""Differentiable VALID conv of the training path (counterpart of
multi_modal_image_fusion_tpu ops/pallas/conv_vjp.py:71 conv_valid_fast).

A `torch.autograd.Function` over the conv_valid kernel
(ops/cuda/conv_valid.py), as the JAX package's `jax.custom_vjp` is over
`conv_tlane_dma`:

    forward   y = conv_valid(xp, w)                    (pre-padded VALID conv)
    dx        conv_valid of dy zero-padded by k-1, with w flipped in both
              spatial axes and in/out swapped: the same kernel, launched
              again (only when xp needs a gradient: `needs_input_grad`)
    dw        dw[co, ci, kh, kw] = sum_{b,i,j} xp[b, i+kh, j+kw, ci]
              * dy[b, i, j, co]: k*k matmuls (C_in, B*H*W) x (B*H*W, C_out)
              in f32, cast to w's dtype. The JAX package leaves this product
              to XLA (conv_vjp.py:94-106); here it is torch matmuls, a
              hand-written dw kernel is queued (ROADMAP queue 3).

Bias and activation stay torch ops after the conv (JAX ops/layers.py:
713-723), so autograd covers them. On CPU tensors the forward and dx take
conv_valid's plain version. `conv_fast_fits` (conv_vjp.py:37), a TPU VMEM
estimate, has no counterpart.
"""

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .conv_valid import conv_valid

__all__ = ["conv_valid_dw", "conv_valid_fast"]


def conv_valid_dw(xp, dy):
    """Weight gradient of the VALID conv, OIHW: per tap, the contraction of
    the shifted input with dy over (b, i, j), in f32 (float64 for float64
    inputs)."""
    dt = torch.float64 if xp.dtype == torch.float64 else torch.float32
    b, h, w, cout = dy.shape
    cin = xp.shape[-1]
    k = xp.shape[1] - h + 1
    x = xp.to(dt)
    d = dy.to(dt).reshape(-1, cout)
    taps = torch.stack([
        x[:, kh:kh + h, kw:kw + w, :].reshape(-1, cin).t() @ d
        for kh in range(k) for kw in range(k)])            # (k*k, Cin, Cout)
    return taps.view(k, k, cin, cout).permute(3, 2, 0, 1).contiguous()


class ConvValidFast(torch.autograd.Function):
    """conv_valid with the kernel in its forward and dx (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, xp, weight):
        ctx.save_for_backward(xp, weight)
        return conv_valid(xp, weight, site="forward")

    @staticmethod
    def backward(ctx, dy):
        xp, weight = ctx.saved_tensors
        k = weight.shape[-1]
        dy = dy.contiguous()
        dxp = dw = None
        if ctx.needs_input_grad[0]:
            # FULL correlation = VALID conv of the zero-padded cotangent
            dy_pad = F.pad(dy, (0, 0, k - 1, k - 1, k - 1, k - 1))
            w_flip = weight.flip(2, 3).transpose(0, 1).to(dy.dtype)
            dxp = conv_valid(dy_pad, w_flip, site="dx").to(xp.dtype)
        if ctx.needs_input_grad[1]:
            with record_function("conv_valid_dw"):
                dw = conv_valid_dw(xp, dy).to(weight.dtype)
        return dxp, dw


def conv_valid_fast(xp, weight):
    """VALID conv of a pre-padded NHWC input, differentiable in xp and
    weight: xp (B, H+k-1, W+k-1, C_in), weight OIHW -> (B, H, W, C_out)."""
    return ConvValidFast.apply(xp, weight)
