"""Differentiable VALID conv of the training path (counterpart of
multi_modal_image_fusion_tpu ops/pallas/conv_vjp.py:71 conv_valid_fast).

A `torch.autograd.Function` over the conv_valid kernels
(ops/cuda/conv_valid.py), as the JAX package's `jax.custom_vjp` is over
`conv_tlane_dma`:

    forward   y = conv_valid(xp, w)                    (pre-padded VALID conv)
    dx        conv_valid_dx(dy, w): the same kernel in its dx mode, the full
              correlation of dy read in place, its zero halo and the
              flipped, in/out-swapped taps in the kernel's loads (only when
              xp needs a gradient: `needs_input_grad`)
    dw        conv_valid_dw(xp, dy): dw[co, ci, kh, kw] = sum_{b,i,j}
              xp[b, i+kh, j+kw, ci] * dy[b, i, j, co], one kernel launch, in
              f32, cast to w's dtype. The JAX package leaves this product
              to XLA (conv_vjp.py:94-106).

Bias and activation stay torch ops after the conv (JAX ops/layers.py:
713-723), so autograd covers them. On CPU tensors each step takes its
kernel's plain version. `conv_fast_fits` (conv_vjp.py:37), a TPU VMEM
estimate, has no counterpart.
"""

import torch
from torch.profiler import record_function

from .conv_valid import conv_valid, conv_valid_dw, conv_valid_dx

__all__ = ["conv_valid_fast"]


class ConvValidFast(torch.autograd.Function):
    """conv_valid with its kernels in the forward, dx and dw (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, xp, weight):
        ctx.save_for_backward(xp, weight)
        return conv_valid(xp, weight, site="forward")

    @staticmethod
    def backward(ctx, dy):
        xp, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dxp = dw = None
        if ctx.needs_input_grad[0]:
            dxp = conv_valid_dx(dy, weight.to(dy.dtype)).to(xp.dtype)
        if ctx.needs_input_grad[1]:
            with record_function("conv_valid_dw"):
                dw = conv_valid_dw(xp, dy.to(xp.dtype)).to(weight.dtype)
        return dxp, dw


def conv_valid_fast(xp, weight):
    """VALID conv of a pre-padded NHWC input, differentiable in xp and
    weight: xp (B, H+k-1, W+k-1, C_in), weight OIHW -> (B, H, W, C_out)."""
    return ConvValidFast.apply(xp, weight)
