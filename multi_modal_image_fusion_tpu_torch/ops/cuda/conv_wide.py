"""The wide reflect-SAME conv of the C-major chain (csrc/conv_wide.cu) with
its plain version.

Replaces the TPU kernel `ops/pallas/conv_kernel.py:719 conv_tlane_chain`
(halo=True): a k x k reflect-SAME conv over the channel concat of several
input legs, without building the concat, with bias and activation applied
once in the epilogue, as the JAX package's ConvLayer chain route sums its
per-part convs (`ops/layers.py:579-591`). A leg is a pair `(tensor, b_off)`:
an NHWC tensor (B_l, H, W, c_l) read at batch `b + b_off` for output image
b; with `fuse_n > 0` every leg first adds its sibling at `b + b_off + fuse_n`
(the siamese 'sum' fusion in the load, rounded to the legs' dtype as a sum
in that dtype is). The weight is OIHW with its input channels in leg-concat
order; the output is (n_out, H, W, c_out) in the legs' dtype.

bf16 runs the `wgmma` implicit GEMM of conv_chain and conv_multi
(csrc/conv_chain.cuh; bf16 products, f32 sums), its weights packed by
`pack_weights_tc` and its block of output channels picked by `pick_bn_tc`
(ops/cuda/conv_chain.py); f32 runs f32 FMAs (the conv_chain body), never
TF32. Built for k1, k3 and k5, c_out a multiple of 4, any channel count per
leg, 1 to 8 legs; the wrapper raises on anything else, and when an input
needs a gradient (the kernel is forward-only; the training routes
concatenate the legs, ops/layers.py).

`s2d_f=2` is the TPU kernel's space-to-depth mode (its call sites: the
JAX package's `ops/layers.py:409-437`, then `conv_tlane_chain(...,
s2d_f=f)` at `:531`): one leg, packed f = 2 with phase-major channels
(ops/s2d.py), H and W its packed sizes, the weight already packed
(`s2d_pack_weights`, k the packed span). The halo is the packed reflect
extension of the original image, phase by phase (`s2d_reflect_pad`).

The plain version (`conv_wide_plain`) is the concat of the legs in batch
chunks (their fuse_n sum in the legs' dtype), the reflect pad (s2d: the
gather of the per-phase reflect-padded packed input) and F.conv2d in f32,
the activation, the cast. CPU tensors take it; a CUDA tensor launches the
kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F

from ..s2d import s2d_reflect_pad
from .build import check_launch, check_no_grad, kernel_function, stream_handle
from .conv_chain import (DTYPE_CODES, act_code, apply_act, chain_weights,
                         conv_chain_plain)
from .conv_multi import check_legs, concat_legs, legs_n_out

__all__ = ["conv_wide", "conv_wide_plain", "s2d_conv_plain"]

KSIZES = (1, 3, 5)
CO_MULTIPLE = 4
_PLAIN_CHUNK = 2 ** 29     # elements of one chunk's padded f32 input


def s2d_conv_plain(x, weight, bias=None, act=None):
    """Plain packed conv: the per-phase reflect extension of the packed x
    (s2d_reflect_pad), F.conv2d in f32 with the packed weight, the
    activation, the cast to x.dtype."""
    p = weight.shape[-1] // 2
    xp = s2d_reflect_pad(x.float(), p).permute(0, 3, 1, 2)
    y = F.conv2d(xp, weight.float(),
                 None if bias is None else bias.float())
    return apply_act(y, act).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_wide_plain(legs, weight, bias=None, act=None, fuse_n=0, n_out=None,
                    s2d_f=1):
    """Plain version of conv_wide: the legs' concat (fuse_n sum in their
    dtype), then conv_chain_plain (f32 conv, cast back; s2d_f=2:
    s2d_conv_plain), in batch chunks of at most 2^29 padded input
    elements."""
    if n_out is None:
        n_out = legs_n_out(legs, fuse_n)
    h, w = legs[0][0].shape[1:3]
    k = weight.shape[-1]
    px = (h + k - 1) * (w + k - 1) * max(weight.shape[:2])
    step = max(1, _PLAIN_CHUNK // px)
    conv = s2d_conv_plain if s2d_f == 2 else conv_chain_plain
    outs = []
    for i in range(0, n_out, step):
        n = min(step, n_out - i)
        x = concat_legs([(t, off + i) for t, off in legs], fuse_n, n)
        if fuse_n:
            x = x[:n] + x[n:]
        outs.append(conv(x, weight, bias, act))
        del x
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def conv_wide(legs, weight, bias=None, act=None, fuse_n=0, n_out=None,
              s2d_f=1):
    """Reflect-SAME conv over the channel concat of `legs` = [(x_l, b_off_l),
    ...]; weight OIHW (c_out, sum c_l, k, k). Output (n_out, H, W, c_out) in
    the legs' dtype; n_out defaults to `legs_n_out(legs, fuse_n)`. s2d_f=2:
    one f = 2 packed leg and a packed weight, the halo per phase (module
    docstring)."""
    legs = [(t, int(off)) for t, off in legs]
    if n_out is None:
        n_out = legs_n_out(legs, fuse_n)
    if legs[0][0].device.type == "cpu":
        _check_s2d(legs, s2d_f)
        return conv_wide_plain(legs, weight, bias, act, fuse_n, n_out, s2d_f)
    y = torch.empty((n_out, *legs[0][0].shape[1:3], weight.shape[0]),
                    dtype=legs[0][0].dtype, device=legs[0][0].device)
    return conv_wide_into(y, legs, weight, bias, act, fuse_n, s2d_f)


def _check_s2d(legs, s2d_f):
    if s2d_f not in (1, 2):
        raise ValueError(f"conv_wide: s2d_f={s2d_f} (1, or 2 for a packed "
                         f"leg)")
    if s2d_f == 2 and (len(legs) != 1 or legs[0][0].shape[-1] % 4):
        raise ValueError("conv_wide: s2d_f=2 takes one packed leg with a "
                         "multiple of 4 channels")


def conv_wide_into(y, legs, weight, bias=None, act=None, fuse_n=0, s2d_f=1):
    """conv_wide's launch into y, a CUDA tensor of (n_out, H, W, c_out) in
    the legs' dtype; the kernel writes y's elements and nothing else."""
    legs = [(t, int(off)) for t, off in legs]
    _check_s2d(legs, s2d_f)
    n_out = y.shape[0]
    check_no_grad("conv_wide", *[t for t, _ in legs], weight, bias)
    k, cout = check_legs(legs, weight, bias, fuse_n, n_out, "conv_wide",
                         KSIZES, CO_MULTIPLE)
    x0 = legs[0][0]
    h, w = x0.shape[1:3]
    if (y.shape != (n_out, h, w, cout) or y.dtype != x0.dtype
            or y.device != x0.device or not y.is_contiguous()):
        raise ValueError(f"conv_wide: output {tuple(y.shape)} {y.dtype} is "
                         f"not a contiguous ({n_out}, {h}, {w}, {cout}) "
                         f"{x0.dtype} tensor on {x0.device}")
    cins = [t.shape[-1] for t, _ in legs]
    wk, bk, bn = chain_weights(weight, bias, cins, x0.dtype, fuse_n)
    nl = len(legs)
    xs = (ctypes.c_void_p * nl)(*[t.data_ptr() for t, _ in legs])
    cin_arr = (ctypes.c_int * nl)(*cins)
    offs = (ctypes.c_int * nl)(*[off for _, off in legs])
    I, P = ctypes.c_int, ctypes.c_void_p
    fn = kernel_function("mmif_conv_wide",
                         [I, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                          P])
    with torch.cuda.device(x0.device):
        err = fn(DTYPE_CODES[x0.dtype], nl, ctypes.cast(xs, P),
                 ctypes.cast(cin_arr, P), ctypes.cast(offs, P),
                 P(wk.data_ptr()), None if bk is None else P(bk.data_ptr()),
                 P(y.data_ptr()), n_out, h, w, cout, k, bn, fuse_n,
                 act_code(act), int(s2d_f == 2), stream_handle(x0.device))
    check_launch("conv_wide", err, "s2d" if s2d_f == 2 else None)
    return y
