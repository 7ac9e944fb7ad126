"""Multi-leg reflect-SAME conv (the conv_chain kernel of csrc/conv_chain.cu
over several legs) with its plain version.

Replaces the TPU kernel `ops/pallas/hiw_kernel.py:619
conv_hiw_chain_multi`: one k x k reflect-SAME conv over the channel concat
of several input legs, without building the concat. A leg is a pair
`(tensor, b_off)`: an NHWC tensor (B_l, H, W, c_l) read at batch
`b + b_off` for output image b. With `fuse_n > 0` every leg first adds its
sibling at `b + b_off + fuse_n` (the siamese 'sum' fusion in the load). The
weight is OIHW with its input channels in leg-concat order, so a centre-tap
identity weight on a leg (`identity_weights`) carries a residual add. Bias
and activation are fused; the output is (n_out, H, W, c_out) in the legs'
dtype. It is the kernel behind `conv_chain`, launched with the legs in its
launch parameters (`conv_chain` is the case of one leg at offset 0); this
wrapper counts its own launches as `conv_multi`.

In bf16 the kernel is conv_chain's `wgmma` body, each leg's channels
zero-padded to whole 16-channel k-steps in the packed weights
(`pack_weights_tc`); in f32 its FMA body.

The plain version (`conv_multi_plain`) is the concat of the legs at their
batch offsets (plus their fuse_n siblings) and `conv_chain_plain`. CPU
tensors take it; a CUDA tensor launches the kernel or raises. The kernel is
forward-only and raises when an input needs a gradient (the training routes
concatenate the legs, ops/layers.py). Built for kernel sizes 1, 3, 5 and 7,
up to 8 legs of any channel count, c_out a multiple of 16, one dtype.
"""

import ctypes

import torch

from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle
from .conv_chain import (CO_TILE, DTYPE_CODES, act_code, chain_weights,
                         check_tensors, conv_chain_plain)

__all__ = ["check_legs", "concat_legs", "conv_multi", "conv_multi_plain",
           "identity_weights", "legs_n_out"]

MAX_LEGS = 8
_GRID_Z_MAX = 65535


def identity_weights(k, c):
    """OIHW (c, c, k, k) f32 centre-tap identity: conv(x, I) == x
    (`hiw_identity_weights`, JAX models/zoo.py:115-124)."""
    w = torch.zeros((c, c, k, k))
    w[torch.arange(c), torch.arange(c), k // 2, k // 2] = 1.0
    return w


def legs_n_out(legs, fuse_n=0):
    """The largest output batch every leg can feed: min(B_l - b_off_l -
    fuse_n)."""
    return min(t.shape[0] - off - fuse_n for t, off in legs)


def concat_legs(legs, fuse_n=0, n_out=None):
    """The concat the kernel never builds: the legs' channels at their batch
    offsets, (n_out, H, W, sum c_l); with fuse_n the fuse_n siblings follow
    as a second half (2 * n_out images)."""
    if n_out is None:
        n_out = legs_n_out(legs, fuse_n)

    def at(extra):
        return torch.cat([t[off + extra:off + extra + n_out]
                          for t, off in legs], dim=-1)
    if fuse_n:
        return torch.cat([at(0), at(fuse_n)], dim=0)
    return at(0)


def conv_multi_plain(legs, weight, bias=None, act=None, fuse_n=0,
                     n_out=None):
    """Plain version of conv_multi: the concat, then conv_chain_plain (the
    fuse_n sum and the weight in the legs' dtype, the conv in f32, cast
    back)."""
    if n_out is None:
        n_out = legs_n_out(legs, fuse_n)
    return conv_chain_plain(concat_legs(legs, fuse_n, n_out), weight, bias,
                            act, n_out if fuse_n else 0)


def check_legs(legs, weight, bias, fuse_n, n_out, name="conv_multi",
               ksizes=(1, 3, 5, 7), co_tile=CO_TILE):
    """The multi-leg kernels' contract (conv_multi; conv_wide with its own
    kernel sizes and output-channel multiple); returns (k, c_out)."""
    if not 1 <= len(legs) <= MAX_LEGS:
        raise ValueError(f"{name}: 1 to {MAX_LEGS} legs, got {len(legs)}")
    tensors = [t for t, _ in legs]
    check_tensors(name, tensors)
    x0 = tensors[0]
    h, w = x0.shape[1:3]
    for t, off in legs:
        if t.shape[1:3] != x0.shape[1:3] or t.dtype != x0.dtype:
            raise ValueError(f"{name}: legs differ in H, W or dtype")
        if off < 0 or off + fuse_n + n_out > t.shape[0]:
            raise ValueError(f"{name}: a leg of batch {t.shape[0]} at offset "
                             f"{off} cannot feed {n_out} outputs "
                             f"(fuse_n={fuse_n})")
    if weight.dim() != 4 or weight.shape[2] != weight.shape[3]:
        raise ValueError(f"{name}: weight must be OIHW with square taps, got "
                         f"{tuple(weight.shape)}")
    k = weight.shape[-1]
    if k not in ksizes:
        raise ValueError(f"{name}: kernel size {k} not built {ksizes}")
    if h <= k // 2 or w <= k // 2:
        raise ValueError(f"{name}: reflect padding {k // 2} needs H and W "
                         f"above it, got {h}x{w}")
    cin = sum(t.shape[-1] for t in tensors)
    if weight.shape[1] != cin:
        raise ValueError(f"{name}: weight takes {weight.shape[1]} input "
                         f"channels, the legs have {cin}")
    cout = weight.shape[0]
    if cout % co_tile:
        raise ValueError(f"{name}: Cout must be a multiple of {co_tile}, "
                         f"got {cout}")
    if n_out < 1 or n_out * (cout // co_tile) > _GRID_Z_MAX:
        raise ValueError(f"{name}: {n_out} output images in one launch")
    dev = x0.device
    if weight.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"{name}: weight and bias must be on {dev}")
    return k, cout


def conv_multi(legs, weight, bias=None, act=None, fuse_n=0, n_out=None):
    """Reflect-SAME conv over the channel concat of `legs` = [(x_l, b_off_l),
    ...]; weight OIHW (Cout, sum c_l, K, K). Output (n_out, H, W, Cout) in
    the legs' dtype; n_out defaults to `legs_n_out(legs, fuse_n)`."""
    legs = [(t, int(off)) for t, off in legs]
    if n_out is None:
        n_out = legs_n_out(legs, fuse_n)
    if legs[0][0].device.type == "cpu":
        return conv_multi_plain(legs, weight, bias, act, fuse_n, n_out)
    check_no_grad("conv_multi", *[t for t, _ in legs], weight, bias)
    k, cout = check_legs(legs, weight, bias, fuse_n, n_out)
    x0 = legs[0][0]
    h, w = x0.shape[1:3]
    wk, bk, bn = chain_weights(weight, bias, [t.shape[-1] for t, _ in legs],
                               x0.dtype, fuse_n)
    y = torch.empty((n_out, h, w, cout), dtype=x0.dtype, device=x0.device)
    nl = len(legs)
    xs = (ctypes.c_void_p * nl)(*[t.data_ptr() for t, _ in legs])
    cins = (ctypes.c_int * nl)(*[t.shape[-1] for t, _ in legs])
    offs = (ctypes.c_int * nl)(*[off for _, off in legs])
    I, P = ctypes.c_int, ctypes.c_void_p
    fn = kernel_function("mmif_conv_multi",
                         [I, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P])
    with torch.cuda.device(x0.device):
        err = fn(DTYPE_CODES[x0.dtype], nl, ctypes.cast(xs, P),
                 ctypes.cast(cins, P), ctypes.cast(offs, P), ptr(wk),
                 ptr(bk), ptr(y), n_out, h, w, cout, k, bn, fuse_n,
                 act_code(act), stream_handle(x0.device))
    check_launch("conv_multi", err)
    return y
