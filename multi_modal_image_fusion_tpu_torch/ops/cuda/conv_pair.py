"""Two chained reflect-SAME convs in one launch (csrc/conv_pair.cu) with
their plain version.

Replaces the TPU kernel `ops/pallas/conv_kernel.py:970
conv_tlane_chain_pair`: conv_a (bias, activation), the intermediate
rounded to the chain dtype and kept on chip with its own reflect halo,
then conv_b (bias, activation). DeepFuse's `MMIF_CHAIN_PAIR` route
(models/zoo.py) runs its two instances:

- `conv_pair_enter(img1, img2, wa, ba, act_a, wb, bb, act_b)`: enc0 (1 ->
  16, k5) then enc1 (16 -> 32, k7) on the grayscale pair (B, H, W, 1),
  read straight from the two images and cast to the chain dtype (the
  weights' dtype) in the load: (2B, H, W, 32), img1's batch first. It
  takes the place of conv_gray_enter + conv_chain on this route.
- `conv_pair_exit(t, wa, ba, act_a, wb, bb, act_b)`: dec1 (32 -> 16, k5)
  then dec2 (16 -> 1, k5) on t (B, H, W, 32): (B, H, W, 1) in t's dtype.

Weights are OIHW, biases (C,) or None. In bf16 the wide conv of each pair
(enc1, dec1) runs on `wgmma` with the mid in shared memory in the wgmma
body's staging layout, its weights packed by `pack_weights_tc` (N block 32
and 16), and the thin one (enc0, dec2) on `mma.sync` with conv_gray.cu's
products and packing (`pack_gray_enter`, `pack_gray_exit`); both kernels
walk `PAIR_TILES` on a persistent grid (`pair_tile` mirrors the walk). f32
runs f32 FMAs, never TF32. csrc/conv_pair.cu's header has the design.

The plain version (`conv_pair_plain`) is two `conv_chain_plain` calls with
the mid cast to the chain dtype in between: what two launches compute.
CPU tensors take it; a CUDA tensor launches the kernel or raises. The
kernels are forward-only and raise when an input needs a gradient.
"""

import ctypes

import torch

from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle
from .conv_chain import (DTYPE_CODES, act_code, check_tensors,
                         conv_chain_plain, pack_gray_enter, pack_gray_exit,
                         pack_weights_tc)

__all__ = ["ENTER_SHAPES", "EXIT_SHAPES", "PAIR_TILES", "conv_pair_enter",
           "conv_pair_exit", "conv_pair_plain", "pair_tile", "pair_weights"]

# (wa, wb) OIHW shapes of the two instances built (DeepFuse's pairs)
ENTER_SHAPES = ((16, 1, 5, 5), (32, 16, 7, 7))
EXIT_SHAPES = ((16, 32, 5, 5), (1, 16, 5, 5))
# csrc/conv_pair.cu's bf16 tiles: (output rows, output pixels a row)
PAIR_TILES = {"enter": (8, 64), "exit": (20, 56)}
_GRID_Z_MAX = 65535     # the f32 kernel's grid: one z a batch image
_I = ctypes.c_int
_P = ctypes.c_void_p


def conv_pair_plain(x, wa, ba=None, act_a=None, wb=None, bb=None,
                    act_b=None):
    """Plain version of the pair: conv_b(cast(conv_a(x))), each a
    reflect-SAME f32 conv cast back to x.dtype."""
    return conv_chain_plain(conv_chain_plain(x, wa, ba, act_a), wb, bb,
                            act_b)


def _check(name, shapes, wa, ba, wb, bb, dev):
    for w, want in zip((wa, wb), shapes):
        if tuple(w.shape) != want:
            raise ValueError(f"{name}: built for weights {shapes}, got "
                             f"{tuple(wa.shape)} and {tuple(wb.shape)}")
    for t in (wa, ba, wb, bb):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: weights and biases must be on {dev}")
    if wa.dtype != wb.dtype or wa.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: weights in one dtype (float32 or "
                        f"bfloat16), got {wa.dtype} and {wb.dtype}")


def _fma_rows(w):
    """OIHW -> (k*k, I, O) f32: the FMA conv's weight rows."""
    k = w.shape[-1]
    return w.detach().permute(2, 3, 1, 0).reshape(
        k * k, w.shape[1], w.shape[0]).float().contiguous()


def _bias(b):
    return None if b is None else b.detach().float().contiguous()


def pair_weights(kind, wa, wb):
    """The kernel's weights of the pair `kind` ('enter' or 'exit') in the
    weights' dtype. bf16: the enter's enc0 as B fragments
    (`pack_gray_enter`) and enc1 for the wgmma body (`pack_weights_tc`, N
    block 32); the exit's dec1 for the wgmma body (N block 16, two k-steps)
    and dec2 as B fragments (`pack_gray_exit`). f32: (k*k, I, O) rows for
    the FMAs."""
    if wa.dtype != torch.bfloat16:
        return _fma_rows(wa), _fma_rows(wb)
    if kind == "enter":
        return pack_gray_enter(wa), pack_weights_tc(wb, [wb.shape[1]], 32)
    return pack_weights_tc(wa, [wa.shape[1]], 16), pack_gray_exit(wb)


def pair_tile(kind, b_out, h, w, tile):
    """(image, first row, first column, rows, pixels) of output tile `tile`
    of csrc/conv_pair.cu's bf16 walk for `kind`, x fastest, and the tile
    count: the last tile of a row or band is ragged where H or W is not a
    multiple of PAIR_TILES[kind]."""
    th, tw = PAIR_TILES[kind]
    ty, tx = -(-h // th), -(-w // tw)
    b, r = divmod(tile, ty * tx)
    y0, x0 = r // tx * th, r % tx * tw
    return (b, y0, x0, min(th, h - y0), min(tw, w - x0)), b_out * ty * tx


def conv_pair_enter(img1, img2, wa, ba, act_a, wb, bb, act_b):
    """enc0 then enc1 on a grayscale pair: img1, img2 (B, H, W, 1) in f32 or
    bf16 -> (2B, H, W, 32) in the weights' dtype (the chain dtype)."""
    dtype = wa.dtype
    if img1.device.type == "cpu":
        return conv_pair_plain(torch.cat([img1, img2], 0).to(dtype), wa, ba,
                               act_a, wb, bb, act_b)
    check_no_grad("conv_pair_enter", img1, img2, wa, ba, wb, bb)
    check_tensors("conv_pair_enter", [img1, img2])
    b, h, w, c = img1.shape
    if c != 1 or img2.shape != img1.shape or img2.dtype != img1.dtype:
        raise ValueError(f"conv_pair_enter: a pair of (B, H, W, 1) images "
                         f"of one dtype, got {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)}")
    _check("conv_pair_enter", ENTER_SHAPES, wa, ba, wb, bb, img1.device)
    if h <= 3 or w <= 3:
        raise ValueError(f"conv_pair_enter: reflect padding 3 needs H and W "
                         f"above it, got {h}x{w}")
    if dtype == torch.float32 and 2 * b > _GRID_Z_MAX:
        raise ValueError(f"conv_pair_enter: batch {b} too large for one "
                         f"launch")
    wak, wbk = pair_weights("enter", wa, wb)
    bak, bbk = _bias(ba), _bias(bb)
    y = torch.empty((2 * b, h, w, 32), dtype=dtype, device=img1.device)
    fn = kernel_function("mmif_conv_pair_enter",
                         [_I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I,
                          _I, _P])
    with torch.cuda.device(img1.device):
        err = fn(DTYPE_CODES[dtype], DTYPE_CODES[img1.dtype], ptr(img1),
                 ptr(img2), ptr(wak), ptr(bak), act_code(act_a), ptr(wbk),
                 ptr(bbk), act_code(act_b), ptr(y), b, h, w,
                 stream_handle(img1.device))
    check_launch("conv_pair_enter", err)
    return y


def conv_pair_exit(t, wa, ba, act_a, wb, bb, act_b):
    """dec1 then dec2: t (B, H, W, 32) -> (B, H, W, 1) in t's dtype."""
    if t.device.type == "cpu":
        return conv_pair_plain(t, wa, ba, act_a, wb, bb, act_b)
    check_no_grad("conv_pair_exit", t, wa, ba, wb, bb)
    check_tensors("conv_pair_exit", [t])
    b, h, w, c = t.shape
    if c != 32:
        raise ValueError(f"conv_pair_exit: 32 input channels, got {c}")
    _check("conv_pair_exit", EXIT_SHAPES, wa, ba, wb, bb, t.device)
    if wa.dtype != t.dtype:
        raise TypeError(f"conv_pair_exit: weights in the input's dtype "
                        f"{t.dtype}, got {wa.dtype}")
    if h <= 2 or w <= 2:
        raise ValueError(f"conv_pair_exit: reflect padding 2 needs H and W "
                         f"above it, got {h}x{w}")
    if t.dtype == torch.float32 and b > _GRID_Z_MAX:
        raise ValueError(f"conv_pair_exit: batch {b} too large for one "
                         f"launch")
    wak, wbk = pair_weights("exit", wa, wb)
    bak, bbk = _bias(ba), _bias(bb)
    y = torch.empty((b, h, w, 1), dtype=t.dtype, device=t.device)
    fn = kernel_function("mmif_conv_pair_exit",
                         [_I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I,
                          _P])
    with torch.cuda.device(t.device):
        err = fn(DTYPE_CODES[t.dtype], ptr(t), ptr(wak), ptr(bak),
                 act_code(act_a), ptr(wbk), ptr(bbk), act_code(act_b),
                 ptr(y), b, h, w, stream_handle(t.device))
    check_launch("conv_pair_exit", err)
    return y
