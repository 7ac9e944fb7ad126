"""Space-to-depth conv packing and the chain-route switches of the port
(counterpart of multi_modal_image_fusion_tpu ops/s2d.py and of the switch
of ops/pallas/hiw_kernel.py:50-59).

Packing f x f spatial phases into channels rewrites a k x k reflect-SAME
conv on (H, W, C) as a kp x kp conv on (H/f, W/f, f^2 C) with

    kp = 2*ceil((k//2)/f) + 1        (k7, f2 -> 5; k5, f2 -> 3)

Every original weight lands once per output phase of the packed kernel,
zero-padded to the kp x kp span, so the packed conv computes the same sums
(at (kp f / k)^2 times the products). Channels are phase-major: packed
channel (py*f + px)*C + c holds original pixel (f*y + py, f*x + px) of
channel c. For f == 2 the reflect halo of the packed tensor is the packed
reflect extension of the original image: a packed row r of phase py reads
packed row reflect(2r + py, 2H) // 2 of the same phase (reflection keeps
the parity), so phase 0 mirrors exclusively and phase 1 inclusively, and
they swap at the far edge (ops/cuda/conv_wide.py's s2d mode).

The switches, read at call time as the JAX package reads them:

- `MMIF_S2D` (`s2d_enabled`): DeepFuse's packed chain; '0'/'1' force,
  unset or 'auto' gives S2D_DEFAULT;
- `MMIF_S2D_IO` (`s2d_io_enabled`): the packed chain enters and exits
  through the s2d_enter / s2d_exit kernels (ops/cuda/s2d_io.py) where
  `s2d_io_ok` holds; S2D_IO_DEFAULT likewise;
- `MMIF_CHAIN_HIW` (`hiw_enabled`): in the JAX package the H-major chain
  route, taken before the packed chain when on (HIW_DEFAULT True). The
  port's default route computes the same function in either layout, so
  the switch decides routes only: `MMIF_S2D=1` reaches the packed chain
  with `MMIF_CHAIN_HIW=0`, as in the JAX package;
- `MMIF_CHAIN_PAIR` (`chain_pair_enabled`): DeepFuse's fused conv pairs
  (ops/cuda/conv_pair.py); any non-empty value, "0" included, is on, as
  the JAX package's `bool(os.environ.get(...))` reads it.

The JAX module's S2D_VMEM_BUDGET and MMIF_CHAIN_VMEM_BUDGET size the TPU
kernel's scoped VMEM; the port's kernels stage fixed tiles in shared
memory, so they are not ported.
"""

import math
import os

import torch
import torch.nn.functional as F

__all__ = ["HIW_DEFAULT", "S2D_DEFAULT", "S2D_IO_DEFAULT",
           "chain_pair_enabled", "hiw_enabled", "s2d_enabled",
           "s2d_flop_overhead", "s2d_io_enabled", "s2d_io_ok", "s2d_pack",
           "s2d_pack_bias", "s2d_pack_weights", "s2d_reflect_pad",
           "s2d_span", "s2d_unpack"]

S2D_DEFAULT = False
S2D_IO_DEFAULT = False
HIW_DEFAULT = True


def _switch(name, default):
    v = os.environ.get(name, "auto")
    if v in ("0", "1"):
        return v == "1"
    return default


def s2d_enabled():
    """MMIF_S2D: '1'/'0' force; unset/'auto' -> S2D_DEFAULT."""
    return _switch("MMIF_S2D", S2D_DEFAULT)


def s2d_io_enabled():
    """MMIF_S2D_IO: '1'/'0' force; unset/'auto' -> S2D_IO_DEFAULT."""
    return _switch("MMIF_S2D_IO", S2D_IO_DEFAULT)


def hiw_enabled():
    """MMIF_CHAIN_HIW: '1'/'0' force; unset/'auto' -> HIW_DEFAULT."""
    return _switch("MMIF_CHAIN_HIW", HIW_DEFAULT)


def chain_pair_enabled():
    """MMIF_CHAIN_PAIR: on for any non-empty value ("0" too)."""
    return bool(os.environ.get("MMIF_CHAIN_PAIR"))


def s2d_io_ok(h, w, dtype):
    """Where the JAX package runs its packed enter/exit kernels
    (ops/pallas/s2d_io.py:56): bf16, H % 8 == 0, W % 256 == 0, H >= 32."""
    return (dtype == torch.bfloat16 and h % 8 == 0 and w % 256 == 0
            and h >= 32)


def s2d_span(k, f):
    """Packed kernel span: 2*ceil((k//2)/f) + 1 (odd by construction)."""
    return 2 * math.ceil((k // 2) / f) + 1


def s2d_flop_overhead(k, f):
    """Product-count multiplier of the packed conv against the original."""
    return (s2d_span(k, f) * f / k) ** 2


def s2d_pack(x, f=2):
    """NHWC (B, H, W, C) -> (B, H/f, W/f, f*f*C), phase-major channels:
    packed[b, y, x, (py*f+px)*C + c] == x[b, y*f+py, x*f+px, c]."""
    b, h, w, c = x.shape
    if h % f or w % f:
        raise ValueError(f"s2d_pack: {h}x{w} is not a multiple of {f}")
    x = x.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // f, w // f, f * f * c)


def s2d_unpack(y, f=2):
    """Inverse of s2d_pack."""
    b, hf, wf, cp = y.shape
    c = cp // (f * f)
    y = y.reshape(b, hf, wf, f, f, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, hf * f, wf * f, c)


def s2d_pack_weights(w, f=2):
    """OIHW (C_out, C_in, k, k) -> (f^2 C_out, f^2 C_in, kp, kp): the JAX
    package's packed HWIO kernel, transposed. Output channel
    (phy*f+phx)*C_out + o, input channel (psy*f+psx)*C_in + i and tap
    (ty, tx) hold w[o, i, dy, dx] where dy = f*(ty - kp//2) + psy - phy +
    k//2 (dx likewise) lies in [0, k), else zero."""
    co, ci, k, _ = w.shape
    kp = s2d_span(k, f)
    lo = f - 1 + f * (kp // 2) - k // 2          # zeros before tap 0
    hi = max(0, f * (kp - 1) + 2 * f - 1 - lo - k)
    wz = F.pad(w, (lo, hi, lo, hi))
    # index of the padded tap for (phase of the output, phase of the
    # input, packed tap): f*t + ps + f - 1 - ph
    ph = torch.arange(f, device=w.device).view(f, 1, 1)
    ps = torch.arange(f, device=w.device).view(1, f, 1)
    t = torch.arange(kp, device=w.device).view(1, 1, kp)
    idx = f * t + ps + (f - 1 - ph)                     # (phy, psy, ty)
    g = wz[:, :, idx][..., idx]   # (co, ci, phy, psy, ty, phx, psx, tx)
    g = g.permute(2, 5, 0, 3, 6, 1, 4, 7)  # (phy, phx, co, psy, psx, ci, ty, tx)
    return g.reshape(f * f * co, f * f * ci, kp, kp).contiguous()


def s2d_pack_bias(b, f=2):
    """(C,) -> (f^2 C,): every phase gets the per-channel bias."""
    return b.repeat(f * f)


def _reflect(i, n):
    """torch ReflectionPad2d's source index of position i in [-(n-1), 2n-1)."""
    i = i.abs()
    return torch.where(i >= n, 2 * n - 2 - i, i)


def s2d_reflect_pad(x, p):
    """The packed reflect extension of an f = 2 packed NHWC tensor (B, H, W,
    4C) by p packed rows and columns: each phase's channel block gathered
    at packed row reflect(2r + py, 2H) // 2 and column reflect(2c + px,
    2W) // 2, r in [-p, H + p). Equals s2d_pack of the original image
    reflect-padded by 2p (the packed pad of the plain packed conv)."""
    b, h, w, c4 = x.shape
    cb = c4 // 4
    r = torch.arange(-p, h + p, device=x.device)
    c = torch.arange(-p, w + p, device=x.device)
    blocks = []
    for ph in range(4):
        rows = _reflect(2 * r + (ph >> 1), 2 * h) // 2
        cols = _reflect(2 * c + (ph & 1), 2 * w) // 2
        blocks.append(x[..., ph * cb:(ph + 1) * cb][:, rows][:, :, cols])
    return torch.cat(blocks, -1)
