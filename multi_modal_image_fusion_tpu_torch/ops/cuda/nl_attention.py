"""Non-local spatial attention kernels (csrc/nl_attention.cu) with their
plain versions.

Replaces the TPU kernel `ops/pallas/nl_kernel.py:132 nl_spatial_flash`,
the attention of the 'nl' spatial pooling (JAX ops/fusion.py:144-170): q
(B, N, C) is every pixel of a feature map, k (B, M, C) its 8x8 average
pool, and the result (B, N, C), in q's dtype and without the +q residual,
is

    softmax((q k^T - lo) / (hi - lo)) k

where lo and hi are the min and max of q k^T over the whole batch. Two
kernels, each with its own wrapper and launch count:

- `nl_minmax(q, k)` -> (2,) f32 tensor (lo, hi) on q's device (pass 1,
  the TPU kernel's `_nl_minmax_kernel`);
- `nl_apply(q, k, lohi)` -> the attention output (pass 2,
  `_nl_apply_kernel`).

`nl_spatial_flash(q, k)` runs both. The kernels are built for C = 112
(Res2Fusion's attention) and raise on other channel counts. Products
accumulate in f32. The f32 path is f32 throughout (FMAs on the CUDA cores),
as the JAX package's precision="float32" einsums; bf16 runs both products
as warp-specialised `wgmma` on the tensor cores over a ring of key tiles
that the wrapper first repacks (`pack_keys`, counted in each launch's
time) and, as the TPU kernel does, rounds the unnormalised weights exp(s)
to bf16 before the value product. What bounds the kernels on an H100 and
what their design does about it is in the header of csrc/nl_attention.cu.

The plain versions are the JAX package's two-pass blocked math
(`_nl_spatial_blocked`, ops/fusion.py:176-216) over blocks of `block`
query rows; with one block (block >= N) they are its dense math
(fusion.py:157-165). In bf16 the normalised weights are cast to bf16
before the value product, as JAX does; `nl_apply_flash_plain` is pass 2
with the TPU kernel's rounding instead (nl_kernel.py:116-120), the
function the bf16 kernel computes. CPU tensors take the plain versions; a
CUDA tensor launches the kernels or raises. The kernels are forward-only:
on a CUDA tensor that needs a gradient they raise (the custom-VJP
counterpart of `_nl_spatial_flash_diff` comes with Res2Fusion training).
hi == lo gives NaN, as in JAX.
"""

import ctypes

import torch

from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle
from .conv_chain import DTYPE_CODES

__all__ = ["nl_apply", "nl_apply_flash_plain", "nl_apply_plain",
           "nl_minmax", "nl_minmax_plain", "nl_spatial_flash",
           "nl_spatial_plain", "pack_keys", "unpack_keys"]

BLOCK = 4096           # query rows a block of the plain versions
NL_C = 112             # the channels the kernels are built for
KEY_TILE = 64          # keys a staged tile of the bf16 kernels
_BQ = 64               # fewest query rows a kernel block (part's size)
_GRID_Y_MAX = 65535

_I = ctypes.c_int
_P = ctypes.c_void_p


def _energy(q_blk, k):
    """(B, n, C) x (B, M, C) -> (B, n, M) f32, the products in f32."""
    return torch.matmul(q_blk.float(), k.float().transpose(1, 2))


def nl_minmax_plain(q, k, block=BLOCK):
    """Plain pass 1: (lo, hi) of q k^T over the whole batch, (2,) f32."""
    lo = hi = None
    for i in range(0, q.shape[1], block):
        e = _energy(q[:, i:i + block], k)
        blo, bhi = e.min(), e.max()
        lo = blo if lo is None else torch.minimum(lo, blo)
        hi = bhi if hi is None else torch.maximum(hi, bhi)
    return torch.stack([lo, hi])


def nl_apply_plain(q, k, lohi, block=BLOCK):
    """Plain pass 2: softmax((q k^T - lo) / (hi - lo)) k per block of query
    rows, in q's dtype."""
    lo, hi = lohi[0], lohi[1]
    out = torch.empty_like(q)
    for i in range(0, q.shape[1], block):
        e = (_energy(q[:, i:i + block], k) - lo) / (hi - lo)
        a = torch.softmax(e, dim=-1).to(k.dtype)
        out[:, i:i + block] = torch.matmul(a.float(), k.float()).to(q.dtype)
    return out


def nl_apply_flash_plain(q, k, lohi, block=BLOCK):
    """Plain pass 2 with the TPU kernel's rounding (nl_kernel.py:116-120):
    p = exp((q k^T - lo) / (hi - lo)) in f32, the value product on p
    rounded to k's dtype, the row sums of the f32 p, one divide, the result
    in q's dtype."""
    lo, hi = lohi[0], lohi[1]
    out = torch.empty_like(q)
    for i in range(0, q.shape[1], block):
        p = torch.exp((_energy(q[:, i:i + block], k) - lo) / (hi - lo))
        acc = torch.matmul(p.to(k.dtype).float(), k.float())
        out[:, i:i + block] = (acc / p.sum(-1, keepdim=True)).to(out.dtype)
    return out


def nl_spatial_plain(q, k, block=BLOCK):
    """Plain version of nl_spatial_flash: the two passes over blocks of
    `block` query rows (JAX `_nl_spatial_blocked`; block >= N is the dense
    math)."""
    return nl_apply_plain(q, k, nl_minmax_plain(q, k, block), block)


def pack_keys(k):
    """k (B, M, C) -> the bf16 kernels' staged layout (B, Mp / 8, C / 8, 8,
    8), Mp = M rounded up to KEY_TILE with zero keys:

        packed[b, m // 8, c // 8, m % 8, c % 8] = k[b, m, c]

    Each 8 keys x 8 channels is one 128-byte wgmma core matrix, and a tile
    of KEY_TILE keys is KEY_TILE * C contiguous values (one bulk copy)."""
    b, m, c = k.shape
    mp = -(-m // KEY_TILE) * KEY_TILE
    kp = torch.nn.functional.pad(k, (0, 0, 0, mp - m))
    return kp.view(b, mp // 8, 8, c // 8, 8).permute(0, 1, 3, 2, 4) \
        .contiguous()


def unpack_keys(kp, m):
    """The inverse of pack_keys: (B, Mp / 8, C / 8, 8, 8) -> (B, m, C)."""
    b, groups, cgroups = kp.shape[:3]
    return kp.permute(0, 1, 3, 2, 4).reshape(b, groups * 8, cgroups * 8)[:, :m]


def _kernel_keys(k):
    """k as the kernels take it: packed in bf16, as it is in f32."""
    return pack_keys(k) if k.dtype == torch.bfloat16 else k


def _check(name, q, k):
    for t in (q, k):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported (float32 "
                            f"or bfloat16)")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expects contiguous, 16-byte aligned "
                             f"(B, rows, C) tensors, got {tuple(t.shape)}")
    if k.dtype != q.dtype:
        raise TypeError(f"{name}: q and k dtypes differ")
    b, n, c = q.shape
    if k.shape[0] != b or k.shape[2] != c:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or channels")
    if c != NL_C or n < 1 or k.shape[1] < 1:
        raise ValueError(f"{name}: built for C = {NL_C} and N, M at least "
                         f"1, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if b > _GRID_Y_MAX:
        raise ValueError(f"{name}: batch {b} too large for one launch")
    if not q.is_cuda or k.device != q.device:
        raise ValueError(f"{name}: q and k must be on one CUDA device")
    return b, n, k.shape[1], c


def nl_minmax(q, k):
    """(lo, hi) of q k^T over the whole batch: a (2,) f32 tensor on q's
    device (pass 1)."""
    if q.device.type == "cpu":
        return nl_minmax_plain(q, k)
    check_no_grad("nl_minmax", q, k)
    b, n, m, c = _check("nl_minmax", q, k)
    part = torch.empty((b * -(-n // _BQ), 2), dtype=torch.float32,
                       device=q.device)
    lohi = torch.empty(2, dtype=torch.float32, device=q.device)
    keys = _kernel_keys(k)
    fn = kernel_function("mmif_nl_minmax",
                         [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODES[q.dtype], ptr(q), ptr(keys), ptr(part),
                 ptr(lohi), b, n, m, c, stream_handle(q.device))
    check_launch("nl_minmax", err)
    return lohi


def nl_apply(q, k, lohi):
    """softmax((q k^T - lo) / (hi - lo)) k in q's dtype, lohi = (lo, hi) as
    nl_minmax returns it (pass 2)."""
    if q.device.type == "cpu":
        return nl_apply_plain(q, k, lohi)
    check_no_grad("nl_apply", q, k)
    b, n, m, c = _check("nl_apply", q, k)
    if (lohi.device != q.device or lohi.dtype != torch.float32
            or lohi.shape != (2,)):
        raise ValueError("nl_apply: lohi must be a (2,) float32 tensor on "
                         "q's device")
    lohi = lohi.contiguous()
    out = torch.empty_like(q)
    keys = _kernel_keys(k)
    fn = kernel_function("mmif_nl_apply",
                         [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODES[q.dtype], ptr(q), ptr(keys), ptr(lohi),
                 ptr(out), b, n, m, c, stream_handle(q.device))
    check_launch("nl_apply", err)
    return out


def nl_spatial_flash(q, k):
    """Non-local spatial attention of q (B, N, C) over k (B, M, C), without
    the +q residual, in q's dtype: both passes."""
    if q.device.type == "cpu":
        return nl_spatial_plain(q, k)
    return nl_apply(q, k, nl_minmax(q, k))
