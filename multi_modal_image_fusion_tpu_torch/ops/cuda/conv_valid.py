"""The train step's VALID conv kernels (csrc/conv_valid.cuh), with their
plain versions.

`conv_valid(xp, weight, bias, act)` replaces the TPU kernel
`ops/pallas/conv_kernel.py:161 conv_tlane_dma`: a k x k VALID conv of a
pre-padded NHWC input, xp (B, H+k-1, W+k-1, C_in), with an OIHW weight
(C_out, C_in, k, k), to (B, H, W, C_out) in xp's dtype, f32 accumulation,
and an optional bias + relu/relu6/lrelu 0.2/tanh epilogue.
`conv_valid_dx(dy, weight)` is the same kernel in its dx mode: the full
correlation of a cotangent dy (B, H, W, C_out) with the forward's own
weight, to dxp (B, H+k-1, W+k-1, C_in), the zero halo and the flipped taps
in the kernel's loads. `conv_valid_dw(xp, dy)` is the weight gradient,
(C_out, C_in, k, k) in f32, summed in a fixed order (the same bits every
run); it replaces no Pallas kernel (the JAX package leaves dw to XLA
einsums, `ops/pallas/conv_vjp.py:94-106`). Any C_in >= 1 and C_out >= 1;
k 3, 5 or 7; f32 (a 3xTF32 split on the tensor cores) or bf16, the weight in
the activations' dtype. What bounds them on an H100 and what the design
does about it is in the header of csrc/conv_valid.cuh.

CPU tensors take the plain versions (`conv_valid_plain`,
`conv_valid_dx_plain`, `conv_valid_dw_plain`); a CUDA tensor launches the
kernel or raises. The kernels are forward-only: the differentiable conv of
the train step is `conv_vjp.conv_valid_fast`, whose forward, dx and dw
launch them. `valid_plan` and `dw_plan` mirror the kernels' walks (the
tests check their coverage and waste on the CPU).
"""

import ctypes

import torch
import torch.nn.functional as F

from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle
from .conv_chain import DTYPE_CODES, act_code, apply_act, check_tensors

__all__ = ["conv_valid", "conv_valid_plain", "conv_valid_dx",
           "conv_valid_dx_plain", "conv_valid_dw", "conv_valid_dw_plain",
           "valid_plan", "dw_plan"]

KSIZES = (3, 5, 7)
TILE_M = 96           # output positions a tile (VA_BM)
TILE_PAIR = 2         # tiles a block computes at once, one N block (VA_SUB)
STRIP_ONE = 136       # output widths up to this are one strip
STRIP_W = 128         # strip width aimed at for wider outputs
DW_CB = 16            # input channels a dw block (DW_CB)
DW_QS = 64            # output pixels of a dw stage (DW_QS)
_GRID_Y_MAX = 65535

_I = ctypes.c_int
_P = ctypes.c_void_p


def pick_bn(n):
    """The N block (output channels a tile): 8, 16 or 32."""
    return 8 if n <= 8 else 16 if n <= 16 else 32


def valid_plan(h_out, w_out, k):
    """The conv_valid kernel's walk of one image's output: (tw, pitch,
    strips, tiles a strip). A strip is `tw` output columns, flattened at the
    pitch tw + k - 1; a tile is TILE_M consecutive flattened positions."""
    if w_out <= STRIP_ONE:
        tw = w_out
    else:
        n = -(-w_out // STRIP_W)
        tw = -(-w_out // n)
    pitch = tw + k - 1
    return tw, pitch, -(-w_out // tw), -(-(h_out * pitch) // TILE_M)


def dw_plan(b, h, cin, cout, k, slots):
    """conv_valid_dw's grid: (bn, groups, chunks). A group is (kh, a block
    of DW_CB input channels, an N block); the b * h output rows are split
    into `chunks` contiguous runs, one block each per group, as many as one
    wave of `slots` blocks (the card's multiprocessors times the blocks
    that fit on one) takes."""
    bn = pick_bn(cout)
    groups = k * -(-cin // DW_CB) * -(-cout // bn)
    chunks = max(1, min(b * h, slots // groups))
    return bn, groups, chunks


def _float_dt(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def conv_valid_plain(xp, weight, bias=None, act=None):
    """Plain version of conv_valid: F.conv2d on the NCHW-permuted input, in
    float64 for a float64 input (so gradcheck can run on it), else in f32,
    cast back to xp.dtype."""
    dt = _float_dt(xp)
    y = F.conv2d(xp.to(dt).permute(0, 3, 1, 2), weight.to(dt),
                 None if bias is None else bias.to(dt))
    return apply_act(y.permute(0, 2, 3, 1), act).to(xp.dtype).contiguous()


def conv_valid_dx_plain(dy, weight):
    """Plain version of conv_valid_dx: the full correlation of dy with the
    forward's OIHW weight, F.conv_transpose2d (the VALID conv of dy
    zero-padded by k-1 through the flipped, in/out-swapped taps), in f32
    (float64 for float64), cast back to dy.dtype."""
    dt = _float_dt(dy)
    dx = F.conv_transpose2d(dy.to(dt).permute(0, 3, 1, 2), weight.to(dt))
    return dx.permute(0, 2, 3, 1).to(dy.dtype).contiguous()


def conv_valid_dw_plain(xp, dy):
    """Plain version of conv_valid_dw, OIHW: per tap, the contraction of the
    shifted input with dy over (b, i, j), in f32 (float64 for float64)."""
    dt = _float_dt(xp)
    b, h, w, cout = dy.shape
    cin = xp.shape[-1]
    k = xp.shape[1] - h + 1
    x = xp.to(dt)
    d = dy.to(dt).reshape(-1, cout)
    taps = torch.stack([
        x[:, kh:kh + h, kw:kw + w, :].reshape(-1, cin).t() @ d
        for kh in range(k) for kw in range(k)])            # (k*k, Cin, Cout)
    return taps.view(k, k, cin, cout).permute(3, 2, 0, 1).contiguous()


def _check_weight(name, weight, x, cc, contraction_dim):
    if weight.dim() != 4 or weight.shape[2] != weight.shape[3]:
        raise ValueError(f"{name}: weight must be OIHW with square taps, "
                         f"got {tuple(weight.shape)}")
    k = weight.shape[-1]
    if k not in KSIZES:
        raise ValueError(f"{name}: kernel size {k} not built (one of "
                         f"{KSIZES})")
    if weight.shape[contraction_dim] != cc:
        raise ValueError(f"{name}: weight takes {weight.shape[contraction_dim]} "
                         f"channels, the input has {cc}")
    if weight.dtype != x.dtype:
        raise TypeError(f"{name}: weight dtype {weight.dtype} differs from "
                        f"the input's {x.dtype}")
    if weight.device != x.device:
        raise ValueError(f"{name}: weight must be on {x.device}")
    return k


def _launch(site, dx, x, weight, bias, act, out_hw):
    b, hin, win, cc = x.shape
    hout, wout = out_hw
    cn = weight.shape[1 if dx else 0]
    k = weight.shape[-1]
    wk = weight.detach().contiguous()
    bk = None if bias is None else bias.detach().float().contiguous()
    y = torch.empty((b, hout, wout, cn), dtype=x.dtype, device=x.device)
    tw = valid_plan(hout, wout, k)[0]
    fn = kernel_function("mmif_conv_valid",
                         [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _P])
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], int(dx), ptr(x), ptr(wk), ptr(bk),
                 ptr(y), b, hin, win, cc, cn, hout, wout, k, pick_bn(cn),
                 act_code(act), tw, stream_handle(x.device))
    check_launch("conv_valid", err, site)
    return y


def conv_valid(xp, weight, bias=None, act=None, site="valid"):
    """VALID conv: xp (B, H+k-1, W+k-1, Cin) NHWC, weight OIHW (Cout, Cin,
    k, k) -> (B, H, W, Cout) in xp.dtype. `site` names the caller in the
    launch count (`conv_valid/<site>`): "forward" for the train step's
    conv_valid_fast, "valid" for the fused valid-step conv."""
    if xp.device.type == "cpu":
        return conv_valid_plain(xp, weight, bias, act)
    check_no_grad("conv_valid", xp, weight, bias)
    check_tensors("conv_valid", [xp])
    b, hp, wp, cin = xp.shape
    k = _check_weight("conv_valid", weight, xp, cin, 1)
    if bias is not None and (bias.device != xp.device
                             or bias.shape != (weight.shape[0],)):
        raise ValueError(f"conv_valid: bias must be ({weight.shape[0]},) on "
                         f"{xp.device}")
    h, w = hp - k + 1, wp - k + 1
    if h < 1 or w < 1:
        raise ValueError(f"conv_valid: padded input {hp}x{wp} is smaller "
                         f"than the {k}x{k} window")
    return _launch(site, False, xp, weight, bias, act, (h, w))


def conv_valid_dx(dy, weight):
    """dx of the VALID conv: dy (B, H, W, Cout) NHWC, the forward's weight
    OIHW (Cout, Cin, k, k) -> dxp (B, H+k-1, W+k-1, Cin) in dy.dtype, the
    full correlation (counted as `conv_valid/dx`)."""
    if dy.device.type == "cpu":
        return conv_valid_dx_plain(dy, weight)
    check_no_grad("conv_valid_dx", dy, weight)
    check_tensors("conv_valid_dx", [dy])
    b, h, w, cout = dy.shape
    k = _check_weight("conv_valid_dx", weight, dy, cout, 0)
    return _launch("dx", True, dy, weight, None, None, (h + k - 1, w + k - 1))


_TICKETS = {}
_DW_SLOTS = {}


def _dw_slots(device, dtype, k, bn):
    """Blocks of one wave of the conv_valid_dw instance on the card."""
    key = (device, dtype, k, bn)
    if key not in _DW_SLOTS:
        fn = kernel_function("mmif_conv_valid_dw_blocks", [_I, _I, _I])
        with torch.cuda.device(device):
            per_sm = fn(DTYPE_CODES[dtype], k, bn)
        if per_sm < 1:
            raise RuntimeError(f"conv_valid_dw: k{k} bn{bn} {dtype} fits no "
                               f"block on a multiprocessor")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _DW_SLOTS[key] = sms * per_sm
    return _DW_SLOTS[key]


def _tickets(device, n):
    """Per-device ticket counters of the dw reduction: zeros, and left zero
    by every launch (the last block of a group resets its counter)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def conv_valid_dw(xp, dy):
    """Weight gradient of the VALID conv: xp (B, H+k-1, W+k-1, Cin) and dy
    (B, H, W, Cout), NHWC, one dtype -> dw (Cout, Cin, k, k) in f32 (float64
    for float64 on the CPU), summed in a fixed order."""
    if xp.device.type == "cpu":
        return conv_valid_dw_plain(xp, dy)
    check_no_grad("conv_valid_dw", xp, dy)
    check_tensors("conv_valid_dw", [xp, dy])
    b, hp, wp, cin = xp.shape
    b2, h, w, cout = dy.shape
    k = hp - h + 1
    if b2 != b or k not in KSIZES or wp - w + 1 != k:
        raise ValueError(f"conv_valid_dw: xp {tuple(xp.shape)} and dy "
                         f"{tuple(dy.shape)} are no VALID conv of k in "
                         f"{KSIZES}")
    if dy.dtype != xp.dtype:
        raise TypeError(f"conv_valid_dw: dy dtype {dy.dtype} differs from "
                        f"xp's {xp.dtype}")
    bn, groups, chunks = dw_plan(
        b, h, cin, cout, k, _dw_slots(xp.device, xp.dtype, k, pick_bn(cout)))
    if groups > _GRID_Y_MAX:
        raise ValueError(f"conv_valid_dw: {cin} -> {cout} channels at k{k} "
                         f"is more than one launch takes")
    part = torch.empty(groups * chunks * k * DW_CB * bn, dtype=torch.float32,
                       device=xp.device)
    dw = torch.empty((cout, cin, k, k), dtype=torch.float32,
                     device=xp.device)
    fn = kernel_function("mmif_conv_valid_dw",
                         [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P])
    with torch.cuda.device(xp.device):
        err = fn(DTYPE_CODES[xp.dtype], ptr(xp), ptr(dy), ptr(part),
                 ptr(_tickets(xp.device, groups)), ptr(dw), b, h, w, cin,
                 cout, k, bn, chunks, stream_handle(xp.device))
    check_launch("conv_valid_dw", err)
    return dw
