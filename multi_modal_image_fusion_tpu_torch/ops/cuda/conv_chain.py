"""Reflect-SAME conv kernels of the DeepFuse chain, with their plain versions.

Three wrappers over csrc/conv_chain.cu, all NHWC, f32 accumulation:

- `conv_chain(x, weight, bias, act, fuse_n)` replaces the TPU kernel
  `ops/pallas/hiw_kernel.py:335 conv_hiw_chain`: a k x k reflect-SAME conv
  with bias and activation; with `fuse_n > 0` the input holds 2n images and
  the kernel convolves x[i] + x[i+n] (the siamese 'sum' fusion in the load).
- `conv_gray_enter(img1, img2, weight, ...)` replaces
  `ops/pallas/conv_kernel.py:357 _chain_enter_gray` (reached by
  `hiw_enter`) together with the c_in=1 entry conv: it reads the grayscale
  pair directly, so the concat, the cast to the chain dtype and the reflect
  halo all happen in its load.
- `conv_gray_exit(x, weight, ...)` replaces
  `ops/pallas/conv_kernel.py:383 _chain_exit_gray` (reached by `hiw_exit`)
  together with the c_out=1 exit conv, writing (B, H, W, 1) directly.

What bounds them on an H100 and what the design does about it is in the
header of csrc/conv_chain.cu: the wide layers are bound by arithmetic and
run as register-blocked f32 FMAs on the CUDA cores; the thin enter/exit
layers have their own loops.

Each wrapper takes its plain version (`*_plain`, F.pad + F.conv2d in f32)
only for CPU tensors. A CUDA tensor launches the kernel or raises; there is
no fallback. The kernels are forward-only: on a CUDA tensor with grad mode
on and an input, weight or bias that requires grad, the wrappers raise
(training goes through ops/cuda/conv_vjp.py). They are built for
what DeepFuse launches: `conv_chain` k5 and k7, `conv_gray_enter` and
`conv_gray_exit` k5, output channels a multiple of 16 (but the exit's 1),
input and output in one dtype. The wrappers raise on anything else.
"""

import ctypes

import torch
import torch.nn.functional as F

from .build import check_launch, check_no_grad, kernel_function, ptr, \
    stream_handle

__all__ = ["ACT_CODES", "apply_act", "conv_chain", "conv_chain_plain",
           "conv_gray_enter", "conv_gray_enter_plain", "conv_gray_exit",
           "conv_gray_exit_plain"]

# epilogue activations the kernels fuse (csrc/common.cuh Act; the TPU
# kernels' _apply_act, ops/pallas/conv_kernel.py:43)
ACT_CODES = {None: 0, "relu": 1, "relu6": 2, "lrelu": 3, "tanh": 4}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CO_TILE = 16          # output channels per block (csrc/conv_chain.cu)
_GRID_Z_MAX = 65535

_I = ctypes.c_int
_P = ctypes.c_void_p


def apply_act(y, act):
    """The fused epilogue activation (f32, before the output cast)."""
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if act == "lrelu":
        return F.leaky_relu(y, 0.2)
    if act == "tanh":
        return torch.tanh(y)
    raise ValueError(f"unfusable activation {act!r}")


def _conv_nhwc_f32(x, weight, bias):
    """f32 reflect-SAME conv of an NHWC tensor (OIHW weight)."""
    p = weight.shape[-1] // 2
    xn = F.pad(x.float().permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    y = F.conv2d(xn, weight.float(),
                 None if bias is None else bias.float())
    return y.permute(0, 2, 3, 1).contiguous()


def conv_chain_plain(x, weight, bias=None, act=None, fuse_n=0):
    """Plain version of conv_chain: the same function in f32, cast back to
    x.dtype."""
    xf = x.float()
    if fuse_n:
        xf = xf[:fuse_n] + xf[fuse_n:]
    return apply_act(_conv_nhwc_f32(xf, weight, bias), act).to(x.dtype)


def conv_gray_enter_plain(img1, img2, weight, bias=None, act="relu"):
    """Plain version of conv_gray_enter."""
    x = img1 if img2 is None else torch.cat([img1, img2], dim=0)
    return apply_act(_conv_nhwc_f32(x, weight, bias), act).to(img1.dtype)


def conv_gray_exit_plain(x, weight, bias=None, act=None):
    """Plain version of conv_gray_exit."""
    return apply_act(_conv_nhwc_f32(x, weight, bias), act).to(x.dtype)


def check_tensors(name, tensors):
    """The CUDA wrappers' contract on activations: one CUDA device, f32 or
    bf16, contiguous 4-D (NHWC), 16-byte aligned."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on the same "
                             f"CUDA device")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported "
                            f"(float32 or bfloat16)")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous NHWC tensors, got "
                             f"shape {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def _check_cuda_args(name, tensors, weight, bias, h, w, ksizes):
    check_tensors(name, tensors)
    dev = tensors[0].device
    if weight.dim() != 4 or weight.shape[2] != weight.shape[3]:
        raise ValueError(f"{name}: weight must be OIHW with square taps, "
                         f"got {tuple(weight.shape)}")
    k = weight.shape[-1]
    if k not in ksizes:
        raise ValueError(f"{name}: kernel size {k} not built "
                         f"(one of {ksizes})")
    if h <= k // 2 or w <= k // 2:
        raise ValueError(f"{name}: reflect padding {k // 2} needs H and W "
                         f"above it, got {h}x{w}")
    if weight.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"{name}: weight and bias must be on {dev}")
    return k


def weights_f32(weight, bias):
    """OIHW -> [Cin][K][K][Cout] f32 for the kernels' weight slices."""
    wk = weight.detach().permute(1, 2, 3, 0).float().contiguous()
    bk = None if bias is None else bias.detach().float().contiguous()
    return wk, bk


def act_code(act):
    if act not in ACT_CODES:
        raise ValueError(f"unfusable activation {act!r}")
    return ACT_CODES[act]


def conv_chain(x, weight, bias=None, act=None, fuse_n=0):
    """Reflect-SAME conv: x (B, H, W, Cin) NHWC, weight OIHW (Cout, Cin, K,
    K) -> (B_out, H, W, Cout) in x.dtype, B_out = fuse_n or B. fuse_n > 0:
    x holds 2*fuse_n images and output i is conv(x[i] + x[i + fuse_n])."""
    if x.device.type == "cpu":
        return conv_chain_plain(x, weight, bias, act, fuse_n)
    check_no_grad("conv_chain", x, weight, bias)
    b_in, h, w, cin = x.shape
    k = _check_cuda_args("conv_chain", [x], weight, bias, h, w, (5, 7))
    cout = weight.shape[0]
    if weight.shape[1] != cin:
        raise ValueError(f"conv_chain: weight takes {weight.shape[1]} input "
                         f"channels, x has {cin}")
    if cout % _CO_TILE:
        raise ValueError(f"conv_chain: Cout must be a multiple of "
                         f"{_CO_TILE}, got {cout}")
    if fuse_n and b_in != 2 * fuse_n:
        raise ValueError(f"conv_chain: fuse_n={fuse_n} needs {2 * fuse_n} "
                         f"input images, got {b_in}")
    b_out = fuse_n or b_in
    if b_out * (cout // _CO_TILE) > _GRID_Z_MAX:
        raise ValueError(f"conv_chain: batch {b_out} too large for one "
                         f"launch")
    wk, bk = weights_f32(weight, bias)
    y = torch.empty((b_out, h, w, cout), dtype=x.dtype, device=x.device)
    fn = kernel_function("mmif_conv_chain",
                         [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P])
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], ptr(x), ptr(wk), ptr(bk), ptr(y),
                 b_out, h, w, cin, cout, k, fuse_n, act_code(act),
                 stream_handle(x.device))
    check_launch("conv_chain", err)
    return y


def conv_gray_enter(img1, img2, weight, bias=None, act="relu"):
    """c_in=1 entry conv of the chain: img1 (B, H, W, 1) and the optional
    img2 (same shape and dtype), weight (Cout, 1, K, K) -> (B or 2B, H, W,
    Cout) in the images' dtype, img1's batch first."""
    if img1.device.type == "cpu":
        return conv_gray_enter_plain(img1, img2, weight, bias, act)
    check_no_grad("conv_gray_enter", img1, img2, weight, bias)
    b, h, w, c = img1.shape
    imgs = [img1] if img2 is None else [img1, img2]
    k = _check_cuda_args("conv_gray_enter", imgs, weight, bias, h, w, (5,))
    cout = weight.shape[0]
    if c != 1 or weight.shape[1] != 1:
        raise ValueError("conv_gray_enter: inputs and weight must have one "
                         "channel")
    if img2 is not None and img2.shape != img1.shape:
        raise ValueError("conv_gray_enter: img1 and img2 shapes differ")
    if img2 is not None and img2.dtype != img1.dtype:
        raise TypeError("conv_gray_enter: img1 and img2 dtypes differ")
    if cout % _CO_TILE:
        raise ValueError(f"conv_gray_enter: Cout must be a multiple of "
                         f"{_CO_TILE}, got {cout}")
    b_out = b * len(imgs)
    if b_out * (cout // _CO_TILE) > _GRID_Z_MAX:
        raise ValueError(f"conv_gray_enter: batch {b} too large for one "
                         f"launch")
    wk, bk = weights_f32(weight, bias)
    y = torch.empty((b_out, h, w, cout), dtype=img1.dtype,
                    device=img1.device)
    fn = kernel_function("mmif_conv_gray_enter",
                         [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P])
    with torch.cuda.device(img1.device):
        err = fn(DTYPE_CODES[img1.dtype], ptr(img1), ptr(img2), ptr(wk),
                 ptr(bk), ptr(y), b, h, w, cout, k, act_code(act),
                 stream_handle(img1.device))
    check_launch("conv_gray_enter", err)
    return y


def conv_gray_exit(x, weight, bias=None, act=None):
    """c_out=1 exit conv of the chain: x (B, H, W, Cin), weight (1, Cin, K,
    K) -> (B, H, W, 1) in x.dtype."""
    if x.device.type == "cpu":
        return conv_gray_exit_plain(x, weight, bias, act)
    check_no_grad("conv_gray_exit", x, weight, bias)
    b, h, w, cin = x.shape
    k = _check_cuda_args("conv_gray_exit", [x], weight, bias, h, w, (5,))
    if weight.shape[0] != 1 or weight.shape[1] != cin:
        raise ValueError(f"conv_gray_exit: weight {tuple(weight.shape)} "
                         f"does not map {cin} channels to 1")
    if b > _GRID_Z_MAX:
        raise ValueError(f"conv_gray_exit: batch {b} too large for one "
                         f"launch")
    wk, bk = weights_f32(weight, bias)
    y = torch.empty((b, h, w, 1), dtype=x.dtype, device=x.device)
    fn = kernel_function("mmif_conv_gray_exit",
                         [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], ptr(x), ptr(wk), ptr(bk), ptr(y),
                 b, h, w, cin, k, act_code(act), stream_handle(x.device))
    check_launch("conv_gray_exit", err)
    return y
