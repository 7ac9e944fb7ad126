"""Device times of the bf16 `wgmma` conv layers of DeepFuse, DenseFuse,
VIFNet, Res2Fusion and UNFusion's encoder, of the models' enter and exit
convs, of DeepFuse's pair kernels, and of their benches, from one checkout
of the port: run it once per checkout, in turns, to compare two commits on
one card. With `--int8`, the same for the int8 kernels (rows 11 and 12) and
the `--int8` benches. With `--valid`, also rows 8 and 15: the train step's conv
launches, each layer's forward and backward and the whole train step,
against their library calls, in five rounds. With `--metrics`, instead of the
conv layers, rows 4 and 6: `ssim_maps` and `moments` at every shape the test
and eval CLIs launch, each as a raw launch of its C entry and as a wrapper
call, and one `eval_metrics` chunk.

    python multi_modal_image_fusion_tpu_torch/ab_times.py --root <checkout>
        [--tag parent] [--benches deepfuse,deepfuse_pair,densefuse,...]
        [--int8] [--profile densefuse] [--valid] [--metrics]
        [--dw [--against <checkout>]]

`--root` is the checkout whose `multi_modal_image_fusion_tpu_torch` is
imported (and built, into its own `_build/`); the layers are called through
the wrappers whose signatures every checkout since the `wgmma` body shares
(`conv_chain`, `conv_multi`, `conv_gray_enter`, `conv_gray_exit`,
`conv_pair_enter`, `conv_pair_exit`, `conv_valid`; with `--int8` every
checkout since the int8 kernels': `conv_int8` on one tensor,
`conv_int8_chain`). Layers: bf16, 16 pairs of 1224x1024 (DeepFuse enc1 and
dec0, DenseFuse dec0, VIFNet dec0; UNFusion's encoder convs at their scale,
32 images; Res2Fusion's RB2 pwconv1 at 2 pairs, its bench batch); the
enter and exit convs (`gray_cases`: DeepFuse enc0 and dec2 k5, DenseFuse
conv_in and dec3 k3, UNFusion conv_out k1, DBNet's 32-channel enter) in
bf16 at 16 pairs and DeepFuse's two in f32 at the test CLI's one pair;
DeepFuse's pair kernels (`pair_cases`: enc0 + enc1, dec1 + dec2) likewise;
`--int8`: DeepFuse's chain legs
(enc1 to int8, dec0 int8 with fuse_n to int8, dec1 int8 to bf16),
DenseFuse's dense2 and dec0 (their concat) and UNFusion's DB3_1 conv1
(1280 -> 640 at 306x256), bf16 16 pairs. `--valid`: the nine conv_valid
launches of a DeepFuse train step (f32, 16 patches of 64x64: five
forwards, four dx) against F.conv2d and torch.nn.grad.conv2d_input on the
same inputs (TF32 off), each layer's forward and backward through
conv_valid_fast against F.conv2d's autograd, and Trainer.train_step by
wall clock, each timed once a round, kernel then library; the train
step's device time and launches by torch.profiler. `--metrics`
(`window_cases`): `ssim_maps` at the test CLI's pair (1x1224x1024) and an
eval chunk's five MS-SSIM levels (16 pairs, 1224x1024 to 77x64), `moments` at
the chunk's four VIF scales (1224x1024 ws 17 to 150x125 ws 3), each raw (the
C entry, whose arguments every checkout of the port shares, on outputs
allocated beforehand), as a wrapper call and as the wrapper's host time a
call (host clock over 50 calls, no synchronisation inside); and
`eval_metrics` on one chunk of 16 pairs by wall clock (the median of 5
synchronised calls) and by CUDA events. With `--dw`, instead of the conv
layers, row 1's depthwise instance: the 12 `conv_dw` launches of a
Res2Fusion forward (`dw_cases`: RB1 dw0-dw3, RB2 dw0-dw7) at the
res2fusion bench's 4x1224x1024 in bf16 and the test CLI's 2x1224x1024 in
f32, each raw (the C entry, whose arguments are those of the kernel's
first version, on taps packed and an output allocated beforehand), raw on
a contiguous copy of the window (what reading the window in place costs),
as a wrapper call and as the wrapper's host time a call; with `--against
<checkout>` also the largest difference between this checkout's outputs
and that checkout's (its library built and loaded beside this one) on the
same inputs; the bench default is res2fusion.
Random centred inputs from a
seed; each time the mean of 5 cold-L2 runs (CUDA events, a 256 MB write
between runs) after a warmup. Benches: `bench.run` (10 timed forwards
after one warmup; `deepfuse_pair` is DeepFuse under MMIF_CHAIN_PAIR=1;
`--int8`: DeepFuse, DenseFuse and UNFusion under
`--int8`). `--profile NAME`: one `--int8` forward of NAME at the bench's
shapes under torch.profiler, its device time by op name (the largest 15).
Prints one JSON line with the card, the tag, the layers' ms and the
benches' pairs/s (and the profile, and row 8's rounds). Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

H, W, PAIRS = 1224, 1024, 16
REPS = 5


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def layer_cases():
    """(name, kernel, [leg channels], c_out, k, fuse_n, images, h, w): the
    legs are read at b_off 0, each image of fuse_n layers twice."""
    full = [("deepfuse.enc1", "conv_chain", [16], 32, 7, 0, 2 * PAIRS),
            ("deepfuse.dec0", "conv_chain", [32], 32, 7, PAIRS, PAIRS),
            ("densefuse.dec0", "conv_multi", [16] * 4, 64, 3, PAIRS, PAIRS),
            ("vifnet.dec0", "conv_multi", [16] * 8, 128, 3, 0, PAIRS)]
    cases = [(n, kern, c, co, k, f, b, H, W) for n, kern, c, co, k, f, b
             in full]
    cases.append(("res2fusion.RB2.pwconv1", "conv_multi", [16, 32], 384, 1,
                  0, 4, H, W))
    for name, cin, cout, lvl in (("EB3_1.conv2", 40, 96, 2),
                                 ("EB4_1.conv2", 56, 128, 3),
                                 ("EB4_2.conv2", 144, 304, 3),
                                 ("EB4_3.conv2", 376, 1024, 3)):
        cases.append((f"unfusion.{name}", "conv_chain", [cin], cout, 3, 0,
                      2 * PAIRS, H >> lvl, W >> lvl))
    return cases


def gray_cases():
    """(name, kernel, c_in, c_out, k, act, pairs, dtype): the enter reads
    both images of each pair, the exit one image a pair."""
    cases = [("deepfuse.enc0", "conv_gray_enter", 1, 16, 5, "relu"),
             ("deepfuse.dec2", "conv_gray_exit", 16, 1, 5, None),
             ("densefuse.conv_in", "conv_gray_enter", 1, 16, 3, "relu"),
             ("densefuse.dec3", "conv_gray_exit", 16, 1, 3, None),
             ("unfusion.conv_out", "conv_gray_exit", 16, 1, 1, "relu"),
             ("dbnet.encode", "conv_gray_enter", 1, 32, 3, "relu")]
    out = [c + (PAIRS, "bf16") for c in cases]
    return out + [(f"{c[0]}.f32",) + c[1:] + (1, "f32") for c in cases[:2]]


def gray_layer(torch, case, gen, dev):
    """The call of one enter or exit case on seeded inputs and weights."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        conv_gray_enter, conv_gray_exit)
    _, kern, cin, cout, k, act, n, dt = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    wt = ((torch.rand((cout, cin, k, k), generator=gen, device=dev) - 0.5)
          * 0.4).to(dtype)
    bias = torch.rand((cout,), generator=gen, device=dev) - 0.5
    if kern == "conv_gray_enter":
        a, b = (torch.rand((n, H, W, 1), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        return lambda: conv_gray_enter(a, b, wt, bias, act)
    x = (torch.rand((n, H, W, cin), generator=gen, device=dev)
         - 0.5).to(dtype)
    return lambda: conv_gray_exit(x, wt, bias, act)


def pair_cases():
    """(name, kind, pairs, dtype): DeepFuse's pair kernels (row 10) as the
    MMIF_CHAIN_PAIR route launches them."""
    cases = [("deepfuse.pair_enter", "enter"), ("deepfuse.pair_exit", "exit")]
    return ([c + (PAIRS, "bf16") for c in cases]
            + [(f"{c[0]}.f32", c[1], 1, "f32") for c in cases])


def pair_layer(torch, case, gen, dev):
    """The call of one pair case on seeded inputs and weights."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
        ENTER_SHAPES, EXIT_SHAPES, conv_pair_enter, conv_pair_exit)
    _, kind, n, dt = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    wa, wb = (((torch.rand(s, generator=gen, device=dev) - 0.5)
               * (2.0 / (s[1] * s[2] * s[3]) ** 0.5)).to(dtype)
              for s in (ENTER_SHAPES if kind == "enter" else EXIT_SHAPES))
    ba = torch.rand((wa.shape[0],), generator=gen, device=dev) - 0.5
    bb = torch.rand((wb.shape[0],), generator=gen, device=dev) - 0.5
    if kind == "enter":
        a, b = (torch.rand((n, H, W, 1), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        return lambda: conv_pair_enter(a, b, wa, ba, "relu", wb, bb, "relu")
    x = (torch.rand((n, H, W, 32), generator=gen, device=dev)
         - 0.5).to(dtype)
    return lambda: conv_pair_exit(x, wa, ba, "relu", wb, bb, None)


# a DeepFuse train step's VALID convs (f32, 64x64 patches): (name, images,
# c_in, c_out, k); a dx launch for each but enc0
VALID = [("enc0", 32, 1, 16, 5), ("enc1", 32, 16, 32, 7),
         ("dec0", 16, 32, 32, 7), ("dec1", 16, 32, 16, 5),
         ("dec2", 16, 16, 1, 5)]


def valid_rounds(torch, timed, gen, dev, rounds=5):
    """Rows 8 and 15: each train-step launch of conv_valid and its library
    call (F.conv2d forward, conv2d_input dx; the dx through `conv_valid_dx`
    where the checkout has it, else through `conv_valid` on the padded
    cotangent with the flipped weight, made outside the timing); each
    layer's forward and backward through `conv_valid_fast` (torch.autograd
    .grad on xp and w, w alone for enc0, whose input needs none) against
    F.conv2d's autograd; and `Trainer.train_step` (DeepFuse, f32, fast) by
    wall clock (the median of 10 synchronised steps). Each timed once a
    round, kernel then library; then the steps' device time a step
    (torch.profiler over 10 steps)."""
    import numpy as np
    import torch.nn.functional as F

    from multi_modal_image_fusion_tpu_torch.ops.cuda import conv_valid as cv
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_vjp import \
        conv_valid_fast
    calls = {}
    for name, b, cin, cout, k in VALID:
        wt = (torch.rand((cout, cin, k, k), generator=gen, device=dev)
              - 0.5) * 0.2
        x = torch.rand((b, 63 + k, 63 + k, cin), generator=gen,
                       device=dev) - 0.5
        xn = x.permute(0, 3, 1, 2).contiguous()
        calls[f"{name}.fwd"] = (
            lambda x=x, wt=wt: cv.conv_valid(x, wt, None, None, "forward"),
            lambda xn=xn, wt=wt: F.conv2d(xn, wt))
        dy = torch.rand((b, 64, 64, cout), generator=gen, device=dev) - 0.5
        dyn = dy.permute(0, 3, 1, 2).contiguous()
        size = (b, cin, 63 + k, 63 + k)
        grad_x = name != "enc0"
        xg, wg = x.clone().requires_grad_(grad_x), wt.clone().requires_grad_()
        xng = xn.clone().requires_grad_(grad_x)
        ins, ins_n = ((xg, wg), (xng, wg)) if grad_x else ((wg,), (wg,))
        calls[f"{name}.fwd_bwd"] = (
            lambda xg=xg, wg=wg, dy=dy, ins=ins: torch.autograd.grad(
                conv_valid_fast(xg, wg), ins, dy),
            lambda xng=xng, wg=wg, dyn=dyn, ins=ins_n: torch.autograd.grad(
                F.conv2d(xng, wg), ins, dyn))
        if not grad_x:
            continue
        if hasattr(cv, "conv_valid_dx"):
            def kern(dy=dy, wt=wt):
                return cv.conv_valid_dx(dy, wt)
        else:
            xp = F.pad(dy, (0, 0, k - 1, k - 1, k - 1, k - 1))
            wk = wt.flip(2, 3).transpose(0, 1).contiguous()

            def kern(xp=xp, wk=wk):
                return cv.conv_valid(xp, wk, None, None, "dx")
        calls[f"{name}.dx"] = (
            kern, lambda size=size, wt=wt, dyn=dyn: torch.nn.grad.conv2d_input(
                size, wt, dyn))
    trainer, batch = _train_step_setup(torch, gen, dev)

    def step_wall():
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    out = {key: {"ms": [], "library_ms": []} for key in calls}
    out["train_step"] = {"wall_ms": []}
    for _ in range(rounds):
        for key, (kern, lib) in calls.items():
            out[key]["ms"].append(timed(kern))
            out[key]["library_ms"].append(timed(lib))
        out["train_step"]["wall_ms"].append(step_wall())
    launch_keys = [key for key in calls if not key.endswith("fwd_bwd")]
    step = {m: [sum(out[key][m][i] for key in launch_keys)
                for i in range(rounds)] for m in ("ms", "library_ms")}
    return {"launches": out, "step": step,
            "train_step_device": _train_step_device(torch, trainer, batch)}


def _train_step_setup(torch, gen, dev):
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(6)).to(dev)
    trainer = Trainer(model, make_lr_schedule(1e-4, 32, 12), fast=True)
    batch = tuple(torch.rand((16, 64, 64, 1), generator=gen, device=dev)
                  for _ in range(2))
    for _ in range(3):
        trainer.train_step(batch)
    return trainer, batch


def _train_step_device(torch, trainer, batch, steps=10):
    """Device time and kernel launches a train step, torch.profiler."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": sum(e.device_time_total for e in kernels) / 1e3
            / steps, "launches": len(kernels) / steps,
            "top_ms": {n[:60]: v / 1e3 / steps for n, v in top}}


def window_cases():
    """(name, kernel, images, h, w, ws) of the window kernels' launches:
    ssim_maps at the test CLI's pair and the eval chunk's MS-SSIM levels
    (ops/ssim.downsample_half: ceil(h / 2)), moments at its VIF scales
    (ops/metrics.calc_vif: a VALID filter, then every second pixel)."""
    cases = [("ssim_maps.test_cli", "ssim_maps", 1, H, W, 11)]
    h, w = H, W
    for level in range(5):
        cases.append((f"ssim_maps.eval.{h}x{w}", "ssim_maps", PAIRS, h, w,
                      11))
        h, w = (h + 1) // 2, (w + 1) // 2
    h, w = H, W
    for scale in range(1, 5):
        ws = 2 ** (5 - scale) + 1
        if scale > 1:
            h, w = (h - ws + 2) // 2, (w - ws + 2) // 2
        cases.append((f"moments.eval.{h}x{w}.ws{ws}", "moments", PAIRS, h,
                      w, ws))
    return cases


def window_pair(torch, n, h, w, gen, dev):
    """A seeded pair of (n, h, w, 1) images in 0..255, correlated."""
    a = torch.rand((n, h, w, 1), generator=gen, device=dev) * 255
    b = (0.6 * a + 102 * torch.rand((n, h, w, 1), generator=gen,
                                    device=dev)).clamp(0, 255)
    return a, b


def window_raw(torch, kern, a, b, ws, data_range=255.0):
    """A zero-argument raw launch of `kern`'s C entry on (n, h, w, 1) f32
    images, its outputs allocated here once (ssim_maps: sigma 1.5; moments:
    sigma ws / 5)."""
    import ctypes

    import numpy as np

    from multi_modal_image_fusion_tpu_torch.ops.cuda.build import \
        kernel_function
    from multi_modal_image_fusion_tpu_torch.ops.ssim import gaussian_kernel
    n, h, w, _ = a.shape
    k = 3 if kern == "ssim_maps" else 5
    outs = [torch.empty((n, h - ws + 1, w - ws + 1), device=a.device)
            for _ in range(k)]
    taps = np.ascontiguousarray(gaussian_kernel(
        ws, 1.5 if kern == "ssim_maps" else ws / 5), np.float32)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [a.data_ptr(), b.data_ptr()] + [o.data_ptr() for o in outs]
    dims = [n, h, w, ws, taps.ctypes.data]
    if kern == "ssim_maps":
        fn = kernel_function("mmif_ssim_maps",
                             [P, P, P, P, P, I, I, I, I, P, Fl, Fl, P])
        args = head + dims + [(0.01 * data_range) ** 2,
                              (0.03 * data_range) ** 2]
    else:
        fn = kernel_function("mmif_moments",
                             [P, P, P, P, P, P, P, I, I, I, I, P, P])
        args = head + dims

    def launch(outs=outs, taps=taps):   # keeps both alive
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kern}: launch failed with error {err}")
        return outs
    return launch


def window_wrapper(kern, a, b, ws):
    """The wrapper call of one window case (the test and eval CLIs' args)."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.moments import moments
    from multi_modal_image_fusion_tpu_torch.ops.cuda.ssim_kernel import \
        ssim_maps
    if kern == "ssim_maps":
        return lambda: ssim_maps(a, b, ws, 255.0, False, 1.5)
    return lambda: moments(a, b, ws, ws / 5, False)


def window_times(torch, timed, gen, dev):
    """Rows 4 and 6 (`--metrics`): per window case the raw launch, the
    wrapper call, the wrapper's host time a call; one eval_metrics chunk."""
    import numpy as np

    from multi_modal_image_fusion_tpu_torch.ops.metrics import eval_metrics
    out = {}
    for name, kern, n, h, w, ws in window_cases():
        a, b = window_pair(torch, n, h, w, gen, dev)
        raw, wrap = window_raw(torch, kern, a, b, ws), \
            window_wrapper(kern, a, b, ws)
        ok = all(bool(torch.isfinite(t).all()) for t in raw() + list(wrap()))
        if not ok:
            raise RuntimeError(f"{name}: output not finite")
        rec = {"raw_ms": timed(raw), "wrapper_ms": timed(wrap)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            wrap()
        rec["wrapper_host_us"] = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        out[name] = rec
        del a, b, raw, wrap
        torch.cuda.empty_cache()
    a, b = window_pair(torch, PAIRS, H, W, gen, dev)
    f = (0.5 * a + 0.5 * b).round()
    eval_metrics(a, b, f)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_metrics(a, b, f)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["eval_metrics.chunk16"] = {"wall_ms": float(np.median(walls)),
                                   "event_ms": timed(
                                       lambda: eval_metrics(a, b, f))}
    return out


def dw_cases():
    """(name, channels of the expanded tensor, group width, k, window base,
    with the add, dtype, images): the 12 conv_dw launches of a Res2Fusion
    forward in bf16 at the bench's 2 pairs and in f32 at the test CLI's
    one."""
    layers = ([("RB1.dw0", 64, 16, 1, 0, False)]
              + [(f"RB1.dw{i}", 64, 16, 3, 16 * i, i > 1) for i in (1, 2, 3)]
              + [("RB2.dw0", 384, 48, 1, 0, False)]
              + [(f"RB2.dw{i}", 384, 48, 3, 48 * i, i > 1)
                 for i in range(1, 8)])
    return ([lay + ("bf16", 4) for lay in layers]
            + [lay + ("f32", 2) for lay in layers])


def dw_entry(lib):
    """mmif_conv_dw of a loaded kernel library, typed."""
    import ctypes
    I, P = ctypes.c_int, ctypes.c_void_p
    fn = lib.mmif_conv_dw
    fn.argtypes = [I, P, I, I, P, I, P, P, P, I, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def against_library(root):
    """The kernel library of another checkout, built into its own _build/
    and loaded beside this one."""
    import ctypes
    import importlib.util
    path = os.path.join(os.path.abspath(root), "multi_modal_image_fusion_"
                        "tpu_torch", "ops", "cuda", "build.py")
    spec = importlib.util.spec_from_file_location("mmif_against_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return ctypes.CDLL(str(mod.build()))


def dw_times(torch, timed, gen, dev, other):
    """Row 1's depthwise instance (`--dw`): per case the raw launch, the
    wrapper call, the wrapper's host time a call and, with another
    checkout's library, the largest difference of the outputs."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda import build
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import conv_dw
    own = dw_entry(build.library())
    theirs = None if other is None else dw_entry(other)
    out = {}
    for name, cx, c, k, lo, with_add, dt, n in dw_cases():
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = ((torch.rand((n, H, W, cx), generator=gen, device=dev) - 0.3)
             * 6).to(dtype)
        wt = ((torch.rand((c, 1, k, k), generator=gen, device=dev) - 0.5)
              * 2 / k).to(dtype)
        add = (((torch.rand((n, H, W, c), generator=gen, device=dev) - 0.3)
                * 3).to(dtype) if with_add else None)
        wk = wt.reshape(c, k * k).t().float().contiguous()

        def raw(fn, x=x, cx=cx, lo=lo):
            y = torch.empty((n, H, W, c), dtype=dtype, device=dev)
            args = (1 if dt == "bf16" else 0, x.data_ptr(), cx, lo,
                    None if add is None else add.data_ptr(), c,
                    wk.data_ptr(), None, y.data_ptr(), n, H, W, c, k, 0)

            def launch():
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed with {err}")
                return y
            return launch
        mine = raw(own)

        def wrap():
            return conv_dw(x, wt, None, None, lo, add)
        y = mine()
        if not bool(torch.isfinite(y.float()).all()):
            raise RuntimeError(f"{name} {dt}: output not finite")
        rec = {"raw_ms": timed(mine), "wrapper_ms": timed(wrap)}
        xc = x[..., lo:lo + c].contiguous()
        rec["raw_contiguous_input_ms"] = timed(raw(own, xc, c, 0))
        del xc
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            wrap()
        rec["wrapper_host_us"] = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        if theirs is not None:
            rec["max_abs_diff_vs_against"] = float(
                (mine().float() - raw(theirs)().float()).abs().max())
        out[f"conv_dw.{name}.{dt}"] = rec
        del x, add, y, mine
        torch.cuda.empty_cache()
    return out


def int8_layer_cases():
    """(name, kernel, c_in, c_out, k, fuse_n, input images, h, w, input,
    output): "int8" an int8-resident tensor, "float" bf16."""
    return [("deepfuse.enc1", "conv_int8_chain", 16, 32, 7, 0, 2 * PAIRS, H,
             W, "float", "int8"),
            ("deepfuse.dec0", "conv_int8_chain", 32, 32, 7, PAIRS, 2 * PAIRS,
             H, W, "int8", "int8"),
            ("deepfuse.dec1", "conv_int8_chain", 32, 16, 5, 0, PAIRS, H, W,
             "int8", "float"),
            ("densefuse.dense2", "conv_int8", 48, 16, 3, 0, 2 * PAIRS, H, W,
             "float", "float"),
            ("densefuse.dec0", "conv_int8", 64, 64, 3, 0, PAIRS, H, W,
             "float", "float"),
            ("unfusion.DB3_1.conv1", "conv_int8", 1280, 640, 3, 0, PAIRS, 306,
             256, "float", "float")]


def int8_layer(torch, case, gen, dev):
    """The call of one int8 case on seeded inputs, scales and weights."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8, conv_int8_chain)
    _, kern, cin, cout, k, fuse_n, n, h, w, src, dst = case
    if src == "int8":
        x = torch.randint(-127, 128, (n, h, w, cin), generator=gen,
                          device=dev, dtype=torch.int8)
    else:
        x = (torch.rand((n, h, w, cin), generator=gen, device=dev)
             - 0.5).to(torch.bfloat16)
    qw = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                       device=dev, dtype=torch.int8)
    f = torch.rand((cin,), generator=gen, device=dev) * 0.01 + 0.002
    dq = torch.rand((cout,), generator=gen, device=dev) * 1e-4
    bias = torch.rand((cout,), generator=gen, device=dev) - 0.5
    if kern == "conv_int8":
        return lambda: conv_int8(x, qw, dq, f, bias, "relu")
    return lambda: conv_int8_chain(x, qw, dq, bias, "relu", 1.0 / f, fuse_n,
                                   dst == "int8", torch.bfloat16)


def int8_profile(torch, name):
    """{op name: device ms} of one --int8 forward of `name` (16 pairs at
    1224x1024, calibrated as bench.run calibrates), the largest 15."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from multi_modal_image_fusion_tpu_torch import bench
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.quant import (
        calibrate, quantized_inference)
    dev = torch.device("cuda")
    model = create_model(name, generator=torch.Generator().manual_seed(
        0)).to(dev, torch.bfloat16).eval()
    r = np.random.RandomState(0)
    a, b = (torch.from_numpy(r.rand(bench.BATCH, H, W, 1).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    amax = calibrate(model, [(a[:1, :256, :256], b[:1, :256, :256])])
    with torch.no_grad(), quantized_inference(amax):
        model(a, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(a, b)
            torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return {"total_ms": sum(ms for _, ms in rows),
            "ops_ms": dict(rows[:15])}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="checkout whose port package is timed")
    p.add_argument("--tag", default="", help="a label for the JSON line")
    p.add_argument("--benches", default=None,
                   help="default deepfuse,densefuse,vifnet,res2fusion; "
                        "with --int8 deepfuse,densefuse,unfusion")
    p.add_argument("--int8", action="store_true",
                   help="the int8 kernels' layers and the --int8 benches")
    p.add_argument("--profile", default="",
                   help="a model whose --int8 forward is profiled")
    p.add_argument("--valid", action="store_true",
                   help="rows 8 and 15 (the train step's convs and the "
                        "step) against their library calls, five rounds")
    p.add_argument("--metrics", action="store_true",
                   help="rows 4 and 6 (ssim_maps, moments) at the test and "
                        "eval CLIs' shapes and one eval_metrics chunk, "
                        "instead of the conv layers")
    p.add_argument("--dw", action="store_true",
                   help="row 1's depthwise instance (the 12 conv_dw "
                        "launches of a Res2Fusion forward) instead of the "
                        "conv layers")
    p.add_argument("--against", default=None,
                   help="with --dw, a checkout whose conv_dw outputs are "
                        "compared with this one's")
    args = p.parse_args(argv)
    if args.benches is None:
        args.benches = ("" if args.metrics
                        else "res2fusion" if args.dw
                        else "deepfuse,densefuse,unfusion" if args.int8
                        else "deepfuse,densefuse,vifnet,res2fusion")
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("ab_times: no CUDA device", file=sys.stderr)
        return 2
    from multi_modal_image_fusion_tpu_torch import bench
    from multi_modal_image_fusion_tpu_torch.ops.cuda import build
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        conv_chain
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import \
        conv_multi

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.library()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def timed(fn):
        fn()
        total = 0.0
        for _ in range(REPS):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / REPS

    gen = torch.Generator(device=dev).manual_seed(0)
    layers = {}
    with torch.no_grad():
        for case in int8_layer_cases() if args.int8 else []:
            fn = int8_layer(torch, case, gen, dev)
            if not bool(torch.isfinite(fn().float()).all()):
                raise RuntimeError(f"{case[0]}: output not finite")
            layers[case[0]] = timed(fn)
            del fn
            torch.cuda.empty_cache()
        convs = not (args.int8 or args.metrics or args.dw)
        for case in gray_cases() + pair_cases() if convs else []:
            fn = (gray_layer if case in gray_cases() else pair_layer)(
                torch, case, gen, dev)
            if not bool(torch.isfinite(fn().float()).all()):
                raise RuntimeError(f"{case[0]}: output not finite")
            layers[case[0]] = timed(fn)
            del fn
            torch.cuda.empty_cache()
        for name, kern, cins, cout, k, fuse_n, n, h, w in (
                layer_cases() if convs else []):
            b_in = 2 * fuse_n if fuse_n else n
            legs = [((torch.rand((b_in, h, w, c), generator=gen, device=dev)
                      - 0.5).to(torch.bfloat16), 0) for c in cins]
            wt = ((torch.rand((cout, sum(cins), k, k), generator=gen,
                              device=dev) - 0.5) * 0.1).to(torch.bfloat16)
            bias = torch.rand((cout,), generator=gen, device=dev) - 0.5
            if kern == "conv_chain":
                def fn(x=legs[0][0], wt=wt, bias=bias, fuse_n=fuse_n):
                    return conv_chain(x, wt, bias, "relu", fuse_n)
            else:
                def fn(legs=legs, wt=wt, bias=bias, fuse_n=fuse_n, n=n):
                    return conv_multi(legs, wt, bias, "relu", fuse_n, n)
            y = fn()
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"{name}: output not finite")
            layers[name] = timed(fn)
            del legs, wt, bias, y
            torch.cuda.empty_cache()
        if args.metrics:
            layers.update(window_times(torch, timed, gen, dev))
        if args.dw:
            other = (None if args.against is None
                     else against_library(args.against))
            layers.update(dw_times(torch, timed, gen, dev, other))
    valid = valid_rounds(torch, timed, gen, dev) if args.valid else None
    benches = {}
    for name in filter(None, args.benches.split(",")):
        batch = 2 if name == "res2fusion" else bench.BATCH
        pair = name == "deepfuse_pair"
        if pair:
            os.environ["MMIF_CHAIN_PAIR"] = "1"
        try:
            result, _ = bench.run(seed=0, model_name=name.split("_")[0],
                                  batch=batch, int8=args.int8)
        finally:
            if pair:
                os.environ.pop("MMIF_CHAIN_PAIR")
        benches[name] = result["value"]
        torch.cuda.empty_cache()
    out = {"card": card(), "tag": args.tag, "int8": args.int8,
           "root": os.path.abspath(args.root), "layers_ms": layers,
           "benches_pairs_per_sec": benches}
    if valid is not None:
        out["valid"] = valid
    if args.profile:
        out["profile"] = {args.profile: int8_profile(torch, args.profile)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
