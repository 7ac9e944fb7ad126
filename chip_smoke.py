#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (any failure raises and the script exits non-zero):

1. Print the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 off, so f32 comparisons are f32.
2. Build every kernel from the sources in multi_modal_image_fusion_tpu_torch/
   csrc/ (one nvcc per source, in parallel); print the build time.
3. Hold each kernel (conv_gray_enter, conv_chain, conv_gray_exit, ssim_maps)
   against its plain PyTorch version on the card: at the main path's shapes
   (1224x1024; bf16 batch 16 as the bench runs it, f32 batch 1 as the test
   CLI runs it) and at 45x61, with tolerances relative to the plain output's
   largest magnitude: f32 1e-4 (same f32 products, another summation
   order), bf16 2e-2 (both round an f32 result to bf16's 8-bit mantissa,
   ~4e-3, and another summation order can flip that rounding). Time the
   kernel, the plain version and, for the convs, one F.conv2d on the
   reflect-padded input in the same dtype (the pad timed apart), each with
   CUDA events over cold-L2 repetitions; compute each kernel's bound from
   this run's shapes.
4. Main path, with every launch count set to 0 just before it: the port's
   bench (DeepFuse, 1224x1024, bf16, batch 16, 1 warmup + 10 timed
   forwards), then the port's test CLI on 51 synthetic 1224x1024 BMP pairs
   with a seeded checkpoint (the first pair is the CLI's warmup; the other
   50 give the per-pair latency's median and spread). Counts are read just
   after; every kernel must have run, and each forward must be 1 enter +
   3 chain + 1 exit launches.
5. Check the outputs: the bench's last timed batch (16 bf16 fused pairs)
   has a mean SSIM against its inputs within 1e-3 of the f32 plain forward
   of the same weights on the same inputs (the BASELINE contract), and the
   CLI's SSIM is finite and within 1e-4 of the f32 plain path on the card,
   its NN.bmp files exist and it printed fps.
6. Training, with every launch count set to 0 just before it: the port's
   train CLI on 10 synthetic seeded 512x512 BMP pairs (8 train, 2 valid) at
   the reference defaults (bs 16, 64x64 patches, f32, --fast_train), 2
   epochs of 32 train steps and 8 valid batches. Counts are read just
   after: conv_valid must have launched exactly 9 times a train step (5
   forward, 4 dx) and 5 times a valid batch. Each train step is timed (host
   clock, synchronised before and after); the median and spread exclude
   the first epoch's first 3 steps. Then one train step of the same
   weights and batch through the kernels and through F.conv2d (TF32 off):
   loss parts within 1e-5 relative, gradients within 1e-4 of the largest
   gradient magnitude, every parameter's gradient non-zero. Then 20 steps
   under torch.profiler on one device batch: summed kernel time against
   the wall time of the same steps without the profiler (the device's busy
   share), and the conv_valid, dw, loss and optimizer shares. Last, the
   port's test CLI on the checkpoint the training wrote: its SSIM must be
   finite.

Phase 3 also holds conv_valid against its plain version (TF32 off): the 5
forward and 4 dx launches of a train step in f32 and bf16, the valid
step's bias+relu and bias+none epilogues, and enc1 at 1224x1024 in bf16,
batch 2; the library time is one F.conv2d on the same pre-padded input
(forward) or one torch.nn.grad.conv2d_input (dx).

Prints the `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}. Needs one card; exits non-zero without one.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 1224, 1024
BATCH = 16
REPS = 3
CLI_PAIRS = 51        # the first is the CLI's warmup
# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
TOL = {"f32": 1e-4, "bf16": 2e-2}


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _rand(torch, shape, seed, dev, dtype, lo=0.0, scale=1.0):
    r = np.random.RandomState(seed)
    x = ((r.rand(*shape) + lo) * scale).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


class Timer:
    """Mean device time of a callable over cold-L2 repetitions."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device=dev)   # 256 MB > the 50 MB L2

    def __call__(self, fn, reps=REPS):
        torch = self.torch
        fn()                                     # warmup
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def _err(torch, got, want, dt):
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite kernel output")
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    if err > TOL[dt] * scale:
        raise AssertionError(f"max abs err {err} above {TOL[dt]} x {scale}")
    return err, err / scale


def check_kernels(torch, F, dev, timer):
    """Phase 3. Returns {kernel name: record} for the kernels line."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        conv_chain, conv_chain_plain, conv_gray_enter, conv_gray_enter_plain,
        conv_gray_exit, conv_gray_exit_plain)
    from multi_modal_image_fusion_tpu_torch.ops.cuda.ssim_kernel import (
        ssim_maps, ssim_maps_plain)
    from multi_modal_image_fusion_tpu_torch.ops.ssim import gaussian_kernel

    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    # DeepFuse's layers: (name, kernel, c_in, c_out, k, act, fuse)
    layers = [("enc0", "conv_gray_enter", 1, 16, 5, "relu", False),
              ("enc1", "conv_chain", 16, 32, 7, "relu", False),
              ("dec0", "conv_chain", 32, 32, 7, "relu", True),
              ("dec1", "conv_chain", 32, 16, 5, "relu", False),
              ("dec2", "conv_gray_exit", 16, 1, 5, None, False)]
    rec = {}
    for name, kern, cin, cout, k, act, fuse in layers:
        wt = _rand(torch, (cout, cin, k, k), 10 + k + cin, dev, torch.float32,
                   lo=-0.5, scale=2.0 / np.sqrt(cin * k * k))
        bias = _rand(torch, (cout,), 20 + cout, dev, torch.float32, lo=-0.5,
                     scale=0.1)
        # (dtype, pairs, h, w): bench shape, test-CLI shape, odd small shape
        for dt, n, h, w in (("bf16", BATCH, H, W), ("f32", 1, H, W),
                            ("bf16", 2, 45, 61), ("f32", 2, 45, 61)):
            dtype = dts[dt]
            wk = wt.to(dtype)
            if kern == "conv_gray_enter":
                a = _rand(torch, (n, h, w, 1), 1, dev, dtype)
                b = _rand(torch, (n, h, w, 1), 2, dev, dtype)
                xin = torch.cat([a, b], 0)

                def run():
                    return conv_gray_enter(a, b, wk, bias, act)

                def plain():
                    return conv_gray_enter_plain(a, b, wk, bias, act)
                b_in, b_out = 2 * n, 2 * n
            else:
                b_in = 2 * n if name in ("enc1", "dec0") else n
                b_out = n if name != "enc1" else 2 * n
                xin = _rand(torch, (b_in, h, w, cin), 3, dev, dtype)
                fuse_n = n if fuse else 0
                if kern == "conv_chain":
                    def run():
                        return conv_chain(xin, wk, bias, act, fuse_n)

                    def plain():
                        return conv_chain_plain(xin, wk, bias, act, fuse_n)
                else:
                    def run():
                        return conv_gray_exit(xin, wk, bias, act)

                    def plain():
                        return conv_gray_exit_plain(xin, wk, bias, act)
            err, rel = _err(torch, run(), plain(), dt)
            r = rec.setdefault(kern, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                      "layers": {}})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            if not (dt == "bf16" and h == H):
                continue
            # timings at the bench's shape
            xn = xin[:n] + xin[n:] if fuse else xin
            p = k // 2
            xnchw = xn.permute(0, 3, 1, 2)
            xp = F.pad(xnchw, (p, p, p, p), mode="reflect")
            wb, bb = wk, bias.to(dtype)
            esz = 2
            flops = 2.0 * b_out * h * w * cin * k * k * cout
            nbytes = (b_in * h * w * cin + b_out * h * w * cout) * esz \
                + wt.numel() * 4
            bound = max(nbytes / PEAK_BYTES_S,
                        flops / PEAK_FLOPS[dt]) * 1e3
            r["layers"][name] = {
                "ms": timer(run), "plain_ms": timer(plain),
                "library_ms": timer(lambda: F.conv2d(xp, wb, bb)),
                "library_pad_ms": timer(
                    lambda: F.pad(xnchw, (p, p, p, p), mode="reflect")),
                "bound_ms": bound,
                "bound_by": ("bytes" if nbytes / PEAK_BYTES_S
                             > flops / PEAK_FLOPS[dt] else "operations"),
                "shape": f"{b_in}x{h}x{w}x{cin}->{b_out}x{h}x{w}x{cout} "
                         f"k{k} {dt}"}
            del xp, xnchw, xn

    # SSIM: test-CLI pairs (1, H, W, 1) f32, VALID, window 11
    ws = 11
    taps = gaussian_kernel(ws, 1.5)
    r = rec["ssim_maps"] = {"max_abs_err": 0.0, "max_rel_err": 0.0,
                            "layers": {}}
    for n, h, w in ((1, H, W), (2, 45, 61)):
        a = _rand(torch, (n, h, w, 1), 4, dev, torch.float32)
        b = (a + _rand(torch, (n, h, w, 1), 5, dev, torch.float32, lo=-0.5,
                       scale=0.2)).clamp(0, 1)
        for pad in (False, True):
            got = ssim_maps(a, b, ws, 1.0, pad, sigma=1.5)
            want = ssim_maps_plain(a, b, taps, 1.0, pad)
            for g, wnt in zip(got, want):
                err, rel = _err(torch, g, wnt, "f32")
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["max_rel_err"] = max(r["max_rel_err"], rel)
        if h == H:
            px = n * (h - ws + 1) * (w - ws + 1)
            # 3 products + 5 maps x ws taps x 2 passes x 2 flops + algebra
            flops = px * (3 + 5 * ws * 4 + 20)
            nbytes = n * h * w * 4 * 2 + px * 4 * 3
            r["layers"]["ssim"] = {
                "ms": timer(lambda: ssim_maps(a, b, ws, 1.0, False, 1.5)),
                "plain_ms": timer(
                    lambda: ssim_maps_plain(a, b, taps, 1.0, False)),
                "library_ms": None,
                "bound_ms": max(nbytes / PEAK_BYTES_S,
                                flops / PEAK_FLOPS["f32"]) * 1e3,
                "bound_by": ("bytes" if nbytes / PEAK_BYTES_S
                             > flops / PEAK_FLOPS["f32"] else "operations"),
                "shape": f"{n}x{h}x{w}x1 pair f32 ws{ws}"}
    return rec


# DeepFuse's train step at the reference defaults (bs 16, 64x64 patches):
# (name, images, c_in, c_out, k) of the conv_valid launches. The siamese
# fold runs the encoder once over both images of the 16 pairs.
TRAIN_BS, PATCH = 16, 64
VALID_FWD = [("enc0", 2 * TRAIN_BS, 1, 16, 5),
             ("enc1", 2 * TRAIN_BS, 16, 32, 7),
             ("dec0", TRAIN_BS, 32, 32, 7), ("dec1", TRAIN_BS, 32, 16, 5),
             ("dec2", TRAIN_BS, 16, 1, 5)]
# dx of every layer but enc0 (the images carry no gradient): a VALID conv
# of the cotangent (c_out channels) zero-padded by k-1, back to c_in
VALID_DX = [(n, b, cin, cout, k) for n, b, cin, cout, k in VALID_FWD[1:]]


def _bound(nbytes, flops, dt):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dt]
    return max(t_b, t_f) * 1e3, "bytes" if t_b > t_f else "operations"


def check_conv_valid(torch, F, dev, timer):
    """conv_valid against its plain version at the train step's launches,
    the valid step's epilogues and one full-resolution shape, with times."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_valid import (
        conv_valid, conv_valid_plain)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    r = {"max_abs_err": 0.0, "max_rel_err": 0.0, "layers": {}}

    def check(got, want, dt):
        err, rel = _err(torch, got, want, dt)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)

    cases = []
    for dt in ("f32", "bf16"):
        for name, b, cin, cout, k in VALID_FWD:
            cases.append((f"{name}.fwd.{dt}", "fwd", dt, b, PATCH, PATCH,
                          cin, cout, k, None, None))
        for name, b, cin, cout, k in VALID_DX:
            cases.append((f"{name}.dx.{dt}", "dx", dt, b, PATCH, PATCH, cin,
                          cout, k, None, None))
    cases += [("enc1.valid_relu.f32", "fwd", "f32", 2 * TRAIN_BS, PATCH,
               PATCH, 16, 32, 7, "relu", True),
              ("dec2.valid_none.f32", "fwd", "f32", TRAIN_BS, PATCH, PATCH,
               16, 1, 5, None, True),
              ("enc1.fwd.bf16.1224x1024", "fwd", "bf16", 2, H, W, 16, 32, 7,
               None, None)]
    for key, kind, dt, b, h, w, cin, cout, k, act, with_bias in cases:
        dtype = dts[dt]
        wt = _rand(torch, (cout, cin, k, k), 50 + k + cin, dev, torch.float32,
                   lo=-0.5, scale=2.0 / np.sqrt(cin * k * k)).to(dtype)
        bias = (_rand(torch, (cout,), 60 + cout, dev, torch.float32, lo=-0.5,
                      scale=0.1) if with_bias else None)
        if kind == "fwd":
            x = _rand(torch, (b, h + k - 1, w + k - 1, cin), 7, dev, dtype)
            wk = wt
            lib_in = x.permute(0, 3, 1, 2).contiguous()
            lib_w = wt

            def library():
                return F.conv2d(lib_in, lib_w, bias)
            in_bytes = x.numel()
            macs = b * h * w * cin * cout * k * k
            out_c = cout
        else:
            # dx: the cotangent of a (h, w) output with c_out channels,
            # zero-padded by k-1, through the flipped, io-swapped weight
            dy = _rand(torch, (b, h, w, cout), 8, dev, dtype, lo=-0.5)
            x = F.pad(dy, (0, 0, k - 1, k - 1, k - 1, k - 1))
            wk = wt.flip(2, 3).transpose(0, 1).contiguous()
            dy_nchw = dy.permute(0, 3, 1, 2).contiguous()
            in_size = (b, cin, h + k - 1, w + k - 1)

            def library():
                return torch.nn.grad.conv2d_input(in_size, wt, dy_nchw)
            in_bytes = dy.numel()
            macs = b * h * w * cin * cout * k * k
            out_c = cin
            h, w = h + k - 1, w + k - 1

        def run():
            return conv_valid(x, wk, bias, act)

        def plain():
            return conv_valid_plain(x, wk, bias, act)
        check(run(), plain(), dt)
        esz = 2 if dt == "bf16" else 4
        nbytes = (in_bytes + b * h * w * out_c) * esz + wt.numel() * esz
        bound, by = _bound(nbytes, 2.0 * macs, dt)
        r["layers"][key] = {
            "ms": timer(run), "plain_ms": timer(plain),
            "library_ms": timer(library), "bound_ms": bound, "bound_by": by,
            "shape": f"{tuple(x.shape)}->{(b, h, w, out_c)} k{k} {dt}"
                     + (f" bias+{act}" if with_bias else "")}
        del x, wk, library, run, plain
    return r


def write_train_fixture(torch, root, n_pairs=10, n_test=2, size=512):
    """Synthetic seeded BMP pairs: `n_pairs` under train/ (the CLI splits
    them 80/20 into train and valid) and `n_test` under test/."""
    from multi_modal_image_fusion_tpu_torch.data.io import imwrite
    r = np.random.RandomState(11)
    yy, xx = np.mgrid[0:size, 0:size]
    for split, n in (("train", n_pairs), ("test", n_test)):
        for mod in ("vis", "ir"):
            os.makedirs(os.path.join(root, "synthtrain", split, mod))
        for i in range(n):
            base = 127 + 100 * np.sin(xx / (11.0 + i)) * np.cos(yy / 19.0)
            vis = np.clip(base + r.randn(size, size) * 12, 0, 255)
            ir = np.clip(255 - base * 0.7 + r.randn(size, size) * 25, 0, 255)
            for mod, img in (("vis", vis), ("ir", ir)):
                imwrite(os.path.join(root, "synthtrain", split, mod,
                                     f"{i + 1}.bmp"), img.astype(np.uint8))


def train_step_check(torch, dev):
    """One DeepFuse train step of the same weights and batch through the
    kernels (fast_training) and through F.conv2d, TF32 off."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
    from multi_modal_image_fusion_tpu_torch.train.trainer import \
        make_loss_bundle
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(5)).to(dev)
    x1 = _rand(torch, (TRAIN_BS, PATCH, PATCH, 1), 12, dev, torch.float32)
    x2 = _rand(torch, (TRAIN_BS, PATCH, PATCH, 1), 13, dev, torch.float32)
    bundle = make_loss_bundle()
    out = {}
    for fast in (True, False):
        with fast_training(fast):
            total, parts = bundle(x1, x2, model(x1, x2))
            grads = torch.autograd.grad(total, list(model.parameters()))
        out[fast] = ({k: float(v.detach()) for k, v in parts.items()}, grads)
    (pf, gf), (pp, gp) = out[True], out[False]
    for k in pf:
        if abs(pf[k] - pp[k]) > 1e-5 * abs(pp[k]):
            raise AssertionError(f"train step {k}: kernels {pf[k]} vs "
                                 f"F.conv2d {pp[k]}")
    worst = 0.0
    for (name, _), a, b in zip(model.named_parameters(), gf, gp):
        scale = float(b.abs().max())
        if float(a.abs().max()) == 0.0:
            raise AssertionError(f"train step: no gradient reaches {name}")
        err = float((a - b).abs().max())
        if err > 1e-4 * scale:
            raise AssertionError(f"train step grad {name}: {err} above "
                                 f"1e-4 x {scale}")
        worst = max(worst, err / scale)
    return {"loss_parts": pf, "max_grad_rel_err": worst,
            "params": len(gf)}


def profile_steps(torch, dev, steps=20):
    """Busy share of the card over `steps` train steps of one device batch
    (bs 16, 64x64, f32, fast): summed kernel time over wall time, from
    torch.profiler; the share of the conv_valid kernel, of the dw matmuls,
    of the loss and of the optimizer update. Also the steps' wall time
    without the profiler."""
    from torch.autograd import DeviceType
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(6)).to(dev)
    trainer = Trainer(model, make_lr_schedule(1e-4, 32, 12), fast=True)
    batch = (_rand(torch, (TRAIN_BS, PATCH, PATCH, 1), 14, dev, torch.float32),
             _rand(torch, (TRAIN_BS, PATCH, PATCH, 1), 15, dev, torch.float32))
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    conv_ms = sum(e.device_time_total for e in kernels
                  if "conv_valid_kernel" in e.name) / 1e3

    def range_ms(name):
        return sum(e.device_time_total for e in events
                   if e.name == name and e.device_type == DeviceType.CPU) / 1e3
    # busy share against the unprofiled step: the profiler's own host cost
    # lengthens the profiled steps, not their kernels
    rec = {"steps": steps, "step_ms_unprofiled": plain_wall,
           "wall_ms_profiled": wall / steps, "kernel_ms": dev_ms / steps,
           "launches": len(kernels) / steps,
           "busy_share": dev_ms / steps / plain_wall,
           "busy_share_profiled": dev_ms / wall, "source": "torch.profiler"}
    if dev_ms == 0.0:
        # no device time in the trace: enqueue the steps behind a sleep so
        # the card runs them back to back, and time that with CUDA events
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9))
        start.record()
        for _ in range(steps):
            trainer.train_step(batch)
        end.record()
        end.synchronize()
        dev_ms = start.elapsed_time(end)
        rec.update(kernel_ms=dev_ms / steps, busy_share=dev_ms / steps
                   / plain_wall, busy_share_profiled=None,
                   source="cuda events behind a sleep")
    rec.update({k + "_ms": v / steps for k, v in (
        ("conv_valid", conv_ms), ("dw", range_ms("conv_valid_dw")),
        ("loss", range_ms("loss")), ("optimizer", range_ms("optimizer")))})
    return rec


def train_phase(torch, build, root):
    """The port's train CLI at the reference defaults with --fast_train;
    returns (launch counts, per-step seconds, checkpoint dir)."""
    from multi_modal_image_fusion_tpu_torch.cli import train as train_cli
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    step_s = []
    orig = Trainer.train_step

    def timed(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    Trainer.train_step = timed
    try:
        build.LAUNCHES.clear()
        ckpt_dir = train_cli.main([
            "--data", "synthtrain", "--data_root", root, "--ckpt_root",
            os.path.join(root, "ckpt"), "--epoch", "2", "--bs",
            str(TRAIN_BS), "--fast_train"])
        counts = dict(build.LAUNCHES)
    finally:
        Trainer.train_step = orig
    return counts, step_s, ckpt_dir


def plain_forward(torch, model, img1, img2):
    """The f32 DeepFuse forward through the plain versions only."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        conv_chain_plain, conv_gray_enter_plain, conv_gray_exit_plain)
    enc0, enc1 = model.encode
    dec0, dec1, dec2 = model.decode

    def p(layer):
        return layer.weight.float(), layer.bias.float(), layer.act

    t = conv_gray_enter_plain(img1.float(), img2.float(), *p(enc0))
    t = conv_chain_plain(t, *p(enc1))
    t = conv_chain_plain(t, *p(dec0), fuse_n=img1.shape[0])
    t = conv_chain_plain(t, *p(dec1))
    return conv_gray_exit_plain(t, *p(dec2))


def _plain_ssim(torch, x, y):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.ssim_kernel import \
        ssim_maps_plain
    from multi_modal_image_fusion_tpu_torch.ops.ssim import gaussian_kernel
    ws = min(11, x.shape[1], x.shape[2])
    return ssim_maps_plain(x, y, gaussian_kernel(ws, 1.5), 1.0)[0].mean(
        dim=(1, 2, 3))


def write_cli_fixture(torch, root, n_pairs=CLI_PAIRS):
    """Synthetic 1224x1024 BMP pairs and a seeded DeepFuse checkpoint."""
    from multi_modal_image_fusion_tpu_torch.data.io import imwrite
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.train.checkpoint import \
        save_state_dict
    r = np.random.RandomState(7)
    for mod in ("vis", "ir"):
        os.makedirs(os.path.join(root, "data", "synth", "test", mod))
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(n_pairs):
        base = 127 + 100 * np.sin(xx / (17.0 + i)) * np.cos(yy / 23.0)
        vis = np.clip(base + r.randn(H, W) * 10, 0, 255).astype(np.uint8)
        ir = np.clip(255 - base * 0.6 + r.randn(H, W) * 20, 0,
                     255).astype(np.uint8)
        imwrite(os.path.join(root, "data", "synth", "test", "vis",
                             f"{i + 1}.bmp"), vis)
        imwrite(os.path.join(root, "data", "synth", "test", "ir",
                             f"{i + 1}.bmp"), ir)
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(3))
    ckpt_dir = os.path.join(root, "ckpt", "run")
    save_state_dict(os.path.join(ckpt_dir, "epoch_best.pth"),
                    model.state_dict(), meta={"model": "deepfuse"})
    with open(os.path.join(ckpt_dir, "train.log"), "w") as f:
        f.write("synthetic run")
    return model


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from multi_modal_image_fusion_tpu_torch import bench
    from multi_modal_image_fusion_tpu_torch.cli import test as test_cli
    from multi_modal_image_fusion_tpu_torch.data.dataset import FusionDataset
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.cuda import build

    # phase 1
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 2
    t0 = time.perf_counter()
    lib_path = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    build.library()

    # phase 3
    timer = Timer(torch, dev)
    rec = check_kernels(torch, F, dev, timer)
    rec["conv_valid"] = check_conv_valid(torch, F, dev, timer)
    torch.cuda.empty_cache()
    print("kernel checks passed")

    # phase 4: main path, counts from 0
    build.LAUNCHES.clear()
    result, (a16, b16, y16) = bench.run(seed=0)
    fwd = bench.ITERS + 1
    bench_counts = dict(build.LAUNCHES)
    print(f"bench: {json.dumps(result)}")
    want = {"conv_gray_enter": fwd, "conv_chain": 3 * fwd,
            "conv_gray_exit": fwd}
    for k, v in want.items():
        if bench_counts.get(k, 0) != v:
            raise AssertionError(f"bench launches {bench_counts}, want {want}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        model = write_cli_fixture(torch, root)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_ssim, cli_time = test_cli.main([
                "--data", "synth", "--data_root", os.path.join(root, "data"),
                "--ckpt_root", os.path.join(root, "ckpt"), "--ckpt", "run"])
        counts = dict(build.LAUNCHES)
        print(out.getvalue().rstrip())
        iter_ms = [float(m) for m in re.findall(r"^iter: \d+, .*time: "
                                                r"([\d.]+)ms$", out.getvalue(),
                                                re.M)]
        if len(iter_ms) != CLI_PAIRS:
            raise AssertionError(f"CLI printed {len(iter_ms)} iterations, "
                                 f"want {CLI_PAIRS}")
        lat = np.array(iter_ms[1:])                # first = warmup
        cli_lat = {"pairs": len(lat), "mean_ms": cli_time * 1e3,
                   "median_ms": float(np.median(lat)),
                   "min_ms": float(lat.min()), "max_ms": float(lat.max())}
        fwd += CLI_PAIRS
        want = {"conv_gray_enter": fwd, "conv_chain": 3 * fwd,
                "conv_gray_exit": fwd, "ssim_maps": 2 * CLI_PAIRS}
        if counts != want:
            raise AssertionError(f"main-path launches {counts}, want {want}")

        # phase 5: outputs
        if "fps" not in out.getvalue():
            raise AssertionError("test CLI printed no fps")
        for i in range(CLI_PAIRS):
            bmp = os.path.join(root, "ckpt", "run", "synth", f"{i + 1:0>2}.bmp")
            if not os.path.isfile(bmp):
                raise AssertionError(f"missing {bmp}")
        model = model.to(dev)
        ds = FusionDataset(os.path.join(root, "data", "synth"), "test",
                           "test", "ir")
        ref = []
        with torch.no_grad():
            for i in range(len(ds)):
                a, b = (torch.from_numpy(v)[None, ..., None].to(dev)
                        for v in ds[i])
                y = plain_forward(torch, model, a, b)
                ref.append(float((_plain_ssim(torch, a, y)
                                  + _plain_ssim(torch, b, y))[0] * 0.5))
        ref_ssim = float(np.mean(ref))
        if not (np.isfinite(cli_ssim)
                and abs(cli_ssim - ref_ssim) <= 1e-4):
            raise AssertionError(f"CLI SSIM {cli_ssim} vs plain f32 "
                                 f"{ref_ssim}")
        print(f"test CLI: ssim {cli_ssim:.6f} (plain f32 on the card "
              f"{ref_ssim:.6f}), latency over {cli_lat['pairs']} pairs: "
              f"median {cli_lat['median_ms']:.3f} ms, mean "
              f"{cli_lat['mean_ms']:.3f} ms, min {cli_lat['min_ms']:.3f}, "
              f"max {cli_lat['max_ms']:.3f}")
    del model, ds, ref
    torch.cuda.empty_cache()

    # BASELINE contract on the bench's last timed batch: its bf16 fused
    # pairs against the f32 plain forward of the same weights and inputs
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(0)).to(dev)
    x1, x2, y16 = a16.float(), b16.float(), y16.float()
    with torch.no_grad():
        y32 = plain_forward(torch, model, x1, x2)
        s32 = float(((_plain_ssim(torch, x1, y32)
                      + _plain_ssim(torch, x2, y32)) * 0.5).mean())
        s16 = float(((_plain_ssim(torch, x1, y16)
                      + _plain_ssim(torch, x2, y16)) * 0.5).mean())
        y_diff = float((y16 - y32).abs().max())
    if not (np.isfinite(s16) and abs(s16 - s32) <= 1e-3):
        raise AssertionError(f"bf16 SSIM {s16} vs f32 {s32}")
    print(f"bf16 contract ({y16.shape[0]} bench pairs): mean SSIM bf16 "
          f"{s16:.6f} vs f32 {s32:.6f} (|d| {abs(s16 - s32):.2e} <= 1e-3); "
          f"fused max |bf16 - f32| {y_diff:.4g} (f32 max "
          f"{float(y32.abs().max()):.4g})")

    # phase 6: training, counts from 0
    del model, y32, y16, a16, b16
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        write_train_fixture(torch, root)
        train_counts, step_s, ckpt_dir = train_phase(torch, build, root)
        steps, valid_batches = 2 * 32, 2 * 8
        want = {"conv_valid": 9 * steps + 5 * valid_batches,
                "conv_valid/forward": 5 * steps, "conv_valid/dx": 4 * steps,
                "conv_valid/valid": 5 * valid_batches}
        if train_counts != want or len(step_s) != steps:
            raise AssertionError(f"training launches {train_counts} over "
                                 f"{len(step_s)} steps, want {want} over "
                                 f"{steps}")
        ms = np.array(step_s[3:]) * 1e3        # after epoch 1's first 3
        step_stats = {"steps": len(ms), "median_ms": float(np.median(ms)),
                      "p10_ms": float(np.percentile(ms, 10)),
                      "p90_ms": float(np.percentile(ms, 90)),
                      "min_ms": float(ms.min()), "max_ms": float(ms.max()),
                      "patches_per_s": TRAIN_BS * 1e3 / float(np.median(ms))}
        print(f"train CLI: {steps} steps, {valid_batches} valid batches, "
              f"launches {train_counts}; step median "
              f"{step_stats['median_ms']:.3f} ms (p10 "
              f"{step_stats['p10_ms']:.3f}, p90 {step_stats['p90_ms']:.3f}, "
              f"min {step_stats['min_ms']:.3f}, max "
              f"{step_stats['max_ms']:.3f}), "
              f"{step_stats['patches_per_s']:.1f} patches/s")
        step_check = train_step_check(torch, dev)
        print(f"train step, kernels vs F.conv2d: loss parts "
              f"{step_check['loss_parts']}, max grad err "
              f"{step_check['max_grad_rel_err']:.3g} of the largest "
              f"gradient, all {step_check['params']} parameters reached")
        busy = profile_steps(torch, dev)
        print(f"train step profile: {json.dumps(busy)}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_ssim, _ = test_cli.main([
                "--data", "synthtrain", "--data_root", root, "--ckpt_root",
                os.path.dirname(ckpt_dir), "--ckpt",
                os.path.basename(ckpt_dir)])
        if not np.isfinite(train_ssim):
            raise AssertionError(f"test CLI on the trained checkpoint: "
                                 f"SSIM {train_ssim}")
        print(f"test CLI on the trained checkpoint: ssim {train_ssim:.6f}")

    replaces = {
        "conv_gray_enter": "multi_modal_image_fusion_tpu/ops/pallas/"
                           "conv_kernel.py:357",
        "conv_chain": "multi_modal_image_fusion_tpu/ops/pallas/"
                      "hiw_kernel.py:335",
        "conv_gray_exit": "multi_modal_image_fusion_tpu/ops/pallas/"
                          "conv_kernel.py:383",
        "ssim_maps": "multi_modal_image_fusion_tpu/ops/pallas/"
                     "ssim_kernel.py:86",
    }
    sources = {"ssim_maps": "multi_modal_image_fusion_tpu_torch/csrc/ssim.cu"}
    kernels = []
    counts = {**counts, **train_counts}
    for name in ("conv_gray_enter", "conv_chain", "conv_gray_exit",
                 "ssim_maps"):
        r = rec[name]
        ls = r["layers"].values()
        lib = [v["library_ms"] for v in ls]
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources.get(
                name, "multi_modal_image_fusion_tpu_torch/csrc/conv_chain.cu"),
            "replaces": replaces[name],
            "launches": counts.get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"],
            "tolerance_rel": TOL,
            "ms": sum(v["ms"] for v in ls),
            "plain_ms": sum(v["plain_ms"] for v in ls),
            "bound_ms": sum(v["bound_ms"] for v in ls),
            "bound_by": "operations" if any(
                v["bound_by"] == "operations" for v in ls) else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "layers": r["layers"],
        })
    # conv_valid: the sums are one train step's 9 launches in f32, the
    # training CLI's dtype; every shape checked is under "layers"
    r = rec["conv_valid"]
    step = [v for key, v in r["layers"].items()
            if key.endswith((".fwd.f32", ".dx.f32"))]
    kernels.append({
        "name": "conv_valid", "route": "cuda",
        "source": "multi_modal_image_fusion_tpu_torch/csrc/conv_valid.cu",
        "replaces": "multi_modal_image_fusion_tpu/ops/pallas/"
                    "conv_kernel.py:161 (conv_tlane_dma), "
                    "multi_modal_image_fusion_tpu/ops/pallas/conv_vjp.py:71 "
                    "(conv_valid_fast)",
        "launches": train_counts["conv_valid"],
        "launches_by_site": {k.split("/")[1]: v for k, v in
                             train_counts.items() if "/" in k},
        "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
        "tolerance_rel": TOL,
        "ms": sum(v["ms"] for v in step),
        "plain_ms": sum(v["plain_ms"] for v in step),
        "bound_ms": sum(v["bound_ms"] for v in step),
        "bound_by": "operations" if any(
            v["bound_by"] == "operations" for v in step) else "bytes",
        "library_ms": sum(v["library_ms"] for v in step),
        "layers": r["layers"],
    })
    print(json.dumps({"kernels": kernels,
                      "pairs_per_sec": result["value"],
                      "cli_latency": cli_lat,
                      "main_path_launches": counts,
                      "training": {"step": step_stats, "profile": busy,
                                   "step_check": step_check,
                                   "test_cli_ssim": train_ssim}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
