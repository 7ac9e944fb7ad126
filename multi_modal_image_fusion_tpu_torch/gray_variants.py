"""Design variants of the enter and exit convs (csrc/conv_gray.cu), timed
on one CUDA card at the benches' shapes, beside the wrapper's own cost and
the card's streaming rates.

    python -m multi_modal_image_fusion_tpu_torch.gray_variants [--reps 2]

Each variant is the committed source with one change, compiled alone with
the build's nvcc flags into a library of its own (in a temporary
directory): the exit with a ring of 3 stages and its P tile apart (one
block an SM at k5, the first design), with 6-row tiles, or with 12-row
tiles; the enter with plain instead of streaming stores, or with 8-row
tiles. Cases: bf16 at 16 pairs of 1224x1024 (enter k5 and k3 at 16
channels, k3 at 32; exit k5, k3, k1 from 16 channels) and f32 at one pair
(enter k5, exit k5). For each variant and case, `--reps` times in turn, the
mean time of the kernel's C entry over 5 cold-L2 launches (CUDA events),
the weights packed beforehand, and its largest difference from the plain
version relative to the plain output's largest magnitude. Then, with the
committed build: the wrapper call (packing included) beside the raw launch,
the wrapper's host time a call, and torch writing the enter's output bytes
(`zero_`), reading the exit's input (`sum`) and copying it (`clone`), the
rates these kernels can reach on the card. Needs nvcc and a card; raises
without them.
"""

import argparse
import ctypes
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .ops.cuda import build
from .ops.cuda.conv_chain import (conv_gray_enter, conv_gray_enter_plain,
                                  conv_gray_exit, conv_gray_exit_plain,
                                  gray_weights)

H, W, PAIRS = 1224, 1024, 16
_I, _P = ctypes.c_int, ctypes.c_void_p
ENTER_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
EXIT_ARGS = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def variants(src):
    """name -> source text of each variant of conv_gray.cu."""
    def sub(text, old, new):
        if old not in text:
            raise ValueError(f"gray_variants: {old!r} not in the source")
        return text.replace(old, new, 1)

    out = {"committed": src}
    ring3 = sub(src, "constexpr int EX_RING = 2;", "constexpr int EX_RING = 3;")
    # the P tile beside the ring, as the first design had it
    ring3 = sub(ring3, "  return EX_RING * ex_slot_bytes<T, K>();",
                "  return EX_RING * ex_slot_bytes<T, K>() + "
                "EX_TH * K * ExGeom<K>::PP * 4;")
    ring3 = sub(ring3, "      float* s_p = reinterpret_cast<float*>(smem + "
                "(s % EX_RING) * SLOT);",
                "      float* s_p = reinterpret_cast<float*>(smem + "
                "EX_RING * SLOT);")
    out["exit_ring3_p_apart"] = ring3
    for th in (6, 12):
        out[f"exit_rows{th}"] = sub(src, "constexpr int EX_TH = 8;",
                                    f"constexpr int EX_TH = {th};")
    out["enter_plain_stores"] = sub(
        src, "  __stcs(reinterpret_cast<uint4*>(p), v);",
        "  *reinterpret_cast<uint4*>(p) = v;")
    out["enter_rows8"] = sub(src, "constexpr int EN_TH = 4; ",
                             "constexpr int EN_TH = 8; ")
    return out


def compile_all(tmp):
    """Compile every variant in parallel; name -> ctypes library."""
    for hdr in build.CSRC.glob("*.cuh"):
        (tmp / hdr.name).write_text(hdr.read_text())
    procs = {}
    for name, text in variants((build.CSRC / "conv_gray.cu")
                               .read_text()).items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn, args in (("mmif_conv_gray_enter", ENTER_ARGS),
                         ("mmif_conv_gray_exit", EXIT_ARGS)):
            getattr(libs[name], fn).argtypes = args
    return libs


def cold_ms(fn, flush, reps=5):
    """Mean device time of fn over `reps` launches, the L2 flushed before
    each (CUDA events), after one warmup."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def host_ms(fn, n=50):
    """Host time of one call, the mean of n calls issued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def cases(dev, gen):
    """(name, 'enter' or 'exit', wrapper call, C arguments after the
    function, output, plain output, the tensors the C arguments point
    to, kept alive with the case)."""
    ptr = lambda t: _P(t.data_ptr()) if t is not None else None  # noqa: E731
    stream = _P(torch.cuda.current_stream().cuda_stream)
    out = []
    for dt, n, enter, exits in (("bf16", PAIRS, ((5, 16), (3, 16), (3, 32)),
                                 (5, 3, 1)),
                                ("f32", 1, ((5, 16),), (5,))):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        code = 1 if dt == "bf16" else 0
        a, b = (torch.rand((n, H, W, 1), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        for k, cout in enter:
            wt = torch.rand((cout, 1, k, k), generator=gen, device=dev) - 0.5
            bias = torch.rand((cout,), generator=gen, device=dev) - 0.5
            wk, bk = gray_weights("enter", wt, bias, dtype)
            y = torch.empty((2 * n, H, W, cout), dtype=dtype, device=dev)
            out.append((f"enter k{k} c{cout} {dt}", "enter",
                        lambda a=a, b=b, wt=wt, bias=bias: conv_gray_enter(
                            a, b, wt, bias, "relu"),
                        (code, ptr(a), ptr(b), ptr(wk), ptr(bk), ptr(y), n, H,
                         W, cout, k, 1, stream), y,
                        conv_gray_enter_plain(a, b, wt, bias, "relu"),
                        (a, b, wk, bk)))
        x = (torch.rand((n, H, W, 16), generator=gen, device=dev)
             - 0.5).to(dtype)
        for k in exits:
            wt = (torch.rand((1, 16, k, k), generator=gen, device=dev)
                  - 0.5) * 0.3
            bias = torch.rand((1,), generator=gen, device=dev) - 0.5
            wk, bk = gray_weights("exit", wt, bias, dtype)
            y = torch.empty((n, H, W, 1), dtype=dtype, device=dev)
            out.append((f"exit k{k} {dt}", "exit",
                        lambda x=x, wt=wt, bias=bias: conv_gray_exit(
                            x, wt, bias, None),
                        (code, ptr(x), ptr(wk), ptr(bk), ptr(y), n, H, W, 16,
                         k, 0, stream), y,
                        conv_gray_exit_plain(x, wt, bias, None),
                        (x, wk, bk)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gray_variants: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    print(f"card: {torch.cuda.get_device_name(0)}")
    with torch.no_grad():
        work = cases(dev, gen)
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp))
        times = {name: {} for name in libs}
        for _ in range(args.reps):
            for name, lib in libs.items():
                for case, kind, _, cargs, y, want, _ in work:
                    fn = getattr(lib, f"mmif_conv_gray_{kind}")

                    def call(fn=fn, cargs=cargs):
                        err = fn(*cargs)
                        if err:
                            raise RuntimeError(f"{name} {case}: error {err}")
                    ms = cold_ms(call, flush)
                    rel = float((y.float() - want.float()).abs().max()
                                / want.float().abs().max())
                    times[name].setdefault(case, {"ms": [], "rel_err": rel})
                    times[name][case]["ms"].append(ms)
        for name, r in times.items():
            print(f"{name}: {json.dumps(r)}")
    build.library()
    wrap = {}
    for case, kind, wrapper, cargs, _, _, _ in work:
        fn = getattr(build.library(), f"mmif_conv_gray_{kind}")
        fn.argtypes = ENTER_ARGS if kind == "enter" else EXIT_ARGS
        wrap[case] = {"raw_ms": cold_ms(lambda: fn(*cargs), flush),
                      "wrapper_ms": cold_ms(wrapper, flush),
                      "wrapper_host_ms": host_ms(wrapper)}
    print(f"committed build, raw launch and wrapper: {json.dumps(wrap)}")
    big = torch.empty((2 * PAIRS, H, W, 16), dtype=torch.bfloat16, device=dev)
    x = torch.rand((PAIRS, H, W, 16), generator=gen, device=dev).bfloat16()
    rates = {"write 32x1224x1024x16 bf16 (zero_)":
             cold_ms(lambda: big.zero_(), flush),
             "read 16x1224x1024x16 bf16 (sum)":
             cold_ms(lambda: x.sum(dtype=torch.float32), flush),
             "copy 16x1224x1024x16 bf16 (clone)":
             cold_ms(lambda: x.clone(), flush)}
    print(f"torch streaming the same bytes, ms: {json.dumps(rates)}")


if __name__ == "__main__":
    main()
