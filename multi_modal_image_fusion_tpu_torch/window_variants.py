"""Design variants of the window stencil (csrc/window_stencil.cuh, the body
of ssim_maps and moments), timed on one CUDA card at the test and eval
CLIs' shapes.

    python -m multi_modal_image_fusion_tpu_torch.window_variants [--reps 2]

Each variant is the committed source with one change, compiled with the
build's nvcc flags (csrc/ssim.cu and csrc/moments.cu on the variant's
header) into a library of its own in a temporary directory, and timed in a
process of its own: `committed`; `slots_1` and `slots_2`, the strip plan
made as if one or two blocks fit an SM (three do: fewer, taller strips);
`tall_strips`, strips never shorter than 64 rows (the committed plan takes
down to 4 (ws - 1) rows where 64-row strips would leave blocks idle, as at
the test CLI's one pair); `ahead_2`, the copies two row groups ahead;
`ssim_fast_div`, the SSIM epilogue's divisions by `__fdividef` (not IEEE:
what the two divisions cost); and, to see what a launch's time is made of
(their maps are wrong, their errors are printed all the same),
`no_vertical` and `no_horizontal` without that pass, `copies_and_stores`
without either (the staging, barriers, epilogue and stores alone). Cases:
ssim_maps at the test CLI's 1x1224x1024 and the eval chunk's 16x1224x1024
and 16x612x512, moments at the chunk's four VIF scales. For each variant and case, `--reps` rounds in turn: the
mean device time of the C entry over 5 cold-L2 launches (CUDA events) on
outputs allocated beforehand, and the largest difference of its first map
from the plain version's relative to max(|y|, 1). Prints one JSON line a
variant and round, then torch's times for the same bytes (`a + b` of the
chunk's two inputs, `zero_` of its output maps): the rate a frame could
reach. Needs nvcc and a card; raises without them.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .ops.cuda import build
from .ops.cuda.moments import moments_plain
from .ops.cuda.ssim_kernel import ssim_maps_plain
from .ops.ssim import gaussian_kernel

H, W, PAIRS = 1224, 1024, 16
_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
SSIM_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _F, _P]
MOMENT_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]
# (kernel, images, h, w, ws)
CASES = [("ssim_maps", 1, H, W, 11), ("ssim_maps", PAIRS, H, W, 11),
         ("ssim_maps", PAIRS, 612, 512, 11), ("moments", PAIRS, H, W, 17),
         ("moments", PAIRS, 608, 508, 9), ("moments", PAIRS, 302, 252, 5),
         ("moments", PAIRS, 150, 125, 3)]


def variants(src):
    """name -> source text of each variant of window_stencil.cuh."""
    def sub(text, old, new):
        if old not in text:
            raise ValueError(f"window_variants: {old!r} not in the source")
        return text.replace(old, new, 1)

    plan = "window_plan(p, n, cache.sms, cache.slots);"
    idle = ("const bool idle = per * ((p.OH + th_tall - 1) / th_tall) "
            "< slots;")
    div = ("    p.out[1][o] = v1 / v2;\n"
           "    p.out[0][o] = (m1v * v1) / (m2v * v2);\n")
    fast_div = ("    p.out[1][o] = __fdividef(v1, v2);\n"
                "    p.out[0][o] = __fdividef(m1v * v1, m2v * v2);\n")
    vert = "    wn_vertical<WS>(p, ring, sv, s_taps, ws, base);\n"
    horiz = "    wn_horizontal<WS>(p, sv, s_taps, ws);\n"
    return {"committed": src,
            "slots_1": sub(src, plan, "window_plan(p, n, cache.sms, "
                                      "cache.sms);"),
            "slots_2": sub(src, plan, "window_plan(p, n, cache.sms, "
                                      "2 * cache.sms);"),
            "tall_strips": sub(src, idle, "const bool idle = false && "
                                          "th_tall;"),
            "ahead_2": ahead_2(src, sub),
            "ssim_fast_div": sub(src, div, fast_div),
            "no_vertical": sub(src, vert, ""),
            "no_horizontal": sub(src, horiz, ""),
            "copies_and_stores": sub(sub(src, vert, ""), horiz, "")}


def ahead_2(src, sub):
    """The ring two row groups deep: group g's copies are issued for group
    g + 2 (a third of the ring more: two blocks an SM at ws 11 and 17)."""
    src = sub(src, "static constexpr int NR = 2 * WN_R + KW - 1;",
              "static constexpr int NR = 3 * WN_R + KW - 1;")
    src = sub(src, "  wn_load_rows<WS>(p, ring, img, x0, y0, 0, first);\n"
                   "  cp_async_commit();\n",
              "  wn_load_rows<WS>(p, ring, img, x0, y0, 0, first);\n"
              "  cp_async_commit();\n"
              "  if (ng > 1) wn_load_rows<WS>(p, ring, img, x0, y0, first, "
              "WN_R);\n"
              "  cp_async_commit();\n")
    src = sub(src, "    if (g + 1 < ng) wn_load_rows<WS>(p, ring, img, x0, "
                   "y0, g * WN_R + first, WN_R);",
              "    if (g + 2 < ng) wn_load_rows<WS>(p, ring, img, x0, y0, "
              "g * WN_R + first + WN_R, WN_R);")
    return sub(src, "    cp_async_wait<1>();", "    cp_async_wait<2>();")


def compile_all(tmp):
    """Compile every variant in parallel; name -> library path."""
    for f in list(build.CSRC.glob("*.cuh")) + [build.CSRC / "ssim.cu",
                                                build.CSRC / "moments.cu"]:
        (tmp / f.name).write_text(f.read_text())
    src = (build.CSRC / "window_stencil.cuh").read_text()
    procs = {}
    for name, text in variants(src).items():
        d = tmp / name
        d.mkdir()
        for f in tmp.glob("*.c*"):
            (d / f.name).write_text(f.read_text())
        (d / "window_stencil.cuh").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "ssim.cu"), str(d / "moments.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        out[name] = tmp / name / "lib.so"
    return out


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


def time_library(path):
    """{case: {ms, rel_err}} of one variant's library (this process)."""
    lib = ctypes.CDLL(str(path))
    lib.mmif_ssim_maps.argtypes = SSIM_ARGS
    lib.mmif_moments.argtypes = MOMENT_ARGS
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for kern, n, h, w, ws in CASES:
        a = torch.rand((n, h, w, 1), generator=gen, device=dev) * 255
        b = (0.6 * a + 102 * torch.rand((n, h, w, 1), generator=gen,
                                        device=dev)).clamp(0, 255)
        k = 3 if kern == "ssim_maps" else 5
        ys = [torch.empty((n, h - ws + 1, w - ws + 1, 1), device=dev)
              for _ in range(k)]
        sigma = 1.5 if kern == "ssim_maps" else ws / 5
        taps = np.ascontiguousarray(gaussian_kernel(ws, sigma), np.float32)
        args = ([a.data_ptr(), b.data_ptr()] + [y.data_ptr() for y in ys]
                + [n, h, w, ws, taps.ctypes.data])
        if kern == "ssim_maps":
            fn = lib.mmif_ssim_maps
            args += [(0.01 * 255) ** 2, (0.03 * 255) ** 2]
            want = ssim_maps_plain(a, b, taps, 255.0)[0]
        else:
            fn = lib.mmif_moments
            want = moments_plain(a, b, taps)[0]

        def call(fn=fn, args=args):
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f"{kern}: launch failed with error {err}")
        ms = cold_ms(call, flush)
        rel = float((ys[0] - want).abs().max()) / max(
            float(want.abs().max()), 1.0)
        out[f"{kern} {n}x{h}x{w} ws{ws}"] = {"ms": ms, "rel_err": rel}
        del a, b, ys, want
        torch.cuda.empty_cache()
    return out


def streaming_rates():
    """Torch moving the eval chunk's bytes at the card's streaming rate, ms:
    `a + b` of two 16x1224x1024 f32 images (reads both, writes one) and
    `zero_` of ssim_maps' three and moments' five output maps (ws 11, 17),
    each the mean of 5 cold-L2 runs: what the frame could reach."""
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    a, b = (torch.rand((PAIRS, H, W), device=dev) for _ in range(2))
    y = torch.empty_like(a)
    out3 = torch.empty((3, PAIRS, H - 10, W - 10), device=dev)
    out5 = torch.empty((5, PAIRS, H - 16, W - 16), device=dev)
    return {"a + b (read 160 MB, write 80 MB)":
            cold_ms(lambda: torch.add(a, b, out=y), flush),
            "zero_ ssim_maps' outputs (236 MB)":
            cold_ms(lambda: out3.zero_(), flush),
            "zero_ moments' outputs (390 MB)":
            cold_ms(lambda: out5.zero_(), flush)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--time", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("window_variants: needs a CUDA card")
    if args.time:
        print(json.dumps(time_library(args.time)))
        return
    print(f"card: {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp))
        for rep in range(args.reps):
            for name, path in libs.items():
                res = subprocess.run(
                    [sys.executable, "-m", __spec__.name, "--time",
                     str(path)], capture_output=True, text=True, check=True)
                print(f"{name} round {rep}: {res.stdout.strip()}",
                      flush=True)
    print(f"torch streaming the same bytes, ms: "
          f"{json.dumps(streaming_rates())}")


if __name__ == "__main__":
    main()
