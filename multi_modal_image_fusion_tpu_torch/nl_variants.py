"""Design variants of the bf16 nl kernels (csrc/nl_attention.cu), timed on
one CUDA card at the Res2Fusion bench's nl call: q (2, 1253376, 112) and k
(2, 19584, 112), bf16, as the 'nl' pooling of a 1224x1024 feature map
gives them.

    python -m multi_modal_image_fusion_tpu_torch.nl_variants [--reps 2]

Each variant is the committed source with one change, compiled alone with
the build's nvcc flags into a library of its own (in a temporary
directory): the ring of key tiles 2, 3, 6 or 8 deep instead of 4; the
consumer warpgroups issuing without taking turns (no named barriers); and
nl_apply waiting for its value product before taking the next tile's
weights (no overlap of the exps with the MMAs). For each it prints ptxas's
registers and whether ptxas serialized the wgmmas, then, `--reps` times in
turn, the mean time of each kernel over 3 cold-L2 launches (CUDA events)
and its largest difference from the committed kernels' output. The keys are
packed once (pack_keys) and are not in the times. Needs nvcc and a card;
raises without them.
"""

import argparse
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from .ops.cuda import build
from .ops.cuda.nl_attention import pack_keys

SHAPE = (2, 1224 * 1024, 153 * 128, 112)   # B, N, M, C


def variants(src):
    """name -> source text of each variant of nl_attention.cu."""
    def sub(text, old, new):
        if old not in text:
            raise ValueError(f"nl_variants: {old!r} not in the source")
        return text.replace(old, new, 1)

    out = {"committed": src}
    for st in (2, 3, 6, 8):
        out[f"ring{st}"] = sub(src, "constexpr int NL_STAGES = 4;",
                               f"constexpr int NL_STAGES = {st};")
    out["no_turns"] = "\n".join(
        line for line in src.splitlines()
        if "named_bar_sync(me" not in line and "named_bar_arrive(" not in line)
    i = src.index("nl_apply_ws_kernel(const")
    out["apply_no_overlap"] = src[:i] + sub(src[i:], "wgmma_wait<1>();",
                                            "wgmma_wait<0>();")
    return out


def compile_all(tmp):
    """Compile every variant in parallel; name -> (ctypes library, ptxas
    summary)."""
    for hdr in build.CSRC.glob("*.cuh"):
        (tmp / hdr.name).write_text(hdr.read_text())
    procs = {}
    for name, text in variants((build.CSRC / "nl_attention.cu")
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
        regs = dict(re.findall(r"properties for \S*(nl_\w+?_ws_kernel)\S*\n"
                               r".*\n.*Used (\d+) registers", log))
        summary = {"registers": regs, "serialized": "serialized" in log}
        libs[name] = (ctypes.CDLL(str(tmp / f"{name}.so")), summary)
    return libs


def cold_ms(fn, flush, reps=3):
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nl_variants: needs a CUDA card")
    dev = torch.device("cuda")
    b, n, m, c = SHAPE
    g = torch.Generator(device=dev).manual_seed(5)
    q = (torch.rand((b, n, c), generator=g, device=dev) * 2 - 1).bfloat16()
    k = torch.rand((b, m, c), generator=g, device=dev) * 2 - 1
    k = (k - k.mean(1, keepdim=True)).bfloat16()
    kp = pack_keys(k)
    part = torch.empty((b * -(-n // 64), 2), dtype=torch.float32, device=dev)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = ctypes.c_void_p
    argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ptr]
    print(f"card: {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp))
        for name, (_, summary) in libs.items():
            print(f"{name}: ptxas {summary}")
        ref = None
        for rep in range(args.reps):
            for name, (lib, _) in libs.items():
                lib.mmif_nl_minmax.argtypes = argtypes
                lib.mmif_nl_apply.argtypes = argtypes
                lohi = torch.empty(2, dtype=torch.float32, device=dev)
                out = torch.empty_like(q)

                def minmax():
                    err = lib.mmif_nl_minmax(1, ptr(q.data_ptr()),
                                             ptr(kp.data_ptr()),
                                             ptr(part.data_ptr()),
                                             ptr(lohi.data_ptr()), b, n, m, c,
                                             stream)
                    if err:
                        raise RuntimeError(f"{name}: nl_minmax error {err}")

                def apply():
                    err = lib.mmif_nl_apply(1, ptr(q.data_ptr()),
                                            ptr(kp.data_ptr()),
                                            ptr(lohi.data_ptr()),
                                            ptr(out.data_ptr()), b, n, m, c,
                                            stream)
                    if err:
                        raise RuntimeError(f"{name}: nl_apply error {err}")
                t_minmax = cold_ms(minmax, flush)
                t_apply = cold_ms(apply, flush)
                if ref is None:
                    ref = (lohi.clone(), out.float())
                d_lohi = float((lohi - ref[0]).abs().max())
                d_out = float((out.float() - ref[1]).abs().max())
                print(f"rep {rep} {name}: nl_minmax {t_minmax:.3f} ms, "
                      f"nl_apply {t_apply:.3f} ms; largest difference from "
                      f"the committed kernels: lohi {d_lohi:.3g}, "
                      f"out {d_out:.3g}")


if __name__ == "__main__":
    main()
