"""Device times of the bf16 `wgmma` conv layers of DeepFuse, DenseFuse,
VIFNet, Res2Fusion and UNFusion's encoder, and of their benches, from one
checkout of the port: run it once per checkout, in turns, to compare two
commits on one card.

    python multi_modal_image_fusion_tpu_torch/ab_times.py --root <checkout>
        [--tag parent] [--benches deepfuse,densefuse,vifnet,res2fusion]

`--root` is the checkout whose `multi_modal_image_fusion_tpu_torch` is
imported (and built, into its own `_build/`); the layers are called through
the wrappers whose signatures every checkout since the `wgmma` body shares
(`conv_chain`, `conv_multi`). Layers: bf16, 16 pairs of 1224x1024 (DeepFuse
enc1 and dec0, DenseFuse dec0, VIFNet dec0; UNFusion's encoder convs at
their scale, 32 images; Res2Fusion's RB2 pwconv1 at 2 pairs, its bench
batch), random centred inputs from a seed; each time the mean of 5
cold-L2 runs (CUDA events, a 256 MB write between runs) after a warmup.
Benches: `bench.run` (10 timed forwards after one warmup). Prints one JSON
line with the card, the tag, the layers' ms and the benches' pairs/s.
Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="checkout whose port package is timed")
    p.add_argument("--tag", default="", help="a label for the JSON line")
    p.add_argument("--benches", default="deepfuse,densefuse,vifnet,res2fusion")
    args = p.parse_args(argv)
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
        for name, kern, cins, cout, k, fuse_n, n, h, w in layer_cases():
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
    benches = {}
    for name in filter(None, args.benches.split(",")):
        batch = 2 if name == "res2fusion" else bench.BATCH
        result, _ = bench.run(seed=0, model_name=name, batch=batch)
        benches[name] = result["value"]
        torch.cuda.empty_cache()
    print(json.dumps({"card": card(), "tag": args.tag,
                      "root": os.path.abspath(args.root), "layers_ms": layers,
                      "benches_pairs_per_sec": benches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
