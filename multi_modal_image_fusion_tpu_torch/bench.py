"""Fused-pair throughput benchmark of the port on one CUDA card
(counterpart of the repo root's bench.py:44-174, inference mode).

Protocol, as the root bench: DeepFuse (the reference CLIs' default model)
fusing 1224x1024 grayscale pairs in bf16, batch 16, device-resident; the
first run is excluded as warmup; every timed iteration chains on the full
previous output (its mean feeds the next input), and the timed region ends
with torch.cuda.synchronize() and a host fetch of the accumulated sum.

    python -m multi_modal_image_fusion_tpu_torch.bench [--seed 0]

Prints one JSON line: {"metric": "fusion_throughput_pairs_per_sec", ...}.
Weights and inputs are random, made from the seed: the throughput does not
depend on them. There is no CPU mode: a measurement needs the card.
"""

import argparse
import json
import time

import numpy as np
import torch

from .models import create_model

HEIGHT, WIDTH = 1224, 1024
BATCH, ITERS = 16, 10


def bench_loop(model, a, b, iters):
    """`iters` forwards, each input nudged by the previous output's mean
    (so no forward can be skipped); returns ((img1, img2, fused) of the last
    forward, sum of the means)."""
    s = torch.zeros((), dtype=torch.float32, device=a.device)
    for _ in range(iters):
        y = model(a, b)
        m = y.float().mean()
        last = (a, b, y)
        a = a + (m * 1e-6).to(a.dtype)
        s = s + m
    return last, s


def run(seed=0, device="cuda"):
    """Time the fused forward; returns the result dict that main prints and
    (img1, img2, fused) of the last timed forward, so a caller can check
    what was timed."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the bench measures the CUDA card; none is "
                           "available")
    dt = torch.bfloat16
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dt).eval()
    r = np.random.RandomState(seed)

    def batch():
        x = r.rand(BATCH, HEIGHT, WIDTH, 1).astype(np.float32)
        return torch.from_numpy(x).to(device, dt)

    a, b = batch(), batch()
    with torch.no_grad():
        _, s = bench_loop(model, a, b, 1)           # warmup (builds kernels)
        float(s)
        a = batch()
        torch.cuda.synchronize(device)
        start = time.perf_counter()
        last, s = bench_loop(model, a, b, ITERS)
        torch.cuda.synchronize(device)
        total = float(s)
        elapsed = time.perf_counter() - start
    if not np.isfinite(total):
        raise RuntimeError(f"bench output is not finite ({total})")
    return {
        "metric": "fusion_throughput_pairs_per_sec",
        "value": BATCH * ITERS / elapsed,
        "unit": "pairs/s",
        "ms_per_pair": elapsed * 1e3 / (BATCH * ITERS),
        "config": f"deepfuse {HEIGHT}x{WIDTH} bf16 b{BATCH} x{ITERS}",
        "device": torch.cuda.get_device_name(device),
    }, last


def main(argv=None):
    p = argparse.ArgumentParser(description="fused-pair throughput")
    p.add_argument("--seed", default=0, type=int)
    result, _ = run(seed=p.parse_args(argv).seed)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
