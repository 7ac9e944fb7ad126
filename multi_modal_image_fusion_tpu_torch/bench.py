"""Fused-pair throughput benchmark of the port on one CUDA card
(counterpart of the repo root's bench.py:44-174, inference mode).

Protocol, as the root bench: a zoo model (DeepFuse, the reference CLIs'
default, unless --model names another, as the root bench's BENCH_MODEL)
fusing 1224x1024 grayscale pairs in bf16, batch 16 (--batch, the root
bench's BENCH_BATCH), device-resident; the first run is excluded as warmup;
every timed iteration (10, as BENCH_ITERS) chains on the full previous
output (its mean feeds the next input), and the timed region ends with
torch.cuda.synchronize() and a host fetch of the accumulated sum.
The models are the port's zoo: deepfuse, densefuse, vifnet, dbnet,
unfusion, nestfuse, rfnnest, pfnetv1, pfnetv2, ifcnn, difnet, pmgi,
sedrfuse and myfusion (its default configuration) at batch 16; Res2Fusion
is benched at
--batch 2: its 384-channel Res2 expansion takes ~2 GB an image in bf16, so
16 pairs do not fit on an 80 GB card; MAFusion at --batch 4: its
decoder's 960-channel legs at full resolution take 2.4 GB an image, its
480-channel hidden layer 1.2 GB more.

    python -m multi_modal_image_fusion_tpu_torch.bench [--model deepfuse]
        [--batch 16] [--seed 0] [--int8]

--int8 (the root bench's BENCH_INT8) times post-training int8 inference
(ops/quant.py): the model is calibrated on the first pair's top-left
256x256 crop in bf16, as the root bench calibrates, and the timed forwards
run under quantized_inference (DeepFuse's int8 chain, every other model's
eligible convs on conv_int8).

Prints one JSON line: {"metric": "fusion_throughput_pairs_per_sec", ...}.
Weights and inputs are random, made from the seed: the throughput does not
depend on them. There is no CPU mode: a measurement needs the card.
"""

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from .models import MODEL_ZOO, create_model
from .ops.quant import calibrate, default_skip, quantized_inference

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


def run(seed=0, device="cuda", model_name="deepfuse", batch=BATCH,
        int8=False, model=None):
    """Time the fused forward of `model_name` on `batch` pairs (int8: under
    quantized_inference after a calibration forward); returns the result
    dict that main prints and (img1, img2, fused) of the last timed
    forward, so a caller can check what was timed. `model`: a built
    `model_name` (a checkpoint's weights, or batch norms with statistics)
    in place of the init drawn from `seed`."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the bench measures the CUDA card; none is "
                           "available")
    dt = torch.bfloat16
    if model is None:
        model = create_model(model_name,
                             generator=torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dt).eval()
    r = np.random.RandomState(seed)

    def pairs():
        x = r.rand(batch, HEIGHT, WIDTH, 1).astype(np.float32)
        return torch.from_numpy(x).to(device, dt)

    a, b = pairs(), pairs()
    qctx = contextlib.nullcontext()
    if int8:
        amax = calibrate(model, [(a[:1, :256, :256].contiguous(),
                                  b[:1, :256, :256].contiguous())])
        qctx = quantized_inference(amax, skip=default_skip(model_name))
    with torch.no_grad(), qctx:
        _, s = bench_loop(model, a, b, 1)           # warmup (builds kernels)
        float(s)
        a = pairs()
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
        "value": batch * ITERS / elapsed,
        "unit": "pairs/s",
        "ms_per_pair": elapsed * 1e3 / (batch * ITERS),
        "config": f"{model_name} {HEIGHT}x{WIDTH} "
                  f"{'int8' if int8 else 'bf16'} b{batch} x{ITERS}",
        "device": torch.cuda.get_device_name(device),
    }, last


def main(argv=None):
    p = argparse.ArgumentParser(description="fused-pair throughput")
    p.add_argument("--model", default="deepfuse", choices=sorted(MODEL_ZOO),
                   help="zoo model to time: " + ", ".join(sorted(MODEL_ZOO)))
    p.add_argument("--batch", default=BATCH, type=int,
                   help="pairs a forward (root bench BENCH_BATCH)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 inference (root bench "
                        "BENCH_INT8)")
    args = p.parse_args(argv)
    if args.batch < 1:
        p.error("--batch must be at least 1")
    result, _ = run(seed=args.seed, model_name=args.model, batch=args.batch,
                    int8=args.int8)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
