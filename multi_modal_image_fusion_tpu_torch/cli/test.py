"""Inference CLI (counterpart of multi_modal_image_fusion_tpu cli/test.py:
30-264): runs the model over the test split (batch 1, full resolution),
reports per-image SSIM (data_range 1.0) and latency/fps with the first
iteration excluded as warmup (reference test.py:41-48), dumps the fused
images as NN.bmp into <ckpt_root>/<ckpt>/<data>/ (default root
<repo>/checkpoints, data from <repo>/datasets), and appends the results
to train.log when it exists. With --int8 it first calibrates the model's
conv layers on the first min(4, N) pairs (batch 1, the model's dtype; JAX
cli/test.py:229-243), prints `int8: calibrated N conv layers on M image
pairs`, then serves under ops/quant.quantized_inference. With --tiles N
each pair is fused in N height slabs (parallel/tiling.py), its height
reflect-padded to a multiple of 8 N and the output cropped (a height that
needs it is noted once; JAX cli/test.py:82-116); --int8 combines with it.
The checkpoint
folder may be the port's (`.pth`) or the JAX package's (`.ckpt`, read
without flax: train/checkpoint.py).

Runs on the CUDA card (conv and SSIM kernels of ops/cuda/) unless asked
for the CPU:

    python -m multi_modal_image_fusion_tpu_torch.cli.test --data roadscene \\
        --ckpt <timestamp-dir> --ckpt_root <dir> [--device cpu]
"""

import contextlib
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import FusionDataset
from ..data.io import imwrite
from ..device import resolve_device
from ..models import create_model
from ..ops.metrics import calc_ssim
from ..ops.quant import calibrate, default_skip, quantized_inference
from ..parallel.tiling import tiled_forward
from ..train.checkpoint import checkpoint_path, load_checkpoint_meta, restore
from ..utils.meters import AverageMeter
from .common import ckpt_root, dataset_layout, get_test_parser, \
    resolve_data_dir, save_result


def _reflect_pad(x, ph, pw):
    """Reflect-pad an NHWC tensor at the bottom and right."""
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                 mode="reflect").permute(0, 2, 3, 1).contiguous()


def test_model(model, dataset, device, save_dir=None, log_file=None,
               pad_bucket=0, tiles=0):
    """Fuse every pair of `dataset` (in `tiles` height slabs when above 1);
    returns (mean SSIM, mean seconds per pair without the first)."""
    timer = AverageMeter()
    ssim_meter = AverageMeter()
    # the slab grid needs H a multiple of 8 x tiles (8-row aligned slabs):
    # folded into the pad-and-crop bucket (JAX cli/test.py:82-116)
    h_mult = 8 * tiles if tiles > 1 else 1
    noted_heights = set()
    for i in range(len(dataset)):
        img1, img2 = dataset[i]
        x1 = torch.from_numpy(img1)[None, ..., None].to(device)
        x2 = torch.from_numpy(img2)[None, ..., None].to(device)
        h, w = x1.shape[1:3]
        xp1, xp2 = x1, x2
        if pad_bucket or h_mult > 1:
            ph = -h % math.lcm(pad_bucket or 1, h_mult)
            pw = -w % pad_bucket if pad_bucket else 0
            if ph and not pad_bucket and h not in noted_heights:
                noted_heights.add(h)
                print(f"note: H={h} not divisible by the --tiles slab grid "
                      f"multiple {h_mult}; reflect-padding to {h + ph} "
                      f"(output deviates within the receptive field of "
                      f"the pad seam, as with --pad_bucket)")
            xp1, xp2 = _reflect_pad(x1, ph, pw), _reflect_pad(x2, ph, pw)

        start = time.time()
        with torch.no_grad():
            imgf = (tiled_forward(model, xp1, xp2, tiles) if tiles > 1
                    else model(xp1, xp2))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.time() - start
        imgf = imgf[:, :h, :w]
        ssim = (calc_ssim(x1, imgf, data_range=1.0)
                + calc_ssim(x2, imgf, data_range=1.0)) * 0.5
        if i > 0:                     # first iteration = warmup
            timer.update(elapsed)

        ssim_meter.update(float(ssim))
        line = (f"iter: {i + 1:0>2}, ssim: {ssim_meter.val:.4f}, "
                f"time: {elapsed * 1000:.3f}ms")
        print(line)
        if log_file is not None:
            log_file.write("\n" + line)

        if save_dir is not None:
            result = save_result(imgf[0].float().cpu().numpy())
            imwrite(os.path.join(save_dir, f"{i + 1:0>2}.bmp"), result)

    return ssim_meter.avg, timer.avg if timer.count else float("nan")


def main(argv=None):
    args = get_test_parser().parse_args(argv)
    if args.spatial > 1:
        raise NotImplementedError(
            "--spatial > 1 is not ported yet (ROADMAP.md queue 1 item 7b, "
            "spatial sharding)")
    device = resolve_device(args.device)

    ckpt_dir = os.path.join(ckpt_root(args), args.ckpt)
    ckpt_path = checkpoint_path(ckpt_dir)

    meta = load_checkpoint_meta(ckpt_path)
    model_name = args.model or meta.get("model", "deepfuse")
    model_cfg = meta.get("model_cfg", {}) if args.model is None else {}
    model = create_model(model_name, generator=torch.Generator().manual_seed(0),
                         **model_cfg)
    print(f"model: {model_name}")

    data_dir, _ = resolve_data_dir(args)
    _, set_name_test, img_type = dataset_layout(args.data)
    dataset = FusionDataset(data_dir, set_name=set_name_test,
                            set_type="test", img_type=img_type)

    missing, unexpected = restore(model, ckpt_path, model_name)
    if missing:
        print(f"partial checkpoint: {len(missing)} leaves kept at init "
              f"(e.g. {missing[0]}), {len(unexpected)} checkpoint-only "
              f"leaves dropped")
    model = model.to(device).eval()
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    print(f"params: {n_params / 1e6:.3f}M")

    save_dir = os.path.join(ckpt_dir, args.data)
    os.makedirs(save_dir, exist_ok=True)

    qctx = contextlib.nullcontext()
    if args.int8:
        cal = [tuple(torch.from_numpy(v)[None, ..., None].to(device)
                     for v in dataset[i])
               for i in range(min(4, len(dataset)))]
        amax = calibrate(model, cal)
        skip = default_skip(model_name)
        print(f"int8: calibrated {len(amax)} conv layers on {len(cal)} "
              f"image pairs" + (f"; float-skip {','.join(skip)}"
                                if skip else ""))
        qctx = quantized_inference(amax, skip=skip)

    log_path = os.path.join(ckpt_dir, "train.log")
    log_file = open(log_path, "a") if os.path.isfile(log_path) else None
    # a negative bucket is the JAX CLI's "auto": 128 on a TPU, where each
    # new shape is a new compile, exact shapes elsewhere (JAX cli/test.py:
    # 213-216); the card takes any shape
    pad_bucket = max(args.pad_bucket, 0)
    try:
        with qctx:
            ssim, avg_time = test_model(model, dataset, device, save_dir,
                                        log_file, pad_bucket=pad_bucket,
                                        tiles=args.tiles)
        line = (f"ssim: {ssim:.4f}, time: {avg_time * 1000:.3f}ms, "
                f"fps: {1.0 / avg_time:.3f}")
        print(line)
        if log_file is not None:
            log_file.write("\n" + line)
    finally:
        if log_file is not None:
            log_file.close()
    return ssim, avg_time


if __name__ == "__main__":
    main()
