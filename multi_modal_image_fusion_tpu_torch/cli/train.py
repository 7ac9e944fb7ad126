"""Training CLI (counterpart of multi_modal_image_fusion_tpu cli/train.py;
reference train.py) on one device, the CUDA card unless asked for the CPU,
or data-parallel over ranks (`--multihost`). Output tree as the
reference's:

    <ckpt_root>/<YYYY-MM-DD_HH-MM>/
        train.log  scalars.jsonl  events.out.tfevents.*
        train/NN.png  valid/NN.png          per-epoch [img1|img2|fused]
        epoch_best.pth  epoch_last.pth      model state dicts, each with
                                            .json metadata and .optim
                                            (step + Adam moments, resume)

    python -m multi_modal_image_fusion_tpu_torch.cli.train --data roadscene \\
        --bs 16 --epoch 12 [--fast_train] [--amp bf16] [--device cpu]

`--multihost` trains data-parallel, one process a rank, under the
reference launcher's env contract (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT; LOCAL_RANK picks the card): NCCL between cards, gloo with
`--device cpu` (parallel/mesh.py). `--bs` stays the global batch and must
divide by the world size; every rank reads the same global batches and
steps on its slice, the gradients and the batch norms' statistics cover
the global batch, and only rank 0 writes under --ckpt_root (the others
write into a temporary folder, removed at the end). Two ranks on one
machine's CPU:

    for r in 0 1; do RANK=$r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 \\
        MASTER_PORT=29512 python -m multi_modal_image_fusion_tpu_torch.cli.train \\
        --multihost --device cpu --bs 4 --epoch 1 & done; wait

Defaults are the reference recipe: bs 16, 64x64 patches, SSIM 1.0 +
pixel-max 0.01 + grad-max 0.1, Adam(1e-4, 0.9, 0.999), global-norm clip 5,
MultiStep at 2/3 E and 8/9 E. `--fast_train` runs every conv of the train
and valid steps through the conv_valid kernel (ops/layers.py); without it
they run F.conv2d. TF32 is off, so f32 convs and matmuls are f32.
`--resume` and `--init_from` also take a JAX package run's folder (its
flax msgpack `.ckpt` files, read without flax: train/checkpoint.py):
`--resume` its whole TrainState and epoch, `--init_from` its parameters
and batch statistics with a fresh optimizer, as the JAX CLI does.
"""

import contextlib
import os
import shutil
import tempfile
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataset import AEDataset, FusionDataset, FusionPatches
from ..data.io import imwrite
from ..data.pipeline import Feeder
from ..device import resolve_device
from ..models import create_model
from ..parallel.mesh import (broadcast_module, init_multihost,
                             is_main_process, rank, world_size)
from ..train.checkpoint import (checkpoint_path, jax_tree,
                                load_checkpoint_meta, load_train_state,
                                restore, save_checkpoint)
from ..train.schedules import make_lr_schedule
from ..train.trainer import Trainer, make_loss_bundle
from ..utils.jax_convert import jax_train_state_to_torch
from ..utils.logger import Logger, close_logger
from ..utils.meters import AverageMeter
from ..utils.scalars import ScalarWriter
from ..utils.seed import setup_seed
from .common import (ckpt_root, dataset_layout, get_train_parser,
                     parse_model_cfg, resolve_data_dir, save_result)


def _n_of(batch):
    return (batch[0] if isinstance(batch, (tuple, list)) else batch).shape[0]


def _chunks(feeder, k):
    """Consecutive same-shape train batches in groups of k for
    Trainer.train_steps; a batch of another shape starts a new group."""
    def shape_of(item):
        parts = item if isinstance(item, (tuple, list)) else (item,)
        return tuple(p.shape for p in parts)

    buf = []
    for item in feeder:
        if buf and shape_of(item) != shape_of(buf[0]):
            yield buf
            buf = []
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []
    if buf:
        yield buf


def _stack(items):
    if isinstance(items[0], (tuple, list)):
        return tuple(torch.stack([it[i] for it in items])
                     for i in range(len(items[0])))
    return torch.stack(items)


def run_epoch(trainer, feeder, epoch, mode, logger, writer, save_dir=None,
              log_interval=10, schedule=None, steps_per_dispatch=1):
    """One train or valid epoch. The loss sum stays on the device between
    log points (a host fetch waits for the device), so the epoch average is
    exact while per-iteration scalars are sampled every `log_interval`."""
    loss_meter = AverageMeter()
    num_iters = len(feeder)
    start_time = time.time()
    last = None
    loss_sum = None
    n_total = 0

    def iter_steps():
        if mode == "train" and steps_per_dispatch > 1:
            for items in _chunks(feeder, steps_per_dispatch):
                parts, imgf = trainer.train_steps(_stack(items))
                for i, batch in enumerate(items):
                    yield (batch, _n_of(batch),
                           {k: v[i] for k, v in parts.items()},
                           imgf if i == len(items) - 1 else None)
            return
        for item in feeder:
            if feeder.with_mask:
                # the mask keeps the valid loss an exact partial-batch mean
                # (reference train.py:82-90)
                batch, mask, n = item
                parts, imgf = trainer.valid_step(batch, mask)
            elif mode == "train":
                batch, n = item, _n_of(item)
                parts, imgf = trainer.train_step(batch)
            else:
                batch, n = item, _n_of(item)
                parts, imgf = trainer.valid_step(batch)
            yield batch, n, parts, imgf

    for it, (batch, n, parts, imgf) in enumerate(iter_steps()):
        if imgf is not None:
            last = (batch, imgf)
        contrib = parts["loss"] * n       # stays on the device
        loss_sum = contrib if loss_sum is None else loss_sum + contrib
        n_total += n

        if mode == "train" and schedule is not None:
            # per-iteration lr, as reference train.py:108-110
            writer.add_scalar("lr_iter", schedule(num_iters * epoch + it),
                              num_iters * epoch + it)

        if (it + 1) % log_interval == 0 or it + 1 == num_iters:
            global_step = num_iters * epoch + it
            writer.add_scalar(f"{mode}_loss_iter", float(parts["loss"]),
                              global_step)
            for k in ("loss1", "loss2", "loss3"):
                writer.add_scalar(f"{mode}_{k}_iter", float(parts[k]),
                                  global_step)
            loss_meter.sum = float(loss_sum)
            loss_meter.count = n_total
            loss_meter.avg = loss_meter.sum / max(n_total, 1)
            logger.info(f"epoch: {epoch + 1:0>2}, iter: {it + 1:0>3}, "
                        f"{mode} loss: {loss_meter.avg:.4f}")

    logger.info(f"cost time: {time.time() - start_time:.3f}s\n")

    if save_dir is not None and last is not None:
        batch, imgf = last

        def first(x):
            return x[0].float().cpu().numpy()

        if isinstance(batch, (tuple, list)):
            result = save_result(first(imgf), first(batch[0]),
                                 first(batch[1]))
        else:  # AE mode: [input | reconstruction]
            result = save_result(first(imgf), first(batch), first(imgf))
        imwrite(os.path.join(save_dir, f"{epoch + 1:0>2}.png"), result)

    return loss_meter.avg


def _snapshot(model, trainer):
    """Host copies of the model and optimizer state at an epoch boundary."""
    return ({k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}, trainer.state_dict())


def resume(run_dir, model, trainer, model_name):
    """Load a run's last state into `model` and `trainer`: the port's
    epoch_last.pth with its .optim or, where the folder holds none, the
    JAX package's epoch_last.ckpt (its whole TrainState: params,
    statistics, the optax state and step, `jax_train_state_to_torch`). Returns (the path
    read, the epoch its metadata records)."""
    path = os.path.join(run_dir, "epoch_last.pth")
    if not os.path.isfile(path) and os.path.isfile(path[:-4] + ".ckpt"):
        path = path[:-4] + ".ckpt"
        tree, name, cfg = jax_tree(path, model, model_name)
        state, train_state = jax_train_state_to_torch(tree, name, **cfg)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        train_state = load_train_state(path)
    model.load_state_dict(state)
    trainer.load_state_dict(train_state)
    return path, int(load_checkpoint_meta(path).get("epoch", 0))


def main(argv=None):
    args = get_train_parser().parse_args(argv)
    if args.spatial > 1:
        raise NotImplementedError(
            "--spatial > 1 is not ported yet (ROADMAP.md queue 1 item 7b, "
            "spatial sharding)")
    if args.multihost:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if args.bs % world:
            raise ValueError(f"--bs {args.bs} is the global batch and must "
                             f"divide by the world size {world}")
        device = init_multihost(args.device)
    else:
        device = resolve_device(args.device)
    setup_seed(args.seed)
    # f32 means f32: cuDNN would run the F.conv2d route and the loss filters
    # in TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # rank-0-only persistent outputs (reference train.py:100, 121, 167,
    # 354): the other ranks run the same steps and write into a folder of
    # their own, removed at the end
    root = ckpt_root(args) if is_main_process() else tempfile.mkdtemp(
        prefix="mmif_rank_scratch_")
    time_str = datetime.strftime(datetime.now(), "%Y-%m-%d_%H-%M")
    ckpt_dir = os.path.join(root, time_str)
    n = 1
    while os.path.isdir(ckpt_dir):     # same-minute runs get a suffix
        ckpt_dir = os.path.join(root, f"{time_str}_{n}")
        n += 1
    os.makedirs(ckpt_dir)
    logger = Logger(os.path.join(ckpt_dir, "train.log")).init_logger()
    writer = ScalarWriter(ckpt_dir)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    logger.info(f"device: {device} ({name})")
    if args.multihost:
        logger.info(f"data parallel: rank {rank()} of {world_size()} "
                    f"({dist.get_backend()}), global batch {args.bs}")
    logger.info(f"model: {args.model}")

    data_dir, is_sample = resolve_data_dir(args)
    set_name_train, _, img_type = dataset_layout(args.data)
    if is_sample:
        set_name_train = "test"   # the bundled samples ship a test split
        logger.info(f"using bundled sample data at {data_dir}")

    rng = np.random.RandomState(args.seed)
    if args.ae:
        train_set = AEDataset(data_dir, set_name=set_name_train,
                              img_type=img_type, transform=True,
                              fix_size=True, rng=rng)
        valid_set = AEDataset(data_dir, set_name=set_name_train,
                              img_type=img_type, fix_size=True, rng=rng)
    elif args.use_patches:
        train_set = FusionPatches(data_dir, set_name=set_name_train,
                                  set_type="train", img_type=img_type,
                                  transform=True, rng=rng)
        valid_set = FusionPatches(data_dir, set_name=set_name_train,
                                  set_type="valid", img_type=img_type)
    else:
        train_set = FusionDataset(data_dir, set_name=set_name_train,
                                  set_type="train", img_type=img_type,
                                  transform=True, fix_size=args.fix_size,
                                  rng=rng)
        valid_set = FusionDataset(data_dir, set_name=set_name_train,
                                  set_type="valid", img_type=img_type,
                                  fix_size=args.fix_size, rng=rng)

    # train drops the final partial batch (one step shape); valid keeps it,
    # as the reference DataLoader does
    shard = (rank(), world_size()) if args.multihost else None
    train_feeder = Feeder(train_set, args.bs, shuffle=True, drop_last=True,
                          device=device, seed=args.seed, workers=args.workers,
                          shard=shard)
    valid_feeder = Feeder(valid_set, args.bs, shuffle=False, drop_last=False,
                          device=device, with_mask=True, workers=args.workers,
                          shard=shard)
    logger.info(f"train iters/epoch: {len(train_feeder)}, "
                f"valid iters/epoch: {len(valid_feeder)}")

    model_cfg = parse_model_cfg(args.model_cfg)
    model = create_model(args.model,
                         generator=torch.Generator().manual_seed(args.seed),
                         **model_cfg).to(device)
    schedule = make_lr_schedule(args.lr, len(train_feeder), args.epoch,
                                warmup=args.warmup,
                                warmup_method=args.warmup_method)
    bundle = make_loss_bundle(args.ssim_mode, args.ssim_weight,
                              args.pixel_mode, args.pixel_weight,
                              args.grad_mode, args.grad_weight)
    logger.info(f"ssim mode: {args.ssim_mode}, weight: {args.ssim_weight}")
    logger.info(f"pixel mode: {args.pixel_mode}, weight: "
                f"{args.pixel_weight}")
    logger.info(f"grad mode: {args.grad_mode}, weight: {args.grad_weight}")
    trainer = Trainer(model, schedule, bundle,
                      clip_grad=5.0 if args.clip_grad else None,
                      ae=args.ae, fast=args.fast_train, amp=args.amp)

    start_epoch = 0
    if args.init_from:
        # stage-2 init: the parameters of another run, a fresh optimizer
        init_path = checkpoint_path(os.path.join(root, args.init_from))
        missing, _ = restore(model, init_path, args.model)
        logger.info(f"initialized params from {init_path}"
                    + (f" ({len(missing)} kept at init)" if missing else ""))
    if args.resume:
        resume_path, start_epoch = resume(os.path.join(root, args.resume),
                                          model, trainer, args.model)
        logger.info(f"resumed from {resume_path} at epoch {start_epoch}")
    # every rank starts from rank 0's state (the reference broadcasts its
    # init-weight file, train.py:286-294)
    broadcast_module(model, *trainer.mu.values(), *trainer.nu.values())
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"params: {n_params / 1e6:.3f}M")

    train_dir = os.path.join(ckpt_dir, "train")
    valid_dir = os.path.join(ckpt_dir, "valid")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(valid_dir, exist_ok=True)

    meta = {"model": args.model, "data": args.data, "model_cfg": model_cfg}
    best_epoch, best_loss = 0, 0.0
    # epoch_last holds the state of the last completed epoch, so --resume
    # after an interrupt restarts exactly where that epoch ended
    last_completed_epoch = start_epoch
    last_good = _snapshot(model, trainer)
    try:
        for epoch in range(start_epoch, args.epoch):
            profiling = args.profile and epoch == start_epoch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = (torch.profiler.profile(activities=acts) if profiling
                    else contextlib.nullcontext())
            lr_now = schedule(trainer.step)
            logger.info(f"Epoch: [{epoch + 1:0>2}/{args.epoch:0>2}], "
                        f"lr: {lr_now:.2e}")
            logger.info("-" * 16)
            with prof:
                train_loss = run_epoch(
                    trainer, train_feeder, epoch, "train", logger, writer,
                    train_dir, schedule=schedule,
                    steps_per_dispatch=args.steps_per_dispatch)
                valid_loss = run_epoch(trainer, valid_feeder, epoch, "valid",
                                       logger, writer, valid_dir)
            if profiling:
                trace = os.path.join(ckpt_dir, "profile", "trace.json")
                os.makedirs(os.path.dirname(trace), exist_ok=True)
                prof.export_chrome_trace(trace)
                logger.info(f"profiler trace written to {trace}")

            writer.add_scalar("train_loss_epoch", train_loss, epoch)
            writer.add_scalar("valid_loss_epoch", valid_loss, epoch)
            writer.add_scalar("lr", lr_now, epoch)
            logger.info(f"epoch: {epoch + 1:0>2}, train loss: "
                        f"{train_loss:.4f}, valid loss: {valid_loss:.4f}\n")
            last_completed_epoch = epoch + 1
            last_good = _snapshot(model, trainer)

            # best-checkpoint gate: reference train.py:362-371
            if epoch < args.epoch // 2:
                continue
            if valid_loss < best_loss or epoch == args.epoch // 2:
                best_epoch, best_loss = epoch + 1, valid_loss
                save_checkpoint(os.path.join(ckpt_dir, "epoch_best.pth"),
                                *last_good,
                                {**meta, "epoch": best_epoch,
                                 "valid_loss": best_loss})
    finally:
        save_checkpoint(os.path.join(ckpt_dir, "epoch_last.pth"), *last_good,
                        {**meta, "epoch": last_completed_epoch})
        writer.close()
        logger.info(f"training model done, best loss: {best_loss:.4f} "
                    f"in epoch: {best_epoch}")
        close_logger(logger)
        if args.multihost:
            dist.destroy_process_group()
            if root != ckpt_root(args):
                shutil.rmtree(root, ignore_errors=True)
    return ckpt_dir


if __name__ == "__main__":
    main()
