"""Data parallelism over torch.distributed (counterpart of
multi_modal_image_fusion_tpu parallel/mesh.py; reference common.py:96-113,
train.py:203-222, 285-297: single-node NCCL DDP with SyncBatchNorm).

The JAX package shards the batch over a `data` mesh and lets XLA insert
the gradient and batch-statistic reductions. The port keeps one process a
rank and makes each reduction itself:

- every rank holds the identical global batch (the feeders are seeded
  alike, as the JAX multi-process feeders are) and `shard_batch` takes
  its contiguous slice;
- parameters and buffers are broadcast from rank 0 after init or restore
  (`broadcast_module`; the reference broadcasts its init-weight file);
- the Trainer averages the gradients and the logged loss parts over the
  ranks (`all_reduce_mean`) before its global-norm clip, as the JAX step
  clips the global gradient;
- a batch norm's batch statistics cover the global batch
  (ops/layers.batch_norm through `global_sum`, a differentiable
  all-reduce).

Collectives run only in a process group of more than one rank
(`spans_ranks`, the one rule the Trainer and the batch norms read): with
no group, or a world-1 group, every helper is the identity and calls no
collective. torch's DistributedDataParallel is not used: its reducer hooks
`.backward()`, and the Trainer takes its gradients with
`torch.autograd.grad`.
"""

import os

import torch
import torch.distributed as dist

__all__ = ["all_reduce_mean", "broadcast_module", "global_sum",
           "init_multihost", "is_main_process", "rank", "shard_batch",
           "spans_ranks", "world_size"]


def _initialized():
    return dist.is_available() and dist.is_initialized()


def world_size():
    """Ranks of the process group, 1 without one."""
    return dist.get_world_size() if _initialized() else 1


def rank():
    return dist.get_rank() if _initialized() else 0


def spans_ranks():
    """True in a process group of more than one rank: the one rule for
    when a collective runs (a world-1 group reduces nothing)."""
    return world_size() > 1


def is_main_process():
    """True on the rank that writes logs, checkpoints and scalars (the
    reference gates them on rank 0: train.py:100, 121, 167, 354)."""
    return rank() == 0


def init_multihost(device=None, backend=None):
    """Join the process group of the reference launcher's env contract
    (reference common.py:96-102): RANK and WORLD_SIZE, MASTER_ADDR
    (default 127.0.0.1) and MASTER_PORT (default 12355, the JAX package's);
    LOCAL_RANK picks the card, cuda:<LOCAL_RANK>, unless `device` names
    another ("cpu"). `backend` defaults to NCCL on a card and gloo on the
    CPU; gloo also runs ranks that share one card. Returns this rank's
    torch.device."""
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise ValueError(f"--multihost needs the launcher's env contract: "
                         f"{', '.join(missing)} not set (RANK, WORLD_SIZE, "
                         f"MASTER_ADDR, MASTER_PORT, LOCAL_RANK)")
    if device is None or str(device) == "cuda":
        device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; the port runs on the GPU unless "
                "asked for the CPU (--device cpu)")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "12355")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def shard_batch(batch, rank_=None, world=None):
    """This rank's contiguous slice of a global batch (an array, or a tuple
    of arrays sharing the batch axis): rows [r * n / W, (r + 1) * n / W).
    The batch must divide by the world size."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, r, w) for b in batch)
    n = batch.shape[0]
    if n % w:
        raise ValueError(f"batch of {n} does not divide over {w} ranks")
    m = n // w
    return batch[r * m:(r + 1) * m]


def broadcast_module(module, *tensors):
    """Rank 0's parameters and buffers (and `tensors`, e.g. optimizer
    moments) into every rank's, in place."""
    if not spans_ranks():
        return
    with torch.no_grad():
        for t in (*module.state_dict().values(), *tensors):
            dist.broadcast(t, src=0)


def all_reduce_mean(tensors):
    """The mean over the ranks of each tensor, as new tensors (one
    all-reduce of their concatenation, which must share a dtype); the
    tensors themselves unless the group spans ranks."""
    tensors = list(tensors)
    if not spans_ranks():
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def global_sum(t):
    """t summed over the ranks by a differentiable all-reduce (its gradient
    is summed back over the ranks); t unless the group spans ranks."""
    if not spans_ranks():
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)
