"""Host -> device input pipeline (counterpart of multi_modal_image_fusion_tpu
data/pipeline.py; replaces the reference's DataLoader workers, reference
train.py:207-222).

A background thread assembles NHWC numpy batches, pins them (CUDA targets)
and starts `non_blocking` copies to the device, so transfers overlap the
step; the consumer pops ready device batches from a bounded queue. Index
order is the JAX Feeder's: one seeded `np.random.RandomState` shuffles at
every epoch and advances from epoch to epoch.
"""

import queue
import threading

import numpy as np
import torch

from ..parallel.mesh import shard_batch


def _to_batch(items):
    """items: list of HW arrays or of tuples of HW arrays -> NHWC array(s)."""
    if isinstance(items[0], tuple):
        return tuple(np.stack([it[i] for it in items])[..., None]
                     for i in range(len(items[0])))
    return np.stack(items)[..., None]


class Feeder:
    """Iterates a dataset in batches of NHWC float32 tensors on `device`.

    Args:
      dataset: indexable dataset returning HW arrays or tuples of them.
      batch_size: batch size.
      shuffle: reshuffle the indices at every epoch (seeded numpy RNG).
      drop_last: drop the final partial batch (keeps one step shape).
      device: torch device of the batches (default: CPU).
      with_mask: yield (batch, mask, n_true), mask a (N,) 0/1 float32
        tensor on the device, for the valid step's masked loss average.
      workers: item-loading threads per batch (reference DataLoader
        num_workers); 0 loads in the producer thread.
      prefetch: queue depth of batches in flight.
      shard: (rank, world) under data parallelism (parallel/mesh.py):
        every rank assembles the identical global batch (the same items in
        the same order, so the augmentation draws match), wrap-pads a
        final partial one to a multiple of `world` (torch's
        DistributedSampler; the mask excludes the repeats) and places its
        contiguous slice (`shard_batch`); n_true stays the global count.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 device="cpu", seed=0, prefetch=2, with_mask=False,
                 workers=0, shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.with_mask = with_mask
        self.workers = workers
        self.shard = shard
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self, pool):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        world = self.shard[1] if self.shard else 1
        for i in range(0, stop, self.batch_size):
            take = idx[i:i + self.batch_size]
            n_true = len(take)
            if n_true % world:
                # np.resize repeats cyclically, also past len(take)
                take = np.resize(take, n_true + world - n_true % world)
            if pool is not None:
                items = list(pool.map(lambda j: self.dataset[int(j)], take))
            else:
                items = [self.dataset[int(j)] for j in take]
            batch = _to_batch(items)
            mask = np.zeros((len(take),), np.float32)
            mask[:n_true] = 1.0
            if self.shard:
                batch, mask = shard_batch((batch, mask), *self.shard)
            if self.with_mask:
                yield batch, mask, n_true
            else:
                yield batch

    def _place(self, x):
        if isinstance(x, tuple):
            return tuple(map(self._place, x))
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def produce():
            pool = None
            try:
                if self.workers:
                    from concurrent.futures import ThreadPoolExecutor
                    pool = ThreadPoolExecutor(max_workers=self.workers)
                for item in self._batches(pool):
                    if stop.is_set():
                        return
                    if self.with_mask:
                        batch, mask, n_true = item
                        put((self._place(batch), self._place(mask), n_true))
                    else:
                        put(self._place(item))
            except Exception as e:  # surface loader errors to the consumer
                put(e)
            finally:
                if pool is not None:
                    pool.shutdown()
                put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
