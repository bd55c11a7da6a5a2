"""Host-side input pipeline: process sharding, epoch shuffling, prefetch
(a copy of ``splade_tpu/data/pipeline.py``).

Replaces the reference's DataLoader + DistributedSampler
(reference: src/train/data/dataloader.py:167-240,
train_v33_ddp.py:159-189): each process sees a disjoint 1/P slice of the
epoch permutation (numpy-seeded by epoch like ``sampler.set_epoch``, so the
port and the JAX package see the same order), batches are collated on a
background thread, and a bounded queue gives prefetch-depth overlap with
device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np


class ShardedBatchIterator:
    """Deterministic sharded, shuffled, drop-last batch iterator."""

    def __init__(
        self,
        dataset,
        collate_fn: Callable,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 42,
        epoch: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        prefetch_depth: int = 2,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch_depth = max(prefetch_depth, 0)

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Reseed the permutation (reference: DistributedSampler.set_epoch).

        ``skip_batches`` fast-forwards the epoch without tokenizing or
        collating the skipped batches (mid-epoch resume: the permutation is
        a pure function of seed+epoch, so skipping over raw indices
        reproduces the uninterrupted run at zero collation cost)."""
        self.epoch = epoch
        self.skip_batches = skip_batches

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = (
            np.random.default_rng(self.seed + self.epoch).permutation(n)
            if self.shuffle else np.arange(n)
        )
        # Pad to a multiple of P so every process sees the same batch count
        # (reference DistributedSampler wraps around). np.resize tiles the
        # permutation as many times as needed — a single slice falls short
        # when P - n % P > n (e.g. 3 docs on 8 processes), which would give
        # processes unequal batch counts and deadlock the jitted step's
        # collectives on the idle hosts.
        P = self.process_count
        if n % P:
            order = np.resize(order, n + (P - n % P))
        return order[self.process_index::P]

    def __len__(self) -> int:
        # pure arithmetic: materializing the O(n) permutation just to count
        # batches costs seconds + GBs at 10^7-triplet scale
        n = len(self.dataset)
        P = self.process_count
        per_proc = (n + (-n % P)) // P
        if self.drop_last:
            return per_proc // self.batch_size
        return -(-per_proc // self.batch_size)

    def _batches(self) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        nb = len(self)
        for b in range(getattr(self, "skip_batches", 0), nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.prefetch_depth == 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def producer():
            try:
                for batch in self._batches():
                    # bounded put with a stop check: a consumer that
                    # abandons the epoch early (preemption, max_steps)
                    # closes the generator and the producer must not stay
                    # blocked on a full queue forever
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surface worker errors to the consumer
                err.append(e)
            finally:
                while not stop.is_set():  # consumer alive: must deliver
                    try:
                        q.put(sentinel, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()  # GeneratorExit / break: release the producer


def create_dataloader(
    dataset,
    collate_fn: Callable,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 42,
    drop_last: bool = True,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    prefetch_depth: int = 2,
) -> ShardedBatchIterator:
    """Factory mirroring the reference's create_dataloader contract. The
    rank and world size come from ``torch.distributed`` when it is
    initialised, else 0 of 1."""
    if process_index is None or process_count is None:
        import torch.distributed as dist

        ready = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if ready else 0
        process_count = dist.get_world_size() if ready else 1
    return ShardedBatchIterator(
        dataset, collate_fn, batch_size,
        shuffle=shuffle, seed=seed, drop_last=drop_last,
        process_index=process_index, process_count=process_count,
        prefetch_depth=prefetch_depth,
    )
