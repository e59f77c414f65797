"""Host input pipeline: weighted sampling and threaded prefetch.

Port of ``oaprogressionmmf_tpu/data/pipeline.py``: counter-based samplers,
a thread pool that reads and crops samples on the host, batch assembly
into stacked arrays, and a bounded prefetch queue. Where the JAX loader
puts a batch onto its mesh, this one hands over torch CPU tensors, in
pinned memory when ``pin_memory`` is set, so that the trainer's
``.to(device, non_blocking=True)`` copies run asynchronously.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch


class WeightedSampler:
    """Inverse-class-frequency sampling with replacement, replayable: the
    order of an epoch is numpy's ``default_rng([seed, epoch])`` draw, the
    JAX package's order index for index."""

    def __init__(self, targets: Sequence[int], seed: int = 0):
        targets = np.asarray(targets)
        _, inverse, counts = np.unique(targets, return_inverse=True,
                                       return_counts=True)
        freqs = counts / len(targets)
        self.weights = 1.0 / freqs[inverse]
        self.probs = self.weights / self.weights.sum()
        self.num_samples = len(targets)
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, epoch])
        return rng.choice(self.num_samples, size=self.num_samples,
                          replace=True, p=self.probs)


class SequentialSampler:
    def __init__(self, num_samples: int):
        self.num_samples = num_samples

    def epoch_indices(self, epoch: int) -> np.ndarray:
        return np.arange(self.num_samples)


def _put(q, item, stop) -> bool:
    """Queue put that yields to the consumer's stop flag, so that no
    producer thread stays blocked when an epoch's iterator is abandoned."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


class BatchLoader:
    """Iterate the batches of one epoch, read ahead on threads.

    Args:
        dataset: an object with ``.get(idx, epoch)`` (DatasetOAI3d-like).
        sampler: an object with ``.epoch_indices(epoch)`` and
            ``.num_samples``.
        batch_size: samples per batch (per shard).
        drop_last: drop the ragged final batch.
        num_workers: read threads.
        prefetch: batches read ahead.
        pad_to_batch: repeat the last sample to fill a ragged batch
            (``_n_valid`` keeps the true count).
        shard_index, shard_count: contiguous equal shards of
            floor(n / shard_count) samples, the remainder dropped.
        pin_memory: hand over the arrays as pinned CPU tensors.

    A batch is a dict of CPU tensors (the stacked arrays), lists (strings
    such as ``exam_knee_id``) and ``_n_valid``."""

    def __init__(self, dataset, sampler, batch_size: int,
                 drop_last: bool = False, num_workers: int = 8,
                 prefetch: int = 2, pad_to_batch: bool = False,
                 shard_index: int = 0, shard_count: int = 1,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pad_to_batch = pad_to_batch
        self.shard_index = int(shard_index)
        self.shard_count = int(shard_count)
        self.pin_memory = pin_memory
        if not 0 <= self.shard_index < self.shard_count:
            raise ValueError(f"shard_index {shard_index} out of range for "
                             f"shard_count {shard_count}")

    def _local_samples(self) -> int:
        n = self.sampler.num_samples
        if self.shard_count > 1:
            n = n // self.shard_count
        return n

    def _shard_order(self, order: np.ndarray) -> np.ndarray:
        if self.shard_count <= 1:
            return order
        k = len(order) // self.shard_count
        return order[self.shard_index * k:(self.shard_index + 1) * k]

    def batches_per_epoch(self) -> int:
        n = self._local_samples()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __len__(self):
        return self.batches_per_epoch()

    def _assemble(self, items: list[dict]) -> dict:
        n_valid = len(items)
        if self.pad_to_batch and n_valid < self.batch_size:
            items = items + [items[-1]] * (self.batch_size - n_valid)
        batch: dict = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            if isinstance(vals[0], np.ndarray):
                t = torch.from_numpy(np.stack(vals, axis=0))
                batch[k] = t.pin_memory() if self.pin_memory else t
            else:
                batch[k] = vals  # e.g. exam_knee_id strings
        batch["_n_valid"] = n_valid
        return batch

    def epoch(self, epoch_idx: int = 0):
        """Generator of the batches of one epoch, read ahead."""
        order = self._shard_order(self.sampler.epoch_indices(epoch_idx))
        nb = self.batches_per_epoch()
        chunks = [order[i * self.batch_size:(i + 1) * self.batch_size]
                  for i in range(nb)]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for chunk in chunks:
                        if stop.is_set():
                            return
                        items = list(pool.map(
                            lambda i: self.dataset.get(int(i),
                                                       epoch=epoch_idx),
                            chunk))
                        if not _put(out_q, self._assemble(items), stop):
                            return
                _put(out_q, None, stop)
            except BaseException as e:  # raised again in the consumer
                _put(out_q, e, stop)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


def make_batch_loader(backend: str, *args, **kwargs) -> BatchLoader:
    """Loader factory (``loader_backend``): ``threads``, the default. The
    JAX package's ``grain`` backend (worker processes) is not ported."""
    if backend == "grain":
        raise NotImplementedError(
            "loader_backend=grain is not ported (ROADMAP.md §1 item 1: "
            "worker processes on torch.utils.data); use 'threads'")
    if backend in ("threads", None, ""):
        return BatchLoader(*args, **kwargs)
    raise ValueError(f"Unknown loader backend: {backend}")
