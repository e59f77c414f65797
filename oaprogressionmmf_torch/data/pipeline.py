"""Host input pipeline: weighted sampling and threaded prefetch.

Port of ``oaprogressionmmf_tpu/data/pipeline.py``: counter-based samplers,
a thread pool that reads and crops samples on the host (or worker
processes, ``loader_backend: grain``), batch assembly into stacked
arrays, and a bounded prefetch queue. Where the JAX loader
puts a batch onto its mesh, this one hands over torch CPU tensors, in
pinned memory when ``pin_memory`` is set, so that the trainer's
``.to(device, non_blocking=True)`` copies run asynchronously.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Sequence

import numpy as np
import torch

from .. import tracing


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
        """Generator of the batches of one epoch, read ahead. Each batch's
        read and assembly on the producer thread is the span
        ``loader.batch``, id ``(epoch_idx, batch index)``, recorded when
        the thread that starts the epoch records."""
        order = self._shard_order(self.sampler.epoch_indices(epoch_idx))
        nb = self.batches_per_epoch()
        chunks = [order[i * self.batch_size:(i + 1) * self.batch_size]
                  for i in range(nb)]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # a profiler session covers only the thread that opened it
        traced = tracing.active()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b, chunk in enumerate(chunks):
                        if stop.is_set():
                            return
                        with (tracing.recording() if traced
                              else nullcontext()), tracing.span(
                                "loader.batch", id=(epoch_idx, b)):
                            items = list(pool.map(
                                lambda i: self.dataset.get(int(i),
                                                           epoch=epoch_idx),
                                chunk))
                            batch = self._assemble(items)
                        if not _put(out_q, batch, stop):
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


class _OrderedView(torch.utils.data.Dataset):
    """Record k = the dataset's sample ``order[k]`` read for ``epoch`` (its
    crop and flip draws replayed), as JAX's grain data source."""

    def __init__(self, dataset, order, epoch: int):
        self._dataset = dataset
        self._order = np.asarray(order)
        self._epoch = int(epoch)

    def __len__(self):
        return len(self._order)

    def __getitem__(self, k):
        return self._dataset.get(int(self._order[k]), epoch=self._epoch)


def _as_list(items: list) -> list:
    return items


class WorkerBatchLoader(BatchLoader):
    """``loader_backend: grain``: samples read by ``num_workers`` worker
    processes of ``torch.utils.data.DataLoader`` (0: in this process), in
    the order of :class:`BatchLoader`, so the batches are the same (the
    JAX package's GrainBatchLoader, whose worker processes grain starts).

    The workers are spawned for each epoch (``persistent_workers=False``),
    as grain spawns its own: the dataset must pickle. Each worker reads
    whole batches' samples; the batch is assembled (padded, pinned) in
    this process."""

    def epoch(self, epoch_idx: int = 0):
        order = self._shard_order(self.sampler.epoch_indices(epoch_idx))
        # never read a sample of a dropped batch
        order = order[:self.batches_per_epoch() * self.batch_size]
        workers = int(self.num_workers)
        loader = torch.utils.data.DataLoader(
            _OrderedView(self.dataset, order, epoch_idx),
            batch_size=self.batch_size, shuffle=False, drop_last=False,
            collate_fn=_as_list, num_workers=workers,
            persistent_workers=False,
            prefetch_factor=self.prefetch if workers else None,
            multiprocessing_context="spawn" if workers else None)
        for items in loader:
            yield self._assemble(items)


def make_batch_loader(backend: str, *args, **kwargs) -> BatchLoader:
    """Loader factory (``loader_backend``): ``threads`` (the default, a
    thread pool) or ``grain`` (worker processes,
    :class:`WorkerBatchLoader`)."""
    if backend == "grain":
        return WorkerBatchLoader(*args, **kwargs)
    if backend in ("threads", None, ""):
        return BatchLoader(*args, **kwargs)
    raise ValueError(f"Unknown loader backend: {backend}")
