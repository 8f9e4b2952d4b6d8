"""Batched host-to-device input pipeline (data/loader.py of the JAX package).

A producer thread assembles numpy batches ahead of time with a thread pool
(numpy releases the interpreter lock), and the consumer moves each batch to
the device through pinned memory with `non_blocking=True`, one batch ahead,
so the copy overlaps the previous step. `n_repeat` passes over the dataset
make one epoch (blox RepeatedDataLoader).

Under data parallelism (`rows=(rank_in_data, n_data)`) every rank walks the
same global shuffled order (the seed is shared) and assembles only its
`mesh.batch_rows` of each global batch, so no rank loads, or re-renders,
another's examples. A short final batch (drop_last=False) that does not
split evenly is assembled whole by every rank, as the JAX loader places it
unsharded: each rank computes the same values on it.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import itertools
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.parallel.mesh import batch_rows


def _stack_batch(examples) -> AttrDict:
    return AttrDict({k: np.stack([np.asarray(ex[k]) for ex in examples], 0)
                     for k in examples[0]})


def to_device(batch_np: AttrDict, device: torch.device) -> AttrDict:
    """numpy batch -> tensors on `device`; to a GPU through pinned memory,
    without waiting for the copy."""
    out = AttrDict()
    for k, v in batch_np.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 n_repeat: int = 1, drop_last: bool = True,
                 num_workers: int = 4, seed: int = 0, device="cpu",
                 prefetch: int = 2, rows=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.n_repeat = n_repeat
        self.drop_last = drop_last
        # clamp to the host's cores: on a 1-core host the pool's threads only
        # fight over the interpreter lock (loader.py:45-48 of the JAX package)
        self.num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        self.seed = seed
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.rows = rows  # (rank_in_data, n_data), or None for the whole batch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) * self.n_repeat
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_stream(self):
        rng = np.random.RandomState(self.seed + self._epoch)
        for _ in range(self.n_repeat):
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(idx)
            yield from idx
        self._epoch += 1

    def _own_rows(self, idx):
        if self.rows is None or len(idx) % self.rows[1]:
            return idx
        return idx[batch_rows(self.rows[0], self.rows[1], len(idx))]

    def __iter__(self) -> Iterator[AttrDict]:
        stream = self._index_stream()
        done = object()
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()
        errors = []

        def put_checked(item) -> bool:
            """A put that re-checks `stop`, so an abandoned iterator cannot
            leave the producer blocked."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                pool_cm = (concurrent.futures.ThreadPoolExecutor(self.num_workers)
                           if self.num_workers > 1 else contextlib.nullcontext())
                with pool_cm as pool:
                    fetch = (pool.map if pool is not None else map)
                    while not stop.is_set():
                        idx = list(itertools.islice(stream, self.batch_size))
                        if len(idx) < self.batch_size and (self.drop_last or not idx):
                            break
                        idx = self._own_rows(idx)
                        batch = _stack_batch(list(fetch(self.dataset.__getitem__, idx)))
                        if not put_checked(batch):
                            return
            except Exception as e:  # raised again in the consumer
                errors.append(e)
            finally:
                put_checked(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        pending = collections.deque()
        try:
            while True:
                batch = q.get()
                if batch is done:
                    break
                pending.append(to_device(batch, self.device))
                if len(pending) > 1:
                    yield pending.popleft()
            if errors:
                raise errors[0]
            while pending:
                yield pending.popleft()
        finally:
            stop.set()
            thread.join(timeout=10)
