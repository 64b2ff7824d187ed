"""Host -> device data pipeline: sharded placement + background prefetch,
the port of ``repro/data/pipeline.py``.

A batch is laid out over a grid's batch axes: each rank keeps its own
block of every leaf along dim 0 (``shard_batch``, the counterpart of a
``NamedSharding`` over ``P(batch_axes)``).  A single background thread
keeps ``prefetch`` batches in flight, each already on the device, so
host generation overlaps device compute (the standard input-pipeline
overlap).  On the card each array is copied from pinned host memory
with ``non_blocking=True``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .. import device as device_mod


def shard_batch(batch: dict, grid, batch_axes=("data",), device=None):
    """This rank's block of a host batch over ``batch_axes`` (those the
    grid has): each leaf's rows ``r * B / n`` to ``(r + 1) * B / n``,
    ``n`` the axes' size and ``r`` this rank's row-major index along
    them, on ``device``; a 0-d leaf whole.  A leading dim the axes do
    not divide raises ``ValueError``."""
    axes = tuple(a for a in batch_axes if a in grid.names)
    sizes = dict(zip(grid.names, grid.shape))
    at = dict(zip(grid.names, grid.coords))
    r, n = 0, 1
    for a in axes:
        r, n = r * sizes[a] + at[a], n * sizes[a]
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim >= 1:
            if v.shape[0] % n:
                raise ValueError(f"batch leaf {k!r}: {v.shape[0]} rows do "
                                 f"not divide over {axes} ({n} blocks)")
            b = v.shape[0] // n
            v = v[r * b:(r + 1) * b]
        out[k] = v
    return to_device(out, device_mod.resolve(device))


def to_device(batch: dict, device) -> dict:
    """A host batch (dict of numpy arrays) as tensors on ``device``; to a
    CUDA device through pinned memory, without waiting for the copy."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            out[k] = t.pin_memory().to(dev, non_blocking=True)
        else:
            out[k] = t.to(dev)
    return out


class DataPipeline:
    """``source.batch_at(step)`` from ``start_step`` on, on ``device``;
    with ``mesh`` (a grid), this rank's block of each over
    ``batch_axes`` (``shard_batch``)."""

    def __init__(self, source, device=None, prefetch: int = 2,
                 start_step: int = 0, mesh=None, batch_axes=("data",)):
        self.source = source
        self.device = device_mod.resolve(device)
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            if self.mesh is not None:
                batch = shard_batch(batch, self.mesh, self.batch_axes,
                                    self.device)
            else:
                batch = to_device(batch, self.device)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.5)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        """Stop the worker and wait for it (it finishes the batch in
        hand)."""
        self._stop.set()
        self._thread.join()
