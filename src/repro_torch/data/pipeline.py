"""Host -> device data pipeline with background prefetch, the port of
``repro/data/pipeline.py`` (one device; placement over a mesh waits for
ROADMAP A.10d).

A single background thread keeps ``prefetch`` batches in flight, each
already on the device, so host generation overlaps device compute (the
standard input-pipeline overlap).  On the card each array is copied
from pinned host memory with ``non_blocking=True``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .. import device as device_mod

_MESH = ("sharding a batch over a mesh is not ported yet (ROADMAP A.10d); "
         "the port's pipeline places it on one device")


def shard_batch(batch: dict, mesh, batch_axes=("data",)):
    """Place a host batch onto the mesh, sharded over batch_axes (not
    ported yet)."""
    raise NotImplementedError(_MESH)


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
    def __init__(self, source, device=None, prefetch: int = 2,
                 start_step: int = 0, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self.source = source
        self.device = device_mod.resolve(device)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = to_device(self.source.batch_at(step), self.device)
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
        self._stop.set()
