"""The device side of the chunked run loop: K supersteps to one host fetch.

The reference scans a chunk with ``lax.scan`` (``_scan_steps``), which
XLA compiles into one program.  Here a :class:`ChunkRunner` holds the
engine state, the carry and the chunk's stats rows in static tensors,
and runs each superstep as one *predicated step* over them:

  * ``active = ~done & (left > 0)``, and on a no-flush step also
    ``~flush`` (a flush the device scheduled idles the rest of the chunk:
    the host sees it in the chunk's fetch and starts the next chunk with
    a flush step);
  * the engine superstep, its new state kept only where ``active``;
  * the stats row, with ``active`` last, written into row ``row`` of the
    ``(K, len(keys) + 1)`` f64 buffer (exact for every f32 charge and
    every int32 count, so the reference's int32 side channel
    ``_EXACT_INT_STATS`` has no counterpart);
  * the carry updated by the reference's rules: a drained write-back
    engine with P$ residue schedules a flush, a drained engine without
    residue is done.

A graph cannot branch, so the reference's ``lax.cond`` idle step becomes
this predicated step: an idle row computes a superstep, keeps nothing of
it and is discarded by the host (``active = 0``), as in the reference.

On a CUDA device each superstep of a chunk is one replay of a captured
``torch.cuda.CUDAGraph``, one graph per flush value (``flush`` is a host
bool that selects Python branches of the superstep), both over the same
static tensors and one memory pool.  The first superstep of each graph
runs eagerly: it builds and loads every kernel and warms the allocator,
and then the same step is captured, under
``torch.cuda.set_sync_debug_mode("error")``.  A failed capture or replay
raises; nothing falls back to eager stepping.  On the CPU there are no
graphs and every superstep runs the same predicated step eagerly.

A replay calls no kernel wrapper, so the runner adds each graph's
captured launches to the wrappers' counts once per replay
(``kernels.ops.add_launches``): the counts stay the number of times each
kernel ran.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..obs.metrics import default_registry


class ChunkRunner:
    """Runs chunks of ``length`` predicated supersteps of ``step`` (the
    engine's ``_superstep(state, flush) -> (new_state, stats)``) over a
    copy of ``state``.  ``keys`` orders the scalar stats in a row."""

    def __init__(self, step: Callable, state: Dict[str, torch.Tensor],
                 length: int, write_back: bool, keys: Sequence[str]):
        if length < 1:
            raise ValueError(f"a chunk holds at least one superstep, got "
                             f"{length}")
        self._step = step
        self._write_back = write_back
        self.keys = tuple(keys)
        self.length = length
        # copies: the caller's state may alias the engine's graph arrays
        # (activate_all's cursors), which the steps must not overwrite
        self.state = {k: v.clone() for k, v in state.items()}
        dev = next(iter(self.state.values())).device
        self.flush = torch.zeros((), dtype=torch.bool, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.left = torch.zeros((), dtype=torch.int64, device=dev)
        self.row = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.rows = torch.zeros((length, len(self.keys) + 1),
                                dtype=torch.float64, device=dev)
        self._pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                      else None)
        # flush value -> its graph, and the kernel launches captured in it
        self._graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.captured: Dict[bool, Dict[str, int]] = {}
        self._replays = default_registry().counter("engine.graph_replays")

    # ------------------------------------------------------------ the step
    def step(self, flush: bool) -> None:
        """One predicated superstep on the static tensors: the body every
        graph captures, and the eager step."""
        st = self.state
        active = ~self.done & (self.left > 0)
        if not flush:
            active = active & ~self.flush
        new_state, stats = self._step(st, flush)
        for k, v in new_state.items():
            if v is not st[k]:                 # in place: one pass each
                torch.where(active, v, st[k], out=st[k])
        row = torch.stack([stats[k].to(torch.float64) for k in self.keys]
                          + [active.to(torch.float64)])
        self.rows.index_copy_(0, self.row, row[None])
        drained = active & (stats["pending"] == 0)
        if self._write_back:
            flush_next = drained & (stats["p_resident"] > 0)
        else:
            flush_next = torch.zeros_like(drained)
        self.flush.copy_(torch.where(active, flush_next, self.flush))
        self.done.copy_(self.done | (drained & ~flush_next))
        self.left.sub_(active.to(torch.int64))
        self.row.add_(1)

    def _capture(self, flush: bool):
        graph = torch.cuda.CUDAGraph()
        before = kops.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.step(flush)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        captured = {k: n - before[k]
                    for k, n in kops.launch_counts().items() if n > before[k]}
        kops.add_launches(captured, -1)       # a capture runs nothing
        self._graphs[flush] = graph
        self.captured[flush] = captured

    def _superstep(self, flush: bool) -> None:
        if self._pool is None:
            self.step(flush)
            return
        graph = self._graphs.get(flush)
        if graph is None:
            self.step(flush)           # warm-up, then capture the same step
            self._capture(flush)
            return
        graph.replay()
        kops.add_launches(self.captured[flush])
        self._replays.inc()

    # ----------------------------------------------------------- the chunk
    def launch(self, left: int, flush: bool) -> None:
        """Enqueue one chunk: ``length`` supersteps within a budget of
        ``left``, the first a flush step when ``flush`` (the flag the
        previous chunk's fetch returned).  No host sync."""
        self.left.fill_(left)
        self.row.zero_()
        for r in range(self.length):
            self._superstep(flush and r == 0)

    def fetch(self) -> Tuple[bool, bool, np.ndarray]:
        """``(done, flush, rows)`` of the chunk just launched, in ONE
        device-to-host transfer; ``rows`` is ``(length, len(keys) + 1)``
        f64 with ``active`` last."""
        packed = torch.cat([self.rows.reshape(-1),
                            torch.stack([self.done, self.flush]).to(
                                torch.float64)]).cpu().numpy()
        return (bool(packed[-2]), bool(packed[-1]),
                packed[:-2].reshape(self.rows.shape))
