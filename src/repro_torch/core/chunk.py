"""The device side of the chunked run loop: K supersteps to one host fetch.

The reference scans a chunk with ``lax.scan`` (``_scan_steps``), which
XLA compiles into one program.  Here a :class:`ChunkRunner` holds the
engine state, the carry and the chunk's stats rows in static tensors,
and runs each superstep as one *predicated step* over them:

  * ``active = ~done & (left > 0) & ~overflow``, and on a no-flush step
    also ``~flush`` (a flush the device scheduled idles the rest of the
    chunk: the host sees it in the chunk's fetch and starts the next
    chunk with a flush step);
  * the engine superstep, its new state kept only where ``active``; in a
    compaction window of W lanes a chip (the chunk's, picked by the
    host) also only where every chip's active tiles fit in W (the
    step's ``ACTIVE_MAX`` stat), and a row that does not fit sets
    ``overflow``, which idles the rest of the chunk the way a scheduled
    flush does: the host starts the next chunk in the window that fits,
    from the busiest chip's active-tile count the fetch carries.  In a
    window the superstep writes its rows of ``values`` and the cursors
    into the static tensors itself, under the same predicate (the
    engine's ``commit``), and only the arrays it returns anew are
    selected here.  The state may hold more than the engine's arrays:
    the double-buffered exchange's deferred values ride in it, so an
    idle row leaves them for the next active one, in whichever graph;
  * the stats row, with ``active`` last, written into row ``row`` of the
    ``(K, len(keys) + 1)`` f64 buffer (exact for every f32 charge and
    every int32 count, so the reference's int32 side channel
    ``_EXACT_INT_STATS`` has no counterpart), and, with telemetry, the
    superstep's per-tile vectors (``tv_*``) into row ``row`` of a
    ``(K, len(vec_keys), width)`` f32 buffer: the reference's separate
    ``(K, T)`` channel, so the stats row is the same with telemetry on
    or off;
  * the carry updated by the reference's rules: a drained write-back
    engine with P$ residue schedules a flush, a drained engine without
    residue is done.

A graph cannot branch, so the reference's ``lax.cond`` idle step becomes
this predicated step: an idle row computes a superstep, keeps nothing of
it and is discarded by the host (``active = 0``), as in the reference.

On a CUDA device each superstep of a chunk is one replay of a captured
``torch.cuda.CUDAGraph``, one graph per flush value and window
(``flush`` is a host bool that selects Python branches of the superstep,
the window sets its shapes), all over the same static tensors and one
memory pool: nothing a graph leaves in the pool outlives its replay, so
the graphs replay in any order.  The first superstep of each graph
runs eagerly: it builds and loads every kernel and warms the allocator,
and then the same step is captured, under
``torch.cuda.set_sync_debug_mode("error")``.  A failed capture or replay
raises; nothing falls back to eager stepping.  On ranks the superstep's
collectives (NCCL all-gathers: the exchange's records and the stats) are
captured in its graph too, each rank replaying its own in step with the
others.  On the CPU there are no
graphs and every superstep runs the same predicated step eagerly.

A replay calls no kernel wrapper, so the runner adds each graph's
captured launches to the wrappers' counts once per replay
(``kernels.ops.add_launches``): the counts stay the number of times each
kernel ran.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..obs.metrics import default_registry

# The chunk's stats rows: exact for every f32 charge and every int32
# count (``analysis.steplint``'s ``int-stat-f32-row`` holds it to that).
STATS_DTYPE = torch.float64
# The stat of a compacted superstep that a window must hold: the most
# active tiles on one chip of the state it steps (all of them on one
# chip).  Never a stats row's.
ACTIVE_MAX = "chip_active_max"


class Fetched(NamedTuple):
    """What one chunk's fetch brings to the host."""

    done: bool
    flush: bool             # the next chunk starts with a flush step
    overflow: bool          # a superstep outgrew the chunk's window
    active_tiles: int       # busiest chip's active tiles after the chunk
    rows: np.ndarray        # (length, len(keys) + 1) f64, ``active`` last
    vecs: Dict[str, np.ndarray]   # vec_keys -> (length, width) f32


class ChunkRunner:
    """Runs chunks of ``length`` predicated supersteps of ``step`` (the
    engine's ``_superstep(state, flush, window, commit) -> (new_state,
    stats)``)
    over a copy of ``state``.  ``keys`` orders the scalar stats in a row;
    ``vec_keys`` names the ``(width,)`` vector stats kept beside the rows.
    ``count_active(state)``, given with compaction, counts the busiest
    chip's active tiles on the device for the fetch."""

    def __init__(self, step: Callable, state: Dict[str, torch.Tensor],
                 length: int, write_back: bool, keys: Sequence[str],
                 count_active: Optional[Callable] = None,
                 vec_keys: Sequence[str] = (), width: int = 0):
        if length < 1:
            raise ValueError(f"a chunk holds at least one superstep, got "
                             f"{length}")
        self._step = step
        self._count_active = count_active
        self._write_back = write_back
        self.keys = tuple(keys)
        self.length = length
        # copies: the caller's state may alias the engine's graph arrays
        # (activate_all's cursors), which the steps must not overwrite
        self.state = {k: v.clone() for k, v in state.items()}
        dev = next(iter(self.state.values())).device
        self.flush = torch.zeros((), dtype=torch.bool, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.overflow = torch.zeros((), dtype=torch.bool, device=dev)
        self.left = torch.zeros((), dtype=torch.int64, device=dev)
        self.row = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.rows = torch.zeros((length, len(self.keys) + 1),
                                dtype=STATS_DTYPE, device=dev)
        self.vec_keys = tuple(vec_keys)
        self.vecs = torch.zeros((length, len(self.vec_keys), width),
                                dtype=torch.float32, device=dev)
        self._pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                      else None)
        # (flush value, window) -> its graph, and the kernel launches
        # captured in it
        self._graphs: Dict[Tuple[bool, Optional[int]],
                           torch.cuda.CUDAGraph] = {}
        self.captured: Dict[Tuple[bool, Optional[int]], Dict[str, int]] = {}
        reg = default_registry()
        self._replays = reg.counter("engine.graph_replays")
        self._captures = reg.counter("engine.graph_captures")
        # host seconds spent capturing (a capture runs nothing on the
        # device): what each new (flush, window) key costs the loop
        self._capture_s = reg.counter("engine.graph_capture_seconds")

    # ------------------------------------------------------------ the step
    def step(self, flush: bool, window: Optional[int] = None) -> None:
        """One predicated superstep on the static tensors: the body every
        graph captures, and the eager step."""
        st = self.state
        active = ~self.done & (self.left > 0) & ~self.overflow
        if not flush:
            active = active & ~self.flush
        new_state, stats = self._step(st, flush, window, active)
        if window is not None:
            fits = stats[ACTIVE_MAX] <= window
            self.overflow.copy_(self.overflow | (active & ~fits))
            active = active & fits
        for k, v in new_state.items():
            if v is not st[k]:                 # in place: one pass each
                torch.where(active, v, st[k], out=st[k])
        row = torch.stack([stats[k].to(self.rows.dtype) for k in self.keys]
                          + [active.to(self.rows.dtype)])
        self.rows.index_copy_(0, self.row, row[None])
        if self.vec_keys:
            self.vecs.index_copy_(0, self.row, torch.stack(
                [stats[k].to(torch.float32) for k in self.vec_keys])[None])
        drained = active & (stats["pending"] == 0)
        if self._write_back:
            flush_next = drained & (stats["p_resident"] > 0)
        else:
            flush_next = torch.zeros_like(drained)
        self.flush.copy_(torch.where(active, flush_next, self.flush))
        self.done.copy_(self.done | (drained & ~flush_next))
        self.left.sub_(active.to(torch.int64))
        self.row.add_(1)

    def _capture(self, key: Tuple[bool, Optional[int]]):
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = kops.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.step(*key)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        captured = {k: n - before[k]
                    for k, n in kops.launch_counts().items() if n > before[k]}
        kops.add_launches(captured, -1)       # a capture runs nothing
        self._graphs[key] = graph
        self.captured[key] = captured
        self._captures.inc()
        self._capture_s.inc(time.perf_counter() - t0)

    def _superstep(self, flush: bool, window: Optional[int]) -> None:
        if self._pool is None:
            self.step(flush, window)
            return
        key = (flush, window)
        graph = self._graphs.get(key)
        if graph is None:
            self.step(flush, window)   # warm-up, then capture the same step
            self._capture(key)
            return
        graph.replay()
        kops.add_launches(self.captured[key])
        self._replays.inc()

    def load(self, state: Dict[str, torch.Tensor], flush: bool) -> None:
        """Resume from ``state`` (a restored checkpoint: the same keys,
        shapes and dtypes as the runner's) with the next chunk's flush
        flag ``flush``: copied into the static tensors in place, so every
        captured graph stays valid and nothing is captured again; the
        carry restarts (not done, no overflow)."""
        if set(state) != set(self.state):
            raise ValueError(f"state keys {sorted(state)} are not the "
                             f"runner's {sorted(self.state)}")
        for k, v in self.state.items():
            v.copy_(state[k])
        self.flush.fill_(bool(flush))
        self.done.zero_()
        self.overflow.zero_()

    # ----------------------------------------------------------- the chunk
    def launch(self, left: int, flush: bool,
               window: Optional[int] = None) -> None:
        """Enqueue one chunk: ``length`` supersteps within a budget of
        ``left``, the first a flush step when ``flush`` (the flag the
        previous chunk's fetch returned), each in compaction window
        ``window`` (None: dense).  No host sync."""
        self.left.fill_(left)
        self.row.zero_()
        self.overflow.zero_()
        for r in range(self.length):
            self._superstep(flush and r == 0, window)

    def fetch(self) -> Fetched:
        """The chunk just launched, in ONE device-to-host transfer: the
        f64 rows and flags, then the f32 vectors as raw bytes (one
        ``torch.cat`` of byte views, so neither is widened)."""
        count = (self._count_active(self.state) if self._count_active
                 else torch.zeros((), dtype=torch.int32,
                                  device=self.rows.device))
        packed = torch.cat([self.rows.reshape(-1), torch.stack(
            [t.to(torch.float64) for t in (self.done, self.flush,
                                           self.overflow, count)])])
        m = packed.numel()
        if self.vec_keys:
            packed = torch.cat([packed.view(torch.uint8),
                                self.vecs.reshape(-1).view(torch.uint8)])
        host = packed.cpu().numpy()
        vecs = {}
        if self.vec_keys:
            got = host[8 * m:].view(np.float32).reshape(self.vecs.shape)
            vecs = {k: got[:, i] for i, k in enumerate(self.vec_keys)}
            host = host[:8 * m].view(np.float64)
        return Fetched(bool(host[-4]), bool(host[-3]), bool(host[-2]),
                       int(host[-1]), host[:-4].reshape(self.rows.shape),
                       vecs)
