"""Superstep timeline tracing: the Observer protocol + recorder.

A copy of ``repro.obs.timeline`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in.
``tests/test_torch_obs.py`` holds the copy against the original.

The run loops (``core/engine.py``; the distributed runtime's is not
ported yet) accept an ``observer=`` and call it at the *existing* chunk
host-accounting boundary — the one host sync per chunk the
device-resident loop already pays.  The observer only reads arrays that sync fetched, so attaching
one adds **zero host syncs** and the engine's computation (counters,
trace, final state) is bit-identical with or without it.  The legacy
per-step loop (``chunk=0``) emits one single-step span per superstep
(it already syncs per step).

Wall-clock spans per chunk:
  dispatch  — ``ChunkRunner.launch`` (the superstep on the per-step
              loop): on the card mostly the time to enqueue graph
              replays,
  fetch     — ``ChunkRunner.fetch`` (``fetch_stats`` on the per-step
              loop), the one device-to-host transfer that waits for
              the chunk,
  account   — host-side counter/trace/BSP accounting.

With ``EngineConfig.telemetry=True`` the engine additionally emits
per-tile (monolithic, ``tv_*``) or per-chip (distributed, ``pc_*``)
load vectors per superstep; they ride the same chunk fetch and feed
``obs.imbalance``.  The simulated-time BSP spans are derived after the
run from ``RunResult.trace`` (``obs.export``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class RunMeta:
    """Static facts about the run, emitted once at ``on_run_start``."""

    app: str
    grid_ny: int
    grid_nx: int
    n_chips: int = 1
    chips_y: int = 1
    chips_x: int = 1
    chunk: int = 0                 # supersteps per dispatch (0 = legacy)
    backend: str = "kernels"       # engine backend: "kernels" | "torch"
    sanitize: bool = False
    telemetry: bool = False
    pkg: object = None             # PackageConfig (for sim-span pricing)
    grid: object = None            # TileGrid
    n_devices: int = 1             # ExecMesh device count (chips/device
                                   # = n_chips // n_devices)

    @property
    def tiles(self) -> int:
        return self.grid_ny * self.grid_nx


@dataclasses.dataclass
class ChunkSpan:
    """One chunk (or one legacy superstep) of wall-clock + stat data.

    ``step_lo``/``step_hi`` are the global superstep numbers this chunk
    executed (half-open).  ``stats`` maps scalar stat names to
    ``(n_act,)`` numpy arrays; ``vecs`` maps telemetry vector names
    (``tv_*`` per-tile, ``pc_*`` per-chip) to ``(n_act, W)`` arrays.
    Times are ``time.perf_counter()`` seconds.
    """

    index: int
    step_lo: int
    step_hi: int
    t_dispatch: tuple           # (t0, t1)
    t_fetch: tuple
    t_account: tuple
    stats: Dict[str, np.ndarray]
    vecs: Dict[str, np.ndarray]

    @property
    def n_steps(self) -> int:
        return self.step_hi - self.step_lo

    @property
    def wall_dispatch_s(self) -> float:
        return self.t_dispatch[1] - self.t_dispatch[0]

    @property
    def wall_fetch_s(self) -> float:
        return self.t_fetch[1] - self.t_fetch[0]

    @property
    def wall_account_s(self) -> float:
        return self.t_account[1] - self.t_account[0]


@runtime_checkable
class Observer(Protocol):
    """What the run loops call.  Implementations must only *read* the
    arrays they are handed — the loops hand them the same buffers the
    accounting uses."""

    def on_run_start(self, meta: RunMeta) -> None: ...

    def on_chunk(self, span: ChunkSpan) -> None: ...

    def on_run_end(self, result) -> None: ...


def now() -> float:
    return time.perf_counter()


class TimelineRecorder:
    """Observer that records every span plus the run's meta/result.

    After the run, the recorder holds everything ``obs.export`` needs
    for a Chrome-trace/Perfetto file and ``obs.imbalance`` needs for
    load-balance metrics:

      * ``spans`` — wall-clock chunk spans, in execution order;
      * ``meta`` / ``result`` — run configuration and the finished
        :class:`~repro.core.engine.RunResult` (whose ``trace`` yields
        the simulated BSP spans);
      * ``stat_matrix(key)`` — per-superstep scalar stat vector over the
        whole run; ``vec_matrix(key)`` — ``(supersteps, W)`` telemetry
        load matrix (tiles monolithic, chips distributed).
    """

    def __init__(self):
        self.meta: Optional[RunMeta] = None
        self.result = None
        self.spans: List[ChunkSpan] = []
        self._t0: Optional[float] = None

    # ------------------------------------------------------------ protocol
    def on_run_start(self, meta: RunMeta) -> None:
        self.meta = meta
        self._t0 = now()

    def on_chunk(self, span: ChunkSpan) -> None:
        self.spans.append(span)

    def on_run_end(self, result) -> None:
        self.result = result

    # ------------------------------------------------------------- derived
    @property
    def t0(self) -> float:
        """Wall origin of the run (perf_counter seconds)."""
        if self._t0 is not None:
            return self._t0
        return self.spans[0].t_dispatch[0] if self.spans else 0.0

    @property
    def supersteps(self) -> int:
        return self.spans[-1].step_hi if self.spans else 0

    @property
    def wall_s(self) -> float:
        if not self.spans:
            return 0.0
        return self.spans[-1].t_account[1] - self.t0

    def wall_breakdown(self) -> Dict[str, float]:
        """Total wall seconds per phase across the run."""
        return dict(
            dispatch_s=sum(s.wall_dispatch_s for s in self.spans),
            fetch_s=sum(s.wall_fetch_s for s in self.spans),
            account_s=sum(s.wall_account_s for s in self.spans),
            total_s=self.wall_s,
            chunks=len(self.spans),
        )

    def stat_matrix(self, key: str) -> np.ndarray:
        """Per-superstep values of scalar stat ``key`` over the run."""
        parts = [s.stats[key] for s in self.spans if key in s.stats]
        if not parts:
            return np.zeros((0,))
        return np.concatenate([np.asarray(p, np.float64) for p in parts])

    def vec_keys(self):
        return sorted({k for s in self.spans for k in s.vecs})

    def vec_matrix(self, key: str) -> np.ndarray:
        """(supersteps, W) telemetry load matrix for vector stat ``key``
        (``W`` = tiles for monolithic ``tv_*``, chips for ``pc_*``)."""
        parts = [np.asarray(s.vecs[key], np.float64)
                 for s in self.spans if key in s.vecs]
        if not parts:
            return np.zeros((0, 0))
        return np.concatenate(parts, axis=0)
