"""The distributed multi-chip runtime (paper §V) in one process.

The port of ``repro.distrib.driver`` for one device: a
:class:`~repro_torch.core.tilegrid.ChipPartition` splits the tile grid
into chips, each chip's proxy regions and cascade are cut to the chip
(``proxy.chip_local_proxy``), and records bound for another chip ride the
board between supersteps, charged ``netstats.charge_off_chip``.  Tile
ids, data placement and hop charging keep the monolithic engine's global
numbering, so results compare with it directly.

The reference vmaps a per-chip superstep over the chips.  Here one
superstep runs every chip's tiles at once: the engine
(``core.engine.DataLocalEngine`` built with the partition) steps one
chip-major window, the reference's stacked ``(chips, tiles_local *
chunk)`` layout viewed flat, and folds every leg's off-chip records into
the window's mailbox at the end of the superstep (the reference's
``exchange``).  The ops a superstep dispatches do not depend on the chip
count, and on the card each superstep of the chunked loop is one CUDA
graph replay, as on one chip.

``DistributedEngine`` has the reference's interface: ``init_state`` and
``activate_all`` give the ``(chips, ...)`` state, and ``run`` returns it
with ``values`` in global order, beside a ``RunResult`` whose counters,
trace, supersteps and ``time_s`` equal the reference's (the BSP rule
with the synchronous board leg: ``max(core, t_board)`` plus the IO dies'
latency on a superstep where a record left its chip).  Min-combine
values are bitwise the reference's, add-combine values equal to f32
re-association.  Both run loops, both engine backends (``"kernels"``,
the default, or the ``"torch"`` oracle), telemetry (per-chip ``pc_*``
vectors), the sanitizer and observers run as on one chip.

Not in this slice, and refused with ``NotImplementedError`` naming the
ROADMAP item: compaction on more than one chip and the double-buffered
exchange (A.5b); checkpoints, fault injection and recovery (A.6), with
``rebalance_plan``, whose load feed lives there; more than one device
(A.5c).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.engine import AppSpec, DataLocalEngine, EngineConfig, _pad
from ..core.proxy import chip_local_proxy
from ..core.tilegrid import ChipPartition, TileGrid, partition_grid


def partition(grid: TileGrid, num_chips: int) -> ChipPartition:
    """Partition ``grid`` into the most square chip grid that divides it."""
    return partition_grid(grid, num_chips)


class DistributedEngine:
    """Multi-chip rendering of :class:`DataLocalEngine`, every chip in
    one batched superstep on one device.

    Mirrors the monolithic engine's interface (``init_state`` /
    ``activate_all`` / ``run``) so the six applications run unchanged;
    state is held stacked per chip ``(chips, local...)`` and ``run``
    reassembles ``values`` into global order.  ``device=None`` runs on
    the CUDA card and raises without one (``device="cpu"`` for the CPU).
    """

    def __init__(self, app: AppSpec, cfg: EngineConfig, row_lo, row_hi,
                 col_idx, weights=None, part: Optional[ChipPartition] = None,
                 num_chips: Optional[int] = None, device=None):
        if part is None:
            if num_chips is None:
                raise ValueError("pass part= or num_chips=")
            part = partition_grid(cfg.grid, num_chips)
        if cfg.proxy is not None:
            cfg = dataclasses.replace(
                cfg, proxy=chip_local_proxy(cfg.proxy, part.sub_ny,
                                            part.sub_nx))
        self.app = app
        self.cfg = cfg
        self.part = part
        self.kernel = DataLocalEngine(app, cfg, row_lo, row_hi, col_idx,
                                      weights, part=part, device=device,
                                      per_chip=True)
        self.device = self.kernel.device
        self.C = part.num_chips
        self.Tl = part.tiles_per_chip
        self.Cs, self.Cd = cfg.chunk_src, cfg.chunk_dst

    # ----------------------------------------------------------- data moves
    def _shard(self, a_global: np.ndarray, chunk: int) -> torch.Tensor:
        """Global per-index array -> stacked (chips, tiles_local*chunk)."""
        a = torch.as_tensor(np.asarray(a_global), device=self.device)
        return self.kernel.to_window(a, chunk).reshape(self.C, -1)

    def _flat(self, state):
        """The stacked state as the engine's window (views)."""
        T = self.C * self.Tl
        return {k: v.reshape(T, -1) if k.startswith("p_") else v.reshape(-1)
                for k, v in state.items()}

    def _stacked(self, state):
        """The engine's window state stacked per chip (views)."""
        return {k: v.reshape(self.C, self.Tl, -1) if k.startswith("p_")
                else v.reshape(self.C, -1) for k, v in state.items()}

    # ---------------------------------------------------------------- state
    def init_state(self, seed_idx=None, seed_val=None,
                   values: Optional[np.ndarray] = None):
        """Fresh stacked state; ``seed_idx``/``seed_val`` (global indices)
        pre-load mailbox records, ``values`` the global values."""
        k = self.kernel
        ident = self.app.identity
        vals = (np.full((k.Ngd,), ident, np.float32) if values is None
                else _pad(np.asarray(values, np.float32), k.Ngd, ident))
        mail_val = np.full((k.Ngd,), ident, np.float32)
        mail_flag = np.zeros((k.Ngd,), bool)
        k._n_seeds = 0      # mailbox seeds, for the sanitizer's check_run
        if seed_idx is not None:
            si = np.atleast_1d(np.asarray(seed_idx)).astype(np.int64)
            mail_val[si] = np.atleast_1d(np.asarray(seed_val, np.float32))
            mail_flag[si] = True
            k._n_seeds = int(si.shape[0])

        def zeros(dt):
            return torch.zeros((self.C, self.Tl * self.Cs), dtype=dt,
                               device=self.device)

        st = dict(values=self._shard(vals, self.Cd),
                  mail_val=self._shard(mail_val, self.Cd),
                  mail_flag=self._shard(mail_flag, self.Cd),
                  cur_lo=zeros(torch.int32), cur_hi=zeros(torch.int32),
                  cur_val=zeros(torch.float32))
        if self.cfg.proxy is not None:
            shape = (self.C, self.Tl, self.cfg.proxy.slots)
            st["p_tag"] = torch.full(shape, -1, dtype=torch.int32,
                                     device=self.device)
            st["p_val"] = torch.full(shape, ident, dtype=torch.float32,
                                     device=self.device)
        return st

    def activate_all(self, state, cur_val):
        """Epoch-style activation: every source item starts with its full
        edge range and the carried global value ``cur_val``."""
        k = self.kernel
        state = dict(state)
        state["cur_lo"] = k.row_lo.reshape(self.C, -1)
        state["cur_hi"] = k.row_hi.reshape(self.C, -1)
        state["cur_val"] = self._shard(
            _pad(np.asarray(cur_val, np.float32), k.Ngs, 0.0), self.Cs)
        return state

    # ------------------------------------------------------------------ run
    def chunk_runner(self, state, length: int):
        """The device side of chunks of ``length`` supersteps over a copy
        of the stacked ``state`` (``core/chunk.py``)."""
        return self.kernel.chunk_runner(self._flat(state), length)

    def run(self, state, max_supersteps: Optional[int] = None,
            progress_every: int = 0, chunk: Optional[int] = None,
            observer=None, fault_injector=None,
            ckpt_dir: Optional[str] = None):
        """Run distributed supersteps until drained; returns
        (stacked state with global ``values``, RunResult).

        The engine's loops, on the window: ``chunk`` (default
        ``EngineConfig.run_chunk``) supersteps per host fetch, each with
        its board exchange; ``chunk=0`` the per-step loop.  ``observer``
        and ``progress_every`` as ``DataLocalEngine.run``; with
        telemetry the spans carry the per-chip ``pc_*`` vectors."""
        if fault_injector is not None or ckpt_dir is not None:
            raise NotImplementedError(
                "not ported to repro_torch yet: fault_injector / ckpt_dir, "
                "checkpoints and recovery (ROADMAP A.6)")
        flat, result = self.kernel._run(self._flat(state), max_supersteps,
                                        progress_every, chunk, observer)
        out = self._stacked(flat)
        out["values"] = self.kernel.from_window(flat["values"], self.Cd)
        return out, result


def run_distributed(app: AppSpec, cfg: EngineConfig, row_lo, row_hi,
                    col_idx, weights=None, *, chips: Optional[int] = None,
                    part: Optional[ChipPartition] = None, seed_idx=None,
                    seed_val=None, values=None, activate=None,
                    max_supersteps: Optional[int] = None, device=None):
    """One-call distributed run: partition, seed or activate, run to
    drain.  Returns (global values as a numpy array, RunResult).
    ``activate`` (a global per-source value array) selects epoch-style
    activation; ``seed_idx``/``seed_val`` seed mailboxes."""
    eng = DistributedEngine(app, cfg, row_lo, row_hi, col_idx, weights,
                            part=part, num_chips=chips, device=device)
    state = eng.init_state(seed_idx=seed_idx, seed_val=seed_val,
                           values=values)
    if activate is not None:
        state = eng.activate_all(state, activate)
    state, run = eng.run(state, max_supersteps)
    return state["values"].cpu().numpy(), run
