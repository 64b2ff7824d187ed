"""The distributed multi-chip runtime (paper §V).

The port of ``repro.distrib.driver``: a
:class:`~repro_torch.core.tilegrid.ChipPartition` splits the tile grid
into chips, each chip's proxy regions and cascade are cut to the chip
(``proxy.chip_local_proxy``), and records bound for another chip ride the
board between supersteps, charged ``netstats.charge_off_chip``.  Tile
ids, data placement and hop charging keep the monolithic engine's global
numbering, so results compare with it directly.

The reference vmaps a per-chip superstep over the chips of each device.
Here one superstep runs every chip's tiles of a process at once: the
engine (``core.engine.DataLocalEngine`` built with the partition) steps
one chip-major window, the reference's stacked ``(chips, tiles_local *
chunk)`` layout viewed flat, and folds every leg's off-chip records into
the window's mailbox at the end of the superstep (the reference's
``exchange``).  The ops a superstep dispatches do not depend on the chip
count, and on the card each superstep of the chunked loop is one CUDA
graph replay, as on one chip.

**Ranks** (``backend=`` 'auto' / 'vmap' / 'shard_map' and ``group=``,
``distrib.mesh.ExecMesh``): over the R ranks of a ``torch.distributed``
process group each rank steps the window of its own block of ``C / R``
chips.  The off-chip records of every rank are gathered (one all-gather
of a fixed length a superstep, in the order one process makes them)
before each rank folds the ones it owns; the superstep's stats are
reduced as the reference's ``_aggregate`` does (sums, maxima, and
``pending``, so every rank's chunk stops on the same superstep) and the
per-chip vectors gathered in chip order, in the same all-gather.  Under
compaction every rank runs the window of the busiest chip on any rank
(the reference picks a rung per device and pads the exchange to the
dense length; one window for all ranks keeps the gathered length equal
without the padding), so the collectives a superstep makes and their
lengths do not depend on a rank's data.  ``run`` returns the values in
global order on every rank of the mesh, beside the same ``RunResult``.
A rank that holds no chip (the surplus of a group whose size does not
divide the chips, or a rank left out after a chip loss) returns ``(None,
None)`` from ``run`` at once.  One process with no group runs every chip
and no collective.

``DistributedEngine`` has the reference's interface: ``init_state`` and
``activate_all`` give the ``(chips, ...)`` state, and ``run`` returns it
with ``values`` in global order, beside a ``RunResult`` whose counters,
trace, supersteps and ``time_s`` equal the reference's (the BSP rule
with the synchronous board leg: ``max(core, t_board)`` plus the IO dies'
latency on a superstep where a record left its chip).  Min-combine
values are bitwise the reference's, add-combine values equal to f32
re-association.  Both run loops, both engine backends (``"kernels"``,
the default, or the ``"torch"`` oracle), telemetry (per-chip ``pc_*``
vectors), the sanitizer and observers run as on one chip, and so do:

  * ``EngineConfig.compaction``, with the reference's per-chip ladder:
    a window of rung W runs W lanes on every chip, the rung the one
    that holds the busiest chip's active tiles (``active_tiles`` is
    their sum over the chips, ``bucket_cap`` that rung);
  * ``EngineConfig.double_buffer``: each superstep is charged
    ``max(core, the previous exchange)`` and the last exchange after
    the loop; the chunked loop also defers the exchanged mailbox values
    to the start of the next superstep (flags and arrival counts merge
    at once), the per-step loop keeps the synchronous exchange, as in
    the reference.  The card performs no overlap: both halves run in
    order on one device, and only the BSP time model prices it.

Fault tolerance (``EngineConfig.ckpt_every_supersteps``,
``run(fault_injector=, ckpt_dir=)``): the engine state is checkpointed
at the loops' accounting boundaries through the atomic writer
(``checkpoint.ckpt``), a chip loss the injector raises rolls the run
back to the last checkpoint and replays it, and the recovery's cost is
priced apart, so values, counters, trace and supersteps equal an
unfailed run's and re-pricing the trace gives its ``time_s`` exactly
(``_FaultTolerance``).  ``rebalance_plan`` turns the run's summed
per-chip telemetry into the straggler plan for the next wave.

On ranks the checkpoint is the image one process writes (every chip's
block gathered in chip order, written by the mesh's rank 0, then a
barrier), and a chip loss rebuilds the mesh on the largest dividing
subset of the other ranks (``ExecMesh.shrink``, a new group every rank
makes), places each survivor's engine on its new block and restores the
block from the checkpoint; the graphs bound to the old window are
captured again.  In one process a chip loss keeps the device every chip
lives on (the reference's recovery on one device keeps its mesh too).
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.ckpt import save_checkpoint, to_host
from ..core.costmodel import (PU_OPS_PER_EDGE, PU_OPS_PER_RECORD,
                              board_link_provisioning, checkpoint_leg_cycles,
                              recovery_waste_cycles)
from ..core.engine import AppSpec, DataLocalEngine, EngineConfig, _pad
from ..core.proxy import chip_local_proxy
from ..core.tilegrid import ChipPartition, TileGrid, partition_grid
from .. import device as _device
from ..runtime.elastic import reshard_checkpoint
from .mesh import ExecMesh, LeftMesh
from ..runtime.straggler import detect_stragglers, rebalance_chunks


def partition(grid: TileGrid, num_chips: int) -> ChipPartition:
    """Partition ``grid`` into the most square chip grid that divides it."""
    return partition_grid(grid, num_chips)


class _FaultTolerance:
    """Superstep checkpoint/rollback controller for one ``run()`` call
    (the one in the JAX reference's ``distrib`` package).

    At each accounting boundary (per chunk on the chunked loop, per
    superstep on the per-step loop) it polls the fault injector -- a
    raised :class:`~repro_torch.runtime.fault.ChipLostError` unwinds to
    the engine's retry loop -- and, on cadence, writes the engine state
    through the atomic checkpoint writer plus an in-memory snapshot of
    the host accounting (counters, trace length, BSP cycles, the
    exchange in flight, the telemetry sums).  The image is the chunk
    runner's state with the double buffer's deferred values folded in
    (``DataLocalEngine.checkpoint_image``), stacked per chip: the
    reference's carry, key for key, shape for shape.

    ``recover()`` restores the state through ``runtime.elastic``'s
    placement path onto the engine's device, rolls the host accounting
    back to the snapshot, and prices every overhead leg (checkpoint
    writes, the discarded replay window, the restore) into a *separate*
    accumulator the run adds exactly once at the very end.  Keeping the
    overhead out of the main accumulator is what makes a recovered run
    bit-identical to an unfailed one: the replay re-adds the identical
    floats in the identical order, and the cost model re-prices the
    overhead from the trace's recovery events with the same helpers
    (``checkpoint_leg_cycles`` / ``recovery_waste_cycles``), so
    ``reprice_ratio`` stays exactly 1.0.
    """

    def __init__(self, eng, directory, every, injector, counters, trace,
                 prev_exch, overhead, vec_sums, n_board_links):
        self.eng = eng
        self.dir = directory
        self.every = int(every)
        self.injector = injector
        self.counters = counters
        self.trace = trace
        self.prev_exch = prev_exch
        self.overhead = overhead
        self.vec_sums = vec_sums
        self.blinks = n_board_links
        self.pkg = eng.cfg.pkg
        self.grid = eng.cfg.grid
        self.events = trace.recovery_events
        self._snap = None
        self._next = self.every if self.every > 0 else None
        self._bits = None              # image size (static shapes)
        self._tmpl = None              # restore template (meta tensors)

    def _image_bits(self, image) -> float:
        if self._bits is None:
            self._bits = 8.0 * (sum(v.numel() * v.element_size()
                                    for v in image.values()) + 1)  # + flush
        return self._bits

    def checkpoint(self, steps, state, flush, cycles) -> None:
        """Write the state at superstep ``steps`` + snapshot accounting
        (on ranks: every chip's block, written by the mesh's rank 0)."""
        eng = self.eng
        image = eng._every_chip(eng._stacked(
            eng.kernel.checkpoint_image(state)))
        bits = self._image_bits(image)
        if self._tmpl is None:
            self._tmpl = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device="meta")
                          for k, v in image.items()}
        flush_b = bool(flush)
        if eng.mesh.rank == 0:
            save_checkpoint(
                self.dir, int(steps),
                dict(state=to_host(image),   # waits for the device
                     flush=np.asarray(flush_b)),
                extra_meta=dict(cycles=float(cycles),
                                prev_exch=float(self.prev_exch[0]),
                                overhead=float(self.overhead[0]),
                                counters=self.counters.as_dict()))
        eng.mesh.barrier(eng.device)
        # the write is priced as overhead, never into `cycles`: the main
        # accumulator must replay bit-identically to an unfailed run
        self.overhead[0] += checkpoint_leg_cycles(self.pkg, bits,
                                                  self.blinks)
        self.events.append(dict(kind="checkpoint", step=int(steps),
                                bits=float(bits)))
        self._snap = dict(
            steps=int(steps), flush=flush_b, cycles=float(cycles),
            prev_exch=float(self.prev_exch[0]),
            counters=self.counters.as_dict(),
            vec_sums=(None if self.vec_sums is None else
                      {k: np.array(v, np.float64)
                       for k, v in self.vec_sums.items()}))

    def at_boundary(self, steps, state, flush, done, cycles) -> None:
        """The run loop's boundary hook: poll the injector first (so a
        loss at a checkpoint boundary still forces a real rollback),
        then checkpoint on cadence.  It never touches ``cycles``."""
        if self.injector is not None:
            self.injector.poll(int(steps))          # may raise ChipLostError
        if self._next is not None and steps >= self._next and not done:
            self.checkpoint(steps, state, flush, cycles)
            while self._next <= steps:
                self._next += self.every

    def recover(self, err):
        """Chip loss: re-place the state on the survivors + roll back.

        Returns ``(state, flush, steps, cycles)`` for the retry loop to
        resume from the last checkpoint, the state in window order."""
        eng, snap = self.eng, self._snap
        lo, hi = snap["steps"], int(err.at_step)
        # 1. price the discarded window [lo, hi) from the trace rows
        #    BEFORE truncating -- with the helper the cost model's replay
        #    uses, so both sides sum the identical floats in the
        #    identical order
        self.overhead[0] += recovery_waste_cycles(
            self.pkg, self.grid, self.trace, lo, hi)
        self.events.append(dict(kind="rollback", chip=int(err.chip),
                                from_step=int(lo), at_step=int(hi)))
        # 2. roll host accounting back to the snapshot
        self.trace.truncate(lo)
        for k, v in snap["counters"].items():
            setattr(self.counters, k, v)
        self.counters.supersteps = int(snap["counters"]["supersteps"])
        self.prev_exch[0] = snap["prev_exch"]
        if self.vec_sums is not None:
            self.vec_sums.clear()
            if snap["vec_sums"]:
                self.vec_sums.update(snap["vec_sums"])
        # 3. the device set without the lost chip's device; a rank left
        #    out of it leaves the run here
        _, new_ndev = eng._drop_device(int(err.chip))
        if not eng.mesh.member:
            raise LeftMesh(f"rank left out of the {new_ndev}-rank mesh "
                           f"after chip {err.chip} was lost")
        # 4. restore the state through the elastic path: this rank's
        #    block of every chip-stacked leaf, on the engine's device
        mesh = eng.mesh
        rows = slice(mesh.rank * mesh.per, (mesh.rank + 1) * mesh.per)
        restored = reshard_checkpoint(
            self.dir, dict(state=self._tmpl, flush=torch.empty(
                (), dtype=torch.bool, device="meta")),
            lambda path, shape: ((eng.device, rows)
                                 if path.startswith("['state']") else None),
            step=lo)
        state = eng._flat(restored["state"])
        flush = bool(restored["flush"])
        # 5. the restore streams the image back over board links
        self.overhead[0] += checkpoint_leg_cycles(self.pkg, self._bits,
                                                  self.blinks)
        self.events.append(dict(kind="reshard", step=int(lo),
                                bits=float(self._bits),
                                chip=int(err.chip), devices=int(new_ndev)))
        if self._next is not None:
            self._next = lo + self.every
        return state, flush, lo, snap["cycles"]


class DistributedEngine:
    """Multi-chip rendering of :class:`DataLocalEngine`: the chips of
    each rank of the mesh in one batched superstep on its device.

    Mirrors the monolithic engine's interface (``init_state`` /
    ``activate_all`` / ``run``) so the six applications run unchanged;
    state is held stacked per chip ``(chips, local...)``, this rank's
    ``(chips / ranks, local...)`` block on ranks, and ``run``
    reassembles ``values`` into global order.  ``device=None`` runs on
    the CUDA card (``cuda:$LOCAL_RANK`` where the launcher sets it) and
    raises without one (``device="cpu"`` for the CPU).  ``backend`` and
    ``group`` place the chips on ranks (``ExecMesh.build``); the mesh is
    ``self.mesh``, its label ``self.backend``.
    """

    def __init__(self, app: AppSpec, cfg: EngineConfig, row_lo, row_hi,
                 col_idx, weights=None, part: Optional[ChipPartition] = None,
                 num_chips: Optional[int] = None, device=None,
                 backend: str = "auto", group=None):
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
        self.device = _device.resolve(device)
        self.C = part.num_chips
        self.Tl = part.tiles_per_chip
        self.Cs, self.Cd = cfg.chunk_src, cfg.chunk_dst
        self.mesh = ExecMesh.build(self.C, backend, group=group,
                                   device=self.device)
        self.backend = self.mesh.backend_name
        self.kernel = None             # none on a rank that holds no chip
        if self.mesh.member:
            self.kernel = DataLocalEngine(
                app, cfg, row_lo, row_hi, col_idx, weights, part=part,
                device=self.device, per_chip=True, mesh=self.mesh)
        self.last_load_vecs = None     # summed pc_* vectors of the last run

    # ----------------------------------------------------------- data moves
    def _shard(self, a_global: np.ndarray, chunk: int) -> torch.Tensor:
        """Global per-index array -> stacked (chips, tiles_local*chunk),
        this rank's chips."""
        a = torch.as_tensor(np.asarray(a_global), device=self.device)
        return self.kernel.to_window(a, chunk).reshape(self.mesh.per, -1)

    def _flat(self, state):
        """The stacked state as the engine's window (views)."""
        T = self.mesh.per * self.Tl
        return {k: v.reshape(T, -1) if k.startswith("p_") else v.reshape(-1)
                for k, v in state.items()}

    def _stacked(self, state):
        """The engine's window state stacked per chip (views)."""
        per = self.mesh.per
        return {k: v.reshape(per, self.Tl, -1) if k.startswith("p_")
                else v.reshape(per, -1) for k, v in state.items()}

    def _every_chip(self, stacked):
        """This rank's stacked state with every other rank's blocks, in
        chip order: every chip's ``(chips, ...)`` state (itself in one
        process)."""
        return {k: self.mesh.all_gather(v) for k, v in stacked.items()}

    # ------------------------------------------------------------- elasticity
    def _drop_device(self, chip: int = 0) -> tuple:
        """The device set after the loss of chip ``chip``, as (old, new)
        device counts.  The logical chip count stays ``self.C``: the
        partition and the global tile numbering do not change, only the
        ranks hosting the chips' blocks.  On ranks the mesh is rebuilt
        on the largest dividing subset of the ranks other than the lost
        chip's (every rank of the old mesh takes part) and each
        survivor's engine is placed on its new block; on one rank, or in
        one process, the device stays (the reference rebuilds its mesh
        only on more than one device)."""
        old = self.mesh.ndev
        self.mesh = self.mesh.shrink(chip // self.mesh.per)
        self.backend = self.mesh.backend_name
        if self.mesh.member and self.mesh.ndev != old:
            self.kernel._place(self.mesh)
        return old, self.mesh.ndev

    # ---------------------------------------------------------------- state
    def init_state(self, seed_idx=None, seed_val=None,
                   values: Optional[np.ndarray] = None):
        """Fresh stacked state; ``seed_idx``/``seed_val`` (global indices)
        pre-load mailbox records, ``values`` the global values.  On a rank
        that holds no chip, empty."""
        k = self.kernel
        if k is None:
            return {}
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

        per = self.mesh.per

        def zeros(dt):
            return torch.zeros((per, self.Tl * self.Cs), dtype=dt,
                               device=self.device)

        st = dict(values=self._shard(vals, self.Cd),
                  mail_val=self._shard(mail_val, self.Cd),
                  mail_flag=self._shard(mail_flag, self.Cd),
                  cur_lo=zeros(torch.int32), cur_hi=zeros(torch.int32),
                  cur_val=zeros(torch.float32))
        if self.cfg.proxy is not None:
            shape = (per, self.Tl, self.cfg.proxy.slots)
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
        if k is None:
            return state
        state["cur_lo"] = k.row_lo.reshape(self.mesh.per, -1)
        state["cur_hi"] = k.row_hi.reshape(self.mesh.per, -1)
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
        telemetry the spans carry the per-chip ``pc_*`` vectors, and
        their sums over the run feed ``rebalance_plan``.

        Fault tolerance: with ``EngineConfig.ckpt_every_supersteps > 0``
        the state is checkpointed at the loops' accounting boundaries
        (cadence in supersteps; the fetch the boundary has anyway says
        where it is).  ``fault_injector`` (``runtime.fault
        .FaultInjector``) injects a chip loss mid-run; the engine rolls
        back to the last checkpoint, restores the state on the device
        and replays -- final values, counters, supersteps and trace
        equal an unfailed run's, with all recovery overhead priced
        separately (see ``trace.recovery_events``).  On the chunked loop
        the restore copies into the chunk runner's tensors, so no CUDA
        graph is captured again, and the first chunk after it runs
        dense.  ``ckpt_dir`` overrides the checkpoint directory
        (default: a fresh temporary one, removed when the run ends); on
        ranks it is one directory every rank reads.

        On ranks every rank of the mesh returns the same values and
        ``RunResult``; a rank that holds no chip, or is left out of the
        mesh after a chip loss, returns ``(None, None)``."""
        if not self.mesh.member:
            return None, None
        cfg = self.cfg
        vec_sums = {} if cfg.telemetry else None
        fault_tolerance = made = None
        if cfg.ckpt_every_supersteps > 0 or fault_injector is not None:
            if ckpt_dir is None:
                if self.mesh.rank == 0:
                    made = tempfile.mkdtemp(
                        prefix=f"repro_torch_ckpt_{self.app.name}_")
                ckpt_dir = made = self._from_rank0(made)
            blinks = board_link_provisioning(cfg.pkg, self.part.chips_y,
                                             self.part.chips_x)

            def fault_tolerance(counters, trace, prev_exch, overhead):
                return _FaultTolerance(
                    self, directory=ckpt_dir,
                    every=cfg.ckpt_every_supersteps,
                    injector=fault_injector, counters=counters, trace=trace,
                    prev_exch=prev_exch, overhead=overhead,
                    vec_sums=vec_sums, n_board_links=blinks)
        try:
            flat, result = self.kernel._run(
                self._flat(state), max_supersteps, progress_every, chunk,
                observer, fault_tolerance=fault_tolerance,
                vec_sums=vec_sums)
            values = self.kernel._every_rank(flat["values"])
        except LeftMesh:
            return None, None
        finally:
            # the mesh's rank 0 at the end: every other rank is done
            if made is not None and self.mesh.member and self.mesh.rank == 0:
                shutil.rmtree(made, ignore_errors=True)
        self.last_load_vecs = vec_sums
        out = self._stacked(flat)
        out["values"] = self.kernel.from_window(values, self.Cd)
        return out, result

    def _from_rank0(self, obj):
        """The mesh's rank 0's ``obj`` on every rank of the mesh."""
        if not self.mesh.collective:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.mesh.ranks[0],
                                   group=self.mesh.group, device=self.device)
        return box[0]

    # ---------------------------------------------------- straggler handling
    def rebalance_plan(self, n_items: Optional[int] = None,
                       max_ratio: float = 1.5, threshold: float = 2.0):
        """Straggler-aware ownership re-chunking plan for the next wave.

        Feeds the last run's summed per-chip ``pc_*`` telemetry
        (requires ``EngineConfig.telemetry``) into ``runtime.straggler``:
        per-chip load is modeled in PU ops -- edges streamed plus records
        drained (the cost model's ``PU_OPS_PER_EDGE`` /
        ``PU_OPS_PER_RECORD``) plus exchange arrivals -- and
        ``rebalance_chunks`` returns new destination-range boundaries
        over ``n_items`` (default: the global destination index space).
        Advisory between query waves: applying it re-partitions
        ownership for the *next* run and never perturbs the current one.
        Returns a dict with the measured load, straggler mask/imbalance
        ratio, new boundaries, and the predicted post-rebalance
        imbalance."""
        v = self.last_load_vecs
        if not v:
            raise ValueError(
                "no per-chip load telemetry: run() with "
                "EngineConfig.telemetry=True before rebalance_plan()")
        zero = np.zeros(self.C, np.float64)
        load = (np.asarray(v.get("pc_edges", zero), np.float64)
                * PU_OPS_PER_EDGE
                + np.asarray(v.get("pc_records", zero), np.float64)
                * PU_OPS_PER_RECORD
                + np.asarray(v.get("pc_recv", zero), np.float64))
        mask, ratio = detect_stragglers(load, threshold=threshold)
        n = int(self.part.grid.num_tiles * self.Cd
                if n_items is None else n_items)
        bounds = rebalance_chunks(load, n, max_ratio=max_ratio)
        # predicted post-rebalance load: piecewise-uniform density over
        # the old equal chunks, integrated over the new boundaries
        eq = n / self.C
        cum = np.concatenate([[0.0], np.cumsum(load)])
        new_load = np.diff(np.interp(bounds, np.arange(self.C + 1) * eq,
                                     cum))
        pred = float(new_load.max() / max(new_load.mean(), 1e-9))
        return dict(load=load, stragglers=mask, imbalance=float(ratio),
                    boundaries=bounds, predicted_imbalance=pred)


def run_distributed(app: AppSpec, cfg: EngineConfig, row_lo, row_hi,
                    col_idx, weights=None, *, chips: Optional[int] = None,
                    part: Optional[ChipPartition] = None, seed_idx=None,
                    seed_val=None, values=None, activate=None,
                    max_supersteps: Optional[int] = None, device=None,
                    backend: str = "auto", group=None):
    """One-call distributed run: partition, seed or activate, run to
    drain.  Returns (global values as a numpy array, RunResult), or
    (None, None) on a rank that holds no chip.  ``activate`` (a global
    per-source value array) selects epoch-style activation;
    ``seed_idx``/``seed_val`` seed mailboxes."""
    eng = DistributedEngine(app, cfg, row_lo, row_hi, col_idx, weights,
                            part=part, num_chips=chips, device=device,
                            backend=backend, group=group)
    state = eng.init_state(seed_idx=seed_idx, seed_val=seed_val,
                           values=values)
    if activate is not None:
        state = eng.activate_all(state, activate)
    state, run = eng.run(state, max_supersteps)
    if run is None:
        return None, None
    return state["values"].cpu().numpy(), run
