"""The data-local execution engine (paper §II-B, §III) in PyTorch.

The port of ``repro.core.engine``'s monolithic engine, for the slice of
it that the six paper apps run under their Table-II proxies:

  1. **IQ drain**: each tile consumes up to ``iq_cap`` pending records
     from its mailbox; an improving record re-activates the item's edge
     cursor.
  2. **OQ emit**: each tile streams up to ``oq_cap`` edges from its
     active cursors, producing (dst_index, value) records.
  3. **Proxy stage** (if configured): records are routed to the proxy
     tile in the sender's region, batch-coalesced and filtered through
     the direct-mapped P$.  Write-through forwards every update;
     write-back holds them and forwards only evicted residents and batch
     slot conflicts, and a **flush** superstep spills the whole P$ once
     the live work has drained.  With a cascade, records climb the
     region reduction tree (``_cascade_drain``), merging at each level;
     **selective cascading** sends only apps that profit through it and
     lets a record leave the tree once its owner is near.
  4. **Delivery**: surviving records are combined into owner mailboxes.

Every message is charged exact XY-torus hops at each leg; the BSP time
model (``costmodel.step_cycles``) takes the per-superstep max over tile
compute, per-level network serialization and endpoint contention.

Values, ``TrafficCounters``, ``SuperstepTrace``, supersteps and
``time_s`` equal the reference's on the same inputs: bit for bit for the
min apps, with values to f32 re-association for the add apps
(``tests/test_torch_engine.py``, ``tests/test_torch_addapps.py``).  Hot
spots: with ``EngineConfig.backend="kernels"`` (the default) the IQ-drain
relax, the P$ and cascade segment combine and the owner delivery go
through ``kernels.ops`` -- the hand-written Hopper kernels on a CUDA
tensor, their plain versions on a CPU tensor.  ``backend="torch"`` is the
inline plain-torch path, the counterpart of the reference's ``"jnp"``
oracle.

``run`` runs ``EngineConfig.run_chunk`` supersteps (16 by default) per
host fetch, the reference's device-resident chunked loop: on the card
each superstep of a chunk is one replay of a captured CUDA graph
(``core/chunk.py``), on the CPU the same predicated step runs eagerly.
``chunk=0`` selects the per-step loop, one host sync per superstep.  The
two give identical counters, trace, supersteps and ``time_s``, and
identical values for the min apps.

**Active-set compaction** (``EngineConfig.compaction = L > 0``): a
superstep runs its IQ drain and OQ emit over the smallest window of the
per-chip ladder ``capacity_ladder(Tl, L)`` (``Tl`` the tiles of a chip,
all of them on one chip) that holds the tiles with pending mailbox flags
or open edge cursors on the busiest chip (``_front_compact``): a window
of rung W is W lanes a chip, so the record stream the P$, the cascade
and delivery work on shrinks from ``T*oq_cap`` to ``C*W*oq_cap``.  The
reference switches windows on the device (``lax.switch``); a CUDA graph
cannot branch, so here the host picks the window from the busiest
chip's active-tile count, which rides a fetch the loop makes anyway: on
the per-step loop the count of the state each superstep will step, on
the chunked loop the count after each chunk, with one rung of headroom
(``CHUNK_HEADROOM``; one graph per flush value and window; a superstep
whose tiles outgrow its chunk's window idles the rest of the chunk,
``core/chunk.py``).  The first superstep or chunk runs dense.  Every
window gives the dense result bit for bit, and the stats carry the
reference's ``active_tiles`` (summed over the chips) and ``bucket_cap``
(the rung the reference would pick for the busiest chip).

**Observability and the sanitizer** (the reference's, on both loops,
dense and compacted).  ``EngineConfig.telemetry`` makes each superstep
also emit the per-tile load vectors ``tv_edges``, ``tv_records`` and
``tv_delivered`` (under compaction the lane counts scattered back
into (T,)), which ride the chunk's one fetch in a channel of their own;
``EngineConfig.sanitize`` counts four kinds of invariant violation on
the device (a min app's value that rose, an unflagged mailbox slot off
the identity, a cursor with ``cur_hi < cur_lo``, a NaN value) into the
``sanity_violations`` stat, which the run loops raise
``analysis.invariants.SanitizerError`` on, and checks the finished run
with ``analysis.invariants.check_run``; ``run(observer=)`` hands an
``obs.timeline.Observer`` the run's meta, one span per chunk (per
superstep on the per-step loop) and the result.  All three only
observe: values, counters, trace, supersteps, ``time_s`` and
``engine.host_syncs`` equal the run without them.

**A partition into chips** (``part=ChipPartition`` of more than one
chip, run through ``distrib.DistributedEngine``): the reference vmaps a
per-chip superstep over the chips; here one superstep runs every chip's
tiles at once, as one chip-major window.  Window position ``p = chip *
Tl + ltile`` holds global tile ``perm[p]`` (``_tile_gids``; the
reference's stacked ``(chips, tiles_local)`` layout, flat), so the ops a
superstep dispatches do not depend on the chip count.  A record whose
owner lies on its source tile's chip is delivered on the chip; one that
leaves is charged the board leg (``netstats.charge_board``) and held
back, and at the end of the superstep every leg's off-chip records fold
into the window's mailbox at once (``_Exchange``, the reference's
``exchange``), their arrivals per tile kept apart from the on-chip
ones.  With one chip the window is the grid, ``perm`` the identity and
the step today's.  Such an engine refuses ``init_state``,
``activate_all`` and ``run`` (the driver holds the state).

**The double-buffered exchange** (``EngineConfig.double_buffer``): the
BSP rule charges each superstep ``max(its chip-local work, the previous
superstep's exchange)`` and the last exchange after the loop, on both
loops.  As in the reference, only the chunked loop on more than one chip
also defers the exchange: superstep k merges the exchanged mailbox flags
and arrival counts, and leaves the values' min or sum per mailbox index
in the runner's ``DEFERRED`` buffer, one (Nd,) tensor whichever graph
replays; superstep k+1 folds it into the mailbox first thing.  Nothing
writes the mailbox in between, so values, counters and trace are the
synchronous exchange's.  The card runs both halves in order all the
same: the overlap is priced, not performed.

**Checkpoints and recovery** are the distributed runtime's
(``distrib.DistributedEngine.run(fault_injector=, ckpt_dir=)`` with
``EngineConfig.ckpt_every_supersteps``): ``_run`` takes
``DistributedEngine``'s fault-tolerance controller, which checkpoints at
the loops' accounting boundaries and turns a chip loss into a rollback
and a replay.  On the monolithic engine the cadence is accepted and has
no effect, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import netstats
from .. import device as _device
from ..analysis import invariants
from ..kernels import ops as kops
from ..obs.metrics import default_registry
from ..obs.timeline import ChunkSpan, RunMeta
from ..runtime.fault import ChipLostError
from .chunk import ACTIVE_MAX, ChunkRunner
from .costmodel import (CLOCK_GHZ, IO_DIE_RXTX_LAT_NS, PU_OPS_PER_EDGE,
                        PU_OPS_PER_RECORD, DCRA_SRAM, PackageConfig,
                        _off_pkg_bits_per_cycle, board_link_provisioning,
                        link_provisioning, step_cycles)
from .netstats import MSG_BITS, SuperstepTrace, TrafficCounters
from .proxy import (ProxyConfig, cascade_proxy_tile, make_pcache,
                    pcache_slot, proxy_tile)
from .tilegrid import ChipPartition, TileGrid

INF = float("inf")
# the state arrays the IQ drain and OQ emit read and write, in
# ``_front_rows``' argument order
# The chunked loop sizes a chunk's window for this many times the active
# tiles its fetch counted, one rung of the ladder (rungs are 4x apart):
# the active set grows inside a chunk (a BFS frontier), and a superstep
# that outgrows its window idles the rest of the chunk.  The per-step
# loop counts the very state it steps and needs none.
CHUNK_HEADROOM = 4
_FRONT_KEYS = ("values", "mail_val", "mail_flag", "cur_lo", "cur_hi",
               "cur_val")


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """How an application maps onto the engine."""

    name: str
    combine: str             # 'min' | 'add'
    edge_value: str          # 'add_w' | 'add_one' | 'mul_w' | 'carry' | 'one'
    reactivate: bool = True  # mailbox improvements re-activate edge cursors
    count_teps_on: str = "edges"   # what Graph500-style TEPS counts
    # whether merging in-flight updates to one index is profitable (the
    # selective-cascading criterion)
    cascade_profitable: bool = True

    @property
    def identity(self) -> float:
        return float("inf") if self.combine == "min" else 0.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's configuration, field for field.  ``run_chunk`` is
    the supersteps per host fetch of ``DataLocalEngine.run``'s chunked
    loop (0: the per-step loop)."""

    grid: TileGrid
    n_src: int                       # items with edge cursors
    n_dst: int                       # items receiving updates
    oq_cap: int = 64                 # edge emissions per tile per superstep
    iq_ratio: int = 8                # iq_cap = iq_ratio * oq_cap
    proxy: Optional[ProxyConfig] = None
    pkg: PackageConfig = DCRA_SRAM
    max_supersteps: int = 200_000
    element_bits: int = 64           # index+value footprint per dataset element
    run_chunk: int = 16
    # 'kernels' (hot spots through kernels.ops) or 'torch' (the inline
    # plain-torch oracle path)
    backend: str = "kernels"
    sanitize: bool = False
    telemetry: bool = False
    double_buffer: bool = False
    compaction: int = 0
    # supersteps between checkpoints of ``DistributedEngine.run`` (0:
    # only the step-0 baseline, and that only with a fault injector); the
    # monolithic engine ignores it, as the reference's does
    ckpt_every_supersteps: int = 0

    @property
    def iq_cap(self) -> int:
        return self.iq_ratio * self.oq_cap

    @property
    def chunk_src(self) -> int:
        return self.grid.chunk_size(self.n_src)

    @property
    def chunk_dst(self) -> int:
        return self.grid.chunk_size(self.n_dst)


# Scalar stats of one superstep, in the order the per-step loop packs
# them into the one tensor it fetches (``fetch_stats``) and the chunked
# loop into each row of its chunk buffer (with ``active`` last).
STAT_KEYS = ("edges_processed", "records_consumed", "compute_per_tile_max",
             "filtered_at_proxy", "coalesced_at_proxy", "cascade_combined",
             "pending", "p_resident", "delivered_max_per_tile",
             "messages", "hop_msgs", "intra_die_hops", "inter_die_crossings",
             "inter_pkg_crossings", "cross_region_msgs", "owner_msgs",
             "owner_hop_msgs")
# With compaction, each superstep also reports its input state's active
# tiles (summed over the chips) and the ladder rung that holds the
# busiest chip's; the accounting ignores both.  Beside them, never in a
# stats row, ``chunk.ACTIVE_MAX``: the busiest chip's count, which says
# whether a window holds the superstep.
COMPACTION_KEYS = ("active_tiles", "bucket_cap")
# The chunk runner's state key of the double-buffered exchange: the
# exchanged values' min or sum per window mailbox index, the identity
# where none arrived, folded into the mailbox by the next superstep.
DEFERRED = "mail_deferred"
# With the sanitizer, each superstep reports its on-device violation
# count (saturated at SANITY_CAP), which the run loops raise on.
SANITIZE_KEYS = ("sanity_violations",)
SANITY_CAP = 2 ** 20
# With more than one chip, each superstep also charges the board leg.
OFF_CHIP_KEYS = ("off_chip_msgs", "off_chip_hop_msgs")
# With telemetry, each superstep also emits these (T,) per-tile load
# vectors, fetched beside the stats rows, never in them.
TELEMETRY_KEYS = ("tv_delivered", "tv_edges", "tv_records")
# The distributed runtime's telemetry: the (C,) per-chip reductions of
# the reference's ``_aggregate`` in place of the per-tile vectors
# (``pc_offchip`` with more than one chip only).
PER_CHIP_KEYS = ("pc_compute", "pc_delivered", "pc_delivmax", "pc_edges",
                 "pc_offchip", "pc_owner", "pc_records", "pc_recv")


class DataLocalEngine:
    """Single-device engine: simulates the whole tile grid as one window,
    with exact traffic accounting; with a multi-chip ``part``, the window
    of every chip's tiles in chip-major order (the module docstring).

    ``device=None`` runs on the CUDA card and raises without one; the
    CPU runs only when asked for (``device="cpu"``).  ``row_lo``,
    ``row_hi``, ``col_idx`` and ``weights`` may be numpy arrays or tensors
    (``convert.csr_to_device``); they are moved to the device once.
    ``per_chip`` (set by ``distrib.DistributedEngine``) makes telemetry
    emit the per-chip ``pc_*`` vectors in place of the per-tile ones.
    """

    def __init__(self, app: AppSpec, cfg: EngineConfig,
                 row_lo, row_hi, col_idx, weights=None,
                 part: Optional[ChipPartition] = None, device=None,
                 per_chip: bool = False):
        if cfg.backend not in ("kernels", "torch"):
            raise ValueError(f"unknown engine backend {cfg.backend!r}")
        part = part if part is not None else ChipPartition(cfg.grid, 1, 1)
        self.app = app
        self.cfg = cfg
        self.part = part
        self.device = _device.resolve(device)
        self.n_chips = part.num_chips
        self.Tl = part.tiles_per_chip
        self._multi = self.n_chips > 1
        self._per_chip = per_chip
        T = cfg.grid.num_tiles          # the window: every chip's tiles
        self.T = T
        self.Tg = T
        self.Cs = cfg.chunk_src
        self.Cd = cfg.chunk_dst
        self.Ns = T * self.Cs
        self.Nd = T * self.Cd
        self.Ngs = self.Tg * self.Cs
        self.Ngd = self.Tg * self.Cd
        self._cascade_levels = 0
        if cfg.proxy is not None:
            if T * cfg.proxy.slots >= 2**31:
                raise ValueError("T*slots must fit int32 for P$ sort keys")
            cfg.proxy.validate_window(part.sub_ny, part.sub_nx)
            casc = cfg.proxy.cascade
            if casc is not None and (not casc.selective
                                     or app.cascade_profitable):
                self._cascade_levels = casc.levels
        self._write_back = cfg.proxy is not None and cfg.proxy.write_back
        # an improving mailbox record restarts its item's edge cursor
        self._reactivates = app.reactivate and self.Nd == self.Ns
        dev = self.device
        # window position p holds global tile perm[p]: chip-major, each
        # chip's tiles in local row-major order (the identity on one chip)
        perm = np.concatenate([part.tile_ids(c)
                               for c in range(self.n_chips)])
        self._tile_gids = torch.as_tensor(perm, dtype=torch.int32,
                                          device=dev)
        if self._multi:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(T)
            self._win_pos = torch.as_tensor(inv, dtype=torch.int32,
                                            device=dev)
        # the source items' edge ranges in window order; the edge arrays
        # are indexed by global edge position and stay as they are
        self.row_lo = self.to_window(
            _to(_pad(row_lo, self.Ngs, 0), torch.int32, dev), self.Cs)
        self.row_hi = self.to_window(
            _to(_pad(row_hi, self.Ngs, 0), torch.int32, dev), self.Cs)
        self.col_idx = _to(col_idx, torch.int32, dev)
        if weights is None:
            weights = torch.ones(self.col_idx.shape, dtype=torch.float32)
        self.weights = _to(weights, torch.float32, dev)
        # the source tile of each emitted record and of each P$ entry,
        # fixed per engine: made once, so no superstep sizes an output
        # on the host
        self._src_tile = torch.repeat_interleave(self._tile_gids, cfg.oq_cap)
        self._pcache_src = (None if cfg.proxy is None else
                            torch.repeat_interleave(self._tile_gids,
                                                    cfg.proxy.slots))
        # the reference's per-chip ladder: a window of rung W is W lanes
        # on every chip
        self._ladder = capacity_ladder(self.Tl, cfg.compaction)
        self._compacting = len(self._ladder) > 1
        self._ladder_t = torch.tensor(self._ladder, dtype=torch.float32,
                                      device=dev)
        self.stat_keys = (STAT_KEYS
                          + (OFF_CHIP_KEYS if self._multi else ())
                          + (COMPACTION_KEYS if self._compacting else ())
                          + (SANITIZE_KEYS if cfg.sanitize else ()))
        if not cfg.telemetry:
            self.vec_keys = ()
        elif per_chip:
            self.vec_keys = tuple(k for k in PER_CHIP_KEYS
                                  if self._multi or k != "pc_offchip")
        else:
            self.vec_keys = TELEMETRY_KEYS
        self._vec_width = self.n_chips if per_chip else T
        # the chunked loop defers the exchanged values where there is an
        # exchange; the BSP rule's overlap follows cfg.double_buffer
        self._defers = cfg.double_buffer and self._multi
        self._exch = None              # the superstep's _Exchange
        self._n_seeds = 0              # set by init_state, read by check_run

    def to_window(self, a, width: int):
        """A global per-item tensor of ``width`` items a tile, in window
        order."""
        if not self._multi:
            return a
        return a.reshape(self.T, width).index_select(
            0, self._tile_gids).reshape(-1)

    def from_window(self, a, width: int):
        """A window-order per-item tensor back in global order."""
        if not self._multi:
            return a.reshape(-1)
        return a.reshape(self.T, width).index_select(
            0, self._win_pos).reshape(-1)

    def _pos(self, tid):
        """The window positions of the (R,) global tiles ``tid``: the
        reference's ``chip_of_tile * Tl + local_tile``
        (``_owner_slots``)."""
        return self._win_pos.index_select(0, tid) if self._multi else tid

    def _require_mono(self, what: str) -> None:
        """The state of a multi-chip window is the driver's."""
        if self._multi:
            raise ValueError(
                f"{what} is monolithic-only; with a {self.n_chips}-chip "
                f"partition use distrib.DistributedEngine, which runs this "
                f"engine's window of every chip's tiles")

    # ---------------------------------------------------------------- state
    def init_state(self, seed_idx=None, seed_val=None):
        """Fresh engine state; ``seed_idx``/``seed_val`` pre-load mailbox
        records (the traversal roots)."""
        self._require_mono("init_state")
        ident = self.app.identity
        dev = self.device

        def full(n, v, dt):
            return torch.full((n,), v, dtype=dt, device=dev)

        st = dict(
            values=full(self.Nd, ident, torch.float32),
            mail_val=full(self.Nd, ident, torch.float32),
            mail_flag=full(self.Nd, False, torch.bool),
            cur_lo=full(self.Ns, 0, torch.int32),
            cur_hi=full(self.Ns, 0, torch.int32),
            cur_val=full(self.Ns, 0.0, torch.float32),
        )
        if self.cfg.proxy is not None:
            st["p_tag"], st["p_val"] = make_pcache(
                self.cfg.grid, self.cfg.proxy, ident, dev)
        self._n_seeds = 0   # mailbox seeds, for the sanitizer's consumed-bound
        if seed_idx is not None:
            si = torch.as_tensor(np.atleast_1d(seed_idx), dtype=torch.int64,
                                 device=dev)
            sv = torch.as_tensor(np.atleast_1d(seed_val),
                                 dtype=torch.float32, device=dev)
            st["mail_val"][si] = sv
            st["mail_flag"][si] = True
            self._n_seeds = int(si.shape[0])
        return st

    def activate_all(self, state, cur_val):
        """Epoch-style activation (PageRank/SpMV/Histogram): every source
        item starts with its full edge range and a carried value."""
        self._require_mono("activate_all")
        state = dict(state)
        state["cur_lo"] = self.row_lo
        state["cur_hi"] = self.row_hi
        state["cur_val"] = _to(_pad(cur_val, self.Ns, 0.0), torch.float32,
                               self.device)
        return state

    # ------------------------------------------------------------ superstep
    def _edge_value(self, cval, pos):
        """Per-edge record value from the source cursor value and the
        edge position."""
        ev = self.app.edge_value
        if ev == "add_w":
            return cval + self.weights[pos]
        if ev == "add_one":
            return cval + 1.0
        if ev == "mul_w":
            return cval * self.weights[pos]
        if ev == "carry":
            return cval
        if ev == "one":
            return torch.ones_like(cval)
        raise ValueError(ev)

    def _front_dense(self, row_lo, row_hi, state):
        """Dense IQ drain + OQ emit over all T tiles.

        Returns (new_vals, mail_val, mail_flag, cur_lo, cur_hi, cur_val,
        consumed_per_tile, edges_per_tile, dst, cand, emit_mask,
        src_tile): full-length state tensors, (T,) per-tile counts and
        the flattened (T*oq_cap,) emission record stream."""
        return self._front_rows(
            self.T, *(state[k] for k in _FRONT_KEYS), row_lo,
            row_hi) + (self._src_tile,)

    def _front_compact(self, row_lo, row_hi, state, active, W,
                       commit=None):
        """Compacted IQ drain + OQ emit over a window of W lanes a chip.

        Each chip's active tiles are compacted, in local tile order, into
        the leading lanes of its W and the chip's inactive tiles fill the
        lanes left (``_window_lanes``); the drain and emit run on those
        C*W rows, chip-major, and the rows are written back.  An inactive
        tile has no mailbox flags and no open cursors, so its rows come
        back as they went and it emits nothing; the lanes are distinct
        rows, so the write-back is one ``index_copy_``.  Live records keep
        the dense path's chip-major, tile-major order, so the sorts, segment reductions and delivery
        downstream see the same live sequence and the f32 sums the same
        order: state, counters and trace equal ``_front_dense``'s.  Same
        return contract, with (C*W,) per-lane counts (their sums and
        maxima are the dense ones: the lanes cover every tile with work)
        and a (C*W*oq_cap,) record stream.

        ``commit`` (a 0-d bool, the chunk runner's predicate) writes the
        rows of the arrays only the front changes (``values`` and the
        cursors) into ``state``'s own tensors, where it holds and every
        chip's active tiles fit in W, and returns those tensors: a
        C*W-row write in place of a full-length copy.  Without it every
        array comes back as a new tensor.

        Returns (front, lanes, raised): the front tuple, the (C*W,)
        window rows of the lanes, and, for a min app under the sanitizer,
        the count of window values the drain raised, taken before the
        write-back (after it, ``state["values"]`` holds the new rows, and
        a comparison of new against old would compare new with new);
        otherwise None."""
        T, Cs, Cd = self.T, self.Cs, self.Cd
        per_chip = active.reshape(self.n_chips, self.Tl)
        lanes = _window_lanes(per_chip, W, self.Tl)
        n = lanes.shape[0]
        widths = dict(values=Cd, mail_val=Cd, mail_flag=Cd, cur_lo=Cs,
                      cur_hi=Cs, cur_val=Cs)

        def rows(a, c):
            return a.reshape(T, c)[lanes].reshape(-1)

        react = self._reactivates
        win = {k: rows(state[k], widths[k]) for k in _FRONT_KEYS}
        out = self._front_rows(
            n, *(win[k] for k in _FRONT_KEYS),
            rows(row_lo, Cs) if react else None,
            rows(row_hi, Cs) if react else None)
        # cursors without reactivation keep their bounds and values
        kept = _FRONT_KEYS if react else _FRONT_KEYS[:4]
        if commit is not None:
            commit = commit & (torch.amax(torch.sum(
                per_chip, dim=1, dtype=torch.int32)) <= W)
        raised = None
        if self.cfg.sanitize and self.app.combine == "min":
            raised = torch.sum(out[0] > win["values"])
        new = []
        for k, part in zip(_FRONT_KEYS, out):
            full = state[k].reshape(T, widths[k])
            if k not in kept:
                new.append(state[k])
            elif commit is None or k.startswith("mail"):
                # the mailbox goes on to delivery: a new tensor
                new.append(full.clone().index_copy_(
                    0, lanes, part.reshape(n, -1)).reshape(-1))
            else:
                full.index_copy_(0, lanes, torch.where(
                    commit, part, win[k]).reshape(n, -1))
                new.append(state[k])
        B = self.cfg.oq_cap
        src = self._tile_gids.index_select(0, lanes)
        return (tuple(new) + out[6:] + (src[:, None].expand(n, B)
                                        .reshape(-1),), lanes, raised)

    def _front_rows(self, n, values, mail_val, mail_flag, cur_lo, cur_hi,
                    cur_val, row_lo, row_hi):
        """IQ drain + OQ emit over ``n`` rows of tiles: the state arrays
        and the graph's row bounds hold the rows' items, (n*Cd,) or
        (n*Cs,).  Returns (new_vals, mail_val, mail_flag,
        cur_lo, cur_hi, cur_val, consumed_per_row, edges_per_row, dst,
        cand, emit_mask) with the (n*oq_cap,) record stream."""
        app, cfg = self.app, self.cfg
        Cs, Cd = self.Cs, self.Cd
        dev = self.device

        # ---- 1. IQ drain (budgeted mailbox consumption) -------------------
        flag2d = mail_flag.reshape(n, Cd)
        csum = torch.cumsum(flag2d.to(torch.int32), dim=1, dtype=torch.int32)
        take2d = flag2d & (csum <= cfg.iq_cap)
        take = take2d.reshape(-1)
        mval, vals = mail_val, values
        if cfg.backend == "kernels":
            new_vals, imp8 = kops.relax(vals, mval, take, combine=app.combine)
            improved = imp8.to(torch.bool)
        elif app.combine == "min":
            improved = take & (mval < vals)
            new_vals = torch.where(improved, mval, vals)
        else:
            improved = take
            new_vals = torch.where(take, vals + mval, vals)
        mail_flag = mail_flag & ~take
        mail_val = torch.where(take, app.identity, mval)
        consumed_per_tile = torch.sum(take2d, dim=1)

        if self._reactivates:
            # an improving record restarts the item's edge cursor with the
            # new value (re-expansion of a visited item is the engine's
            # rendering of data staleness: measurable wasted work)
            cur_lo = torch.where(improved, row_lo, cur_lo)
            cur_hi = torch.where(improved, row_hi, cur_hi)
            cur_val = torch.where(improved, new_vals, cur_val)

        # ---- 2. OQ emit (budgeted edge streaming) -------------------------
        B = cfg.oq_cap
        rem2d = (cur_hi - cur_lo).reshape(n, Cs)
        prefix = torch.cumsum(rem2d, dim=1, dtype=torch.int32)  # inclusive
        capped = torch.clamp(prefix, max=B)
        take_v2d = capped - torch.cat(
            [torch.zeros((n, 1), dtype=torch.int32, device=dev),
             capped[:, :-1]], dim=1)
        total_take = capped[:, -1]                               # (n,)
        b_idx = torch.arange(B, dtype=torch.int32, device=dev)
        # per-row searchsorted(side="right") of every emission slot
        vslot = torch.searchsorted(capped, b_idx.expand(n, B).contiguous(),
                                   right=True)
        vslot = torch.clamp(vslot, max=Cs - 1)                   # (n, B)
        capped_prev = capped - take_v2d
        offset = b_idx[None, :] - torch.gather(capped_prev, 1, vslot)
        vglob = vslot + torch.arange(n, device=dev)[:, None] * Cs
        pos = cur_lo[vglob] + offset
        emit_mask = b_idx[None, :] < total_take[:, None]
        pos = torch.clamp(pos, 0, self.col_idx.shape[0] - 1).to(torch.int64)
        dst = self.col_idx[pos]
        cand = self._edge_value(cur_val[vglob], pos)
        cur_lo = cur_lo + take_v2d.reshape(-1)

        # flatten records (tile ids are global; dst indices are global)
        R = n * B
        return (new_vals, mail_val, mail_flag, cur_lo, cur_hi, cur_val,
                consumed_per_tile, total_take, dst.reshape(R),
                cand.reshape(R), emit_mask.reshape(R))

    def _active_tiles(self, state):
        """(T,) mask of the tiles with pending mailbox flags or open edge
        cursors: the tiles the dense superstep does non-identity work on
        (reactivation only touches flagged tiles, so the emission after
        the drain stays inside this set too)."""
        T = self.T
        mail = torch.any(state["mail_flag"].reshape(T, self.Cd), dim=1)
        cur = torch.any((state["cur_hi"] > state["cur_lo"])
                        .reshape(T, self.Cs), dim=1)
        return mail | cur

    def _chip_active_max(self, active):
        """The most active tiles on one chip of the (T,) window mask
        ``active`` (all of them on one chip), as a 0-d int32 tensor."""
        return torch.amax(torch.sum(active.reshape(self.n_chips, self.Tl),
                                    dim=1, dtype=torch.int32))

    def _count_active(self, state):
        """The busiest chip's active tiles of ``state`` as a 0-d int32
        device tensor: what a window must hold."""
        return self._chip_active_max(self._active_tiles(state))

    def _window(self, n_active):
        """The window a superstep whose busiest chip has ``n_active``
        active tiles runs in: the smallest rung of the per-chip ladder
        that holds them, None for the dense one."""
        w = self._ladder[int(bucket_index(n_active, self._ladder))]
        return None if w == self.Tl else w

    def _superstep(self, state, flush: bool = False,
                   window: Optional[int] = None, commit=None):
        """One monolithic superstep: (new_state, stats) with every stat a
        0-d tensor on the device.  ``flush`` (a host bool, decided by the
        run loop from the previous superstep's or chunk's fetched stats)
        spills the write-back P$ in this superstep.  ``window`` (a rung of
        the compaction ladder below T, picked by the run loop) runs the
        front over that many active tiles; ``commit`` is
        ``_front_compact``'s in-place write-back."""
        return self._step(self.row_lo, self.row_hi, state, flush, window,
                          commit)

    def _step(self, row_lo, row_hi, state, flush=False, window=None,
              commit=None):
        app, cfg = self.app, self.cfg
        is_min = app.combine == "min"
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        stats = {}
        deferred = state.get(DEFERRED)
        if deferred is not None:
            # the previous superstep's exchanged values land first: the
            # synchronous exchange's fold, one superstep later (nothing
            # wrote the mailbox in between)
            state = dict(state, mail_val=_fold(state["mail_val"], deferred,
                                               is_min))
        if self._compacting:
            active = self._active_tiles(state)
            n_max = self._chip_active_max(active)
            idx = bucket_index(n_max, self._ladder)
            stats.update(active_tiles=torch.sum(active, dtype=torch.float32),
                         bucket_cap=self._ladder_t.index_select(
                             0, idx.reshape(1)).reshape(()))
            stats[ACTIVE_MAX] = n_max
        if window is None:
            front = self._front_dense(row_lo, row_hi, state)
            lanes = raised = None
            if cfg.sanitize and is_min:
                raised = torch.sum(front[0] > state["values"])
        else:
            front, lanes, raised = self._front_compact(
                row_lo, row_hi, state, active, window, commit)
        (new_vals, mail_val, mail_flag, cur_lo, cur_hi, cur_val,
         consumed_vec, edges_vec, dst, cand, emit_mask, src_tile) = front
        owner = torch.clamp(dst // self.Cd, max=self.Tg - 1)
        self._exch = exch = _Exchange()
        if cfg.telemetry:
            # per-tile load vectors, pure extra outputs; a window's lane
            # counts go back to their tiles (the lanes are distinct, and
            # the fill lanes count zero)
            counts = torch.stack([consumed_vec.to(torch.float32),
                                  edges_vec.to(torch.float32)], dim=1)
            if lanes is not None:
                counts = counts.new_zeros((self.T, 2)).index_copy_(
                    0, lanes, counts)
            stats.update(tv_records=counts[:, 0], tv_edges=counts[:, 1])

        stats.update(edges_processed=torch.sum(edges_vec),
                     records_consumed=torch.sum(consumed_vec),
                     compute_per_tile_max=torch.max(
                         consumed_vec * PU_OPS_PER_RECORD
                         + edges_vec * PU_OPS_PER_EDGE),
                     filtered_at_proxy=zero,
                     coalesced_at_proxy=zero,
                     cascade_combined=zero)

        p_tag = state.get("p_tag")
        p_val = state.get("p_val")
        if cfg.proxy is None:
            (mail_val, mail_flag, owner_leg, off_ch,
             per_tile) = self._drain_to_owners(
                mail_val, mail_flag, dst, cand, emit_mask, src_tile, None,
                is_min)
            dmax = torch.max(per_tile)
            charges = dict(netstats.merge_charges(owner_leg, off_ch),
                           owner_msgs=owner_leg["messages"],
                           owner_hop_msgs=owner_leg["hop_msgs"])
            if cfg.telemetry:
                stats["tv_delivered"] = per_tile.to(torch.float32)
        else:
            (mail_val, mail_flag, p_tag, p_val, charges, pstats,
             dmax) = self._proxy_stage(
                mail_val, mail_flag, p_tag, p_val, dst, cand, emit_mask,
                src_tile, owner, flush, is_min)
            stats.update(pstats)
        self._exch = None
        recv = None
        if self._multi:
            # the board exchange: every leg's off-chip records fold into
            # the window's mailbox at once (min, add or flag-or: order-
            # free up to f32 re-association), their arrivals per
            # receiving tile kept apart from the on-chip deliveries.
            # Deferred, the flags and arrivals merge now and the values
            # combine into an identity buffer the next superstep folds.
            stream = [torch.cat(a) for a in (exch.idx, exch.val, exch.mask)]
            if deferred is None:
                mail_val, mail_flag, recv = _deliver(
                    mail_val, mail_flag, *stream, self.T, self.Nd, is_min,
                    backend=cfg.backend)
            else:
                deferred, mail_flag, recv = _deliver(
                    torch.full_like(mail_val, app.identity), mail_flag,
                    *stream, self.T, self.Nd, is_min, backend=cfg.backend)
            dmax = torch.maximum(dmax, torch.max(recv))
        if cfg.telemetry and self._per_chip:
            stats.update(self._chip_vectors(stats, exch, recv))

        new_state = dict(values=new_vals, mail_val=mail_val,
                         mail_flag=mail_flag, cur_lo=cur_lo, cur_hi=cur_hi,
                         cur_val=cur_val)
        if p_tag is not None:
            new_state["p_tag"], new_state["p_val"] = p_tag, p_val
        if deferred is not None:
            new_state[DEFERRED] = deferred
        stats["pending"] = (torch.sum(mail_flag)
                            + torch.sum(cur_hi > cur_lo))
        # write-back P$ residency is deferred work: it does not keep the
        # engine busy, but must be flushed before the result is final
        if self._write_back:
            stats["p_resident"] = torch.sum(p_tag >= 0)
        else:
            stats["p_resident"] = torch.zeros((), dtype=torch.int32,
                                              device=self.device)
        stats["delivered_max_per_tile"] = dmax
        stats.update({k: v.to(torch.float32) for k, v in charges.items()})
        if cfg.sanitize:
            # the on-device sanitizer: violations counted, never branched
            # on, so the step computes what it computes without it
            bad = (torch.sum(~mail_flag & (mail_val != app.identity))
                   + torch.sum(cur_hi < cur_lo)
                   + torch.sum(torch.isnan(new_vals)))
            if is_min:                    # relaxation never raises a value
                bad = bad + raised
            stats["sanity_violations"] = torch.clamp(
                bad, max=SANITY_CAP).to(torch.float32)
        return new_state, stats

    def _chip_vectors(self, stats, exch, recv):
        """The per-chip ``pc_*`` load vectors of the reference's
        ``_aggregate``, reduced from the superstep's per-tile vectors
        (which they replace), the exchange's arrivals and the legs'
        per-chip counts."""
        C, Tl = self.n_chips, self.Tl
        rec, edg, dlv = (stats.pop(k).reshape(C, Tl) for k in
                         ("tv_records", "tv_edges", "tv_delivered"))
        out = dict(pc_edges=torch.sum(edg, dim=1),
                   pc_records=torch.sum(rec, dim=1),
                   pc_delivered=torch.sum(dlv, dim=1),
                   pc_delivmax=torch.amax(dlv, dim=1),
                   pc_compute=torch.amax(rec * PU_OPS_PER_RECORD
                                         + edg * PU_OPS_PER_EDGE, dim=1),
                   pc_owner=exch.owner,
                   pc_recv=(torch.zeros((C,), dtype=torch.float32,
                                        device=self.device) if recv is None
                            else torch.sum(recv.reshape(C, Tl), dim=1)))
        if self._multi:
            out["pc_offchip"] = exch.off
        return out

    # ------------------------------------------------------- owner delivery
    def _drain_to_owners(self, mail_val, mail_flag, dst, val, mask, src,
                         region_dims, is_min):
        """Charge the owner-bound leg and deliver the records into the
        mailboxes.  On a multi-chip window a record is delivered on the
        chip when its owner lies on its source tile's chip; the others
        are charged the board leg and handed to the superstep's
        ``_Exchange``.  Returns (mail_val, mail_flag, owner_leg_charge,
        off_chip_charge, on-chip delivered_per_tile); the off-chip charge
        is empty on one chip."""
        part, exch = self.part, self._exch
        owner = torch.clamp(dst // self.Cd, max=self.Tg - 1)
        owner_leg = netstats.charge(self.cfg.grid, src, owner, mask,
                                    region_dims=region_dims)
        on, idx, off, off_ch = mask, dst, None, {}
        if self._multi:
            # window position p = chip * Tl + local tile
            opos = self._pos(owner)
            ochip, schip = opos // self.Tl, self._pos(src) // self.Tl
            on_chip = ochip == schip
            on, off = mask & on_chip, mask & ~on_chip
            idx = opos * self.Cd + dst % self.Cd
            off_ch = netstats.charge_board(part, schip, ochip, off)
            exch.send(idx, val, off)
        if self._per_chip and self.cfg.telemetry:
            exch.count(schip if self._multi else part.chip_of_tile(src),
                       mask, off, self.n_chips)
        mail_val, mail_flag, per_tile = _deliver(
            mail_val, mail_flag, idx, val, on, self.T, self.Nd, is_min,
            backend=self.cfg.backend)
        return mail_val, mail_flag, owner_leg, off_ch, per_tile

    # --------------------------------------------------------- proxy stage
    def _proxy_stage(self, mail_val, mail_flag, p_tag, p_val, dst, cand,
                     emit_mask, src_tile, owner, flush, is_min):
        """The P$: batch-coalesce records per (proxy tile, slot, dst),
        filter them against the P$ and write the survivors into it.
        Write-through forwards every update; write-back forwards the
        evicted residents and the batch slot conflicts only, and spills
        the whole P$ on a ``flush`` superstep.  The forwarded records go
        to their owners directly or through the cascade."""
        cfg, grid = self.cfg, self.cfg.grid
        pcfg = cfg.proxy
        T, S = self.T, pcfg.slots
        ident = self.app.identity

        ptile = proxy_tile(grid, pcfg, owner, src_tile)
        leg1 = netstats.charge(grid, src_tile, ptile, emit_mask)
        # the sender's region lies on its chip, so the proxy tile does
        ptile_l = self._pos(ptile)

        slot = pcache_slot(pcfg, dst)
        key = torch.where(emit_mask, ptile_l * S + slot, T * S)  # sentinel
        dkey = torch.where(emit_mask, dst, self.Ngd)
        (skey, sdst, smask, (scand,),
         new_slot, new_dst, gid) = _lex_group(key, dkey, emit_mask, cand)
        gagg = self._segment_reduce(scand, smask, gid, is_min)
        combined = gagg[gid.to(torch.int64)]                 # per-record view
        n_leaders = torch.sum(new_dst)
        coalesced = torch.sum(smask) - n_leaders

        winner = new_slot                                    # first group/slot
        bypass = new_dst & ~new_slot                         # slot conflicts

        wtile = torch.clamp(skey // S, max=T - 1).to(torch.int64)
        wslot = (skey % S).to(torch.int64)
        cur_tag = p_tag[wtile, wslot]
        cur_pv = p_val[wtile, wslot]
        tag_hit = winner & (cur_tag == sdst)
        if is_min:
            improves = combined < cur_pv
        else:
            improves = torch.ones_like(tag_hit)
        filtered = tag_hit & ~improves                       # absorbed
        upd_hit = tag_hit & improves
        miss = winner & ~tag_hit
        # write-back: a miss on an occupied slot evicts its resident
        evict = miss & (cur_tag >= 0) & pcfg.write_back
        if is_min:
            new_pv_hit = torch.minimum(cur_pv, combined)
        else:
            new_pv_hit = cur_pv + combined
        inst_val = torch.where(upd_hit, new_pv_hit, combined)
        do_write = upd_hit | miss
        # P$ update: at most one writer (the winner) per (tile, slot) per
        # superstep.  Non-writers are sent to one spare row past the end,
        # which is cut off again, so no live entry sees two writes (the
        # order of duplicate writes is undefined) and selecting the
        # writers costs no host sync.
        wrow = torch.where(do_write, wtile, T)
        tag_ext = torch.cat([p_tag, p_tag.new_full((1, S), -1)])
        val_ext = torch.cat([p_val, p_val.new_full((1, S), ident)])
        p_tag = tag_ext.index_put((wrow, wslot), sdst)[:T]
        p_val = val_ext.index_put((wrow, wslot), inst_val)[:T]

        # forwarding set: write-back forwards only the batch slot
        # conflicts (and, below, the evicted residents)
        if pcfg.write_back:
            fwd_now = bypass
        else:
            fwd_now = upd_hit | miss | bypass
        fdst = torch.where(fwd_now, sdst, self.Ngd)
        fval = torch.where(fwd_now, combined, ident)
        edst = torch.where(evict, cur_tag, self.Ngd)
        eval_ = torch.where(evict, cur_pv, ident)
        proxy_src = self._tile_gids.index_select(
            0, torch.clamp(skey // S, max=T - 1))
        rdims = (pcfg.region_ny, pcfg.region_nx)
        # Under write-back the whole-P$ flush wave runs in its own leg
        # (_flush_drain), on flush supersteps only, except with a
        # non-selective cascade, where it climbs the reduction tree in
        # one walk with the direct legs (they may merge there).
        split_flush = pcfg.write_back and (
            self._cascade_levels == 0 or pcfg.cascade.selective)
        flushing = pcfg.write_back and flush
        all_dst, all_val = [fdst, edst], [fval, eval_]
        all_src = [proxy_src, proxy_src]
        if flushing and not split_flush:
            ft = p_tag.reshape(-1)
            all_dst.append(torch.where(ft >= 0, ft, self.Ngd))
            all_val.append(torch.where(ft >= 0, p_val.reshape(-1), ident))
            all_src.append(self._pcache_src)
        cat_dst = torch.cat(all_dst)
        cat_val = torch.cat(all_val)
        cat_src = torch.cat(all_src)
        cat_mask = cat_dst < self.Ngd

        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        lvl_max, ncomb = zero, zero
        if self._cascade_levels and not split_flush:
            # the cascaded drain: write-through apps cascade their whole
            # forward set; non-selective write-back cascades the direct
            # legs and the flush wave together
            (mail_val, mail_flag, leg2, owner_leg, per_tile, lvl_max,
             ncomb) = self._cascade_drain(
                mail_val, mail_flag, cat_dst, cat_val, cat_src, cat_mask,
                is_min)
        else:
            (mail_val, mail_flag, owner_leg, off_ch,
             per_tile) = self._drain_to_owners(
                mail_val, mail_flag, cat_dst, cat_val, cat_mask, cat_src,
                rdims, is_min)
            leg2 = netstats.merge_charges(owner_leg, off_ch)

        if flushing and split_flush:
            (mail_val, mail_flag, flush_leg, f_owner_leg, f_per_tile,
             f_lvl_max, f_ncomb) = self._flush_drain(
                p_tag, p_val, mail_val, mail_flag, rdims, is_min)
            leg2 = netstats.merge_charges(leg2, flush_leg)
            owner_leg = netstats.merge_charges(owner_leg, f_owner_leg)
            per_tile = per_tile + f_per_tile     # same-phase deliveries sum
            lvl_max = torch.maximum(lvl_max, f_lvl_max)
            ncomb = ncomb + f_ncomb
        if flushing:                             # the P$ is spilled
            p_tag = torch.full_like(p_tag, -1)
            p_val = torch.full_like(p_val, ident)

        dmax = torch.maximum(torch.max(per_tile), lvl_max)
        charges = dict(netstats.merge_charges(leg1, leg2),
                       owner_msgs=owner_leg["messages"],
                       owner_hop_msgs=owner_leg["hop_msgs"])
        pstats = dict(filtered_at_proxy=torch.sum(filtered).to(torch.float32),
                      coalesced_at_proxy=coalesced.to(torch.float32),
                      cascade_combined=ncomb)
        if cfg.telemetry:
            # owner deliveries per tile, every leg of the superstep summed
            pstats["tv_delivered"] = per_tile.to(torch.float32)
        return mail_val, mail_flag, p_tag, p_val, charges, pstats, dmax

    # --------------------------------------------------------- flush drain
    def _flush_drain(self, p_tag, p_val, mail_val, mail_flag, rdims,
                     is_min):
        """The write-back whole-P$ spill, run on flush supersteps only.

        The reference takes this leg under ``lax.cond`` and returns zero
        charges on the other supersteps; here the run loop already holds
        the flush decision on the host (from the stats fetched the
        superstep before, or from the chunk's fetch, after which the next
        chunk starts with the flush step), so the caller skips the leg
        with a Python ``if`` at no extra host sync.  Adding zero charges
        changes no sum, so the counters and trace are the reference's.  Returns
        (mail_val, mail_flag, merged_leg, owner_leg, per_tile,
        level_max, n_combined); the caller clears the P$."""
        ident = self.app.identity
        ft = p_tag.reshape(-1)
        fmask = ft >= 0
        fdst = torch.where(fmask, ft, self.Ngd)
        fval = torch.where(fmask, p_val.reshape(-1), ident)
        fsrc = self._pcache_src
        if self._cascade_levels:
            # selective write-back: the dense flush wave is exactly the
            # record set that profits from the reduction tree
            return self._cascade_drain(mail_val, mail_flag, fdst, fval,
                                       fsrc, fmask, is_min)
        (mail_val, mail_flag, owner_leg, off_ch,
         per_tile) = self._drain_to_owners(mail_val, mail_flag, fdst, fval,
                                           fmask, fsrc, rdims, is_min)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return (mail_val, mail_flag, netstats.merge_charges(owner_leg,
                                                            off_ch),
                owner_leg, per_tile, zero, zero)

    # ------------------------------------------------------- cascaded drain
    def _cascade_drain(self, mail_val, mail_flag, dst, val, src, mask,
                       is_min):
        """Drain proxy-stage output through the region reduction tree.

        Records climb from their region proxy to the same-index proxy of
        the enclosing super-region at each level, merging with records
        from sibling regions bound for the same destination; only tree
        roots (or selective early exits) forward to the true owner.  Each
        leg is charged exact XY hops; the receive count at intermediate
        proxies feeds the BSP time model's endpoint contention.  The
        owner delivery sees one early-exit copy per level and then the
        root exit, in the reference's order.  (The reference also takes
        an ``eligible`` mask whose records skip the tree; every caller
        passes all records, so that copy is always empty and is left
        out here.)

        Returns (mail_val, mail_flag, merged_charges, owner_leg_charge,
        delivered_per_tile, level_recv_max, n_combined)."""
        cfg, grid = self.cfg, self.cfg.grid
        pcfg = cfg.proxy
        casc = pcfg.cascade
        T = self.T
        rdims = (pcfg.region_ny, pcfg.region_nx)

        cur = torch.clamp(src, max=self.Tg - 1)
        alive = mask
        owner = torch.clamp(dst // self.Cd, max=self.Tg - 1)
        legs = []
        out_dst, out_val, out_src, out_mask = [], [], [], []
        ncomb = torch.zeros((), dtype=torch.float32, device=self.device)
        lvl_max = torch.zeros((), dtype=torch.float32, device=self.device)

        for level in range(1, self._cascade_levels + 1):
            rny, rnx = casc.level_dims(pcfg.region_ny, pcfg.region_nx, level)
            if casc.selective:
                # selective exit: once the owner lies inside the record's
                # level-`level` super-region, climbing further cannot
                # merge it with updates from other subtrees on a shorter
                # path -- it leaves the tree for the owner
                near = alive & (grid.region_id(cur, rny, rnx)
                                == grid.region_id(owner, rny, rnx))
                out_dst.append(dst)
                out_val.append(val)
                out_src.append(cur)
                out_mask.append(near)
                alive = alive & ~near
            ptile = cascade_proxy_tile(grid, rny, rnx, owner, cur)
            ptile_l = self._pos(ptile)
            legs.append(netstats.charge(grid, cur, ptile, alive,
                                        region_dims=rdims))
            # receive count per proxy tile (an index_add_, not bincount,
            # which syncs with the host on a CUDA tensor)
            recv = torch.zeros((T + 1,), dtype=torch.int32,
                               device=self.device).index_add_(
                0, torch.where(alive, ptile_l, T).to(torch.int64),
                alive.to(torch.int32))[:T]
            lvl_max = torch.maximum(lvl_max,
                                    torch.max(recv).to(torch.float32))
            cur, dst, val, owner, alive, merged = self._combine_level(
                ptile_l, dst, val, alive, is_min)
            ncomb = ncomb + merged

        out_dst.append(dst)
        out_val.append(val)
        out_src.append(cur)
        out_mask.append(alive)
        (mail_val, mail_flag, owner_leg, off_ch,
         per_tile) = self._drain_to_owners(
            mail_val, mail_flag, torch.cat(out_dst), torch.cat(out_val),
            torch.cat(out_mask), torch.cat(out_src), rdims, is_min)
        legs.append(owner_leg)
        legs.append(off_ch)
        return (mail_val, mail_flag, netstats.merge_charges(*legs),
                owner_leg, per_tile, lvl_max, ncomb)

    def _combine_level(self, ptile_l, dst, val, alive, is_min):
        """Merge records that meet at the same (proxy tile, dst) of one
        cascade level into a single combined record (the group leaders
        survive), with the P$ coalesce's grouping (``_lex_group``) and
        segment reduce.  Returns the level's outputs in sorted order --
        (cur global tile, dst, value, owner, alive) -- and the merge
        count."""
        T = self.T
        tkey = torch.where(alive, ptile_l, T)
        dkey = torch.where(alive, dst, self.Ngd)
        (stile, sdst, salive, (sval,),
         _, leader, gid) = _lex_group(tkey, dkey, alive, val)
        agg = self._segment_reduce(sval, salive, gid, is_min)
        nval = agg[gid.to(torch.int64)]
        merged = (torch.sum(salive) - torch.sum(leader)).to(torch.float32)
        cur = self._tile_gids.index_select(0, torch.clamp(stile, max=T - 1))
        owner = torch.clamp(sdst // self.Cd, max=self.Tg - 1)
        return cur, sdst, nval, owner, leader, merged

    def _segment_reduce(self, sval, smask, gid, is_min):
        """Combine same-group record values (``gid`` sorted ascending,
        from ``_lex_group``) into one value per group: the
        ``segment_combine`` kernel (masked records become padding) or the
        inline plain-torch path."""
        R = gid.shape[0]
        if self.cfg.backend == "kernels":
            return kops.segment_combine(torch.where(smask, gid, -1), sval, R,
                                        combine="min" if is_min else "add")
        idx = gid.to(torch.int64)
        if is_min:
            out = torch.full((R,), INF, dtype=torch.float32,
                             device=sval.device)
            return out.scatter_reduce_(0, idx, torch.where(smask, sval, INF),
                                       "amin", include_self=True)
        out = torch.zeros((R,), dtype=torch.float32, device=sval.device)
        return out.index_add_(0, idx, torch.where(smask, sval, 0.0))

    # ----------------------------------------------------------------- run
    def chunk_runner(self, state, length: int) -> ChunkRunner:
        """The device side of chunks of ``length`` supersteps over a copy
        of ``state`` (``core/chunk.py``); double-buffered on more than one
        chip, with the ``DEFERRED`` buffer beside it (the identity: nothing
        in flight)."""
        return ChunkRunner(self._superstep, self._with_deferred(state),
                           length, self._write_back, self.stat_keys,
                           count_active=(self._count_active
                                         if self._compacting else None),
                           vec_keys=self.vec_keys, width=self._vec_width)

    def _with_deferred(self, state):
        """``state`` with an identity ``DEFERRED`` buffer where the
        chunked loop defers the exchange and ``state`` has none."""
        if self._defers and DEFERRED not in state:
            state = dict(state, **{DEFERRED: torch.full(
                (self.Nd,), self.app.identity, dtype=torch.float32,
                device=self.device)})
        return state

    def checkpoint_image(self, state):
        """The engine state a checkpoint holds: the chunk runner's with
        the ``DEFERRED`` values folded into ``mail_val`` and the buffer
        dropped (the reference folds its deferred bank at each chunk's
        end).  Nothing writes the mailbox between this fold and the one
        the next superstep would make, so a run resumed from the image
        with an identity buffer is bitwise the one that went on."""
        deferred = state.get(DEFERRED)
        if deferred is None:
            return state
        image = {k: v for k, v in state.items() if k != DEFERRED}
        image["mail_val"] = _fold(state["mail_val"], deferred,
                                  self.app.combine == "min")
        return image

    def run(self, state, max_supersteps: Optional[int] = None,
            progress_every: int = 0, chunk: Optional[int] = None,
            observer=None):
        """Run supersteps until drained; returns (state, RunResult).

        ``chunk`` overrides ``EngineConfig.run_chunk``: supersteps per
        host fetch.  ``chunk=0`` selects the per-step loop (the
        reference's ``_run_legacy``: one superstep, then ONE transfer of
        its packed stats); any K >= 1 runs the chunked loop, K supersteps
        per fetch, with identical results (the reference's contract,
        ``tests/test_chunked.py``).  Every fetch increments the
        ``engine.host_syncs`` counter.  ``progress_every`` reports at
        chunk granularity on the chunked loop: the first chunk boundary
        at or past each multiple prints the true executed superstep
        count.

        ``observer`` (``obs.timeline.Observer``) receives
        ``on_run_start`` with the run's ``RunMeta``, one ``on_chunk``
        span per chunk (per superstep on the per-step loop) at the
        accounting boundary the loop has anyway, and ``on_run_end`` with
        the ``RunResult``.  It reads only what the loop fetched: it adds
        no host sync and changes nothing the run computes.  With
        ``EngineConfig.sanitize`` a nonzero on-device violation count
        raises ``SanitizerError`` at the chunk (or superstep) that
        fetched it, and the finished run is checked by
        ``invariants.check_run``."""
        self._require_mono("run")
        return self._run(state, max_supersteps, progress_every, chunk,
                         observer)

    @property
    def _label(self) -> str:
        """The run's name in progress lines and sanitizer findings."""
        name = self.app.name
        return f"{name}/{self.n_chips}chips" if self._per_chip else name

    def _run(self, state, max_supersteps, progress_every, chunk, observer,
             *, fault_tolerance=None, vec_sums=None):
        """``run``'s loop, on a state in window order: also the
        distributed runtime's (``distrib.DistributedEngine.run``).

        The BSP time of a superstep is the reference driver's: the
        monolithic levels maxed with the board leg (its hop-messages
        over the partition's board links), plus the IO dies' Tx + Rx
        latency when a record left its chip.  Double-buffered, a
        superstep pays the larger of its monolithic levels and the
        previous superstep's exchange (board leg + IO dies), and the
        last exchange drains after the loop.  On one chip the board leg
        is 0 and no record leaves, so either rule is the monolithic one
        to the bit.

        The distributed runtime's extensions (the reference's ``run``):
        ``vec_sums`` (a dict) sums every telemetry vector of the run
        from the fetches the loops make anyway; ``fault_tolerance(
        counters, trace, prev_exch, overhead)`` builds
        ``DistributedEngine``'s controller over this run's accounting
        (``prev_exch`` and ``overhead`` one-element lists it may
        write).  With it the loop writes the step-0 checkpoint, calls its
        ``at_boundary`` at every accounting boundary, turns a
        ``ChipLostError`` into its ``recover`` (a rollback) and a replay
        from the restored state, and adds the priced recovery overhead once, after the last
        exchange drains."""
        cfg, part = self.cfg, self.part
        maxs = max_supersteps or cfg.max_supersteps
        K = cfg.run_chunk if chunk is None else int(chunk)
        counters = TrafficCounters()
        pkg = cfg.pkg
        cy, cx = part.chips_y, part.chips_x
        n_board_links = board_link_provisioning(pkg, cy, cx)
        trace = SuperstepTrace(board_links=n_board_links, chips_y=cy,
                               chips_x=cx, double_buffer=cfg.double_buffer)
        cycles = 0.0
        db = cfg.double_buffer
        # the exchange in flight under the next superstep (double buffer)
        prev_exch = [0.0]
        # recovery overhead, kept apart from `cycles` so that a replay
        # adds the unfailed run's floats in its order; added at the end
        overhead = [0.0]
        links = link_provisioning(cfg.grid, pkg)
        fill = links["diameter"] * 0.5
        board_div = n_board_links * _off_pkg_bits_per_cycle(pkg)
        io_lat = 2.0 * IO_DIE_RXTX_LAT_NS * CLOCK_GHZ     # Tx + Rx IO die
        values_before = state["values"].clone() if cfg.sanitize else None
        if observer is not None:
            observer.on_run_start(RunMeta(
                app=self.app.name, grid_ny=cfg.grid.ny, grid_nx=cfg.grid.nx,
                n_chips=self.n_chips, chips_y=cy, chips_x=cx, chunk=K,
                backend=cfg.backend, sanitize=cfg.sanitize,
                telemetry=cfg.telemetry, pkg=pkg, grid=cfg.grid))

        def account(stats):
            """The per-step loop's accounting.  The chunked loop uses its
            vectorized twin, ``account_chunk``: edit both in lockstep."""
            nonlocal cycles
            _sanitize_gate(cfg, self._label,
                           stats.get("sanity_violations", 0.0))
            counters.add(superstep_counters(stats))
            trace.append_step(stats, element_bits=cfg.element_bits)
            # ---- BSP time model: monolithic levels + the board leg -----
            t_board = stats.get("off_chip_hop_msgs", 0.0) * MSG_BITS / board_div
            core = superstep_cycles(stats, pkg, links)
            off = stats.get("off_chip_msgs", 0.0)
            if db:
                # this superstep's exchange hides under the next one
                if core > 0 or t_board > 0 or stats["pending"] > 0:
                    cycles += max(core, prev_exch[0]) + fill
                    prev_exch[0] = t_board + (io_lat if off > 0 else 0.0)
                return
            sc = max(core, t_board)
            if sc > 0 or stats["pending"] > 0:
                cycles += sc + fill                     # pipeline fill
                if off > 0:
                    cycles += io_lat

        def account_chunk(stacked, n_act):
            nonlocal cycles
            bad = stacked.get("sanity_violations")
            if bad is not None:
                _sanitize_gate(cfg, self._label, float(np.sum(bad[:n_act])))
            counters.add(chunk_counters(stacked, n_act))
            trace.append_chunk(stacked, n_act, element_bits=cfg.element_bits)
            # the BSP terms vectorized, accumulated in execution order:
            # bit-identical to account() per step
            zeros = np.zeros(n_act)
            hop = stacked.get("off_chip_hop_msgs")
            t_board = (zeros if hop is None else
                       np.asarray(hop[:n_act], np.float64) * MSG_BITS
                       / board_div)
            off = stacked.get("off_chip_msgs")
            off = zeros if off is None else off[:n_act]
            core = chunk_cycles(stacked, n_act, pkg, links)
            pending = stacked["pending"][:n_act].tolist()
            if db:
                for c, b, pend, o in zip(core.tolist(), t_board.tolist(),
                                         pending, off.tolist()):
                    if c > 0 or b > 0 or pend > 0:
                        cycles += max(c, prev_exch[0]) + fill
                        prev_exch[0] = b + (io_lat if o > 0 else 0.0)
                return
            sc = np.maximum(core, t_board)
            for s, pend, o in zip(sc.tolist(),
                                  pending, off.tolist()):
                if s > 0 or pend > 0:
                    cycles += s + fill
                    if o > 0:
                        cycles += io_lat

        ft = boundary = None
        if fault_tolerance is not None:
            ft = fault_tolerance(counters, trace, prev_exch, overhead)

            def boundary(bsteps, bstate, bflush, bdone):
                ft.at_boundary(bsteps, bstate, bflush, bdone, cycles)
            ft.checkpoint(0, state, False, cycles)       # step-0 baseline
        runner = self.chunk_runner(state, K) if K > 0 else None
        steps0, flush0 = 0, False
        while True:
            try:
                if runner is None:
                    state, steps = self._run_legacy(
                        state, maxs, progress_every, account, observer,
                        steps0=steps0, flush0=flush0, boundary=boundary,
                        vec_sums=vec_sums)
                else:
                    state, steps = self._run_chunked(
                        runner, maxs, progress_every, account_chunk,
                        observer, steps0=steps0, flush0=flush0,
                        boundary=boundary, vec_sums=vec_sums)
                break
            except ChipLostError as err:
                if ft is None:
                    raise
                state, flush0, steps0, cycles = ft.recover(err)
                if runner is not None:
                    # into the captured graphs' tensors: none is captured
                    # again; the restored copy is not kept beside them
                    runner.load(self._with_deferred(state), flush0)
                    state = None
        cycles += prev_exch[0]   # the last exchange drains in the open
        cycles += overhead[0]    # recovery legs, priced once at the end
        counters.supersteps = steps
        time_s = cycles / (CLOCK_GHZ * 1e9)
        result = RunResult(counters=counters, cycles=cycles, time_s=time_s,
                           supersteps=steps, trace=trace)
        if cfg.sanitize:
            findings = invariants.check_run(
                result, pkg=pkg, grid=cfg.grid,
                where=f"sanitize/{self._label}",
                write_back=self._write_back, seeds=self._n_seeds,
                combine=self.app.combine,
                values_before=values_before.cpu().numpy(),
                values_after=state["values"].cpu().numpy(),
                drained=steps < maxs)
            invariants.assert_clean(findings, context=f"run({self._label})")
        if observer is not None:
            observer.on_run_end(result)
        return state, result

    def _run_legacy(self, state, maxs, progress_every, account,
                    observer=None, *, steps0=0, flush0=False,
                    boundary=None, vec_sums=None):
        """The per-step loop: one superstep and one host sync each.  The
        flush decision for the next superstep is read from this one's
        fetched stats, and with compaction so is the next superstep's
        window (the active tiles of the state it will step, counted on
        the device), so neither costs a sync of its own.  The first
        superstep runs dense.  With an ``observer``, each superstep is
        one single-step span.

        ``steps0`` / ``flush0`` resume from a checkpoint (the first
        superstep then runs dense: the count that picked the window
        belongs to the discarded future); ``boundary(steps, state,
        flush, done)`` runs after each superstep's accounting, where the
        next superstep's flush flag is known and before the loop leaves
        or goes on, so a checkpoint taken there resumes in the right
        write-back phase; ``vec_sums`` sums the telemetry vectors."""
        sync_ctr = default_registry().counter("engine.host_syncs")
        keys = self.stat_keys
        if self._compacting:
            keys = keys + ("next_active_tiles",)
        steps = int(steps0)
        flush, window = bool(flush0), None
        while steps < maxs:
            t0 = time.perf_counter()
            state, stats = self._superstep(state, flush, window)
            if self._compacting:
                stats["next_active_tiles"] = self._count_active(state)
            t1 = time.perf_counter()
            stats = fetch_stats(stats, keys, self.vec_keys)
            sync_ctr.inc()
            t2 = time.perf_counter()
            steps += 1
            account(stats)
            if vec_sums is not None:
                for k in self.vec_keys:
                    vec_sums[k] = vec_sums.get(k, 0.0) + stats[k]
            if observer is not None:
                observer.on_chunk(_legacy_span(
                    steps, {k: stats[k] for k in self.stat_keys},
                    {k: stats[k] for k in self.vec_keys}, (t0, t1),
                    (t1, t2), (t2, time.perf_counter())))
            if self._compacting:
                self._count_window(window, 1, False)
                window = self._window(stats["next_active_tiles"])
            # live work drained: spill any write-back P$ residue (the
            # paper's TSU heuristic: flush when queues go idle).
            # Repeated flushes terminate: a spilled value that does not
            # improve its owner generates no new work.
            drained = stats["pending"] == 0
            flush = drained and self._write_back and stats["p_resident"] > 0
            done = drained and not flush
            if boundary is not None:
                boundary(steps, state, flush, done)
            if done:
                break
            if flush:
                continue
            if progress_every and steps % progress_every == 0:
                print(f"  [{self._label}] step {steps} "
                      f"pending={stats['pending']:.0f}")
        return state, steps

    def _run_chunked(self, runner, maxs, progress_every, account_chunk,
                     observer=None, *, steps0=0, flush0=False,
                     boundary=None, vec_sums=None):
        """The chunked loop (the reference's ``_drain_chunked``) on
        ``runner`` (``chunk_runner``'s): per
        chunk, K predicated supersteps enqueued on the device
        (``ChunkRunner.launch``), ONE host fetch of ``done``, the flush
        and overflow flags, the active-tile count and the stats rows,
        then vectorized accounting of the active rows.  The flush and
        termination rules run on the device; a flush it schedules idles
        the rest of the chunk, and the next chunk starts with the flush
        step.  With compaction each chunk runs in the window that holds
        ``CHUNK_HEADROOM`` times the active tiles the previous fetch
        counted (the first chunk dense); a superstep that outgrows it
        idles the rest of the chunk (``engine.window_overflows``), and
        the next chunk starts in a window that fits.  Double-buffered,
        the exchanged values in flight after the last superstep are
        folded into the state returned.  An ``observer``
        gets one span per chunk: ``launch`` is its dispatch, ``fetch``
        its fetch.

        ``steps0`` / ``flush0`` resume from a checkpoint the caller has
        loaded into ``runner`` (the first chunk then runs dense);
        ``boundary(steps, state, flush, done)`` runs at each chunk's
        boundary after its accounting, on the runner's state;
        ``vec_sums`` sums the telemetry vectors of the active rows."""
        sync_ctr = default_registry().counter("engine.host_syncs")
        progress = _ProgressReporter(self._label, progress_every,
                                     sanitize=self.cfg.sanitize,
                                     tiles=self.T)
        keys = self.stat_keys + ("active",)
        steps, flush, window, index = int(steps0), bool(flush0), None, 0
        while steps < maxs:
            t0 = time.perf_counter()
            runner.launch(maxs - steps, flush, window)
            t1 = time.perf_counter()
            got = runner.fetch()                     # the chunk's one sync
            sync_ctr.inc()
            t2 = time.perf_counter()
            flush = got.flush
            stacked = {k: got.rows[:, i] for i, k in enumerate(keys)}
            n_act = int(np.sum(stacked["active"]))
            if n_act:
                account_chunk(stacked, n_act)
                if vec_sums is not None:
                    for k, v in got.vecs.items():
                        vec_sums[k] = vec_sums.get(k, 0.0) + np.sum(
                            np.asarray(v[:n_act], np.float64), axis=0)
            if observer is not None:
                observer.on_chunk(ChunkSpan(
                    index=index, step_lo=steps, step_hi=steps + n_act,
                    t_dispatch=(t0, t1), t_fetch=(t1, t2),
                    t_account=(t2, time.perf_counter()),
                    stats={k: v[:n_act] for k, v in stacked.items()},
                    vecs={k: v[:n_act] for k, v in got.vecs.items()}))
            index += 1
            steps += n_act
            progress.report(steps, stacked, n_act)
            if self._compacting:
                self._count_window(window, n_act, got.overflow)
                window = self._window(
                    min(got.active_tiles * CHUNK_HEADROOM, self.Tl))
            if boundary is not None:
                boundary(steps, runner.state, flush, got.done)
            if got.done or n_act == 0:
                break
        return self.checkpoint_image(dict(runner.state)), steps

    def _count_window(self, window, steps: int, overflow: bool) -> None:
        """Supersteps run in each window (``engine.window_occupancy.<W>``,
        W the lanes a chip: the per-chip rung, ``Tl`` for the dense
        window) and the chunks a window overflowed
        (``engine.window_overflows``)."""
        reg = default_registry()
        reg.counter(f"engine.window_occupancy.{window or self.Tl}").inc(steps)
        if overflow:
            reg.counter("engine.window_overflows").inc()


class _Exchange:
    """One superstep's board traffic on a multi-chip window: the off-chip
    records of every owner-bound leg (window mailbox index, value, mask),
    which ``_step`` folds into the mailbox at the end of the superstep
    (double-buffered: into the ``DEFERRED`` buffer the next superstep
    folds), and, for the per-chip telemetry, every leg's owner-bound and
    off-chip records counted by source chip."""

    def __init__(self):
        self.idx, self.val, self.mask = [], [], []
        self.owner = self.off = 0.0

    def send(self, idx, val, off) -> None:
        self.idx.append(idx)
        self.val.append(val)
        self.mask.append(off)

    def count(self, chip, mask, off, n_chips: int) -> None:
        def by_chip(m):
            return torch.zeros((n_chips,), dtype=torch.float32,
                               device=m.device).index_add_(
                0, chip.to(torch.int64), m.to(torch.float32))
        self.owner = self.owner + by_chip(mask)
        if off is not None:
            self.off = self.off + by_chip(off)


def fetch_stats(stats, keys=STAT_KEYS, vec_keys=()) -> dict:
    """The superstep's scalar stats ``keys`` as Python floats, and its
    vector stats ``vec_keys`` as f64 numpy arrays, in ONE transfer: every
    stat is packed into one f64 tensor (exact for the f32 charges, the
    f32 load vectors and the integer counts alike) and copied to the host
    at once."""
    packed = torch.cat([torch.stack([stats[k].to(torch.float64)
                                     for k in keys])]
                       + [stats[k].to(torch.float64) for k in vec_keys])
    host = packed.cpu().numpy()
    out = dict(zip(keys, host[:len(keys)].tolist()))
    width = (host.shape[0] - len(keys)) // max(len(vec_keys), 1)
    for i, k in enumerate(vec_keys):
        lo = len(keys) + i * width
        out[k] = host[lo:lo + width]
    return out


def _legacy_span(steps, stats, vecs, t_dispatch, t_fetch, t_account):
    """One per-step-loop superstep as a single-step ChunkSpan: scalar
    stats become ``(1,)`` arrays and telemetry vectors ``(1, T)`` rows,
    the shapes the chunked loop emits, so observers need not care which
    loop ran."""
    scal = {k: np.asarray([v], np.float64) for k, v in stats.items()}
    scal["active"] = np.ones((1,), np.float64)
    return ChunkSpan(index=steps - 1, step_lo=steps - 1, step_hi=steps,
                     t_dispatch=t_dispatch, t_fetch=t_fetch,
                     t_account=t_account, stats=scal,
                     vecs={k: np.asarray(v)[None] for k, v in vecs.items()})


def _sanitize_gate(cfg, app_name: str, violations: float) -> None:
    """Raise on a nonzero on-device ``sanity_violations`` count (the
    ``EngineConfig.sanitize`` checks of ``_step``), in both loops'
    accounting."""
    if cfg.sanitize and violations > 0:
        raise invariants.SanitizerError(
            f"sanitizer: {violations:.0f} on-device invariant violation(s) "
            f"during {app_name} (monotone relaxation / mailbox consistency "
            f"/ NaN checks in the superstep body)")


@dataclasses.dataclass
class RunResult:
    counters: TrafficCounters
    cycles: float
    time_s: float
    supersteps: int
    # per-superstep level-traffic record: what makes the run re-priceable
    trace: Optional[SuperstepTrace] = None


def superstep_counters(stats) -> TrafficCounters:
    """One superstep's measured traffic as a TrafficCounters delta."""
    return TrafficCounters(
        messages=stats["messages"], hop_msgs=stats["hop_msgs"],
        owner_msgs=stats["owner_msgs"],
        owner_hop_msgs=stats["owner_hop_msgs"],
        intra_die_hops=stats["intra_die_hops"],
        inter_die_crossings=stats["inter_die_crossings"],
        inter_pkg_crossings=stats["inter_pkg_crossings"],
        filtered_at_proxy=stats["filtered_at_proxy"],
        coalesced_at_proxy=stats["coalesced_at_proxy"],
        cascade_combined=stats.get("cascade_combined", 0.0),
        cross_region_msgs=stats.get("cross_region_msgs", 0.0),
        off_chip_msgs=stats.get("off_chip_msgs", 0.0),
        off_chip_hop_msgs=stats.get("off_chip_hop_msgs", 0.0),
        edges_processed=stats["edges_processed"],
        records_consumed=stats["records_consumed"], supersteps=1)


def superstep_cycles(stats, pkg, links: dict) -> float:
    """BSP cycles of one superstep: max over (tile compute, per-level
    network serialization, endpoint contention)."""
    bits = MSG_BITS
    return float(step_cycles(
        pkg, links,
        compute_ops=float(stats["compute_per_tile_max"]),
        intra_bits=float(stats["intra_die_hops"]) * bits,
        die_bits=float(stats["inter_die_crossings"]) * bits,
        pkg_bits=float(stats["inter_pkg_crossings"]) * bits,
        endpoint_bits=float(stats["delivered_max_per_tile"]) * bits))


def chunk_counters(stacked, n_active: int) -> TrafficCounters:
    """One chunk's accumulated traffic as a TrafficCounters delta: the
    chunked loop's rendering of :func:`superstep_counters`, one numpy sum
    per field per chunk.  Bit-identical to per-step accumulation because
    every counter is an integer-valued count: float64 sums of integers
    below 2**53 are exact under any association."""
    n = int(n_active)

    def tot(key):
        a = stacked.get(key)
        if a is None:
            return 0.0
        return float(np.sum(np.asarray(a[:n], dtype=np.float64)))

    return TrafficCounters(
        messages=tot("messages"), hop_msgs=tot("hop_msgs"),
        owner_msgs=tot("owner_msgs"),
        owner_hop_msgs=tot("owner_hop_msgs"),
        intra_die_hops=tot("intra_die_hops"),
        inter_die_crossings=tot("inter_die_crossings"),
        inter_pkg_crossings=tot("inter_pkg_crossings"),
        filtered_at_proxy=tot("filtered_at_proxy"),
        coalesced_at_proxy=tot("coalesced_at_proxy"),
        cascade_combined=tot("cascade_combined"),
        cross_region_msgs=tot("cross_region_msgs"),
        off_chip_msgs=tot("off_chip_msgs"),
        off_chip_hop_msgs=tot("off_chip_hop_msgs"),
        edges_processed=tot("edges_processed"),
        records_consumed=tot("records_consumed"), supersteps=n)


def chunk_cycles(stacked, n_active: int, pkg, links: dict) -> np.ndarray:
    """Vectorized :func:`superstep_cycles` over a chunk's stacked stats:
    one ``costmodel.step_cycles`` call on ``(n_active,)`` float64 vectors
    (elementwise identical to the per-step scalar calls)."""
    n = int(n_active)
    bits = MSG_BITS

    def vec(key):
        return np.asarray(stacked[key][:n], dtype=np.float64)

    return np.atleast_1d(step_cycles(
        pkg, links,
        compute_ops=vec("compute_per_tile_max"),
        intra_bits=vec("intra_die_hops") * bits,
        die_bits=vec("inter_die_crossings") * bits,
        pkg_bits=vec("inter_pkg_crossings") * bits,
        endpoint_bits=vec("delivered_max_per_tile") * bits))


class _ProgressReporter:
    """Chunk-granularity progress for the chunked run loop: reports the
    true executed superstep count at the first chunk boundary at or past
    each ``every`` multiple (the per-step loop's ``steps % every == 0``
    would skip multiples that fall inside a chunk).

    Progress flows through the metrics registry -- gauges
    ``progress.<app>.steps`` and ``.pending`` set every chunk, counter
    ``progress.<app>.reports`` per printed line -- so harnesses read it
    without scraping stdout.  Compacted runs also feed the
    ``engine.active_fraction`` gauge (the latest chunk's mean active-tile
    fraction of ``tiles``) and the ``engine.bucket_occupancy.<cap>``
    counters (supersteps whose active tiles fit rung ``cap`` of the
    ladder) from the ``active_tiles`` / ``bucket_cap`` stats, which ride
    the same fetch.  With the sanitizer on, the line also carries the
    run's cumulative ``sanity_violations`` count."""

    def __init__(self, name: str, every: int, sanitize: bool = False,
                 tiles: int = 0):
        self.name = name
        self.every = every
        self.sanitize = sanitize
        self.tiles = tiles
        self._next = every
        self._violations = 0.0
        reg = default_registry()
        self._g_steps = reg.gauge(f"progress.{name}.steps")
        self._g_pending = reg.gauge(f"progress.{name}.pending")
        self._c_reports = reg.counter(f"progress.{name}.reports")
        self._g_active = reg.gauge("engine.active_fraction")

    def report(self, steps: int, stacked, n_act: int) -> None:
        if n_act == 0:
            return
        pending = float(stacked["pending"][n_act - 1])
        self._g_steps.set(steps)
        self._g_pending.set(pending)
        act = stacked.get("active_tiles")
        if act is not None and self.tiles:
            self._g_active.set(float(np.mean(act[:n_act])) / self.tiles)
            caps, cnts = np.unique(np.asarray(stacked["bucket_cap"][:n_act]),
                                   return_counts=True)
            for cap, cnt in zip(caps.tolist(), cnts.tolist()):
                default_registry().counter(
                    f"engine.bucket_occupancy.{int(cap)}").inc(float(cnt))
        if self.sanitize and "sanity_violations" in stacked:
            self._violations += float(
                np.sum(stacked["sanity_violations"][:n_act]))
        if not self.every or steps < self._next:
            return
        self._c_reports.inc()
        line = (f"  [{self.name}] step {steps} (chunk of {n_act}) "
                f"pending={pending:.0f}")
        if self.sanitize:
            line += f" sanity_violations={self._violations:.0f}"
        print(line)
        while self._next <= steps:
            self._next += self.every


def capacity_ladder(T: int, levels: int) -> tuple:
    """Window-capacity ladder for active-set compaction: ``(T, T/4,
    T/16, ...)``, the dense window plus ``levels`` power-of-two rungs
    (each a quarter of the previous, floored at 1 tile; rungs that no
    longer shrink are dropped).  Descending, so ``bucket_index`` can
    pick the smallest capacity that fits the active count."""
    caps = [int(T)]
    for k in range(1, max(int(levels), 0) + 1):
        c = max(int(T) >> (2 * k), 1)
        if c < caps[-1]:
            caps.append(c)
    return tuple(caps)


def bucket_index(n_act, caps: tuple) -> torch.Tensor:
    """Index of the smallest ladder capacity that holds ``n_act`` active
    tiles (0 = the dense window), as a 0-d int32 tensor on ``n_act``'s
    device: no host sync."""
    n_act = torch.as_tensor(n_act)
    idx = torch.zeros((), dtype=torch.int32, device=n_act.device)
    for j, c in enumerate(caps[1:], start=1):
        idx = torch.where(n_act <= c, j, idx)
    return idx


def _slots(active, W: int):
    """(..., W) int32 slot numbers 1..W beside ``active``'s leading dims
    (``searchsorted`` wants one row of values per sorted row)."""
    return torch.arange(1, W + 1, dtype=torch.int32,
                        device=active.device).expand(
        *active.shape[:-1], W).contiguous()


def _compact_window(active, W: int, T: int):
    """Stable compaction of the (T,) active mask (or each row of a
    (C, T) one) into a W-slot window.

    Returns (w_valid, w_rows): per-slot validity and the tile row each
    slot gathers (invalid slots clamp to T-1).  The j-th active tile is
    the first row where the inclusive cumsum reaches j+1: a
    searchsorted, no sort and no ``nonzero``, so nothing sizes an output
    on the host, and the slots keep the tiles' order, which keeps the
    compacted record stream in the dense one's order.  With more than W
    active tiles, the first W."""
    csum = torch.cumsum(active, -1, dtype=torch.int32)
    tile_map = torch.searchsorted(csum, _slots(active, W))
    w_valid = tile_map < T
    return w_valid, torch.clamp(tile_map, max=T - 1)


def _window_lanes(active, W: int, T: int):
    """The W distinct tile rows a window runs on: ``_compact_window``'s
    valid slots (the active tiles, in order), then, in the slots left,
    the inactive tiles in order -- the k-th free slot takes the first
    row where the inactive mask's cumsum reaches k.  W <= T leaves
    enough of them whenever the active tiles fit.  For a (C, T) mask,
    one chip a row, the (C*W,) window positions ``chip * T + row``:
    W lanes a chip, chip-major."""
    w_valid, w_rows = _compact_window(active, W, T)
    k = _slots(active, W) - torch.sum(active, -1, keepdim=True,
                                      dtype=torch.int32)
    idle = torch.searchsorted(torch.cumsum(~active, -1, dtype=torch.int32),
                              k)
    lanes = torch.where(w_valid, w_rows, idle)
    if active.dim() == 1:
        return lanes
    chip = torch.arange(active.shape[0], device=active.device)[:, None]
    return (lanes + chip * T).reshape(-1)


def _lex_group(key, sub, mask, *vals):
    """Lexicographic (key, sub) record grouping.

    Two stable sorts -- by ``sub``, then by ``key`` -- give the same
    permutation as the reference's one stable two-key ``lax.sort``: ties
    in (key, sub) keep arrival order, so downstream f32 segment sums
    accumulate in the same order.  ``mask`` and ``vals`` ride along.
    Masked records must hold sentinel keys that order after all live
    ones.

    Returns (skey, ssub, smask, svals, new_key, new_pair, gid):
      new_key:  sorted-order mask of the first live record of each key;
      new_pair: first live record of each (key, sub) group -- the group
                leaders; gid numbers the groups (masked rows -> last id).
    """
    R = key.shape[0]
    by_sub = torch.sort(sub, stable=True).indices
    perm = by_sub[torch.sort(key[by_sub], stable=True).indices]
    skey, ssub, smask = key[perm], sub[perm], mask[perm]
    svals = tuple(v[perm] for v in vals)
    first = torch.arange(R, device=key.device) == 0
    new_key = smask & (first | (skey != torch.roll(skey, 1)))
    new_pair = smask & (new_key | (ssub != torch.roll(ssub, 1)))
    gid = torch.cumsum(new_pair.to(torch.int32), 0, dtype=torch.int32) - 1
    gid = torch.where(smask, gid, R - 1)
    return skey, ssub, smask, svals, new_key, new_pair, gid


def _deliver(mail_val, mail_flag, dst, val, mask, T, Nd, is_min,
             backend: str = "kernels"):
    """Combine records into owner mailboxes; returns (mail_val,
    mail_flag, per-tile delivered-record counts as f32).

    The arriving values are combined per mailbox index and the arrivals
    counted per index; the counts give both the flag update (count > 0)
    and the per-tile endpoint contention (mailbox indices of one tile are
    contiguous, so a reshape-sum).  min is order-free; add applies
    ``mail + sum(arrivals)``, equal to the reference up to f32
    re-association."""
    if backend == "kernels":
        seg = torch.where(mask, dst, -1)                  # < 0 = padding
        mv, cnt = kops.deliver_fused(seg, val, mail_val,
                                     combine="min" if is_min else "add")
        mf = mail_flag | (cnt > 0)
        per_tile = torch.sum(cnt.reshape(T, Nd // T), dim=1)
        return mv, mf, per_tile
    # masked records go to one spare index past the end, cut off again
    safe_dst = torch.where(mask, dst, Nd).to(torch.int64)
    cnt = torch.zeros((Nd + 1,), dtype=torch.int32, device=val.device)
    cnt = cnt.index_add_(0, safe_dst, mask.to(torch.int32))[:Nd]
    if is_min:
        inc = torch.full((Nd + 1,), INF, dtype=torch.float32,
                         device=val.device)
        inc.scatter_reduce_(0, safe_dst, torch.where(mask, val, INF), "amin",
                            include_self=True)
        mv = torch.minimum(mail_val, inc[:Nd])
    else:
        inc = torch.zeros((Nd + 1,), dtype=torch.float32, device=val.device)
        inc.index_add_(0, safe_dst, torch.where(mask, val, 0.0))
        mv = mail_val + inc[:Nd]
    mf = mail_flag | (cnt > 0)
    per_tile = torch.sum(cnt.reshape(T, Nd // T), dim=1)
    return mv, mf, per_tile.to(torch.float32)


def _fold(mail_val, deferred, is_min: bool):
    """The mailbox with the double-buffered exchange's ``deferred``
    values folded in: ``_deliver``'s last op, min or add."""
    return (torch.minimum(mail_val, deferred) if is_min
            else mail_val + deferred)


def _pad(a, n: int, fill):
    """``a`` (numpy array or tensor) padded with ``fill`` to length n."""
    if isinstance(a, torch.Tensor):
        if a.shape[0] == n:
            return a
        out = torch.full((n,), fill, dtype=a.dtype, device=a.device)
        out[: a.shape[0]] = a
        return out
    a = np.asarray(a)
    if a.shape[0] == n:
        return a
    out = np.full((n,), fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _to(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=dtype)
