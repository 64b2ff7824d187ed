"""Network traffic accounting for the data-local engine.

The PyTorch rendering of ``repro.core.netstats``.  ``TrafficCounters``,
``SuperstepTrace`` and ``MSG_BITS`` are verbatim copies (host-side,
numpy).  ``charge``, ``charge_off_chip`` and ``merge_charges`` are redone
in torch and take the same f32 sums the reference takes: each traffic
class is an f32 sum over the batch.  Every summand is a small integer, so
the sums are exact -- and equal to the reference's in any summation order
-- while every partial sum stays below 2**24.  Past that (a leg of more
than 16.7M hop-messages in one superstep) f32 rounding makes the result
depend on the reduction order, and the port and the reference may differ
in the last bits.

Every message the engine emits is charged here: exact XY-torus hop counts
between source and destination tiles, decomposed into intra-die hops,
inter-die (on-package substrate) crossings and off-package crossings.
These feed the Table-III energy model and the BSP time model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .tilegrid import TileGrid

# A task-invocation message is (index, value): 32-bit index + 32-bit value,
# as in the paper (the first parameter is the routed global array index).
MSG_BITS = 64


@dataclasses.dataclass
class TrafficCounters:
    """Accumulated traffic, all in message units (64 bit each)."""

    messages: float = 0.0            # total messages injected
    hop_msgs: float = 0.0            # sum over msgs of router hops
    owner_msgs: float = 0.0          # messages on the owner-bound leg
    owner_hop_msgs: float = 0.0      # their hop-weighted traffic
    intra_die_hops: float = 0.0
    inter_die_crossings: float = 0.0
    inter_pkg_crossings: float = 0.0
    filtered_at_proxy: float = 0.0   # msgs absorbed by P$ (never forwarded)
    coalesced_at_proxy: float = 0.0  # msgs merged into an existing P$ entry
    cascade_combined: float = 0.0    # msgs merged at cascade tree levels
    cross_region_msgs: float = 0.0   # region-boundary crossings, msg-weighted
    off_chip_msgs: float = 0.0       # records exchanged between chips
    off_chip_hop_msgs: float = 0.0   # their chip-grid (board-level) hops
    dropped_backpressure: float = 0.0
    edges_processed: float = 0.0
    records_consumed: float = 0.0    # mailbox records drained by owners
    supersteps: int = 0

    def add(self, other: "TrafficCounters") -> "TrafficCounters":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self

    def as_dict(self) -> Dict[str, float]:
        return {f.name: float(getattr(self, f.name)) for f in dataclasses.fields(self)}

    @property
    def avg_hops(self) -> float:
        return self.hop_msgs / max(self.messages, 1.0)

    @property
    def avg_owner_hops(self) -> float:
        """Average hops of the owner-bound (vertex-update) messages —
        the quantity the paper's Fig. 8 (top) plots."""
        return self.owner_hop_msgs / max(self.owner_msgs, 1.0)


@dataclasses.dataclass
class SuperstepTrace:
    """Per-superstep level-traffic vectors measured by the run loop.

    One entry per superstep, in execution order.  This is the record that
    makes a run *re-priceable*: ``costmodel.price`` recomputes the BSP
    time superstep-wise from these vectors under an arbitrary
    :class:`~repro.core.costmodel.PackageConfig` (different link widths /
    counts, NoC count, HBM channels), so one measured run can be priced
    across a whole package design space (measure-once / price-many).

    Vector fields (floats, one per superstep):
      compute_ops:   max per-tile PU ops (the BSP compute leg).
      intra_bits:    whole-grid intra-die NoC wire bits.
      die_bits:      inter-die (on-package substrate) crossing bits.
      pkg_bits:      off-package crossing bits.
      endpoint_bits: max per-tile delivered bits (endpoint contention).
      off_chip_bits: board-level hop-weighted bits (distributed runtime).
      off_chip_msgs: records that left their chip (IO-die latency events).
      touched_bits:  dataset bits touched (drives the D$ miss -> HBM leg).
      pending:       live work after the superstep (idle steps charge no
                     pipeline fill; flush-only steps still do).

    ``board_links`` is the provisioned board-link count of the partition
    the run executed on (1 for a monolithic run); ``chips_y`` /
    ``chips_x`` record that partition's chip-grid geometry (1x1
    monolithic), which is what lets ``costmodel.price`` re-provision the
    board leg per axis under an arbitrary :class:`PackageConfig` while
    refusing to re-price the trace at a *different* chip count (the
    off-chip traffic is a property of the measured partition).

    ``double_buffer`` records whether the run overlapped each
    superstep's board exchange with the next superstep's compute
    (``EngineConfig.double_buffer``): re-pricing replays the matching
    overlap-aware BSP accumulation, so the priced time reproduces the
    run's own (the reprice contract holds in both modes).

    ``recovery_events`` is the fault-tolerance machinery's
    execution-order log (checkpoint writes, rollbacks, re-shards onto
    survivors), *not* a per-superstep vector: a recovered run's vector
    rows are bit-identical to the unfailed run's (the rollback truncates
    them and the replay re-records them), while the events record the
    overhead timeline — ``costmodel._trace_time_s_parsed`` replays them
    (checkpoint/restore board legs, discarded-work windows) so the
    reprice contract holds on faulted runs too.  Event dicts carry
    ``kind`` ('checkpoint' | 'rollback' | 'reshard') plus kind-specific
    fields (``step`` / ``from_step`` / ``at_step`` / ``bits`` /
    ``chip`` / ``devices``).
    """

    compute_ops: List[float] = dataclasses.field(default_factory=list)
    intra_bits: List[float] = dataclasses.field(default_factory=list)
    die_bits: List[float] = dataclasses.field(default_factory=list)
    pkg_bits: List[float] = dataclasses.field(default_factory=list)
    endpoint_bits: List[float] = dataclasses.field(default_factory=list)
    off_chip_bits: List[float] = dataclasses.field(default_factory=list)
    off_chip_msgs: List[float] = dataclasses.field(default_factory=list)
    touched_bits: List[float] = dataclasses.field(default_factory=list)
    pending: List[float] = dataclasses.field(default_factory=list)
    board_links: int = 1
    chips_y: int = 1
    chips_x: int = 1
    double_buffer: bool = False
    recovery_events: List[dict] = dataclasses.field(default_factory=list)

    _VECTOR_FIELDS = ("compute_ops", "intra_bits", "die_bits", "pkg_bits",
                      "endpoint_bits", "off_chip_bits", "off_chip_msgs",
                      "touched_bits", "pending")

    def __len__(self) -> int:
        return len(self.compute_ops)

    def truncate(self, n: int) -> "SuperstepTrace":
        """Drop every recorded superstep past the first ``n`` (rollback to
        a checkpoint: the replay re-records the discarded rows
        bit-identically).  ``recovery_events`` survive — they log the
        fault-tolerance timeline in execution order, not per-step rows."""
        n = max(int(n), 0)
        for f in self._VECTOR_FIELDS:
            del getattr(self, f)[n:]
        return self

    def append_step(self, stats, element_bits: int = MSG_BITS) -> None:
        """Record one superstep from the run loop's device-fetched stats."""
        self.compute_ops.append(float(stats["compute_per_tile_max"]))
        self.intra_bits.append(float(stats["intra_die_hops"]) * MSG_BITS)
        self.die_bits.append(float(stats["inter_die_crossings"]) * MSG_BITS)
        self.pkg_bits.append(float(stats["inter_pkg_crossings"]) * MSG_BITS)
        self.endpoint_bits.append(
            float(stats["delivered_max_per_tile"]) * MSG_BITS)
        self.off_chip_bits.append(
            float(stats.get("off_chip_hop_msgs", 0.0)) * MSG_BITS)
        self.off_chip_msgs.append(float(stats.get("off_chip_msgs", 0.0)))
        self.touched_bits.append(
            (float(stats["edges_processed"])
             + float(stats["records_consumed"])) * element_bits)
        self.pending.append(float(stats["pending"]))

    def append_chunk(self, stacked, n_active: int,
                     element_bits: int = MSG_BITS) -> None:
        """Append the first ``n_active`` supersteps of a stacked chunk.

        ``stacked`` is the chunked run loop's device-fetched stats dict:
        every value is a ``(K,)`` array whose row ``i`` holds superstep
        ``i`` of the chunk (rows past ``n_active`` are masked no-op
        padding).  Appending is vectorized (one numpy pass per field per
        chunk, not per step — per-step python accounting would eat the
        chunked loop's dispatch savings) yet bit-identical to per-step
        :meth:`append_step` calls: every source stat is an integer-valued
        count, so the float64 convert-and-scale is exact in either
        formulation.
        """
        n = int(n_active)
        if n == 0:
            return

        def vec(key, scale=1.0):
            a = stacked.get(key)
            if a is None:                    # e.g. off-chip legs, monolithic
                return [0.0] * n
            return (np.asarray(a[:n], np.float64) * scale).tolist()

        self.compute_ops.extend(vec("compute_per_tile_max"))
        self.intra_bits.extend(vec("intra_die_hops", MSG_BITS))
        self.die_bits.extend(vec("inter_die_crossings", MSG_BITS))
        self.pkg_bits.extend(vec("inter_pkg_crossings", MSG_BITS))
        self.endpoint_bits.extend(vec("delivered_max_per_tile", MSG_BITS))
        self.off_chip_bits.extend(vec("off_chip_hop_msgs", MSG_BITS))
        self.off_chip_msgs.extend(vec("off_chip_msgs"))
        touched = (np.asarray(stacked["edges_processed"][:n], np.float64)
                   + np.asarray(stacked["records_consumed"][:n], np.float64))
        self.touched_bits.extend((touched * element_bits).tolist())
        self.pending.extend(vec("pending"))

    # recovery-event fields that index trace rows: shifted when traces
    # concatenate so events keep pointing at their supersteps
    _EVENT_STEP_KEYS = ("step", "from_step", "at_step")

    def extend(self, other: "SuperstepTrace") -> "SuperstepTrace":
        """Concatenate another trace (epoch-style apps accumulate runs)."""
        base = len(self)
        for f in self._VECTOR_FIELDS:
            getattr(self, f).extend(getattr(other, f))
        for ev in other.recovery_events:
            ev = dict(ev)
            for k in self._EVENT_STEP_KEYS:
                if k in ev:
                    ev[k] = int(ev[k]) + base
            self.recovery_events.append(ev)
        self.board_links = max(self.board_links, other.board_links)
        self.chips_y = max(self.chips_y, other.chips_y)
        self.chips_x = max(self.chips_x, other.chips_x)
        self.double_buffer = self.double_buffer or other.double_buffer
        return self

    def to_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {f: list(getattr(self, f))
                                for f in self._VECTOR_FIELDS}
        d["board_links"] = self.board_links
        d["chips_y"] = self.chips_y
        d["chips_x"] = self.chips_x
        d["double_buffer"] = self.double_buffer
        if self.recovery_events:
            d["recovery_events"] = [dict(ev) for ev in self.recovery_events]
        return d

    @classmethod
    def from_dict(cls, d) -> "SuperstepTrace":
        t = cls(board_links=int(d.get("board_links", 1)),
                chips_y=int(d.get("chips_y", 1)),
                chips_x=int(d.get("chips_x", 1)),
                double_buffer=bool(d.get("double_buffer", False)))
        for f in cls._VECTOR_FIELDS:
            getattr(t, f).extend(float(v) for v in d.get(f, ()))
        t.recovery_events.extend(dict(ev)
                                 for ev in d.get("recovery_events", ()))
        return t


def charge(grid: TileGrid, src_tid, dst_tid, mask, region_dims=None):
    """Vectorised traffic charge for a batch of messages.

    Args:
      grid: tile grid geometry.
      src_tid, dst_tid: integer tensors of tile ids (any shape).
      mask: bool tensor, True where a real message exists.
      region_dims: optional (region_ny, region_nx) of the base proxy
        regions; when given, each message is additionally charged its
        region-boundary crossings into ``cross_region_msgs``.

    Returns a dict of scalar f32 tensors (messages, hop_msgs, intra, die,
    pkg, cross_region_msgs).
    """
    m = mask.to(torch.float32).reshape(-1)
    hops = grid.hops(src_tid, dst_tid).to(torch.float32).reshape(-1)
    intra, die, pkg = grid.link_levels(src_tid, dst_tid)
    rows = [m, hops * m, intra.to(torch.float32).reshape(-1) * m,
            die.to(torch.float32).reshape(-1) * m,
            pkg.to(torch.float32).reshape(-1) * m]
    if region_dims is not None:
        rny, rnx = region_dims
        crosses = grid.region_crossings(src_tid, dst_tid, rny, rnx)
        rows.append(crosses.to(torch.float32).reshape(-1) * m)
    # one fused reduction over all traffic classes
    sums = torch.sum(torch.stack(rows), dim=1)
    return dict(
        messages=sums[0],
        hop_msgs=sums[1],
        intra_die_hops=sums[2],
        inter_die_crossings=sums[3],
        inter_pkg_crossings=sums[4],
        cross_region_msgs=(sums[5] if region_dims is not None
                           else torch.zeros((), dtype=torch.float32,
                                            device=m.device)),
    )


def charge_off_chip(part, src_tid, dst_tid, mask):
    """Charge the board-level leg of records leaving their chip: one
    board link per chip-grid hop (``ChipPartition.chip_hops``).  Returns
    dict(off_chip_msgs, off_chip_hop_msgs) of scalar f32 tensors."""
    return charge_board(part, part.chip_of_tile(src_tid),
                        part.chip_of_tile(dst_tid), mask)


def charge_board(part, src_chip, dst_chip, mask):
    """``charge_off_chip`` on the records' source and owner chips."""
    m = mask.to(torch.float32)
    hops = part.chip_grid_hops(src_chip, dst_chip).to(torch.float32)
    return dict(off_chip_msgs=torch.sum(m),
                off_chip_hop_msgs=torch.sum(hops * m))


def merge_charges(*charges) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for c in charges:
        for k, v in c.items():
            out[k] = out.get(k, 0.0) + v
    return out
