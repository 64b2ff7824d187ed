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

Not in this slice, and refused with ``NotImplementedError`` naming the
ROADMAP item rather than ignored: the device-resident chunked loop (A.5:
``run`` always steps one superstep per host round trip); active-set
compaction (A.7); telemetry, the sanitizer and observers (A.8);
multi-chip partitions and double buffering, with the flush's off-chip
buffer sizing ``_flush_off_len`` (A.9); checkpoints (A.10).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import netstats
from .. import device as _device
from ..kernels import ops as kops
from ..obs.metrics import default_registry
from .costmodel import (CLOCK_GHZ, PU_OPS_PER_EDGE, PU_OPS_PER_RECORD,
                        DCRA_SRAM, PackageConfig, link_provisioning,
                        step_cycles)
from .netstats import MSG_BITS, SuperstepTrace, TrafficCounters
from .proxy import (ProxyConfig, cascade_proxy_tile, make_pcache,
                    pcache_slot, proxy_tile)
from .tilegrid import ChipPartition, TileGrid

INF = float("inf")


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
    """The reference's configuration, field for field.  Fields this
    slice does not run must keep their defaults (``DataLocalEngine``
    refuses the others); ``run_chunk`` is accepted and read by nothing
    yet (see ``DataLocalEngine.run``)."""

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


def _refuse_unported(cfg: EngineConfig, part: ChipPartition) -> None:
    """Raise on every setting this slice does not run."""
    unported = []
    if cfg.compaction > 0:
        unported.append("compaction > 0 (ROADMAP A.7)")
    if cfg.telemetry:
        unported.append("telemetry (ROADMAP A.8)")
    if cfg.sanitize:
        unported.append("sanitize (ROADMAP A.8)")
    if cfg.double_buffer:
        unported.append("double_buffer (ROADMAP A.9)")
    if part.num_chips > 1:
        unported.append(f"a {part.num_chips}-chip partition (ROADMAP A.9)")
    if cfg.ckpt_every_supersteps:
        unported.append("ckpt_every_supersteps (ROADMAP A.10)")
    if unported:
        raise NotImplementedError(
            "not ported to repro_torch yet: " + ", ".join(unported))


# Scalar stats of one superstep, in the order ``_superstep`` packs them
# into the one tensor the run loop fetches per superstep.
STAT_KEYS = ("edges_processed", "records_consumed", "compute_per_tile_max",
             "filtered_at_proxy", "coalesced_at_proxy", "cascade_combined",
             "pending", "p_resident", "delivered_max_per_tile",
             "messages", "hop_msgs", "intra_die_hops", "inter_die_crossings",
             "inter_pkg_crossings", "cross_region_msgs", "owner_msgs",
             "owner_hop_msgs")


class DataLocalEngine:
    """Single-device engine: simulates the whole tile grid as one window,
    with exact traffic accounting.

    ``device=None`` runs on the CUDA card and raises without one; the
    CPU runs only when asked for (``device="cpu"``).  ``row_lo``,
    ``row_hi``, ``col_idx`` and ``weights`` may be numpy arrays or tensors
    (``convert.csr_to_device``); they are moved to the device once.
    """

    def __init__(self, app: AppSpec, cfg: EngineConfig,
                 row_lo, row_hi, col_idx, weights=None,
                 part: Optional[ChipPartition] = None, device=None):
        if cfg.backend not in ("kernels", "torch"):
            raise ValueError(f"unknown engine backend {cfg.backend!r}")
        part = part if part is not None else ChipPartition(cfg.grid, 1, 1)
        _refuse_unported(cfg, part)
        self.app = app
        self.cfg = cfg
        self.part = part
        self.device = _device.resolve(device)
        T = part.tiles_per_chip
        self.T = T
        self.Tg = cfg.grid.num_tiles
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
        dev = self.device
        self.row_lo = _to(_pad(row_lo, self.Ngs, 0), torch.int32, dev)
        self.row_hi = _to(_pad(row_hi, self.Ngs, 0), torch.int32, dev)
        self.col_idx = _to(col_idx, torch.int32, dev)
        if weights is None:
            weights = torch.ones(self.col_idx.shape, dtype=torch.float32)
        self.weights = _to(weights, torch.float32, dev)
        self._tile_gids = self.part.global_tile(
            0, torch.arange(T, dtype=torch.int32, device=dev))

    # ---------------------------------------------------------------- state
    def init_state(self, seed_idx=None, seed_val=None):
        """Fresh engine state; ``seed_idx``/``seed_val`` pre-load mailbox
        records (the traversal roots)."""
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
        if seed_idx is not None:
            si = torch.as_tensor(np.atleast_1d(seed_idx), dtype=torch.int64,
                                 device=dev)
            sv = torch.as_tensor(np.atleast_1d(seed_val),
                                 dtype=torch.float32, device=dev)
            st["mail_val"][si] = sv
            st["mail_flag"][si] = True
        return st

    def activate_all(self, state, cur_val):
        """Epoch-style activation (PageRank/SpMV/Histogram): every source
        item starts with its full edge range and a carried value."""
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

    def _front_dense(self, row_lo, row_hi, state, tile_gids):
        """Dense IQ drain + OQ emit over all T tiles.

        Returns (new_vals, mail_val, mail_flag, cur_lo, cur_hi, cur_val,
        consumed_per_tile, edges_per_tile, dst, cand, emit_mask,
        src_tile): full-length state tensors, (T,) per-tile counts and
        the flattened (T*oq_cap,) emission record stream."""
        app, cfg = self.app, self.cfg
        T, Cs, Cd = self.T, self.Cs, self.Cd
        dev = self.device

        # ---- 1. IQ drain (budgeted mailbox consumption) -------------------
        flag2d = state["mail_flag"].reshape(T, Cd)
        csum = torch.cumsum(flag2d.to(torch.int32), dim=1, dtype=torch.int32)
        take2d = flag2d & (csum <= cfg.iq_cap)
        take = take2d.reshape(-1)
        mval, vals = state["mail_val"], state["values"]
        if cfg.backend == "kernels":
            new_vals, imp8 = kops.relax(vals, mval, take, combine=app.combine)
            improved = imp8.to(torch.bool)
        elif app.combine == "min":
            improved = take & (mval < vals)
            new_vals = torch.where(improved, mval, vals)
        else:
            improved = take
            new_vals = torch.where(take, vals + mval, vals)
        mail_flag = state["mail_flag"] & ~take
        mail_val = torch.where(take, app.identity, mval)
        consumed_per_tile = torch.sum(take2d, dim=1)

        cur_lo, cur_hi, cur_val = (state["cur_lo"], state["cur_hi"],
                                   state["cur_val"])
        if app.reactivate and self.Nd == self.Ns:
            # an improving record restarts the item's edge cursor with the
            # new value (re-expansion of a visited item is the engine's
            # rendering of data staleness: measurable wasted work)
            re = improved
            cur_lo = torch.where(re, row_lo, cur_lo)
            cur_hi = torch.where(re, row_hi, cur_hi)
            cur_val = torch.where(re, new_vals, cur_val)

        # ---- 2. OQ emit (budgeted edge streaming) -------------------------
        B = cfg.oq_cap
        rem2d = (cur_hi - cur_lo).reshape(T, Cs)
        prefix = torch.cumsum(rem2d, dim=1, dtype=torch.int32)  # inclusive
        capped = torch.clamp(prefix, max=B)
        take_v2d = capped - torch.cat(
            [torch.zeros((T, 1), dtype=torch.int32, device=dev),
             capped[:, :-1]], dim=1)
        total_take = capped[:, -1]                               # (T,)
        b_idx = torch.arange(B, dtype=torch.int32, device=dev)
        # per-row searchsorted(side="right") of every emission slot
        vslot = torch.searchsorted(capped, b_idx.expand(T, B).contiguous(),
                                   right=True)
        vslot = torch.clamp(vslot, max=Cs - 1)                   # (T, B)
        capped_prev = capped - take_v2d
        offset = b_idx[None, :] - torch.gather(capped_prev, 1, vslot)
        vglob = vslot + torch.arange(T, device=dev)[:, None] * Cs
        pos = cur_lo[vglob] + offset
        emit_mask = b_idx[None, :] < total_take[:, None]
        pos = torch.clamp(pos, 0, self.col_idx.shape[0] - 1).to(torch.int64)
        dst = self.col_idx[pos]
        cand = self._edge_value(cur_val[vglob], pos)
        cur_lo = cur_lo + take_v2d.reshape(-1)

        # flatten records (tile ids are global; dst indices are global)
        R = T * B
        src_tile = torch.repeat_interleave(tile_gids, B)
        return (new_vals, mail_val, mail_flag, cur_lo, cur_hi, cur_val,
                consumed_per_tile, total_take, dst.reshape(R),
                cand.reshape(R), emit_mask.reshape(R), src_tile)

    def _superstep(self, state, flush: bool = False):
        """One monolithic superstep: (new_state, stats) with every stat a
        0-d tensor on the device.  ``flush`` (a host bool, decided by the
        run loop from the previous superstep's fetched stats) spills the
        write-back P$ in this superstep."""
        return self._step(self.row_lo, self.row_hi, state, flush)

    def _step(self, row_lo, row_hi, state, flush=False):
        app, cfg = self.app, self.cfg
        is_min = app.combine == "min"
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        (new_vals, mail_val, mail_flag, cur_lo, cur_hi, cur_val,
         consumed_vec, edges_vec, dst, cand, emit_mask,
         src_tile) = self._front_dense(row_lo, row_hi, state,
                                       self._tile_gids)
        owner = torch.clamp(dst // self.Cd, max=self.Tg - 1)

        stats = dict(edges_processed=torch.sum(edges_vec),
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
        else:
            (mail_val, mail_flag, p_tag, p_val, charges, pstats,
             dmax) = self._proxy_stage(
                mail_val, mail_flag, p_tag, p_val, dst, cand, emit_mask,
                src_tile, owner, flush, is_min)
            stats.update(pstats)

        new_state = dict(values=new_vals, mail_val=mail_val,
                         mail_flag=mail_flag, cur_lo=cur_lo, cur_hi=cur_hi,
                         cur_val=cur_val)
        if p_tag is not None:
            new_state["p_tag"], new_state["p_val"] = p_tag, p_val
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
        return new_state, stats

    # ------------------------------------------------------- owner delivery
    def _drain_to_owners(self, mail_val, mail_flag, dst, val, mask, src,
                         region_dims, is_min):
        """Charge the owner-bound leg and deliver the records into the
        mailboxes.  Returns (mail_val, mail_flag, owner_leg_charge,
        off_chip_charge, delivered_per_tile); the off-chip charge is empty
        on one chip."""
        owner = torch.clamp(dst // self.Cd, max=self.Tg - 1)
        owner_leg = netstats.charge(self.cfg.grid, src, owner, mask,
                                    region_dims=region_dims)
        mail_val, mail_flag, per_tile = _deliver(
            mail_val, mail_flag, dst, val, mask, self.T, self.Nd, is_min,
            backend=self.cfg.backend)
        return mail_val, mail_flag, owner_leg, {}, per_tile

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
        # the sender's region lies on this window, so the proxy tile does
        ptile_l = self.part.local_tile(ptile)

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
        proxy_src = self.part.global_tile(0, torch.clamp(skey // S,
                                                          max=T - 1))
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
            all_src.append(torch.repeat_interleave(self._tile_gids, S))
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
        return mail_val, mail_flag, p_tag, p_val, charges, pstats, dmax

    # --------------------------------------------------------- flush drain
    def _flush_drain(self, p_tag, p_val, mail_val, mail_flag, rdims,
                     is_min):
        """The write-back whole-P$ spill, run on flush supersteps only.

        The reference takes this leg under ``lax.cond`` and returns zero
        charges on the other supersteps; here the run loop already holds
        the flush decision on the host (it comes from the stats fetched
        the superstep before), so the caller skips the leg with a Python
        ``if`` at no extra host sync.  Adding zero charges changes no
        sum, so the counters and trace are the reference's.  Returns
        (mail_val, mail_flag, merged_leg, owner_leg, per_tile,
        level_max, n_combined); the caller clears the P$."""
        ident = self.app.identity
        S = self.cfg.proxy.slots
        ft = p_tag.reshape(-1)
        fmask = ft >= 0
        fdst = torch.where(fmask, ft, self.Ngd)
        fval = torch.where(fmask, p_val.reshape(-1), ident)
        fsrc = torch.repeat_interleave(self._tile_gids, S)
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
            ptile_l = self.part.local_tile(ptile)
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
        cur = self.part.global_tile(0, torch.clamp(stile, max=T - 1))
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
    def run(self, state, max_supersteps: Optional[int] = None,
            progress_every: int = 0, chunk: Optional[int] = None,
            observer=None):
        """Run supersteps until drained; returns (state, RunResult).

        This slice always runs the per-step loop (the reference's
        ``_run_legacy``): one superstep, then ONE device-to-host transfer
        of its packed scalar stats, which the ``engine.host_syncs``
        counter counts.  ``chunk`` and ``EngineConfig.run_chunk`` are
        accepted and change nothing: the reference's own contract
        (``tests/test_chunked.py``) is that its chunked and per-step
        loops give bit-identical results, so the per-step loop is what
        the chunked one must reproduce.  The device-resident chunked loop
        is ROADMAP A.5."""
        if observer is not None:
            raise NotImplementedError(
                "not ported to repro_torch yet: observer= (ROADMAP A.8)")
        cfg = self.cfg
        maxs = max_supersteps or cfg.max_supersteps
        counters = TrafficCounters()
        trace = SuperstepTrace(double_buffer=cfg.double_buffer)
        cycles = 0.0
        pkg = cfg.pkg
        links = link_provisioning(cfg.grid, pkg)

        def account(stats):
            nonlocal cycles
            counters.add(superstep_counters(stats))
            trace.append_step(stats, element_bits=cfg.element_bits)
            # ---- BSP time model for this superstep ----------------------
            sc = superstep_cycles(stats, pkg, links)
            if sc > 0 or stats["pending"] > 0:
                cycles += sc + links["diameter"] * 0.5   # pipeline fill

        state, steps = self._run_legacy(state, maxs, progress_every, account)
        counters.supersteps = steps
        time_s = cycles / (CLOCK_GHZ * 1e9)
        return state, RunResult(counters=counters, cycles=cycles,
                                time_s=time_s, supersteps=steps, trace=trace)

    def _run_legacy(self, state, maxs, progress_every, account):
        """The per-step loop: one superstep and one host sync each.  The
        flush decision for the next superstep is read from this one's
        fetched stats, so it costs no sync of its own."""
        sync_ctr = default_registry().counter("engine.host_syncs")
        steps = 0
        flush = False
        while steps < maxs:
            state, stats = self._superstep(state, flush)
            stats = fetch_stats(stats)
            sync_ctr.inc()
            steps += 1
            account(stats)
            flush = False
            if stats["pending"] == 0:
                # live work drained; spill any write-back P$ residue (the
                # paper's TSU heuristic: flush when queues go idle).
                # Repeated flushes terminate: a spilled value that does
                # not improve its owner generates no new work.
                if self._write_back and stats["p_resident"] > 0:
                    flush = True
                    continue
                break
            if progress_every and steps % progress_every == 0:
                print(f"  [{self.app.name}] step {steps} "
                      f"pending={stats['pending']:.0f}")
        return state, steps


def fetch_stats(stats) -> dict:
    """The superstep's scalar stats as Python floats, in ONE transfer:
    every stat is packed into one f64 tensor (exact for the f32 charges
    and the integer counts alike) and copied to the host at once."""
    packed = torch.stack([stats[k].to(torch.float64) for k in STAT_KEYS])
    return dict(zip(STAT_KEYS, packed.cpu().tolist()))


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
