"""Proxy regions (paper §III-A): the P$ configuration and its index maps.

The PyTorch rendering of ``repro.core.proxy``.  ``CascadeConfig`` and
``ProxyConfig`` are verbatim copies with their validation; ``proxy_tile``,
``cascade_proxy_tile``, ``pcache_slot`` and ``make_pcache`` are redone in
torch; ``max_cascade_levels``, ``chip_local_proxy`` and ``region_id`` are
copies.  The engine runs the write-through and the write-back P$ and the
cascade, on one chip or, adapted by ``chip_local_proxy``, on a partition.

The tile grid is divided into proxy regions.  A task message destined for
a far-away owner is first routed to the proxy tile inside the *sender's*
region (at the owner's coordinates modulo the region dimensions), where a
direct-mapped proxy cache (P$) filters non-improving updates before
forwarding one combined record to the true owner.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .tilegrid import TileGrid


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Region reduction-tree policy for draining proxy output.

    levels:   number of tree levels above the base proxy regions.
    group_ny, group_nx: how many child regions merge into a parent region
              along each axis per level (the paper's reduction-tree fanin).
    selective: apply the selective criterion (per-record early exit and
              the per-app combine-profitability gate).

    A level whose region dimensions reach the whole grid is the
    degenerate tree root: its proxy for any index *is* the owner tile, so
    it adds no wire traffic (and under ``selective=True`` every record
    early-exits it).  Configs whose top level equals the grid therefore
    have ``levels - 1`` genuinely combining sub-grid levels; size the
    base regions (e.g. ``table2_proxy(region_div=8)``) so the top level
    stays below the grid when deeper trees are wanted.
    """

    levels: int = 2
    group_ny: int = 2
    group_nx: int = 2
    selective: bool = True

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError("cascade levels must be >= 1")
        if self.group_ny < 1 or self.group_nx < 1:
            raise ValueError("cascade grouping factors must be >= 1")
        if self.group_ny * self.group_nx < 2:
            raise ValueError(
                "cascade grouping must merge at least 2 regions per level")

    def level_dims(self, region_ny: int, region_nx: int,
                   level: int) -> Tuple[int, int]:
        """Region dimensions at tree level ``level`` (0 = base regions)."""
        return (region_ny * self.group_ny ** level,
                region_nx * self.group_nx ** level)


@dataclasses.dataclass(frozen=True)
class ProxyConfig:
    """Per-task proxy configuration (one entry of Table II 'Per Task')."""

    region_ny: int
    region_nx: int
    slots: int = 1024          # P$ entries per tile (direct-mapped)
    write_back: bool = False   # False => write-through
    cascade: Optional[CascadeConfig] = None

    def num_regions(self, grid: TileGrid) -> int:
        # ceil division, consistent with TileGrid.region_id's numbering
        # (edge regions of a non-divisible grid count as regions).
        return (-(-grid.ny // self.region_ny)) * (-(-grid.nx // self.region_nx))

    def validate(self, grid: TileGrid) -> None:
        """Check the cascade region grouping tiles the grid exactly.

        Raises ValueError on non-divisible groupings: every tree level's
        region dimensions must divide the grid, otherwise super-regions
        straddle the grid edge and the reduction tree is ill-formed.
        """
        self.validate_window(grid.ny, grid.nx)

    def validate_window(self, ny: int, nx: int) -> None:
        """``validate`` against an arbitrary tile window (the whole grid
        for the monolithic engine, one chip's subgrid for the distributed
        runtime)."""
        if self.cascade is None:
            return
        if ny % self.region_ny or nx % self.region_nx:
            raise ValueError(
                f"proxy regions {self.region_ny}x{self.region_nx} do not "
                f"divide the {ny}x{nx} window (required for cascading)")
        for level in range(1, self.cascade.levels + 1):
            rny, rnx = self.cascade.level_dims(self.region_ny,
                                               self.region_nx, level)
            if ny % rny or nx % rnx:
                raise ValueError(
                    f"cascade level {level} regions {rny}x{rnx} do not "
                    f"divide the {ny}x{nx} window: grouping "
                    f"{self.cascade.group_ny}x{self.cascade.group_nx} is "
                    f"non-divisible at this level")


def max_cascade_levels(ny: int, nx: int, region_ny: int, region_nx: int,
                       group_ny: int = 2, group_nx: int = 2) -> int:
    """Deepest well-formed reduction tree on an ``ny x nx`` window: the
    levels of ``group_ny x group_nx`` grouping that divide the window,
    stopping before a level's regions cover it whole (the degenerate
    root, whose proxy is the owner)."""
    if ny % region_ny or nx % region_nx:
        return 0
    fit = 0
    for level in range(1, 64):
        rny = region_ny * group_ny ** level
        rnx = region_nx * group_nx ** level
        if ny % rny or nx % rnx or (rny >= ny and rnx >= nx):
            break
        fit = level
    return fit


def chip_local_proxy(cfg: ProxyConfig, sub_ny: int,
                     sub_nx: int) -> ProxyConfig:
    """Adapt a proxy config to one chip's ``sub_ny x sub_nx`` tile window.

    A sender's region, and every cascade level, must lie on the sender's
    chip, so roots sit at the chip boundary and anything bound further
    out rides the off-chip leg straight to its owner: region dimensions
    shrink to their gcd with the chip's, and cascade levels that would
    outgrow the chip are cut (the cascade is dropped when none fits).
    Both change the schedule only, never the fixed point (min) or the
    delivered sum (add)."""
    rny = math.gcd(cfg.region_ny, sub_ny)
    rnx = math.gcd(cfg.region_nx, sub_nx)
    cascade = cfg.cascade
    if cascade is not None:
        fit = 0
        for level in range(1, cascade.levels + 1):
            lny, lnx = cascade.level_dims(rny, rnx, level)
            if sub_ny % lny or sub_nx % lnx:
                break
            fit = level
        cascade = (dataclasses.replace(cascade, levels=fit) if fit
                   else None)
    return dataclasses.replace(cfg, region_ny=rny, region_nx=rnx,
                               cascade=cascade)


def region_id(grid: TileGrid, cfg: ProxyConfig, tid):
    """Proxy-region id of a tile."""
    return grid.region_id(tid, cfg.region_ny, cfg.region_nx)


def proxy_tile(grid: TileGrid, cfg: ProxyConfig, owner_tid, src_tid):
    """Proxy tile for a message from ``src_tid`` to owner ``owner_tid``:
    in the sender's region, at the owner's coordinates modulo the region
    dimensions (paper Fig. 2)."""
    return cascade_proxy_tile(grid, cfg.region_ny, cfg.region_nx,
                              owner_tid, src_tid)


def cascade_proxy_tile(grid: TileGrid, region_ny: int, region_nx: int,
                       owner_tid, src_tid):
    """The proxy for ``owner_tid`` inside the (region_ny x region_nx)
    region containing ``src_tid``."""
    oy, ox = grid.coords(owner_tid)
    sy, sx = grid.coords(src_tid)
    ry0 = (sy // region_ny) * region_ny
    rx0 = (sx // region_nx) * region_nx
    py = ry0 + oy % region_ny
    px = rx0 + ox % region_nx
    return grid.tid(py, px)


def pcache_slot(cfg: ProxyConfig, global_idx):
    """Direct-mapped P$ slot for a global array index tensor."""
    return global_idx % cfg.slots


def make_pcache(grid: TileGrid, cfg: ProxyConfig, default_value: float,
                device):
    """Allocate per-tile P$ state on ``device``: (tags int32, values f32),
    each (num_tiles, slots).  tag == -1 => invalid."""
    shape = (grid.num_tiles, cfg.slots)
    tags = torch.full(shape, -1, dtype=torch.int32, device=device)
    vals = torch.full(shape, default_value, dtype=torch.float32,
                      device=device)
    return tags, vals
