"""Weak/strong-scaling harness: GTEPS measured across 1..256 chips
(paper Fig. 11's multi-package regime, §V-D's Graph500 comparison).

The port of ``repro.distrib.harness``.  Each chip count runs BFS on the
distributed engine (every chip's supersteps, the board exchange, the
off-chip charges) and reports GTEPS of the modelled chips beside the
energy/$ report, in which off-chip traffic is priced.  Weak scaling
keeps each chip's tile subgrid and dataset share constant while the
chips grow, so the RMAT scale rises with the chip count; strong scaling
fixes the grid and dataset and only re-partitions them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.costmodel import DCRA_SRAM, PackageConfig, price
from ..core.tilegrid import TileGrid, partition_grid, square_grid
from ..graph.rmat import rmat_edges

WEAK_CHIP_COUNTS = (1, 4, 16, 64, 256)


def chip_grid(chips: int, tiles_per_chip: int) -> TileGrid:
    """Tile grid of ``chips`` square subgrids of ``tiles_per_chip`` tiles,
    on the most square chip grid that ``chips`` factors into (chips=2,
    tiles_per_chip=16 -> a 4x8 grid of two 4x4 chips)."""
    s = int(round(math.sqrt(tiles_per_chip)))
    if s * s != tiles_per_chip:
        raise ValueError(f"tiles_per_chip={tiles_per_chip} must be a "
                         f"perfect square")
    best = None
    for cy in range(1, chips + 1):
        if chips % cy == 0:
            cx = chips // cy
            if best is None or abs(cy - cx) < abs(best[0] - best[1]):
                best = (cy, cx)
    cy, cx = best
    return TileGrid(cy * s, cx * s)


def _measure(g, grid, chips: int, oq_cap: int, pkg: PackageConfig,
             backend: str, use_proxy: bool, run_chunk: Optional[int],
             double_buffer: bool, device) -> Optional[Dict[str, float]]:
    """One BFS row, or None on a rank that holds no chip."""
    from ..graph import apps
    root = int(np.argmax(g.out_degree()))
    proxy = apps.table2_proxy(grid, "bfs") if use_proxy else None
    kw = {} if run_chunk is None else dict(run_chunk=run_chunk)
    r = apps.bfs(g, root, grid, proxy=proxy, oq_cap=oq_cap, chips=chips,
                 backend=backend, pkg=pkg, double_buffer=double_buffer,
                 device=device, **kw)
    if r.run is None:
        return None
    # re-price the measured trace under the run's own package config: the
    # analytic board-level pricing must reproduce the measured time
    rep = price(pkg, grid, r.run.counters,
                mem_bits_sram=float(g.footprint_bytes() * 8),
                per_superstep_peak=r.run.trace)
    c = r.run.counters
    return dict(chips=chips, tiles=grid.num_tiles, n_vertices=g.n_rows,
                teps_edges=r.teps_edges, gteps=r.gteps,
                time_s=r.run.time_s, supersteps=r.run.supersteps,
                off_chip_msgs=c.off_chip_msgs,
                off_chip_hop_msgs=c.off_chip_hop_msgs,
                messages=c.messages,
                energy_j=rep.energy_j, cost_usd=rep.cost_usd,
                off_chip_j=rep.breakdown["off_chip_j"],
                gteps_per_w=r.gteps / max(rep.power_w, 1e-12),
                gteps_per_usd=r.gteps / rep.cost_usd,
                reprice_time_s=rep.time_s,
                reprice_ratio=rep.time_s / max(r.run.time_s, 1e-30))


def weak_scaling(chip_counts: Sequence[int] = WEAK_CHIP_COUNTS,
                 tiles_per_chip: int = 16, base_scale: int = 6,
                 edge_factor: int = 8, oq_cap: int = 16,
                 pkg: PackageConfig = DCRA_SRAM, seed: int = 1,
                 backend: str = "kernels", use_proxy: bool = True,
                 run_chunk: Optional[int] = None,
                 double_buffer: bool = False,
                 device=None) -> List[Dict[str, float]]:
    """Constant work per chip: the RMAT scale and the tiles grow with the
    chip count.  One measurement dict per chip count; the GTEPS column is
    the measured multi-chip curve (monotone when the runtime scales).
    ``run_chunk`` overrides the supersteps per host fetch (0: the
    per-step loop); ``double_buffer`` prices each superstep's board
    exchange under the next superstep's compute (the same counters and
    trace, a lower or equal ``time_s``: ``distrib.driver``).
    ``backend`` goes to the app as it is: an engine backend ('kernels' /
    'torch') or a placement on ranks ('auto' / 'vmap' / 'shard_map');
    a rank that holds no chip of a row has no row for it."""
    rows = []
    for chips in chip_counts:
        grid = chip_grid(chips, tiles_per_chip)
        scale = base_scale + int(round(math.log2(chips)))
        g = rmat_edges(scale, edge_factor=edge_factor, seed=seed)
        rows.append(_measure(g, grid, chips, oq_cap, pkg, backend,
                             use_proxy, run_chunk, double_buffer, device))
    return [r for r in rows if r is not None]


def strong_scaling(chip_counts: Sequence[int] = (1, 4, 16, 64),
                   n_tiles: int = 1024, scale: int = 10,
                   edge_factor: int = 8, oq_cap: int = 16,
                   pkg: PackageConfig = DCRA_SRAM, seed: int = 1,
                   backend: str = "kernels", use_proxy: bool = True,
                   run_chunk: Optional[int] = None,
                   double_buffer: bool = False,
                   device=None) -> List[Dict[str, float]]:
    """Fixed grid and dataset, re-partitioned across more chips: what the
    off-chip boundary costs at constant total work (``double_buffer`` and
    ``backend`` as in ``weak_scaling``)."""
    g = rmat_edges(scale, edge_factor=edge_factor, seed=seed)
    grid = square_grid(n_tiles)
    rows = []
    for chips in chip_counts:
        try:
            partition_grid(grid, chips)
        except ValueError:
            print(f"# strong_scaling: skipped chips={chips} "
                  f"(does not partition the {grid.ny}x{grid.nx} grid)")
            continue
        rows.append(_measure(g, grid, chips, oq_cap, pkg, backend,
                             use_proxy, run_chunk, double_buffer, device))
    return [r for r in rows if r is not None]


def measured_gteps_curve(rows: List[Dict[str, float]]) -> Dict[int, float]:
    return {int(r["chips"]): float(r["gteps"]) for r in rows}
