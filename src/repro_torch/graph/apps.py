"""The paper's min-algebra traversals (§IV) on the PyTorch engine.

  BFS    min / add_one   write-through proxy on vertex update
  SSSP   min / add_w     write-through proxy on vertex update
  WCC    min / carry     write-through proxy on vertex update

The port of ``repro.graph.apps`` for this slice: the three apps share the
min algebra and the write-through P$.  PageRank, SpMV and Histogram need
the write-back P$ and its flush (ROADMAP A.4).  Each app returns the
computed values plus the engine's RunResult (traffic counters + BSP
time), from which the paper's metrics (GTEPS, hops/message, energy, $)
follow.

``device=None`` runs on the CUDA card; ``backend="kernels"`` (default) or
``"torch"`` picks the engine's hot-spot implementation; every other
keyword is an ``EngineConfig`` field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.engine import AppSpec, DataLocalEngine, EngineConfig, RunResult
from ..core.proxy import CascadeConfig, ProxyConfig
from ..core.tilegrid import TileGrid
from .csr import CSR, transpose_csr

# Table II per-app cascade profitability (the selective criterion): the
# write-through min propagators bypass the reduction tree.
BFS_SPEC = AppSpec("bfs", combine="min", edge_value="add_one",
                   cascade_profitable=False)
SSSP_SPEC = AppSpec("sssp", combine="min", edge_value="add_w",
                    cascade_profitable=False)
WCC_SPEC = AppSpec("wcc", combine="min", edge_value="carry",
                   cascade_profitable=False)

# Table II per-task proxy policy: which apps run the write-back P$.
WRITE_BACK_APPS = frozenset({"pagerank", "spmv", "histo"})


def table2_proxy(grid: TileGrid, app: str, *, slots: int = 512,
                 region_div: int = 4, cascade_levels: int = 0,
                 cascade_group: int = 2,
                 selective: bool = True) -> ProxyConfig:
    """Build the Table-II proxy config for ``app`` on ``grid``.

    region_div: regions per grid axis (paper default: 4x4 regions).
    cascade_levels > 0 attaches a selective-cascading reduction tree with
    the given per-level region grouping factor.
    """
    cascade = None
    if cascade_levels:
        cascade = CascadeConfig(levels=cascade_levels,
                                group_ny=cascade_group,
                                group_nx=cascade_group,
                                selective=selective)
    return ProxyConfig(region_ny=max(grid.ny // region_div, 2),
                       region_nx=max(grid.nx // region_div, 2),
                       slots=slots,
                       write_back=app in WRITE_BACK_APPS,
                       cascade=cascade)


@dataclasses.dataclass
class AppResult:
    values: np.ndarray
    run: RunResult
    teps_edges: float         # Graph500-style edge count for TEPS

    @property
    def gteps(self) -> float:
        """Edges per second of the *modelled* DCRA chip (the BSP time
        model's ``time_s``), not of the device the engine ran on."""
        return self.teps_edges / max(self.run.time_s, 1e-12) / 1e9


def _engine(spec: AppSpec, g: CSR, grid: TileGrid,
            proxy: Optional[ProxyConfig], chips: int = 0, device=None,
            **kw) -> DataLocalEngine:
    if chips and chips > 1:
        raise NotImplementedError(
            "not ported to repro_torch yet: chips > 1, the distributed "
            "runtime (ROADMAP A.9)")
    cfg = EngineConfig(grid=grid, n_src=g.n_rows, n_dst=g.n_cols,
                       proxy=proxy, **kw)
    return DataLocalEngine(spec, cfg, g.row_lo, g.row_hi, g.col_idx,
                           g.weights, device=device)


def _refuse_observer(observer) -> None:
    if observer is not None:
        raise NotImplementedError(
            "not ported to repro_torch yet: observer= (ROADMAP A.8)")


def _values(state, n: int) -> np.ndarray:
    return state["values"][:n].cpu().numpy()


# ---------------------------------------------------------------- traversals
def bfs(g: CSR, root: int, grid: TileGrid,
        proxy: Optional[ProxyConfig] = None, observer=None, device=None,
        **kw) -> AppResult:
    _refuse_observer(observer)
    eng = _engine(BFS_SPEC, g, grid, proxy, device=device, **kw)
    state = eng.init_state(seed_idx=root, seed_val=0.0)
    state, run = eng.run(state)
    vals = _values(state, g.n_rows)
    reached = np.isfinite(vals)
    teps = float(g.out_degree()[reached].sum())
    return AppResult(values=vals, run=run, teps_edges=teps)


def sssp(g: CSR, root: int, grid: TileGrid,
         proxy: Optional[ProxyConfig] = None, observer=None, device=None,
         **kw) -> AppResult:
    _refuse_observer(observer)
    eng = _engine(SSSP_SPEC, g, grid, proxy, device=device, **kw)
    state = eng.init_state(seed_idx=root, seed_val=0.0)
    state, run = eng.run(state)
    vals = _values(state, g.n_rows)
    reached = np.isfinite(vals)
    teps = float(g.out_degree()[reached].sum())
    return AppResult(values=vals, run=run, teps_edges=teps)


def wcc(g: CSR, grid: TileGrid, proxy: Optional[ProxyConfig] = None,
        symmetrize: bool = False, observer=None, device=None,
        **kw) -> AppResult:
    """Min-label propagation.  The input graph must contain both edge
    directions for weak components; RMAT graphs from ``rmat_edges``
    already do -- pass symmetrize=True otherwise."""
    _refuse_observer(observer)
    if symmetrize:
        gt = transpose_csr(g)
        src = np.concatenate([
            np.repeat(np.arange(g.n_rows, dtype=np.int64), g.out_degree()),
            np.repeat(np.arange(gt.n_rows, dtype=np.int64), gt.out_degree())])
        dst = np.concatenate([g.col_idx.astype(np.int64),
                              gt.col_idx.astype(np.int64)])
        from .csr import csr_from_edges
        g = csr_from_edges(src, dst, max(g.n_rows, g.n_cols))
    eng = _engine(WCC_SPEC, g, grid, proxy, device=device, **kw)
    n = g.n_rows
    state = eng.init_state(seed_idx=np.arange(n),
                           seed_val=np.arange(n, dtype=np.float32))
    state, run = eng.run(state)
    return AppResult(values=_values(state, n), run=run,
                     teps_edges=float(g.nnz))


APPS = dict(bfs=bfs, sssp=sssp, wcc=wcc)
