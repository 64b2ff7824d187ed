"""The paper's six applications (§IV) on the PyTorch engine.

  BFS    min / add_one   write-through proxy on vertex update
  SSSP   min / add_w     write-through proxy on vertex update
  WCC    min / carry     write-through proxy on vertex update
  PageRank add / carry   BSP epochs; write-back proxy, flushed per epoch
  SPMV   add / mul_w     write-back proxy on the row reduction
  Histo  add / one       write-back proxy on the bin reduction

The port of ``repro.graph.apps``, with the same signatures plus
``device=``.  Each app returns the computed values plus the engine's
RunResult (traffic counters + BSP time), from which the paper's metrics
(GTEPS, hops/message, energy, $) follow.

``device=None`` runs on the CUDA card; ``chips > 1`` runs the
distributed engine (``distrib.DistributedEngine``).  ``backend=`` takes
either set of the reference's names: ``"kernels"`` (default) or
``"torch"`` picks the engine's hot-spot implementation (the reference's
``"pallas"`` / ``"jnp"``), ``"auto"`` / ``"vmap"`` / ``"shard_map"`` the
distributed placement over the ranks of ``group=`` (default: the
``torch.distributed`` default group, where one is initialised;
``distrib.mesh.ExecMesh.build``).  Every other keyword is an
``EngineConfig`` field.  ``observer=`` (an ``obs.timeline.Observer``)
goes to the engine's ``run``; PageRank's observer sees one
``on_run_start`` / ``on_run_end`` pair per epoch.  On a rank that holds
no chip an app returns ``values`` and ``run`` None.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.engine import AppSpec, DataLocalEngine, EngineConfig, RunResult
from ..core.netstats import SuperstepTrace, TrafficCounters
from ..core.proxy import CascadeConfig, ProxyConfig
from ..core.tilegrid import TileGrid
from ..distrib.driver import DistributedEngine
from .csr import CSR, transpose_csr

# Table II per-app cascade profitability (the selective criterion): the
# add-combine accumulators drain dense write-back flushes whose records
# merge at every tree level; the write-through min propagators forward
# sparse improvement streams and bypass the reduction tree under
# CascadeConfig(selective=True).
BFS_SPEC = AppSpec("bfs", combine="min", edge_value="add_one",
                   cascade_profitable=False)
SSSP_SPEC = AppSpec("sssp", combine="min", edge_value="add_w",
                    cascade_profitable=False)
WCC_SPEC = AppSpec("wcc", combine="min", edge_value="carry",
                   cascade_profitable=False)
PAGERANK_SPEC = AppSpec("pagerank", combine="add", edge_value="carry",
                        reactivate=False)
SPMV_SPEC = AppSpec("spmv", combine="add", edge_value="mul_w",
                    reactivate=False)
HISTO_SPEC = AppSpec("histo", combine="add", edge_value="one",
                     reactivate=False)

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


def _split_backends(kw: dict):
    """The apps-level ``backend=`` names either the distributed placement
    ('auto' / 'vmap' / 'shard_map') or, given an engine backend's name
    ('kernels' / 'torch'), the ``EngineConfig.backend`` hot-spot
    implementation; the two sets are disjoint, so one keyword serves
    both.  Returns (placement, the EngineConfig keywords)."""
    backend = kw.pop("backend", "auto")
    if backend in ("kernels", "torch"):
        return "auto", dict(kw, backend=backend)
    if backend not in ("auto", "vmap", "shard_map"):
        raise ValueError(
            f"unknown backend {backend!r}: an engine backend ('kernels', "
            f"'torch') or a placement ('auto', 'vmap', 'shard_map')")
    return backend, kw


def _engine(spec: AppSpec, g: CSR, grid: TileGrid,
            proxy: Optional[ProxyConfig], chips: int = 0, device=None,
            **kw):
    return _build(spec, grid, proxy, g.n_rows, g.n_cols, g.row_lo,
                  g.row_hi, g.col_idx, g.weights, chips, device, kw)


def _build(spec: AppSpec, grid: TileGrid, proxy: Optional[ProxyConfig],
           n_src: int, n_dst: int, row_lo, row_hi, col_idx, weights,
           chips: int, device, kw: dict):
    """The monolithic engine, or the distributed one for ``chips > 1``."""
    kw = dict(kw)
    group = kw.pop("group", None)
    placement, kw = _split_backends(kw)
    cfg = EngineConfig(grid=grid, n_src=n_src, n_dst=n_dst, proxy=proxy,
                       **kw)
    if chips and chips > 1:
        return DistributedEngine(spec, cfg, row_lo, row_hi, col_idx,
                                 weights, num_chips=chips, device=device,
                                 backend=placement, group=group)
    return DataLocalEngine(spec, cfg, row_lo, row_hi, col_idx, weights,
                           device=device)


def engine_and_state(name: str, g: CSR, grid: TileGrid,
                     proxy: Optional[ProxyConfig] = None, root: int = 0,
                     x: Optional[np.ndarray] = None,
                     histo_values: Optional[np.ndarray] = None,
                     bins: int = 0, chips: int = 0, device=None, **kw):
    """Engine + ready-to-run initial state for app ``name``: the wiring
    the app functions below use.  Returns ``(engine, state, seeds)``
    where ``seeds`` is the number of initial mailbox records."""
    if name in ("bfs", "sssp"):
        spec = BFS_SPEC if name == "bfs" else SSSP_SPEC
        eng = _engine(spec, g, grid, proxy, chips, device, **kw)
        return eng, eng.init_state(seed_idx=root, seed_val=0.0), 1
    if name == "wcc":
        eng = _engine(WCC_SPEC, g, grid, proxy, chips, device, **kw)
        n = g.n_rows
        state = eng.init_state(seed_idx=np.arange(n),
                               seed_val=np.arange(n, dtype=np.float32))
        return eng, state, n
    if name == "pagerank":
        eng = _engine(PAGERANK_SPEC, g, grid, proxy, chips, device, **kw)
        deg = np.maximum(g.out_degree(), 1).astype(np.float32)
        contrib = 0.85 / g.n_rows / deg
        return eng, eng.activate_all(eng.init_state(), contrib), 0
    if name == "spmv":
        # the engine streams from *columns* (the source items that own
        # x[j]) along the column's nonzeros to row owners: A^T's CSR
        at = transpose_csr(g)
        eng = _build(SPMV_SPEC, grid, proxy, at.n_rows, g.n_rows, at.row_lo,
                     at.row_hi, at.col_idx, at.weights, chips, device, kw)
        xv = np.ones(g.n_cols, np.float32) if x is None else x
        return eng, eng.activate_all(eng.init_state(), xv), 0
    if name == "histo":
        # each input element is a source item with a single 'edge' to
        # its bin
        hv = np.asarray(histo_values, np.int32)
        m = hv.shape[0]
        row_lo = np.arange(m, dtype=np.int32)
        eng = _build(HISTO_SPEC, grid, proxy, m, bins, row_lo, row_lo + 1,
                     hv, None, chips, device, kw)
        return eng, eng.activate_all(eng.init_state(),
                                     np.ones(m, np.float32)), 0
    raise ValueError(name)


def _values(state, n: int) -> Optional[np.ndarray]:
    """The first ``n`` values, None on a rank that holds no chip."""
    return None if state is None else state["values"][:n].cpu().numpy()


def _traversal(vals, run, g: CSR) -> AppResult:
    """A BFS or SSSP result: TEPS counts the edges of reached vertices."""
    teps = 0.0 if vals is None else float(
        g.out_degree()[np.isfinite(vals)].sum())
    return AppResult(values=vals, run=run, teps_edges=teps)


# ---------------------------------------------------------------- traversals
def bfs(g: CSR, root: int, grid: TileGrid,
        proxy: Optional[ProxyConfig] = None, observer=None, device=None,
        **kw) -> AppResult:
    eng = _engine(BFS_SPEC, g, grid, proxy, device=device, **kw)
    state = eng.init_state(seed_idx=root, seed_val=0.0)
    state, run = eng.run(state, observer=observer)
    return _traversal(_values(state, g.n_rows), run, g)


def sssp(g: CSR, root: int, grid: TileGrid,
         proxy: Optional[ProxyConfig] = None, observer=None, device=None,
         **kw) -> AppResult:
    eng = _engine(SSSP_SPEC, g, grid, proxy, device=device, **kw)
    state = eng.init_state(seed_idx=root, seed_val=0.0)
    state, run = eng.run(state, observer=observer)
    return _traversal(_values(state, g.n_rows), run, g)


def wcc(g: CSR, grid: TileGrid, proxy: Optional[ProxyConfig] = None,
        symmetrize: bool = False, observer=None, device=None,
        **kw) -> AppResult:
    """Min-label propagation.  The input graph must contain both edge
    directions for weak components; RMAT graphs from ``rmat_edges``
    already do -- pass symmetrize=True otherwise."""
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
    state, run = eng.run(state, observer=observer)
    return AppResult(values=_values(state, n), run=run,
                     teps_edges=float(g.nnz))


# --------------------------------------------------------------- BSP / algebra
def pagerank(g: CSR, grid: TileGrid, proxy: Optional[ProxyConfig] = None,
             epochs: int = 10, damping: float = 0.85, observer=None,
             device=None, **kw) -> AppResult:
    """BSP PageRank: one engine drain per epoch (barrier = paper's epoch
    end, where the write-back proxy flushes).  An ``observer`` sees one
    on_run_start/on_run_end pair per epoch; spans accumulate across
    epochs (each epoch's step_lo restarts at 0)."""
    n = g.n_rows
    deg = np.maximum(g.out_degree(), 1).astype(np.float32)
    ranks = np.full(n, 1.0 / n, np.float32)
    eng = _engine(PAGERANK_SPEC, g, grid, proxy, device=device, **kw)
    total = RunResult(counters=_zero_counters(), cycles=0.0, time_s=0.0,
                      supersteps=0)
    for _ in range(epochs):
        contrib = damping * ranks / deg
        state = eng.activate_all(eng.init_state(), contrib)
        state, run = eng.run(state, observer=observer)
        if run is None:                 # a rank that holds no chip
            return AppResult(values=None, run=None, teps_edges=0.0)
        ranks = (1.0 - damping) / n + _values(state, n)
        _accumulate(total, run)
    return AppResult(values=ranks, run=total,
                     teps_edges=float(g.nnz) * epochs)


def spmv(a: CSR, x: np.ndarray, grid: TileGrid,
         proxy: Optional[ProxyConfig] = None, observer=None, device=None,
         **kw) -> AppResult:
    """y = A @ x.  The reduction onto y rows is the proxied task (the
    paper's formulation)."""
    eng, state, _ = engine_and_state("spmv", a, grid, proxy,
                                     x=np.asarray(x, np.float32),
                                     device=device, **kw)
    state, run = eng.run(state, observer=observer)
    return AppResult(values=_values(state, a.n_rows), run=run,
                     teps_edges=float(a.nnz))


def histogram(values: np.ndarray, bins: int, grid: TileGrid,
              proxy: Optional[ProxyConfig] = None, observer=None,
              device=None, **kw) -> AppResult:
    """Count values into bins (paper: E elements filtered into V/8
    bins)."""
    eng, state, _ = engine_and_state("histo", None, grid, proxy,
                                     histo_values=values, bins=bins,
                                     device=device, **kw)
    state, run = eng.run(state, observer=observer)
    return AppResult(values=_values(state, bins), run=run,
                     teps_edges=float(np.asarray(values).shape[0]))


APPS = dict(bfs=bfs, sssp=sssp, wcc=wcc, pagerank=pagerank, spmv=spmv,
            histo=histogram)
# every app runs on the distributed engine (``chips > 1``); the product
# search's chips axis measures any of them
DISTRIBUTED_APPS = frozenset(APPS)


def _zero_counters() -> TrafficCounters:
    return TrafficCounters()


def _accumulate(total: RunResult, run: RunResult) -> None:
    total.counters.add(run.counters)
    total.cycles += run.cycles
    total.time_s += run.time_s
    total.supersteps += run.supersteps
    if run.trace is not None:
        if total.trace is None:
            total.trace = SuperstepTrace()
        total.trace.extend(run.trace)
