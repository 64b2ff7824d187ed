"""Matrix runner: every analysis pass over the app/backend/partition grid.

The counterpart of ``repro.analysis.runner``.  One :func:`run_all` call
produces the :class:`~.findings.Report` that
``scripts/lint_engine_torch.py`` serializes and gates on.  The matrix is
the six paper apps x {torch, kernels} x {monolithic, 4-chip, 4-chip
double-buffered, monolithic with compaction=2, 4-chip double-buffered
with compaction=2}: 60 cells.  The reference's Pallas cells are
monolithic only; the port's kernels run on partitions, so both backends
take every row.  The inputs are the reference's (``runner.py``: RMAT
scale 7, edge factor 4, seed 2 on ``square_grid(16)``, ``oq_cap=16``,
the Table-II proxies, SpMV with a one-level cascade, PageRank two
epochs):

  * **steplint** walks one superstep of each cell on both loops (every
    window of a compaction cell, the flush step of a write-back one)
    and checks the cell's run for bucket coverage; per app it also
    compares the two backends' step shapes (``backend-dtype-drift``);
  * **invariants** checks each cell's run (``invariants.check_run``:
    counter conservation, trace sanity, monotone frontier, reprice
    ratio 1);
  * **kernel_races** runs every kernel's cases in three orders, three
    times each (once, not per cell);
  * **deadcode** reports unreachable modules (repo-wide: once).

Each cell runs on ``device`` (default the card; ``"cpu"`` for the CPU,
where the kernels backend runs the kernels' plain versions).
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence

import numpy as np

from .. import device as _device
from . import deadcode, invariants, kernel_races, steplint
from .findings import Finding, Report

APP_NAMES = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
BACKENDS = ("torch", "kernels")
PASSES = ("steplint", "invariants", "kernel_races", "deadcode")
# (chips, double_buffer, compaction) of each row, for every backend
MATRIX = ((0, False, 0), (4, False, 0), (4, True, 0), (0, False, 2),
          (4, True, 2))
_SCALE = 7          # tiny RMAT: 128 vertices, a few supersteps an app


def _inputs():
    from ..core.tilegrid import square_grid
    from ..graph import rmat
    g = rmat.rmat_edges(_SCALE, edge_factor=4, seed=2)
    grid = square_grid(16)
    root = int(np.argmax(g.out_degree()))
    bins = max(g.n_rows // 8, 1)
    hv = rmat.histogram_input(g, bins)
    return g, grid, root, bins, hv


def _proxy_for(name, grid):
    from ..graph import apps
    if name == "bfs":
        return None                        # direct routing (Table II)
    if name == "spmv":
        return apps.table2_proxy(grid, "spmv", cascade_levels=1)
    return apps.table2_proxy(grid, name)


def cell_name(name: str, backend: str, chips: int, double_buffer: bool,
              compaction: int) -> str:
    part = f"{chips}chips" if chips else "mono"
    if double_buffer:
        part += "-db"
    if compaction:
        part += f"-c{compaction}"
    return f"{name}/{backend}/{part}"


def _cell_engine(name, backend, chips, inputs, device, double_buffer=False,
                 compaction=0):
    """(engine, state, seeds) for one matrix cell (no run executed)."""
    from ..graph import apps
    g, grid, root, bins, hv = inputs
    return apps.engine_and_state(
        name, g, grid, proxy=_proxy_for(name, grid), root=root,
        histo_values=hv, bins=bins, backend=backend, chips=chips,
        oq_cap=16, double_buffer=double_buffer, compaction=compaction,
        device=device)


def _run_app(name, backend, chips, inputs, device, observer,
             double_buffer=False, compaction=0):
    """Run one cell's app; returns (RunResult, seeds)."""
    from ..graph import apps
    g, grid, root, bins, hv = inputs
    proxy = _proxy_for(name, grid)
    kw = dict(backend=backend, oq_cap=16, double_buffer=double_buffer,
              compaction=compaction, device=device, observer=observer)
    if chips:
        kw["chips"] = chips
    if name == "bfs":
        return apps.bfs(g, root, grid, **kw).run, 1
    if name == "sssp":
        return apps.sssp(g, root, grid, proxy=proxy, **kw).run, 1
    if name == "wcc":
        return apps.wcc(g, grid, proxy=proxy, **kw).run, g.n_rows
    if name == "pagerank":
        return apps.pagerank(g, grid, proxy=proxy, epochs=2, **kw).run, 0
    if name == "spmv":
        x = np.random.default_rng(3).random(g.n_cols).astype(np.float32)
        return apps.spmv(g, x, grid, proxy=proxy, **kw).run, 0
    if name == "histo":
        return apps.histogram(hv, bins, grid, proxy=proxy, **kw).run, 0
    raise ValueError(name)


class _Clock:
    """Seconds by part, summed into ``seconds`` (a dict) when given."""

    def __init__(self, seconds: Optional[dict]):
        self.seconds = seconds

    @contextlib.contextmanager
    def __call__(self, part: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.seconds is not None:
                self.seconds[part] = (self.seconds.get(part, 0.0)
                                      + time.perf_counter() - t0)


def run_cell(name, backend, chips, inputs, device, where: str,
             passes: Sequence[str], double_buffer=False, compaction=0,
             seconds: Optional[dict] = None) -> List[Finding]:
    """One cell: the steplint walk of its first superstep, then its run,
    held to bucket coverage (steplint) and ``check_run`` (invariants).
    ``seconds`` sums the time of each part: ``steplint`` (the walk and
    the coverage check), ``run`` (the app call), ``invariants``."""
    clock = _Clock(seconds)
    findings: List[Finding] = []
    if "steplint" in passes:
        with clock("steplint"):
            eng, state, _ = _cell_engine(name, backend, chips, inputs,
                                         device, double_buffer, compaction)
            findings += steplint.lint_steps(eng, state, where)[0]
            del eng, state
    rec = steplint.RunRecord()
    with clock("run"), rec:
        run, seeds = _run_app(name, backend, chips, inputs, device, rec,
                              double_buffer, compaction)
    if "steplint" in passes:
        with clock("steplint"):
            findings += steplint.lint_bucket_coverage(
                rec, inputs[1].num_tiles // max(chips, 1), compaction,
                where, on_card=device.type == "cuda")
    if "invariants" in passes:
        proxy = _proxy_for(name, inputs[1])
        from ..core.costmodel import DCRA_SRAM
        with clock("invariants"):
            findings += invariants.check_run(
                run, pkg=DCRA_SRAM, grid=inputs[1], where=where,
                write_back=proxy is not None and proxy.write_back,
                seeds=seeds)
    return findings


def drift_cell(name, inputs, device, where: str) -> List[Finding]:
    """torch-vs-kernels shape/dtype drift of one app's dense superstep."""
    shapes = {}
    for backend in BACKENDS:
        eng, state, _ = _cell_engine(name, backend, 0, inputs, device)
        shapes[backend] = steplint.step_shapes(eng, state)
    return steplint.lint_backend_drift(shapes["torch"], shapes["kernels"],
                                       where)


def run_all(repo_root, app_names: Optional[Sequence[str]] = None,
            passes: Optional[Sequence[str]] = None, progress=None,
            device=None, backends: Optional[Sequence[str]] = None,
            seconds: Optional[dict] = None) -> Report:
    """Run the selected passes over the whole matrix -> :class:`Report`.

    ``passes`` defaults to all of :data:`PASSES`; ``backends`` to both
    engine backends; ``device`` is resolved by ``device.resolve`` (the
    card, raising without one, unless given ``"cpu"``).  ``progress`` is
    an optional ``callable(str)`` for CLI progress lines; ``seconds``, a
    dict, receives the seconds of each part (``run_cell``'s, ``drift``,
    ``kernel_races``, ``deadcode``)."""
    clock = _Clock(seconds)
    dev = _device.resolve(device)
    apps_sel = tuple(app_names or APP_NAMES)
    passes_sel = tuple(passes or PASSES)
    backends_sel = tuple(backends or BACKENDS)
    for p in passes_sel:
        if p not in PASSES:
            raise ValueError(f"unknown pass {p!r}: one of {PASSES}")
    say = progress or (lambda _msg: None)
    report = Report(passes=list(passes_sel))
    inputs = _inputs()
    cell_passes = [p for p in passes_sel if p in ("steplint", "invariants")]

    for name in apps_sel:
        for backend in backends_sel:
            for chips, db, comp in MATRIX:
                where = cell_name(name, backend, chips, db, comp)
                report.matrix.append(where)
                if cell_passes:
                    say(f"{'+'.join(cell_passes)} {where}")
                    report.extend(run_cell(name, backend, chips, inputs,
                                           dev, where, cell_passes, db,
                                           comp, seconds))
        if "steplint" in passes_sel:
            say(f"backend-drift {name}")
            with clock("drift"):
                report.extend(drift_cell(name, inputs, dev,
                                         f"{name}/drift"))

    if "kernel_races" in passes_sel:
        say(f"kernel_races kernel suite ({dev.type})")
        with clock("kernel_races"):
            report.extend(kernel_races.check_kernels(dev))
    if "deadcode" in passes_sel:
        say("deadcode import graph")
        with clock("deadcode"):
            dc, _meta = deadcode.check_repo(repo_root)
        report.extend(dc)
    return report
