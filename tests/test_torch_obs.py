"""The port's observability and runtime sanitizer against the JAX
reference's (the counterpart of ``tests/test_obs.py`` and of the
sanitizer tests in ``tests/test_analysis.py``).

RMAT-8 on 16 tiles, the six apps under their Table-II proxies, as
``tests/test_obs.py`` runs them:

  * chunked (K = 8) with ``telemetry=True, sanitize=True`` and a
    ``TimelineRecorder``, the port's recorder equals the reference's:
    span boundaries (for the write-through apps: a write-back app's
    chunk ends where the device schedules a flush, which the reference
    runs inside the same scan, so there the spans only tile the same
    supersteps), ``stat_matrix`` of every scalar stat (exact, as
    f64), ``vec_matrix`` of ``tv_edges``, ``tv_records`` and
    ``tv_delivered`` (exact) and ``RunMeta`` apart from ``backend``;
  * the hooks-on run equals the port's hooks-off run: values bitwise
    (min apps) or within rtol 1e-4 / atol 1e-5 (add apps,
    ``tests/test_torch_addapps.py``'s tolerance); counters, trace,
    supersteps and ``time_s`` exact; ``engine.host_syncs`` equal;
  * the same with ``compaction=2`` on both loops, against the
    reference's compacted telemetry (its (T,) renderings);
  * the per-step loop gives one span per superstep with (1, T) vectors;
  * ``obs.imbalance``, ``obs.report`` and ``obs.export`` give the
    reference's numbers on the same recorded data;
  * the sanitizer: bit-identical to off, a planted NaN raises
    ``SanitizerError`` on both loops, ``check_run`` gives the
    reference's findings, the progress line carries the count, and a
    value the drain raises in one active tile raises, dense and
    compacted, on both loops (a compacted chunk writes its window's
    values back in place, so the check must look before the write).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs
from repro.analysis import invariants as jinv
from repro.core.tilegrid import square_grid as jsquare_grid
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges
from repro.graph.rmat import histogram_input as jhistogram_input
from repro.obs import export as jexport

from repro_torch import obs
from repro_torch.analysis import findings, invariants
from repro_torch.core import engine
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.obs import export, imbalance, report
from repro_torch.obs.metrics import default_registry

TILES = 16
CHUNK = 8
RTOL, ATOL = 1e-4, 1e-5
ALL_APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
MIN_APPS = ("bfs", "sssp", "wcc")
HOOKS = dict(telemetry=True, sanitize=True)


@pytest.fixture(scope="module")
def inputs():
    g, gj = (rmat_edges(8, edge_factor=8, seed=1),
             jrmat_edges(8, edge_factor=8, seed=1))
    bins = g.n_rows // 8
    return dict(g=g, gj=gj, bins=bins, root=int(np.argmax(g.out_degree())),
                x=np.random.default_rng(3).random(g.n_cols).astype(
                    np.float32),
                hv=histogram_input(g, bins), hvj=jhistogram_input(gj, bins))


def _run(name, inp, jax_side=False, **kw):
    """One app call at ``tests/test_obs.py``'s sizes (Table-II proxies)."""
    pkg, sq = (japps, jsquare_grid) if jax_side else (apps, square_grid)
    if not jax_side:
        kw["device"] = "cpu"
    kw.setdefault("run_chunk", CHUNK)
    grid = sq(TILES)
    g = inp["gj" if jax_side else "g"]
    if name == "bfs":
        return pkg.bfs(g, inp["root"], grid, oq_cap=16, **kw)
    if name == "histo":
        return pkg.histogram(inp["hvj" if jax_side else "hv"], inp["bins"],
                             grid, proxy=pkg.table2_proxy(grid, "histo"),
                             oq_cap=8, **kw)
    px = pkg.table2_proxy(grid, name,
                          **({"cascade_levels": 1} if name == "spmv" else {}))
    if name == "sssp":
        return pkg.sssp(g, inp["root"], grid, proxy=px, oq_cap=16, **kw)
    if name == "wcc":
        return pkg.wcc(g, grid, proxy=px, oq_cap=16, **kw)
    if name == "pagerank":
        return pkg.pagerank(g, grid, proxy=px, epochs=2, oq_cap=16, **kw)
    return pkg.spmv(g, inp["x"], grid, proxy=px, oq_cap=16, **kw)


def _syncs() -> float:
    return default_registry().counter("engine.host_syncs").value


_CACHE = {}


def _reference(inp, name, compaction=0):
    """The reference's recorded run with every hook on (chunked; its two
    loops record the same per-superstep rows), once per module."""
    key = (name, compaction)
    if key not in _CACHE:
        rec = jobs.TimelineRecorder()
        res = _run(name, inp, jax_side=True, compaction=compaction,
                   observer=rec, **HOOKS)
        _CACHE[key] = (rec, res)
    return _CACHE[key]


def _port(inp, name, hooks: bool, **kw):
    """The port's run with every hook on (recorder returned) or off, and
    the host syncs it made."""
    rec = obs.TimelineRecorder() if hooks else None
    extra = dict(HOOKS, observer=rec) if hooks else {}
    s0 = _syncs()
    res = _run(name, inp, **kw, **extra)
    return res, rec, _syncs() - s0


def _same_run(r, want, name):
    a, b = r.run.counters.as_dict(), want.run.counters.as_dict()
    assert a == b, {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert r.run.trace.to_dict() == want.run.trace.to_dict()
    assert r.run.supersteps == want.run.supersteps
    assert r.run.time_s == want.run.time_s
    if name in MIN_APPS:
        assert np.array_equal(r.values, want.values)
    else:
        np.testing.assert_allclose(r.values, want.values, rtol=RTOL,
                                   atol=ATOL)


def _same_recording(rec, jrec, bounds: bool = True):
    """Every per-superstep stat and load vector equal; the spans'
    boundaries equal too where ``bounds``, else the spans tile the same
    supersteps in order (each epoch's first span starts at 0)."""
    spans = [(s.index, s.step_lo, s.step_hi) for s in rec.spans]
    if bounds:
        assert spans == [(s.index, s.step_lo, s.step_hi) for s in jrec.spans]
    for (i, lo, hi), (_, _, prev_hi) in zip(spans[1:], spans[:-1]):
        assert lo == (prev_hi if i else 0) and hi >= lo
    keys = {k for s in jrec.spans for k in s.stats}
    assert {k for s in rec.spans for k in s.stats} == keys
    for k in sorted(keys):
        assert np.array_equal(rec.stat_matrix(k), jrec.stat_matrix(k)), k
    assert rec.vec_keys() == jrec.vec_keys() == [
        "tv_delivered", "tv_edges", "tv_records"]
    for k in jrec.vec_keys():
        assert np.array_equal(rec.vec_matrix(k), jrec.vec_matrix(k)), k
    a, b = rec.meta, jrec.meta
    for f in ("app", "grid_ny", "grid_nx", "n_chips", "chips_y", "chips_x",
              "sanitize", "telemetry", "n_devices"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.backend == "kernels"
    assert a.chunk == (b.chunk if bounds else a.chunk)


# ------------------------------------------------- recorder vs reference
@pytest.mark.parametrize("name", ALL_APPS)
def test_recorder_equals_reference(inputs, name):
    jrec, jres = _reference(inputs, name)
    res, rec, _ = _port(inputs, name, hooks=True)
    _same_recording(rec, jrec, bounds=name in MIN_APPS)
    _same_run(res, jres, name)
    assert rec.result is res.run or name == "pagerank"


@pytest.mark.parametrize("name", ALL_APPS)
def test_hooks_on_equal_hooks_off(inputs, name):
    off, _, syncs_off = _port(inputs, name, hooks=False)
    on, rec, syncs_on = _port(inputs, name, hooks=True)
    _same_run(on, off, name)
    assert syncs_on == syncs_off, "the hooks added host syncs"
    assert rec.spans and rec.meta.sanitize and rec.meta.telemetry
    if name != "pagerank":            # pagerank: one span set per epoch
        assert rec.supersteps == on.run.supersteps
    assert obs.run_load_matrix(rec).shape[1] == TILES
    c = on.run.counters            # the load vectors sum to the counters
    assert rec.vec_matrix("tv_delivered").sum() == c.owner_msgs
    assert rec.vec_matrix("tv_edges").sum() == c.edges_processed
    assert rec.vec_matrix("tv_records").sum() == c.records_consumed


@pytest.mark.parametrize("chunk", [0, CHUNK])
@pytest.mark.parametrize("name", ALL_APPS)
def test_compacted_recorder_equals_reference(inputs, name, chunk):
    jrec, jres = _reference(inputs, name, compaction=2)
    off, _, syncs_off = _port(inputs, name, hooks=False, run_chunk=chunk,
                              compaction=2)
    res, rec, syncs_on = _port(inputs, name, hooks=True, run_chunk=chunk,
                               compaction=2)
    _same_recording(rec, jrec, bounds=chunk and name in MIN_APPS)
    assert rec.meta.chunk == chunk
    _same_run(res, jres, name)
    _same_run(res, off, name)
    assert syncs_on == syncs_off


def test_per_step_loop_emits_one_span_per_superstep(inputs):
    res, rec, syncs = _port(inputs, "bfs", hooks=True, run_chunk=0)
    assert len(rec.spans) == res.run.supersteps == syncs
    assert all(s.n_steps == 1 for s in rec.spans)
    assert [s.step_lo for s in rec.spans] == list(range(res.run.supersteps))
    for s in rec.spans:
        assert set(s.vecs) == set(engine.TELEMETRY_KEYS)
        assert all(v.shape == (1, TILES) for v in s.vecs.values())
        assert all(v.shape == (1,) for v in s.stats.values())
    assert rec.meta.chunk == 0 and rec.supersteps == res.run.supersteps


# -------------------------------------------- imbalance, report, export
def test_imbalance_and_report_equal_reference(inputs):
    jrec, _ = _reference(inputs, "spmv")
    _, rec, _ = _port(inputs, "spmv", hooks=True)
    base = _run("spmv", inputs).run.counters
    jbase = _run("spmv", inputs, jax_side=True).run.counters
    assert (imbalance.imbalance_report(rec, base)
            == jobs.imbalance_report(jrec, jbase))
    a, b = report.run_report(rec), jobs.run_report(jrec)
    for k in ("wall", "metrics", "backend"):
        a.pop(k), b.pop(k)
    assert a == b
    assert "Load imbalance" in report.to_markdown(report.run_report(rec))


def test_imbalance_functions_equal_reference():
    rng = np.random.default_rng(7)
    load = rng.integers(0, 50, (40, 16)).astype(np.float64)
    load[5] = 0.0
    load[9, 3] = 500.0
    assert (imbalance.summarize(load, top=4)
            == jobs.summarize(load, top=4))
    for row in list(load) + [np.zeros(3), np.ones(5), np.array([])]:
        assert imbalance.gini(row) == jobs.gini(row)
        assert imbalance.max_over_mean(row) == jobs.max_over_mean(row)
    for got, base in ((120.0, 300.0), (300.0, 300.0), (5.0, 0.0)):
        assert (imbalance.cascade_efficacy(got, base)
                == jobs.cascade_efficacy(got, base))
    assert (imbalance.summarize(np.zeros((0, 0)))
            == jobs.summarize(np.zeros((0, 0))))


@pytest.mark.parametrize("compaction", [0, 2])
def test_trace_events_equal_reference(inputs, compaction, tmp_path):
    jrec, _ = _reference(inputs, "bfs", compaction)
    _, rec, _ = _port(inputs, "bfs", hooks=True, compaction=compaction)
    got, want = export.to_trace_events(rec), jexport.to_trace_events(jrec)
    # the simulated clock, the load counters and the compaction track
    sim = [e for e in got if e["pid"] != export.PID_HOST]
    assert sim == [e for e in want if e["pid"] != jexport.PID_HOST]
    assert any(e["ph"] == "C" for e in sim)
    assert (any(e.get("name") == "active_fraction" for e in sim)
            == bool(compaction))
    # wall-clock spans: names and count only
    names = sorted(e["name"] for e in got if e["pid"] == export.PID_HOST)
    assert names == sorted(e["name"] for e in want
                           if e["pid"] == jexport.PID_HOST)
    import json
    back = json.loads(open(export.write_trace(rec, str(tmp_path / "t.json")))
                      .read())
    assert len(back["traceEvents"]) == len(got)
    assert back["otherData"]["backend"] == "kernels"


# ------------------------------------------------------------- sanitizer
@pytest.mark.parametrize("name", ALL_APPS)
def test_sanitize_is_bit_identical(inputs, name):
    off = _run(name, inputs)
    on = _run(name, inputs, sanitize=True)
    _same_run(on, off, name)


def _bfs_engine(inputs, tiles=TILES, oq_cap=16, **kw):
    return apps.engine_and_state("bfs", inputs["g"], square_grid(tiles),
                                 root=inputs["root"], oq_cap=oq_cap,
                                 device="cpu", sanitize=True, **kw)


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_planted_nan_raises(inputs, chunk):
    eng, state, _ = _bfs_engine(inputs)
    state["values"][3] = float("nan")
    with pytest.raises(invariants.SanitizerError, match="on-device"):
        eng.run(state, chunk=chunk)


@pytest.mark.parametrize("compaction", [0, 3])
@pytest.mark.parametrize("chunk", [0, 4])
def test_raised_value_in_an_active_tile_raises(inputs, chunk, compaction,
                                               monkeypatch):
    """A drain that raises one finite value of one active tile (the
    first tile with a mailbox flag and a finite value) raises
    ``SanitizerError``: dense and, in a window only, compacted, on both
    loops.  A compacted chunk writes its window's values back in place
    before the step returns.  256 tiles at ``oq_cap=4``: both loops run
    windows of 64 and 16 tiles there."""
    tiles = 256
    front_rows = engine.DataLocalEngine._front_rows
    raised = []

    def raising(self, n, values, mail_val, mail_flag, *rest):
        out = front_rows(self, n, values, mail_val, mail_flag, *rest)
        hit = (torch.isfinite(values).reshape(n, -1)
               & mail_flag.reshape(n, -1).any(dim=1, keepdim=True))
        if (n < tiles or not compaction) and bool(hit.any()):
            i = int(torch.nonzero(hit.reshape(-1))[0])
            new_vals = out[0].clone()
            new_vals[i] = values[i] + 1.0
            raised.append(n)
            return (new_vals,) + out[1:]
        return out

    monkeypatch.setattr(engine.DataLocalEngine, "_front_rows", raising)
    eng, state, _ = _bfs_engine(inputs, tiles=tiles, oq_cap=4,
                                compaction=compaction)
    with pytest.raises(invariants.SanitizerError, match="on-device"):
        eng.run(state, chunk=chunk)
    assert raised and (max(raised) < tiles) == bool(compaction)


def test_check_run_equals_reference(inputs):
    res = _run("spmv", inputs)
    jres = _run("spmv", inputs, jax_side=True)
    grid, jgrid = square_grid(TILES), jsquare_grid(TILES)
    from repro.core.costmodel import DCRA_SRAM as JDCRA_SRAM
    from repro_torch.core.costmodel import DCRA_SRAM

    def both(mutate=None):
        for r in (res, jres):
            r.run.counters = type(r.run.counters)(
                **r.run.counters.as_dict())
            if mutate:
                mutate(r.run.counters)
        got = invariants.check_run(res.run, pkg=DCRA_SRAM, grid=grid,
                                   where="spmv", write_back=True)
        want = jinv.check_run(jres.run, pkg=JDCRA_SRAM, grid=jgrid,
                              where="spmv", write_back=True)
        assert [f.as_dict() for f in got] == [f.as_dict() for f in want]
        return got

    assert both() == []

    def corrupt(c):
        c.owner_msgs += c.edges_processed
        c.hop_msgs += 0.5
        c.records_consumed += 10 ** 9
    bad = both(corrupt)
    assert {f.rule for f in bad} >= {"owner-conservation", "counter-nonint",
                                     "hop-decomposition", "consumed-bound"}
    with pytest.raises(invariants.SanitizerError, match="invariant"):
        invariants.assert_clean(bad, context="corrupted")
    assert findings.summarize(bad) == jinv.summarize(
        [jinv.Finding(**f.as_dict()) for f in bad])


def test_sanitize_progress_line_reports_violations(inputs, capsys):
    eng, state, _ = _bfs_engine(inputs)
    eng.run(state, progress_every=5, chunk=4)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "step " in ln]
    assert lines
    assert all("sanity_violations=0" in ln for ln in lines)
