"""The port's active-set compaction (``EngineConfig.compaction``) against
the JAX reference's and against the port's own dense runs (the
counterpart of ``tests/test_compaction.py``).

  * ``capacity_ladder``, ``bucket_index`` (at, just under and just over
    every rung) and ``_compact_window`` equal the reference's on the same
    numpy masks, and ``_window_lanes`` fills the free slots with distinct
    inactive tiles;
  * a compacted run of each of the six apps, on the per-step loop
    (``chunk=0``) and the chunked loop (``chunk=4``), equals the
    reference's compacted run (min apps bitwise; add apps with exact
    counters, trace, supersteps and ``time_s``, values to rtol 1e-4 /
    atol 1e-5, ``tests/test_torch_addapps.py``'s tolerance) and the
    port's own dense run on the same loop bitwise; so does BFS and SpMV
    on the ``kernels`` backend (the kernels' plain versions here), and
    SSSP at ``oq_cap=1``, where tiles re-enter the active set all the
    time;
  * the per-superstep ``active_tiles`` / ``bucket_cap`` stats, and the
    ``engine.bucket_occupancy`` counters, equal the reference's;
  * each chunk after the first runs in the window that holds
    ``CHUNK_HEADROOM`` times the last fetch's active tiles; a chunk whose
    window the active tiles outgrow idles its rest and the next chunk
    runs in a window that fits (``engine.window_overflows``), with the
    result unchanged;
  * host syncs: the per-step loop one a superstep, as dense; the chunked
    loop one a chunk launched, at most one more per overflow than dense.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import obs as jobs
from repro.core import engine as jengine
from repro.core.tilegrid import square_grid as jsquare_grid
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges
from repro.graph.rmat import histogram_input as jhistogram_input

from repro_torch.core import chunk as tchunk
from repro_torch.core import engine
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.obs.metrics import default_registry

TILES = 16
RTOL, ATOL = 1e-4, 1e-5
ALL_APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
MIN_APPS = ("bfs", "sssp", "wcc")


@pytest.fixture(scope="module")
def inputs():
    g, gj = (rmat_edges(8, edge_factor=8, seed=1),
             jrmat_edges(8, edge_factor=8, seed=1))
    bins = g.n_rows // 8
    return dict(g=g, gj=gj, bins=bins, root=int(np.argmax(g.out_degree())),
                x=np.random.default_rng(3).random(g.n_cols).astype(
                    np.float32),
                hv=histogram_input(g, bins), hvj=jhistogram_input(gj, bins))


def _run(name, inp, jax_side=False, oq_cap=8, **kw):
    """One app call at the reference test's sizes (Table-II proxies)."""
    pkg, sq = (japps, jsquare_grid) if jax_side else (apps, square_grid)
    if not jax_side:
        kw["device"] = "cpu"
    grid = sq(TILES)
    g = inp["gj" if jax_side else "g"]
    kw["oq_cap"] = oq_cap
    if name == "bfs":
        return pkg.bfs(g, inp["root"], grid, **kw)
    px = pkg.table2_proxy(grid, name,
                          **({"cascade_levels": 1} if name == "spmv" else {}))
    if name == "sssp":
        return pkg.sssp(g, inp["root"], grid, proxy=px, **kw)
    if name == "wcc":
        return pkg.wcc(g, grid, proxy=px, **kw)
    if name == "pagerank":
        return pkg.pagerank(g, grid, proxy=px, epochs=2, **kw)
    if name == "spmv":
        return pkg.spmv(g, inp["x"], grid, proxy=px, **kw)
    return pkg.histogram(inp["hvj" if jax_side else "hv"], inp["bins"], grid,
                         proxy=px, **kw)


_CACHE = {}


def _cached(inp, name, side, chunk=None, **kw):
    """The reference's compacted run (its default loop: the results of
    both loops are equal) with its per-superstep ``active_tiles`` /
    ``bucket_cap`` rows, or the port's dense run on one loop; once per
    module."""
    key = (name, side, chunk, tuple(sorted(kw.items())))
    if key not in _CACHE:
        if side == "reference":
            rec = jobs.TimelineRecorder()
            res = _run(name, inp, jax_side=True, compaction=2, observer=rec,
                       **kw)
            res.rows = {k: np.concatenate([s.stats[k] for s in rec.spans])
                        .astype(np.float64) for k in engine.COMPACTION_KEYS}
            _CACHE[key] = res
        else:
            _CACHE[key] = _run(name, inp, run_chunk=chunk, **kw)
    return _CACHE[key]


def _same_run(r, want, values_exact):
    a, b = r.run.counters.as_dict(), want.run.counters.as_dict()
    assert a == b, {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert r.run.trace.to_dict() == want.run.trace.to_dict()
    assert r.run.supersteps == want.run.supersteps
    assert r.run.time_s == want.run.time_s
    if values_exact:
        assert np.array_equal(r.values, want.values)
    else:
        np.testing.assert_allclose(r.values, want.values, rtol=RTOL,
                                   atol=ATOL)


# ----------------------------------------------------- ladder boundaries
@pytest.mark.parametrize("T,levels", [(1024, 3), (4096, 3), (256, 2),
                                      (16, 2), (16, 3), (4, 5), (1, 3),
                                      (256, 0)])
def test_capacity_ladder_matches_reference(T, levels):
    assert engine.capacity_ladder(T, levels) == jengine.capacity_ladder(
        T, levels)


@pytest.mark.parametrize("T,levels", [(1024, 3), (16, 2)])
def test_bucket_index_at_each_rung(T, levels):
    """At, just under and just over every rung, and at 0: the port's
    0-d tensor equals the reference's index."""
    ladder = engine.capacity_ladder(T, levels)
    counts = sorted({n for c in ladder for n in (c - 1, c, c + 1)
                     if 0 <= n <= T} | {0})
    for n in counts:
        got = engine.bucket_index(torch.tensor(n, dtype=torch.int32), ladder)
        assert got.shape == () and got.dtype == torch.int32
        assert int(got) == int(jengine.bucket_index(jnp.int32(n), ladder)), n


@pytest.mark.parametrize("n", [0, 1, 5, 11, 15, 16, 40, 64])
def test_compact_window_matches_reference(n):
    """Stable compaction of the same masks (more active tiles than slots
    included: the window takes the first W in tile order)."""
    T, W = 64, 16
    act = np.zeros(T, bool)
    act[np.sort(np.random.default_rng(n).choice(T, n, replace=False))] = True
    got = engine._compact_window(torch.from_numpy(act), W, T)
    want = jengine._compact_window(jnp.asarray(act), W, T)
    assert len(got) == 2     # (w_valid, w_rows): _window_lanes takes the
    # place of the reference's third output, its drop-mode scatter map
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [0, 1, 5, 11, 15, 16, 40, 64])
def test_window_lanes_are_distinct_rows(n):
    """The reference's valid slots, then the inactive tiles in order: W
    distinct rows whenever the active tiles fit (the write-back is one
    ``index_copy_``); the first W active tiles when they do not."""
    T, W = 64, 16
    act = np.zeros(T, bool)
    act[np.sort(np.random.default_rng(n).choice(T, n, replace=False))] = True
    lanes = engine._window_lanes(torch.from_numpy(act), W, T).numpy()
    w_valid, w_rows, _ = (np.asarray(a) for a in
                          jengine._compact_window(jnp.asarray(act), W, T))
    assert np.array_equal(lanes[w_valid], w_rows[w_valid])
    if n <= W:
        assert len(set(lanes.tolist())) == W
        assert np.array_equal(lanes[~w_valid],
                              np.flatnonzero(~act)[:W - n])
    else:
        assert np.array_equal(lanes, np.flatnonzero(act)[:W])


# ------------------------------------------------- whole-run equality
@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("name", ALL_APPS)
def test_compacted_matches_reference_and_dense(inputs, name, chunk):
    r = _run(name, inputs, run_chunk=chunk, compaction=2, backend="torch")
    _same_run(r, _cached(inputs, name, "reference"), name in MIN_APPS)
    _same_run(r, _cached(inputs, name, "port", chunk, backend="torch"),
              True)


@pytest.mark.parametrize("name", ["bfs", "spmv"])
def test_kernels_backend_compacted(inputs, name):
    r = _run(name, inputs, run_chunk=4, compaction=2)
    _same_run(r, _cached(inputs, name, "reference"), name in MIN_APPS)
    _same_run(r, _cached(inputs, name, "port", 4), True)


def test_reactivation_churn(inputs):
    """SSSP at oq_cap=1: cursors reopen and tiles re-enter the active set
    every superstep, the window choice crossing rungs many times; the
    deepest ladder."""
    kw = dict(oq_cap=1, compaction=3)
    want = _run("sssp", inputs, jax_side=True, **kw)
    dense = _run("sssp", inputs, oq_cap=1, run_chunk=4)
    for chunk in (0, 4):
        r = _run("sssp", inputs, run_chunk=chunk, **kw)
        _same_run(r, want, True)
        _same_run(r, dense, True)


# ------------------------------------------------- the stats rows
def _port_rows(inputs, name, chunk, monkeypatch):
    """The rows the port's run loop accounts: per superstep on the
    per-step loop, per chunk on the chunked loop."""
    rows = {k: [] for k in engine.COMPACTION_KEYS}
    step_counters, chunk_counters = (engine.superstep_counters,
                                     engine.chunk_counters)

    def one(stats):
        for k in rows:
            rows[k].append([stats[k]])
        return step_counters(stats)

    def many(stacked, n):
        for k in rows:
            rows[k].append(stacked[k][:n])
        return chunk_counters(stacked, n)

    monkeypatch.setattr(engine, "superstep_counters", one)
    monkeypatch.setattr(engine, "chunk_counters", many)
    _run(name, inputs, run_chunk=chunk, compaction=2)
    return {k: np.concatenate(v) for k, v in rows.items()}


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("name", ["bfs", "spmv"])
def test_active_tiles_rows_match_reference(inputs, name, chunk,
                                           monkeypatch):
    """Row for row the reference's ``active_tiles`` and ``bucket_cap``,
    whatever window the port ran the superstep in."""
    want = _cached(inputs, name, "reference").rows
    got = _port_rows(inputs, name, chunk, monkeypatch)
    for k in engine.COMPACTION_KEYS:
        assert np.array_equal(got[k], want[k]), k
    assert len(set(got["bucket_cap"].tolist())) > 1


def test_bucket_occupancy_matches_reference(inputs):
    """The chunked loop's ``engine.bucket_occupancy.<cap>`` counters count
    the supersteps of the reference's rows in each rung, and it sets
    ``engine.active_fraction``."""
    caps = engine.capacity_ladder(TILES, 2)
    counters = [default_registry().counter(f"engine.bucket_occupancy.{c}")
                for c in caps]
    before = [c.value for c in counters]
    _run("wcc", inputs, run_chunk=4, compaction=2)
    got = [c.value - b for c, b in zip(counters, before)]
    rungs = _cached(inputs, "wcc", "reference").rows["bucket_cap"]
    assert got == [float(np.sum(rungs == c)) for c in caps]
    assert len([n for n in got if n]) > 1
    # the latest chunk's mean: its value depends on where chunks end
    assert 0 < default_registry().gauge("engine.active_fraction").value <= 1


# ------------------------------------------------- overflow, host syncs
def test_chunk_overflow_keeps_the_result(inputs, monkeypatch):
    """PageRank on the chunked loop: a new epoch makes every tile active
    again inside a chunk whose window (with ``CHUNK_HEADROOM``) was sized
    for the few tiles the last epoch left, which idles the chunk's rest
    and the next chunk runs in a larger window; the result is the dense
    run's, and every window the chunks ran in counted its supersteps."""
    reg = default_registry()
    launches = []
    launch = tchunk.ChunkRunner.launch

    def counted(self, left, flush, window=None):
        launches.append(window)
        return launch(self, left, flush, window)

    monkeypatch.setattr(tchunk.ChunkRunner, "launch", counted)
    caps = engine.capacity_ladder(TILES, 2)
    occ = [reg.counter(f"engine.window_occupancy.{c}") for c in caps]
    occ0 = [c.value for c in occ]
    over, syncs = (reg.counter("engine.window_overflows"),
                   reg.counter("engine.host_syncs"))
    o0, s0 = over.value, syncs.value
    r = _run("pagerank", inputs, run_chunk=4, compaction=2)
    overflows, chunks = over.value - o0, syncs.value - s0
    assert overflows >= 1
    assert launches[0] is None                   # the first chunk: dense
    assert len(set(launches)) > 1
    assert chunks == len(launches)
    dense = _cached(inputs, "pagerank", "port", 4)
    _same_run(r, dense, True)
    assert sum(c.value for c in occ) - sum(occ0) == r.run.supersteps


@pytest.mark.parametrize("name", ["spmv", "histo"])
def test_chunk_window_has_one_rung_of_headroom(inputs, name, monkeypatch):
    """Each chunk after the first (dense) runs in the smallest window
    that holds ``CHUNK_HEADROOM`` times the active tiles the previous
    fetch counted."""
    windows, counts = [], []
    launch, fetch = tchunk.ChunkRunner.launch, tchunk.ChunkRunner.fetch

    def launched(self, left, flush, window=None):
        windows.append(window)
        return launch(self, left, flush, window)

    def fetched(self):
        got = fetch(self)
        counts.append(got.active_tiles)
        return got

    monkeypatch.setattr(tchunk.ChunkRunner, "launch", launched)
    monkeypatch.setattr(tchunk.ChunkRunner, "fetch", fetched)
    _run(name, inputs, run_chunk=4, compaction=2)
    ladder = engine.capacity_ladder(TILES, 2)
    want = [None] + [
        min(c for c in ladder if c >= min(n * engine.CHUNK_HEADROOM, TILES))
        for n in counts[:-1]]
    assert windows == [None if w == TILES else w for w in want]
    assert any(w is not None for w in windows)


@pytest.mark.parametrize("name", ["bfs", "histo"])
def test_host_syncs(inputs, name):
    """Per-step: one sync a superstep, as the dense loop.  Chunked: one a
    chunk launched, at least the dense run's chunks and at most one more
    per overflow."""
    reg = default_registry()
    syncs, over = (reg.counter("engine.host_syncs"),
                   reg.counter("engine.window_overflows"))
    s0 = syncs.value
    r = _run(name, inputs, run_chunk=0, compaction=2)
    assert syncs.value - s0 == r.run.supersteps
    s0 = syncs.value
    _run(name, inputs, run_chunk=0)
    assert syncs.value - s0 == r.run.supersteps
    s0 = syncs.value
    _run(name, inputs, run_chunk=4)
    dense_chunks = syncs.value - s0
    s0, o0 = syncs.value, over.value
    _run(name, inputs, run_chunk=4, compaction=2)
    chunks, overflows = syncs.value - s0, over.value - o0
    assert dense_chunks <= chunks <= dense_chunks + overflows
