"""The port's active-set compaction on a partition (``compaction=L`` with
``chips > 1``) against the JAX reference's and against the port's own
dense runs (the counterpart of ``tests/test_compaction.py``'s 4-chip
cases).

RMAT-8 on 4x4 tiles at 4 chips (2x2 tiles a chip), ``compaction=2``,
``oq_cap=8``, the reference test's Table-II proxies:

  * the per-chip ladder (``capacity_ladder(Tl, L)``) and the per-chip
    lanes of a window (each chip's active tiles in local order, then its
    inactive ones; window position ``chip * Tl + local``);
  * each of the six apps compacted equals its dense run on the same
    loop and exchange, for (``run_chunk``, ``double_buffer``) in (0,
    False), (8, False), (8, True), and (0, True) for SSSP and
    Histogram: values bitwise, counters, trace, supersteps, ``time_s``;
  * each of the six apps compacted, synchronous and double-buffered,
    with telemetry, the sanitizer and a ``TimelineRecorder``, on both
    loops, equals the reference's same run: counters, trace, supersteps and ``time_s``
    exactly, min apps bitwise, add apps within rtol 1e-4 / atol 1e-5;
    every superstep's ``active_tiles`` (summed over the chips) and
    ``bucket_cap`` (the busiest chip's rung), every per-chip ``pc_*``
    load vector, and no sanitizer violation;
  * the chunked loop picks each chunk's per-chip window from the
    busiest chip's count, and ``engine.window_occupancy.<W>`` counts
    the supersteps by per-chip W.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs
from repro.core.tilegrid import square_grid as jsquare_grid
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges
from repro.graph.rmat import histogram_input as jhistogram_input

from repro_torch import obs
from repro_torch.core import chunk as tchunk
from repro_torch.core import engine
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.obs.metrics import default_registry

TILES = 16
CHIPS = 4
TL = TILES // CHIPS
LEVELS = 2
RTOL, ATOL = 1e-4, 1e-5
ALL_APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
MIN_APPS = ("bfs", "sssp", "wcc")
HOOKS = dict(telemetry=True, sanitize=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: beside other test workers, many-threaded ops
    wait on threads that are not scheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    g, gj = (rmat_edges(8, edge_factor=8, seed=1),
             jrmat_edges(8, edge_factor=8, seed=1))
    bins = g.n_rows // 8
    return dict(g=g, gj=gj, bins=bins, root=int(np.argmax(g.out_degree())),
                x=np.random.default_rng(3).random(g.n_cols).astype(
                    np.float32),
                hv=histogram_input(g, bins), hvj=jhistogram_input(gj, bins))


def _run(name, inp, chunk, jax_side=False, tiles=TILES, **kw):
    """One app call as ``tests/test_compaction.py``'s ``_run`` makes it,
    at 4 chips."""
    pkg, sq = (japps, jsquare_grid) if jax_side else (apps, square_grid)
    if not jax_side:
        kw["device"] = "cpu"
    grid = sq(tiles)
    g = inp["gj" if jax_side else "g"]
    kw.update(oq_cap=8, run_chunk=chunk, chips=CHIPS)
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


def _same_run(r, want, values_exact, what):
    a, b = r.run.counters.as_dict(), want.run.counters.as_dict()
    assert a == b, (what, {k: (a[k], b[k]) for k in a if a[k] != b[k]})
    assert r.run.trace.to_dict() == want.run.trace.to_dict(), what
    assert r.run.supersteps == want.run.supersteps, what
    assert r.run.time_s == want.run.time_s, what
    if values_exact:
        assert np.array_equal(r.values, np.asarray(want.values)), what
    else:
        np.testing.assert_allclose(r.values, np.asarray(want.values),
                                   rtol=RTOL, atol=ATOL, err_msg=what)


# ----------------------------------------------------- ladder and lanes
def test_per_chip_ladder(inputs):
    eng, _, _ = apps.engine_and_state("bfs", inputs["g"], square_grid(64),
                                      root=inputs["root"], chips=CHIPS,
                                      compaction=3, device="cpu")
    k = eng.kernel
    assert k._ladder == engine.capacity_ladder(16, 3) == (16, 4, 1)
    assert k._window(0) == 1 and k._window(4) == 4 and k._window(5) is None


@pytest.mark.parametrize("seed", range(6))
def test_window_lanes_per_chip(seed):
    """Each chip's W lanes are the 1-D lanes of its own row, offset by
    ``chip * Tl``: distinct window positions, active ones first, in the
    dense stream's order."""
    C, Tl, W = 4, 16, 4
    rng = np.random.default_rng(seed)
    act = np.zeros((C, Tl), bool)
    for c in range(C):
        n = int(rng.integers(0, W + 1))
        act[c, rng.choice(Tl, n, replace=False)] = True
    lanes = engine._window_lanes(torch.from_numpy(act), W, Tl).numpy()
    assert lanes.shape == (C * W,)
    for c in range(C):
        one = engine._window_lanes(torch.from_numpy(act[c]), W, Tl).numpy()
        assert np.array_equal(lanes[c * W:(c + 1) * W], one + c * Tl)
        n = int(act[c].sum())
        assert np.array_equal(one[:n], np.flatnonzero(act[c]))
    assert len(set(lanes.tolist())) == C * W


# ------------------------------------------------- compacted vs dense
_CACHE = {}


def _dense(inp, name, chunk, db):
    key = (name, chunk, db)
    if key not in _CACHE:
        _CACHE[key] = _run(name, inp, chunk, double_buffer=db)
    return _CACHE[key]


@pytest.mark.parametrize("chunk,db", ((0, False), (8, False), (8, True)))
@pytest.mark.parametrize("name", ALL_APPS)
def test_4chip_compacted_matches_dense(inputs, name, chunk, db):
    comp = _run(name, inputs, chunk, double_buffer=db, compaction=LEVELS)
    _same_run(comp, _dense(inputs, name, chunk, db), True,
              f"{name}/4chip/chunk{chunk}/db{int(db)}")


@pytest.mark.parametrize("name", ("sssp", "histo"))
def test_4chip_db_chunk0_compacted_matches_dense(inputs, name):
    """The (per-step loop, double_buffer) corner: the overlap priced, the
    exchange synchronous."""
    comp = _run(name, inputs, 0, double_buffer=True, compaction=LEVELS)
    _same_run(comp, _dense(inputs, name, 0, True), True,
              f"{name}/4chip/chunk0/db1")


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("db", (False, True), ids=("sync", "db"))
@pytest.mark.parametrize("name", ALL_APPS)
def test_compacted_matches_reference(inputs, name, db):
    jrec = jobs.TimelineRecorder()
    kw = dict(double_buffer=db, compaction=LEVELS, **HOOKS)
    want = _run(name, inputs, 8, jax_side=True, observer=jrec, **kw)
    for chunk in (8, 0):
        rec = obs.TimelineRecorder()
        got = _run(name, inputs, chunk, observer=rec, **kw)
        what = f"{name} run_chunk={chunk} double_buffer={db}"
        _same_run(got, want, name in MIN_APPS, what)
        assert got.run.counters.off_chip_msgs > 0, what
        for key in engine.COMPACTION_KEYS + ("pending", "messages",
                                             "sanity_violations"):
            assert np.array_equal(rec.stat_matrix(key),
                                  jrec.stat_matrix(key)), (what, key)
        assert not np.any(rec.stat_matrix("sanity_violations")), what
        caps = rec.stat_matrix("bucket_cap")
        assert set(caps.tolist()) <= set(engine.capacity_ladder(TL, LEVELS))
        assert rec.vec_keys() == jrec.vec_keys(), what
        for key in jrec.vec_keys():
            assert np.array_equal(rec.vec_matrix(key),
                                  jrec.vec_matrix(key)), (what, key)


# ------------------------------------------------- the chunk's window
def test_chunk_window_from_the_busiest_chip(inputs, monkeypatch):
    """On 8x8 tiles (4x4 a chip: windows of 16, 4 and 1 lanes), each
    chunk after the first (dense) runs in the per-chip window that holds
    ``CHUNK_HEADROOM`` times the busiest chip's active tiles the
    previous fetch counted, and ``engine.window_occupancy.<W>``, W per
    chip, counts every superstep."""
    tiles, tl = 64, 16
    windows, counts = [], []
    launch, fetch = tchunk.ChunkRunner.launch, tchunk.ChunkRunner.fetch

    def launched(self, left, flush, window=None):
        windows.append(window)
        return launch(self, left, flush, window)

    def fetched(self):
        got = fetch(self)
        st = self.state
        active = (torch.any(st["mail_flag"].reshape(tiles, -1), dim=1)
                  | torch.any((st["cur_hi"] > st["cur_lo"])
                              .reshape(tiles, -1), dim=1))
        per_chip = torch.sum(active.reshape(CHIPS, tl), dim=1)
        assert got.active_tiles == int(torch.max(per_chip))
        counts.append(got.active_tiles)
        return got

    monkeypatch.setattr(tchunk.ChunkRunner, "launch", launched)
    monkeypatch.setattr(tchunk.ChunkRunner, "fetch", fetched)
    reg = default_registry()
    ladder = engine.capacity_ladder(tl, LEVELS)
    occ = [reg.counter(f"engine.window_occupancy.{c}") for c in ladder]
    occ0 = [c.value for c in occ]
    r = _run("sssp", inputs, 4, tiles=tiles, compaction=LEVELS,
             double_buffer=True)
    want = [None] + [
        min(c for c in ladder if c >= min(n * engine.CHUNK_HEADROOM, tl))
        for n in counts[:-1]]
    assert windows == [None if w == tl else w for w in want]
    assert 4 in windows          # a busiest chip of one active tile
    assert sum(c.value for c in occ) - sum(occ0) == r.run.supersteps
