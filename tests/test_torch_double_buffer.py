"""The port's double-buffered board exchange (``EngineConfig.double_buffer``)
against the JAX reference's and against the port's synchronous exchange
(the counterpart of ``tests/test_double_buffer.py``).

RMAT-8 on 4x4 tiles at 4 chips, the six apps under the reference test's
Table-II proxies:

  * each app on the per-step loop (``run_chunk=0``, which keeps the
    synchronous exchange and prices the overlap) and the chunked loop
    (``run_chunk=8``, which defers the exchanged mailbox values to the
    next superstep) equals the reference's double-buffered run:
    counters, the full trace, supersteps and ``time_s`` exactly, min
    apps bitwise, add apps within ``tests/test_distrib.py``'s tolerance;
  * on the ``torch`` backend every double-buffered run equals the
    synchronous one bitwise but for the priced overlap, and its
    ``time_s`` is never above it, strictly below for SSSP;
  * on one chip the flag is inert: ``time_s`` bitwise unchanged;
  * re-pricing a double-buffered trace gives its ``time_s``, and the
    scaling harness's ``double_buffer`` rows equal the reference's, at
    or above the synchronous GTEPS;
  * the deferred values survive the rows a chunk idles: a window
    overflow (SSSP at ``oq_cap=1``) and the write-back flush, whose
    wave's deferral a graph of another flush value folds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.tilegrid import square_grid as jsquare_grid
from repro.distrib import harness as jharness
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges
from repro.graph.rmat import histogram_input as jhistogram_input

from repro_torch.core import chunk as tchunk
from repro_torch.core import engine
from repro_torch.core.costmodel import DCRA_SRAM, price
from repro_torch.core.tilegrid import square_grid
from repro_torch.distrib import harness
from repro_torch.graph import apps, rmat_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.obs.metrics import default_registry

TILES = 16
CHIPS = 4
ALL_APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
MIN_APPS = ("bfs", "sssp", "wcc")
REF_RTOL, REF_ATOL = 1e-5, 1e-6          # tests/test_distrib.py _match


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
    bins = max(g.n_rows // 8, 1)
    return dict(g=g, gj=gj, bins=bins, root=int(np.argmax(g.out_degree())),
                x=np.random.default_rng(3).random(g.n_cols).astype(
                    np.float32),
                hv=histogram_input(g, bins), hvj=jhistogram_input(gj, bins))


def _run(name, inp, jax_side=False, tiles=TILES, **kw):
    """One app call as ``tests/test_double_buffer.py`` makes it."""
    pkg, sq = (japps, jsquare_grid) if jax_side else (apps, square_grid)
    if not jax_side:
        kw["device"] = "cpu"
    kw.setdefault("oq_cap", 32)
    grid = sq(tiles)
    g = inp["gj" if jax_side else "g"]
    if name == "bfs":
        return pkg.bfs(g, inp["root"], grid, **kw)
    if name == "sssp":
        return pkg.sssp(g, inp["root"], grid,
                        proxy=pkg.table2_proxy(grid, "sssp"), **kw)
    if name == "wcc":
        return pkg.wcc(g, grid, proxy=pkg.table2_proxy(grid, "wcc"), **kw)
    if name == "pagerank":
        return pkg.pagerank(g, grid, proxy=pkg.table2_proxy(grid, "pagerank"),
                            epochs=2, **kw)
    if name == "spmv":
        return pkg.spmv(g, inp["x"], grid, proxy=pkg.table2_proxy(
            grid, "spmv", cascade_levels=1), **kw)
    if name == "histo":
        return pkg.histogram(inp["hvj" if jax_side else "hv"], inp["bins"],
                             grid, proxy=pkg.table2_proxy(grid, "histo"),
                             **kw)
    raise ValueError(name)


_CACHE = {}


def _cached(inp, name, jax_side=False, **kw):
    key = (name, jax_side, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = _run(name, inp, jax_side=jax_side, **kw)
    return _CACHE[key]


def _same_physics(a, b, what, values_exact=True):
    """Everything but the priced overlap: values, counters, the trace
    less its ``double_buffer`` field, supersteps."""
    if values_exact:
        assert np.array_equal(a.values, np.asarray(b.values)), what
    else:
        np.testing.assert_allclose(a.values, np.asarray(b.values),
                                   rtol=REF_RTOL, atol=REF_ATOL, err_msg=what)
    ca, cb = a.run.counters.as_dict(), b.run.counters.as_dict()
    assert ca == cb, (what, {k: (ca[k], cb[k]) for k in ca if ca[k] != cb[k]})
    ta, tb = a.run.trace.to_dict(), b.run.trace.to_dict()
    ta.pop("double_buffer"), tb.pop("double_buffer")
    assert ta == tb, what
    assert a.run.supersteps == b.run.supersteps, what


# ------------------------------------------------- port vs reference
@pytest.mark.parametrize("name", ALL_APPS)
def test_db_matches_reference(inputs, name):
    want = _cached(inputs, name, jax_side=True, chips=CHIPS, run_chunk=8,
                   double_buffer=True)
    assert want.run.trace.double_buffer
    for chunk in (8, 0):
        got = _run(name, inputs, chips=CHIPS, run_chunk=chunk,
                   double_buffer=True)
        what = f"{name} run_chunk={chunk}"
        _same_physics(got, want, what, name in MIN_APPS)
        assert got.run.trace.to_dict() == want.run.trace.to_dict(), what
        assert got.run.time_s == want.run.time_s, what


# ------------------------------------------------- port db vs port sync
@pytest.mark.parametrize("name", ALL_APPS)
def test_db_bit_identity_4chip(inputs, name):
    sync = _cached(inputs, name, chips=CHIPS, run_chunk=8, backend="torch")
    assert not sync.run.trace.double_buffer
    for chunk in (0, 8):
        db = _run(name, inputs, chips=CHIPS, run_chunk=chunk,
                  double_buffer=True, backend="torch")
        assert db.run.trace.double_buffer
        _same_physics(db, sync, f"{name}/chunk={chunk}")
        assert db.run.time_s <= sync.run.time_s, f"{name}/chunk={chunk}"


@pytest.mark.parametrize("name", ("bfs", "pagerank"))
def test_db_flag_inert_on_monolithic(inputs, name):
    for chunk in (0, 8):
        sync = _run(name, inputs, run_chunk=chunk)
        db = _run(name, inputs, run_chunk=chunk, double_buffer=True)
        _same_physics(db, sync, name)
        assert db.run.time_s == sync.run.time_s, name


def test_db_overlap_actually_charged(inputs):
    sync = _cached(inputs, "sssp", chips=CHIPS, run_chunk=8, backend="torch")
    db = _run("sssp", inputs, chips=CHIPS, run_chunk=8, double_buffer=True)
    assert sync.run.counters.off_chip_msgs > 0
    assert db.run.time_s < sync.run.time_s


@pytest.mark.parametrize("chunk", (0, 8))
def test_db_reprice_ratio_is_one(inputs, chunk):
    db = _run("sssp", inputs, chips=CHIPS, run_chunk=chunk,
              double_buffer=True)
    rep = price(DCRA_SRAM, square_grid(TILES), db.run.counters,
                per_superstep_peak=db.run.trace)
    assert rep.time_s / db.run.time_s == 1.0


def test_scaling_harness_double_buffered():
    got = harness.weak_scaling((1, 4, 16), double_buffer=True, device="cpu")
    want = jharness.weak_scaling((1, 4, 16), double_buffer=True)
    sync = harness.weak_scaling((1, 4, 16), device="cpu")
    for a, b, s in zip(got, want, sync):
        for key in ("chips", "tiles", "gteps", "time_s", "supersteps",
                    "off_chip_msgs", "off_chip_hop_msgs", "energy_j",
                    "reprice_ratio"):
            assert a[key] == b[key], (a["chips"], key)
        # the trace re-priced in one vectorized pass: 1 to the last bit
        # or two (the reference's own test_db_reprice_ratio_is_one)
        assert a["reprice_ratio"] == pytest.approx(1.0, rel=1e-12), a
        assert a["gteps"] >= s["gteps"], a["chips"]
        if a["chips"] > 1:
            assert a["gteps"] > s["gteps"], a["chips"]
    kw = dict(chip_counts=(1, 4, 16), n_tiles=64, scale=8,
              double_buffer=True)
    got = harness.strong_scaling(device="cpu", **kw)
    want = jharness.strong_scaling(**kw)
    assert [(r["chips"], r["gteps"], r["time_s"]) for r in got] == \
        [(r["chips"], r["gteps"], r["time_s"]) for r in want]


# ------------------------------------------------- the deferred buffer
class _Rows:
    """Records, once made, each predicated step of the chunked loop: its
    flush value and window, whether the deferred buffer held records
    going in and coming out, and whether the step overflowed its window
    or ran (eager here, so reading the device state is a host read)."""

    def __init__(self, monkeypatch, identity):
        self.rows = []
        step = tchunk.ChunkRunner.step

        def held(runner):
            d = runner.state.get(engine.DEFERRED)
            return d is not None and bool(torch.any(d != identity))

        def tapped(runner, flush, window=None):
            before, over = held(runner), bool(runner.overflow)
            left = int(runner.left)
            step(runner, flush, window)
            self.rows.append(dict(
                flush=flush, window=window, held_in=before,
                held_out=held(runner),
                overflowed=bool(runner.overflow) and not over,
                ran=int(runner.left) < left))
        monkeypatch.setattr(tchunk.ChunkRunner, "step", tapped)


def test_deferred_values_survive_a_window_overflow(inputs, monkeypatch):
    """SSSP at ``oq_cap=1``, ``compaction=3``, chunked, with the window's
    headroom cut away so that chunks overflow, on 8x8 tiles (4x4 a chip:
    windows of 16, 4 and 1 lanes; on 2x2 chips no window overflowed with
    records in flight): a step that outgrows its window idles with
    records in the deferred buffer, and they land in the next step that
    runs.  The run equals the reference's and the port's dense
    synchronous one."""
    monkeypatch.setattr(engine, "CHUNK_HEADROOM", 1)
    rows = _Rows(monkeypatch, float("inf"))
    reg = default_registry()
    over = reg.counter("engine.window_overflows")
    o0 = over.value
    kw = dict(chips=CHIPS, oq_cap=1, compaction=3, double_buffer=True,
              tiles=64)
    got = _run("sssp", inputs, run_chunk=8, **kw)
    assert over.value > o0
    held = [r for r in rows.rows if r["overflowed"] and r["held_in"]]
    assert held, "no window overflowed with records in flight"
    for i, r in enumerate(rows.rows[:-1]):
        if r["overflowed"] and r["held_in"]:
            # kept through the idle rows, folded by the next step to run
            nxt = next(x for x in rows.rows[i + 1:] if x["ran"])
            assert nxt["held_in"]
    want = _run("sssp", inputs, jax_side=True, run_chunk=8, **kw)
    assert got.run.trace.to_dict() == want.run.trace.to_dict()
    assert got.run.time_s == want.run.time_s
    _same_physics(got, want, "sssp overflow vs reference")
    dense = _run("sssp", inputs, chips=CHIPS, run_chunk=8, oq_cap=1,
                 tiles=64)
    _same_physics(got, dense, "sssp overflow vs dense synchronous")


def test_flush_wave_deferral_crosses_graphs(inputs, monkeypatch):
    """Histogram's write-back flush: the flush step (the first of its
    chunk, the flush graph) sends its wave over the board, and the
    no-flush step after it folds those values; the run equals the
    reference's and the synchronous one."""
    rows = _Rows(monkeypatch, 0.0)
    got = _run("histo", inputs, chips=CHIPS, run_chunk=8, double_buffer=True)
    flushes = [i for i, r in enumerate(rows.rows)
               if r["flush"] and r["ran"] and r["held_out"]]
    assert flushes, "no flush step sent records over the board"
    for i in flushes:
        nxt = rows.rows[i + 1]
        assert not nxt["flush"] and nxt["ran"] and nxt["held_in"]
    want = _cached(inputs, "histo", jax_side=True, chips=CHIPS, run_chunk=8,
                   double_buffer=True)
    _same_physics(got, want, "histo vs reference")
    assert got.run.time_s == want.run.time_s
    sync = _cached(inputs, "histo", chips=CHIPS, run_chunk=8, backend="torch")
    _same_physics(got, sync, "histo vs synchronous")
