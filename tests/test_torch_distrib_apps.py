"""The port's distributed engine against the JAX reference's, app by app
(the counterpart of ``tests/test_distrib.py``'s six-app identity tests).

RMAT-9 on 8x8 tiles, the six apps under ``tests/test_distrib.py``'s
Table-II proxies (SpMV with a 2-level cascade, cut at each chip's
boundary by ``chip_local_proxy``), at 2, 4 and 16 chips.  The reference
runs once per case, chunked, with telemetry, the sanitizer and a
``TimelineRecorder``; the port runs the same call on both loops (chunk
8 and the per-step loop) with the same hooks, and each run equals the
reference's:

  * counters, the full ``trace.to_dict()``, supersteps and ``time_s``
    exactly;
  * values bitwise for BFS, SSSP, WCC and Histogram; PageRank and SpMV
    within the reference test's own tolerance against the reference's
    values (``_match(exact=False)``: rtol 1e-5 / atol 1e-6) and against
    their oracles (rtol 1e-4 / atol 1e-7 and 1e-3 / 1e-3);
  * every recorded scalar stat and every per-chip ``pc_*`` load vector
    over the run (exact), and ``off_chip_msgs > 0``.
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
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, oracles, rmat_edges
from repro_torch.graph.rmat import histogram_input

TILES = 64
CHIP_COUNTS = (2, 4, 16)
ALL_APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
EXACT_APPS = ("bfs", "sssp", "wcc", "histo")
HOOKS = dict(telemetry=True, sanitize=True)
REF_RTOL, REF_ATOL = 1e-5, 1e-6          # tests/test_distrib.py _match
ORACLE_TOL = dict(pagerank=(1e-4, 1e-7), spmv=(1e-3, 1e-3))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the port's CPU runs.  Beside the other
    test workers, ops with many threads wait on threads that are not
    scheduled: the weak-scaling sweep to 64 chips took 61 s so, against
    4 s on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    g, gj = (rmat_edges(9, edge_factor=8, seed=1),
             jrmat_edges(9, edge_factor=8, seed=1))
    bins = g.n_rows // 8
    return dict(g=g, gj=gj, bins=bins, root=int(np.argmax(g.out_degree())),
                x=np.random.default_rng(0).random(g.n_cols).astype(
                    np.float32),
                hv=histogram_input(g, bins), hvj=jhistogram_input(gj, bins))


def _run(name, inp, jax_side=False, **kw):
    """One app call as ``tests/test_distrib.py`` makes it."""
    pkg, sq = (japps, jsquare_grid) if jax_side else (apps, square_grid)
    if not jax_side:
        kw["device"] = "cpu"
    grid = sq(TILES)
    g = inp["gj" if jax_side else "g"]
    kw["oq_cap"] = 32
    if name == "bfs":
        return pkg.bfs(g, inp["root"], grid, **kw)
    if name == "sssp":
        return pkg.sssp(g, inp["root"], grid,
                        proxy=pkg.table2_proxy(grid, "sssp"), **kw)
    if name == "wcc":
        return pkg.wcc(g, grid, proxy=pkg.table2_proxy(grid, "wcc"), **kw)
    if name == "pagerank":
        return pkg.pagerank(g, grid, proxy=pkg.table2_proxy(grid, "pagerank"),
                            epochs=3, **kw)
    if name == "spmv":
        return pkg.spmv(g, inp["x"], grid, proxy=pkg.table2_proxy(
            grid, "spmv", cascade_levels=2), **kw)
    if name == "histo":
        return pkg.histogram(inp["hvj" if jax_side else "hv"], inp["bins"],
                             grid, proxy=pkg.table2_proxy(grid, "histo"),
                             **kw)
    raise ValueError(name)


def _oracle(name, inp):
    g = inp["g"]
    if name == "bfs":
        return oracles.bfs_oracle(g, inp["root"])
    if name == "sssp":
        return oracles.sssp_oracle(g, inp["root"])
    if name == "wcc":
        return oracles.wcc_oracle(g)
    if name == "pagerank":
        return oracles.pagerank_oracle(g, epochs=3)
    if name == "spmv":
        return oracles.spmv_oracle(g, inp["x"])
    return oracles.histogram_oracle(inp["hv"], inp["bins"])


def _assert_same(name, got, want, rec, jrec, what):
    if name in EXACT_APPS:
        assert np.array_equal(got.values, want.values), what
    else:
        np.testing.assert_allclose(got.values, want.values, rtol=REF_RTOL,
                                   atol=REF_ATOL, err_msg=what)
    a, b = got.run.counters.as_dict(), want.run.counters.as_dict()
    assert a == b, (what, {k: (a[k], b[k]) for k in a if a[k] != b[k]})
    assert got.run.trace.to_dict() == want.run.trace.to_dict(), what
    assert got.run.supersteps == want.run.supersteps, what
    assert got.run.time_s == want.run.time_s, what
    assert got.run.counters.off_chip_msgs > 0, what
    # every superstep's stats and per-chip load vectors, over the run
    for key in ("pending", "messages", "delivered_max_per_tile",
                "off_chip_msgs", "off_chip_hop_msgs", "sanity_violations"):
        assert np.array_equal(rec.stat_matrix(key),
                              jrec.stat_matrix(key)), (what, key)
    assert rec.vec_keys() == jrec.vec_keys(), what
    assert all(k.startswith("pc_") for k in rec.vec_keys()), what
    for key in jrec.vec_keys():
        assert np.array_equal(rec.vec_matrix(key),
                              jrec.vec_matrix(key)), (what, key)


@pytest.mark.parametrize("chips", CHIP_COUNTS)
@pytest.mark.parametrize("name", ALL_APPS)
def test_app_matches_reference(name, chips, inputs):
    jrec = jobs.TimelineRecorder()
    want = _run(name, inputs, jax_side=True, chips=chips, run_chunk=8,
                observer=jrec, **HOOKS)
    oracle = _oracle(name, inputs)
    for chunk in (8, 0):
        rec = obs.TimelineRecorder()
        got = _run(name, inputs, chips=chips, run_chunk=chunk,
                   observer=rec, **HOOKS)
        what = f"{name} chips={chips} run_chunk={chunk}"
        _assert_same(name, got, want, rec, jrec, what)
        assert rec.meta.n_chips == chips and rec.meta.chunk == chunk
        if name in ("bfs", "wcc", "histo"):
            assert np.array_equal(got.values, oracle), what
        elif name == "sssp":
            np.testing.assert_allclose(got.values, oracle, err_msg=what)
        else:
            rtol, atol = ORACLE_TOL[name]
            np.testing.assert_allclose(got.values, oracle, rtol=rtol,
                                       atol=atol, err_msg=what)
