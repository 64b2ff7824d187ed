"""The add-combine apps (SpMV, Histogram, PageRank) on the PyTorch engine
against the JAX engine: the write-back P$, its flush and the cascade.

Each app runs under its Table-II proxy without a cascade, with a
selective 2-level cascade and with a non-selective one, on the same
inputs (made by each package from the same seed).  The port's
``backend="torch"`` and ``backend="kernels"`` (plain kernel versions on
the CPU) are held against the reference's ``"jnp"`` oracle, and, on the
smallest configuration, against ``"pallas"`` (interpret mode).
Counters, trace, supersteps and ``time_s`` must be equal; values within
rtol 1e-4 / atol 1e-5 (the reference's own cascade tolerance,
``tests/test_cascade.py``), bitwise for Histogram (sums of 1.0).  BFS
forced through the tree (``selective=False``) must match bit for bit,
and one flush superstep from a carried mid-run state must match the
reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import engine as jengine
from repro.core.tilegrid import square_grid as jsquare_grid
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges
from repro.graph.rmat import histogram_input as jhistogram_input

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, oracles, rmat_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.obs.metrics import default_registry

TILES = 64             # 8x8: 2x2 base regions, 4x4 and 8x8 tree levels
OQ_CAP = 16
RTOL, ATOL = 1e-4, 1e-5
CASCADES = {"none": {}, "selective2": dict(cascade_levels=2),
            "nonselective2": dict(cascade_levels=2, selective=False)}


def _inputs(scale):
    g, gj = (rmat_edges(scale, edge_factor=8, seed=1),
             jrmat_edges(scale, edge_factor=8, seed=1))
    bins = g.n_rows // 8
    x = np.random.default_rng(0).random(g.n_cols).astype(np.float32)
    return dict(g=g, gj=gj, bins=bins, x=x, hv=histogram_input(g, bins),
                hvj=jhistogram_input(gj, bins), scale=scale)


@pytest.fixture(scope="module")
def inputs():
    return _inputs(8)


@pytest.fixture(scope="module")
def smallest():
    """The Pallas kernels in interpret mode are slow: one vertex per
    tile (and, below, a 32-slot P$, so the flush wave is 2,048
    records)."""
    return _inputs(6)


def _run(pkg, sq, app, inp, cascade, jax_side, slots=512, **kw):
    grid = sq(TILES)
    px = pkg.table2_proxy(grid, app, slots=slots, **CASCADES[cascade])
    g = inp["gj" if jax_side else "g"]
    kw = dict(proxy=px, oq_cap=OQ_CAP, **kw)
    if app == "spmv":
        return pkg.spmv(g, inp["x"], grid, **kw)
    if app == "histo":
        return pkg.histogram(inp["hvj" if jax_side else "hv"], inp["bins"],
                             grid, **kw)
    if app == "pagerank":
        return pkg.pagerank(g, grid, epochs=2, **kw)
    return pkg.bfs(g, int(np.argmax(g.out_degree())), grid, **kw)


_REFERENCE = {}


def _reference(inp, app, cascade, jbackend="jnp", slots=512):
    """The JAX run, once per configuration for the module."""
    key = (inp["scale"], app, cascade, jbackend, slots)
    if key not in _REFERENCE:
        _REFERENCE[key] = _run(japps, jsquare_grid, app, inp, cascade, True,
                               slots=slots, backend=jbackend)
    return _REFERENCE[key]


def _assert_same(r, rj, app):
    if app in ("histo", "bfs"):
        assert np.array_equal(r.values, rj.values)
    else:
        np.testing.assert_allclose(r.values, rj.values, rtol=RTOL,
                                   atol=ATOL)
    a, b = r.run.counters.as_dict(), rj.run.counters.as_dict()
    assert a == b, {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert r.run.trace.to_dict() == rj.run.trace.to_dict()
    assert r.run.supersteps == rj.run.supersteps
    assert r.run.time_s == rj.run.time_s
    assert r.run.cycles == rj.run.cycles


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("cascade", sorted(CASCADES))
@pytest.mark.parametrize("app", ["spmv", "histo", "pagerank"])
def test_add_app_matches_reference(inputs, app, cascade, backend):
    r = _run(apps, square_grid, app, inputs, cascade, False, device="cpu",
             backend=backend)
    _assert_same(r, _reference(inputs, app, cascade), app)
    c = r.run.counters
    assert c.coalesced_at_proxy > 0
    assert (c.cascade_combined > 0) == (cascade != "none")


@pytest.mark.parametrize("app", ["spmv", "histo", "pagerank"])
def test_add_app_kernels_match_pallas(smallest, app):
    """The plain kernel versions against the Pallas kernels (interpret
    mode) inside the engine, on the configuration that runs every leg:
    the non-selective cascade, where the flush wave climbs the tree with
    the direct legs."""
    r = _run(apps, square_grid, app, smallest, "nonselective2", False,
             slots=32, device="cpu", backend="kernels")
    _assert_same(r, _reference(smallest, app, "nonselective2", "pallas",
                               slots=32), app)
    assert r.run.counters.cascade_combined > 0


def test_add_apps_match_oracles(inputs):
    g = inputs["g"]
    grid = square_grid(TILES)
    px = apps.table2_proxy(grid, "histo", **CASCADES["selective2"])
    r = apps.histogram(inputs["hv"], inputs["bins"], grid, proxy=px,
                       oq_cap=OQ_CAP, device="cpu")
    assert np.array_equal(r.values, oracles.histogram_oracle(
        inputs["hv"], inputs["bins"]))
    r = apps.spmv(g, inputs["x"], grid,
                  proxy=apps.table2_proxy(grid, "spmv", cascade_levels=2),
                  oq_cap=OQ_CAP, device="cpu")
    np.testing.assert_allclose(r.values, oracles.spmv_oracle(g, inputs["x"]),
                               rtol=1e-3, atol=1e-3)
    r = apps.pagerank(g, grid, proxy=apps.table2_proxy(grid, "pagerank"),
                      epochs=2, oq_cap=OQ_CAP, device="cpu")
    np.testing.assert_allclose(r.values, oracles.pagerank_oracle(g, 2),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_bfs_through_the_tree_matches_reference(inputs, backend):
    """Write-through min app forced through the reduction tree
    (``selective=False``): bit for bit, merges counted.  Under
    ``selective=True`` BFS is not cascade-profitable and runs as without
    a cascade."""
    r = _run(apps, square_grid, "bfs", inputs, "nonselective2", False,
             device="cpu", backend=backend)
    _assert_same(r, _reference(inputs, "bfs", "nonselective2"), "bfs")
    assert r.run.counters.cascade_combined > 0
    sel = _run(apps, square_grid, "bfs", inputs, "selective2", False,
               device="cpu", backend=backend)
    plain = _run(apps, square_grid, "bfs", inputs, "none", False,
                 device="cpu", backend=backend)
    _assert_same(sel, plain, "bfs")


def _engines(app, inp, cascade):
    grid, jgrid = square_grid(TILES), jsquare_grid(TILES)
    eng, state, _ = apps.engine_and_state(
        app, inp["g"], grid, apps.table2_proxy(grid, app,
                                               **CASCADES[cascade]),
        x=inp["x"], histo_values=inp["hv"], bins=inp["bins"],
        oq_cap=OQ_CAP, device="cpu")
    jeng, jstate, _ = japps.engine_and_state(
        app, inp["gj"], jgrid, japps.table2_proxy(jgrid, app,
                                                  **CASCADES[cascade]),
        x=inp["x"], histo_values=inp["hvj"], bins=inp["bins"],
        oq_cap=OQ_CAP, backend="jnp")
    return eng, state, jeng, jstate


@pytest.mark.parametrize("app,cascade", [("spmv", "selective2"),
                                         ("histo", "nonselective2")])
def test_flush_step_from_carried_state_matches_reference(inputs, app,
                                                         cascade):
    """Step the reference until the superstep before its first flush,
    carry that state (warm, resident P$) across with ``convert``, then
    run the flush superstep in both engines."""
    eng, state0, jeng, jstate = _engines(app, inputs, cascade)
    # the port's engine_and_state equals the reference's
    for k, v in convert.engine_state_to_numpy(state0).items():
        assert np.array_equal(v, np.asarray(jstate[k])), k
    no_flush = jnp.asarray(False)
    for _ in range(200):
        jstate, jstats = jeng._superstep(jstate, no_flush)
        if int(jstats["pending"]) == 0:
            break
    assert int(jstats["p_resident"]) > 0
    state = convert.engine_state_from_numpy(jax.device_get(jstate), "cpu")
    jnext, jstats = jax.device_get(jeng._superstep(jstate,
                                                   jnp.asarray(True)))
    nxt, stats = eng._superstep(state, True)
    got = convert.engine_state_to_numpy(nxt)
    assert set(got) == set(jnext)
    for k in got:
        if got[k].dtype == np.float32:
            np.testing.assert_allclose(got[k], np.asarray(jnext[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            assert np.array_equal(got[k], np.asarray(jnext[k])), k
    assert not np.any(got["p_tag"] >= 0)                 # the P$ is spilled
    fetched = engine.fetch_stats(stats)
    for k in engine.STAT_KEYS:
        assert fetched[k] == float(jstats[k]), k
    assert fetched["p_resident"] == 0
    if cascade != "none":
        assert fetched["cascade_combined"] > 0


def test_one_host_sync_per_superstep_write_back(inputs):
    """Write-back runs flush, and on the per-step loop (``chunk=0``) the
    flush decision costs no sync of its own: still exactly one host sync
    per superstep.  (The chunked loop's syncs: test_torch_chunked.py.)"""
    ctr = default_registry().counter("engine.host_syncs")
    before = ctr.value
    grid = square_grid(TILES)
    eng, state, _ = apps.engine_and_state(
        "histo", inputs["g"], grid, apps.table2_proxy(grid, "histo"),
        histo_values=inputs["hv"], bins=inputs["bins"], oq_cap=OQ_CAP,
        device="cpu")
    _, run = eng.run(state, chunk=0)
    assert ctr.value - before == run.supersteps
    # a drained superstep that is not the last: a flush superstep followed
    assert 0.0 in run.trace.pending[:-1]


def test_add_apps_refuse_what_is_not_ported(inputs):
    grid = square_grid(TILES)
    with pytest.raises(NotImplementedError, match="A.5b"):
        apps.spmv(inputs["g"], inputs["x"], grid, chips=4, compaction=3,
                  device="cpu")
    with pytest.raises(ValueError, match="backend"):
        apps.histogram(inputs["hv"], inputs["bins"], grid, backend="jnp",
                       device="cpu")
    with pytest.raises(ValueError):
        apps.engine_and_state("nope", inputs["g"], grid, device="cpu")
