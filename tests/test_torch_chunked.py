"""The port's chunked run loop against the JAX reference's chunked loop and
against the port's own per-step loop (the counterpart of
``tests/test_chunked.py``).

On the CPU the chunked loop runs the same predicated step that the card
replays from a CUDA graph, eagerly, K supersteps to one host fetch.  BFS
and WCC (min) and SpMV (write-back P$, selective 2-level cascade),
Histogram (write-back) and PageRank (write-back, two epochs), each under
its Table-II proxy, at K = 1, 4 and 16: counters, trace, supersteps and
``time_s`` exactly equal to both; values bitwise for the min apps and
Histogram, within rtol 1e-4 / atol 1e-5 of the reference for SpMV and
PageRank (``tests/test_torch_addapps.py``'s tolerance: f32
re-association), and bitwise equal to the port's per-step loop, which
computes the same f32 sums in the same order.  A budget that is not a
chunk multiple cuts both loops at the same superstep; a flush the device
schedules at a chunk's last or first row gives the per-step result; the
chunk accounting on stacked stats equals the per-step accounting; the
progress reports give true step counts; and the host syncs are one a
chunk (one a superstep at ``chunk=0``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jengine
from repro.core.netstats import SuperstepTrace as JSuperstepTrace
from repro.core.tilegrid import square_grid as jsquare_grid
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges
from repro.graph.rmat import histogram_input as jhistogram_input

from repro_torch.core import engine
from repro_torch.core.costmodel import DCRA_SRAM, link_provisioning
from repro_torch.core.netstats import SuperstepTrace, TrafficCounters
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.obs.metrics import default_registry

TILES = 64
OQ_CAP = 16
RTOL, ATOL = 1e-4, 1e-5
APPS = ("bfs", "wcc", "spmv", "histo", "pagerank")
MIN_APPS = ("bfs", "wcc")


@pytest.fixture(scope="module")
def inputs():
    g, gj = (rmat_edges(8, edge_factor=8, seed=1),
             jrmat_edges(8, edge_factor=8, seed=1))
    bins = g.n_rows // 8
    return dict(g=g, gj=gj, bins=bins,
                x=np.random.default_rng(0).random(g.n_cols).astype(
                    np.float32),
                hv=histogram_input(g, bins), hvj=jhistogram_input(gj, bins))


def _run(pkg, sq, app, inp, jax_side, **kw):
    grid = sq(TILES)
    g = inp["gj" if jax_side else "g"]
    cascade = dict(cascade_levels=2) if app == "spmv" else {}
    kw = dict(proxy=pkg.table2_proxy(grid, app, **cascade), oq_cap=OQ_CAP,
              **kw)
    if app == "bfs":
        return pkg.bfs(g, int(np.argmax(g.out_degree())), grid, **kw)
    if app == "wcc":
        return pkg.wcc(g, grid, **kw)
    if app == "spmv":
        return pkg.spmv(g, inp["x"], grid, **kw)
    if app == "histo":
        return pkg.histogram(inp["hvj" if jax_side else "hv"], inp["bins"],
                             grid, **kw)
    return pkg.pagerank(g, grid, epochs=2, **kw)


_CACHE = {}


def _cached(inp, app, side):
    """The reference's chunked run (its default, 16 supersteps a
    dispatch) or the port's per-step run, once per app for the module."""
    if (app, side) not in _CACHE:
        if side == "reference":
            _CACHE[app, side] = _run(japps, jsquare_grid, app, inp, True)
        else:
            _CACHE[app, side] = _run(apps, square_grid, app, inp, False,
                                     device="cpu", run_chunk=0)
    return _CACHE[app, side]


def _assert_same_run(r, want):
    a, b = r.counters.as_dict(), want.counters.as_dict()
    assert a == b, {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert r.trace.to_dict() == want.trace.to_dict()
    assert r.supersteps == want.supersteps
    assert r.time_s == want.time_s
    assert r.cycles == want.cycles


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("app", APPS)
def test_chunked_matches_reference_and_per_step(inputs, app, K):
    r = _run(apps, square_grid, app, inputs, False, device="cpu",
             run_chunk=K)
    ref, per_step = _cached(inputs, app, "reference"), _cached(
        inputs, app, "per-step")
    _assert_same_run(r.run, ref.run)
    _assert_same_run(r.run, per_step.run)
    assert np.array_equal(r.values, per_step.values)
    if app in MIN_APPS or app == "histo":
        assert np.array_equal(r.values, ref.values)
    else:
        np.testing.assert_allclose(r.values, ref.values, rtol=RTOL,
                                   atol=ATOL)
    if app in ("spmv", "histo", "pagerank"):
        # a drained superstep that is not the last: the run flushed
        assert 0.0 in r.run.trace.pending[:-1]


def _engines(inp, app):
    """The port's and the reference's engine and initial state."""
    grid, jgrid = square_grid(TILES), jsquare_grid(TILES)
    cascade = dict(cascade_levels=2) if app == "spmv" else {}
    common = dict(root=int(np.argmax(inp["g"].out_degree())),
                  oq_cap=OQ_CAP, bins=inp["bins"])
    eng, state, _ = apps.engine_and_state(
        app, inp["g"], grid, apps.table2_proxy(grid, app, **cascade),
        x=inp["x"], histo_values=inp["hv"], device="cpu", **common)
    jeng, jstate, _ = japps.engine_and_state(
        app, inp["gj"], jgrid, japps.table2_proxy(jgrid, app, **cascade),
        x=inp["x"], histo_values=inp["hvj"], **common)
    return (eng, state), (jeng, jstate)


@pytest.mark.parametrize("app,budget,K", [("bfs", 7, 4), ("bfs", 7, 16),
                                          ("spmv", 9, 4)])
def test_budget_not_a_chunk_multiple(inputs, app, budget, K):
    """``max_supersteps`` cuts the chunked loop at the same superstep as
    the per-step loop and as the reference's chunked loop at the same K."""
    (eng, state), (jeng, jstate) = _engines(inputs, app)
    _, rc = eng.run(state, max_supersteps=budget, chunk=K)
    _, rl = eng.run(state, max_supersteps=budget, chunk=0)
    _, rj = jeng.run(jstate, max_supersteps=budget, chunk=K)
    assert rc.supersteps == budget
    _assert_same_run(rc, rl)
    _assert_same_run(rc, rj)


def _first_drain(run) -> int:
    """Index of the first superstep that drained with work left (the
    superstep after it flushes the P$)."""
    return run.trace.pending[:-1].index(0.0)


@pytest.mark.parametrize("edge", ["last row", "first row"])
def test_flush_at_a_chunk_edge(inputs, edge):
    """SpMV's first flush scheduled by a chunk's last row (the next chunk
    starts with the flush step), and by a chunk's first row (the rest of
    that chunk idles): both give the per-step result."""
    per_step = _cached(inputs, "spmv", "per-step")
    d = _first_drain(per_step.run)
    assert d >= 2
    K = d + 1 if edge == "last row" else d
    r = _run(apps, square_grid, "spmv", inputs, False, device="cpu",
             run_chunk=K)
    _assert_same_run(r.run, per_step.run)
    assert np.array_equal(r.values, per_step.values)


def _chunks(pending, K) -> int:
    """The chunks the chunked loop takes over a run with these per-step
    ``pending`` counts: a chunk ends after K supersteps or at a drained
    one (done, or a flush scheduled for the next chunk's first row)."""
    n, i = 0, 0
    while i < len(pending):
        n += 1
        r = 0
        while r < K and i < len(pending):
            i, r = i + 1, r + 1
            if pending[i - 1] == 0:
                break
    return n


@pytest.mark.parametrize("app", ["bfs", "histo"])
@pytest.mark.parametrize("K", [4, 16])
def test_host_syncs_one_per_chunk(inputs, app, K):
    ctr = default_registry().counter("engine.host_syncs")
    before = ctr.value
    r = _run(apps, square_grid, app, inputs, False, device="cpu",
             run_chunk=K)
    syncs = ctr.value - before
    assert syncs == _chunks(r.run.trace.pending, K)
    if app == "bfs":
        assert syncs == math.ceil(r.run.supersteps / K)
    else:
        assert syncs > math.ceil(r.run.supersteps / K)   # a flush chunk
    before = ctr.value
    r0 = _run(apps, square_grid, app, inputs, False, device="cpu",
              run_chunk=0)
    assert ctr.value - before == r0.run.supersteps


# ----------------------------------------------------- chunk accounting
STACKED_KEYS = ("messages", "hop_msgs", "owner_msgs", "owner_hop_msgs",
                "intra_die_hops", "inter_die_crossings",
                "inter_pkg_crossings", "filtered_at_proxy",
                "coalesced_at_proxy", "cascade_combined",
                "cross_region_msgs", "edges_processed", "records_consumed",
                "compute_per_tile_max", "delivered_max_per_tile", "pending",
                "p_resident")


def _fake_stacked(n):
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, 1 << 20, n).astype(np.float64)
            for k in STACKED_KEYS}


def test_chunk_counters_match_per_step():
    stacked = _fake_stacked(16)
    via_chunk = engine.chunk_counters(stacked, 11)
    via_steps = TrafficCounters()
    for i in range(11):
        via_steps.add(engine.superstep_counters(
            {k: v[i] for k, v in stacked.items()}))
    assert via_chunk.as_dict() == via_steps.as_dict()
    assert via_chunk.as_dict() == jengine.chunk_counters(stacked,
                                                         11).as_dict()


def test_chunk_cycles_match_per_step():
    stacked = _fake_stacked(16)
    links = link_provisioning(square_grid(TILES), DCRA_SRAM)
    sc = engine.chunk_cycles(stacked, 13, DCRA_SRAM, links)
    assert sc.shape == (13,)
    assert sc.tolist() == [
        engine.superstep_cycles({k: v[i] for k, v in stacked.items()},
                                DCRA_SRAM, links) for i in range(13)]


def test_append_chunk_matches_per_step():
    stacked = _fake_stacked(12)
    t_chunk, t_ref = SuperstepTrace(), JSuperstepTrace()
    t_chunk.append_chunk(stacked, 9, element_bits=64)
    t_ref.append_chunk(stacked, 9, element_bits=64)
    t_step = SuperstepTrace()
    for i in range(9):
        t_step.append_step({k: v[i] for k, v in stacked.items()},
                           element_bits=64)
    assert t_chunk.to_dict() == t_step.to_dict() == t_ref.to_dict()
    assert len(t_chunk) == 9


# ------------------------------------------------------------- progress
def test_progress_reports_true_step_counts(inputs, capsys):
    (eng, state), _ = _engines(inputs, "bfs")
    reports = default_registry().counter("progress.bfs.reports")
    before = reports.value
    capsys.readouterr()
    _, r = eng.run(state, progress_every=5, chunk=4)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "step " in ln]
    assert lines, "progress_every printed nothing"
    steps = [int(ln.split("step ")[1].split()[0]) for ln in lines]
    # true executed counts: strictly increasing chunk boundaries within
    # the run, one line per boundary that reaches a new multiple of 5
    assert steps == sorted(set(steps))
    assert all(0 < s <= r.supersteps for s in steps)
    assert all(s % 4 == 0 or s == r.supersteps for s in steps)
    assert [s // 5 for s in steps] == sorted(set(s // 5 for s in steps))
    assert reports.value - before == len(lines)
    assert default_registry().gauge("progress.bfs.steps").value == \
        r.supersteps
