"""The PyTorch engine against the JAX engine, bit for bit.

BFS, SSSP and WCC, with no proxy and with the Table-II write-through
proxy, on the same graph (made by each package from the same seed):
the port's ``backend="torch"`` against the reference's ``"jnp"`` oracle
and the port's ``backend="kernels"`` (plain kernel versions on the CPU)
against the reference's ``"pallas"`` (interpret mode).  Values,
``counters.as_dict()``, ``trace.to_dict()``, supersteps and ``time_s``
must all be equal.  A mid-run test carries one reference engine state,
warm P$ included, across with ``convert`` and steps both engines once.
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

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.tilegrid import ChipPartition, square_grid
from repro_torch.graph import apps, oracles, rmat_edges
from repro_torch.obs.metrics import default_registry

TILES = 16
OQ_CAP = 16
BACKENDS = [("torch", "jnp"), ("kernels", "pallas")]


@pytest.fixture(scope="module")
def graphs():
    return (rmat_edges(8, edge_factor=8, seed=1),
            jrmat_edges(8, edge_factor=8, seed=1))


def _run(pkg, sq, app, g, proxied, **kw):
    grid = sq(TILES)
    px = pkg.table2_proxy(grid, app) if proxied else None
    if app == "wcc":
        return getattr(pkg, app)(g, grid, proxy=px, oq_cap=OQ_CAP, **kw)
    root = int(np.argmax(g.out_degree()))
    return getattr(pkg, app)(g, root, grid, proxy=px, oq_cap=OQ_CAP, **kw)


def _assert_same(r, rj):
    assert np.array_equal(r.values, rj.values)
    a, b = r.run.counters.as_dict(), rj.run.counters.as_dict()
    assert a == b, {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert r.run.trace.to_dict() == rj.run.trace.to_dict()
    assert r.run.supersteps == rj.run.supersteps
    assert r.run.time_s == rj.run.time_s
    assert r.run.cycles == rj.run.cycles


@pytest.mark.parametrize("backend,jbackend", BACKENDS)
@pytest.mark.parametrize("proxied", [False, True], ids=["direct", "table2"])
@pytest.mark.parametrize("app", ["bfs", "sssp", "wcc"])
def test_app_matches_reference(graphs, app, proxied, backend, jbackend):
    g, gj = graphs
    r = _run(apps, square_grid, app, g, proxied, device="cpu",
             backend=backend)
    rj = _run(japps, jsquare_grid, app, gj, proxied, backend=jbackend)
    _assert_same(r, rj)
    if proxied:
        assert r.run.counters.filtered_at_proxy > 0


@pytest.mark.parametrize("app", ["bfs", "sssp", "wcc"])
def test_app_matches_oracle(graphs, app):
    g, _ = graphs
    r = _run(apps, square_grid, app, g, True, device="cpu")
    root = int(np.argmax(g.out_degree()))
    want = (oracles.wcc_oracle(g) if app == "wcc"
            else getattr(oracles, f"{app}_oracle")(g, root))
    assert np.array_equal(r.values, want)


def _engines(app_name, g, gj, backend, jbackend):
    spec = getattr(apps, f"{app_name.upper()}_SPEC")
    jspec = getattr(japps, f"{app_name.upper()}_SPEC")
    grid, jgrid = square_grid(TILES), jsquare_grid(TILES)
    cfg = engine.EngineConfig(grid=grid, n_src=g.n_rows, n_dst=g.n_cols,
                              oq_cap=OQ_CAP,
                              proxy=apps.table2_proxy(grid, app_name),
                              backend=backend)
    jcfg = jengine.EngineConfig(grid=jgrid, n_src=gj.n_rows,
                                n_dst=gj.n_cols, oq_cap=OQ_CAP,
                                proxy=japps.table2_proxy(jgrid, app_name),
                                backend=jbackend)
    eng = engine.DataLocalEngine(spec, cfg, g.row_lo, g.row_hi, g.col_idx,
                                 g.weights, device="cpu")
    jeng = jengine.DataLocalEngine(jspec, jcfg, gj.row_lo, gj.row_hi,
                                   gj.col_idx, gj.weights)
    return eng, jeng


@pytest.mark.parametrize("backend,jbackend", BACKENDS)
@pytest.mark.parametrize("app", ["bfs", "sssp", "wcc"])
def test_mid_run_step_matches_reference(graphs, app, backend, jbackend):
    """Step the reference k supersteps, carry its state (warm P$
    included) across as numpy, then step both engines once more."""
    g, gj = graphs
    eng, jeng = _engines(app, g, gj, backend, jbackend)
    root = int(np.argmax(g.out_degree()))
    if app == "wcc":
        n = gj.n_rows
        jstate = jeng.init_state(seed_idx=np.arange(n),
                                 seed_val=np.arange(n, dtype=np.float32))
    else:
        jstate = jeng.init_state(seed_idx=root, seed_val=0.0)
    no_flush = jnp.asarray(False)
    for _ in range(4):
        jstate, _ = jeng._superstep(jstate, no_flush)
    np_state = jax.device_get(jstate)
    assert np.any(np.asarray(np_state["p_tag"]) >= 0)     # the P$ is warm
    state = convert.engine_state_from_numpy(np_state, "cpu")
    jnext, jstats = jax.device_get(jeng._superstep(jstate, no_flush))
    nxt, stats = eng._superstep(state)
    got = convert.engine_state_to_numpy(nxt)
    assert set(got) == set(jnext)
    for k in got:
        assert np.array_equal(got[k], np.asarray(jnext[k])), k
    fetched = engine.fetch_stats(stats)
    for k in engine.STAT_KEYS:
        assert fetched[k] == float(jstats[k]), k


def test_engine_takes_device_tensors(graphs):
    """An engine built from ``convert.csr_to_device`` tensors runs as the
    one built from the CSR's numpy arrays."""
    g, _ = graphs
    grid = square_grid(TILES)
    cfg = engine.EngineConfig(grid=grid, n_src=g.n_rows, n_dst=g.n_cols,
                              oq_cap=OQ_CAP, proxy=apps.table2_proxy(grid,
                                                                     "sssp"))
    d = convert.csr_to_device(g, "cpu")
    root = int(np.argmax(g.out_degree()))
    runs = []
    for arrays in ((g.row_lo, g.row_hi, g.col_idx, g.weights),
                   (d["row_lo"], d["row_hi"], d["col_idx"], d["weights"])):
        eng = engine.DataLocalEngine(apps.SSSP_SPEC, cfg, *arrays,
                                     device="cpu")
        runs.append(eng.run(eng.init_state(seed_idx=root, seed_val=0.0)))
    (sa, ra), (sb, rb) = runs
    assert torch.equal(sa["values"], sb["values"])
    assert ra.counters.as_dict() == rb.counters.as_dict()
    assert ra.time_s == rb.time_s


def test_one_host_sync_per_superstep(graphs):
    """One host sync a superstep at ``chunk=0`` (the per-step loop); one
    a chunk on the default chunked loop (``run_chunk`` 16 supersteps,
    and BFS drains without a flush)."""
    g, _ = graphs
    ctr = default_registry().counter("engine.host_syncs")
    before = ctr.value
    r = _run(apps, square_grid, "bfs", g, True, device="cpu", run_chunk=0)
    assert ctr.value - before == r.run.supersteps
    before = ctr.value
    r = _run(apps, square_grid, "bfs", g, True, device="cpu")
    assert ctr.value - before == -(-r.run.supersteps // 16)
    assert r.run.supersteps > 16


def test_chunk_is_accepted_and_changes_nothing(graphs):
    """``chunk=0`` (the per-step loop) and the default (the chunked loop)
    give identical results."""
    g, _ = graphs
    base = _run(apps, square_grid, "bfs", g, True, device="cpu")
    r = _run(apps, square_grid, "bfs", g, True, device="cpu", run_chunk=0)
    _assert_same(r, base)


def test_superstep_budget_matches_reference(graphs):
    g, gj = graphs
    eng, jeng = _engines("bfs", g, gj, "torch", "jnp")
    root = int(np.argmax(g.out_degree()))
    _, r = eng.run(eng.init_state(seed_idx=root, seed_val=0.0),
                   max_supersteps=7)
    _, rj = jeng.run(jeng.init_state(seed_idx=root, seed_val=0.0),
                     max_supersteps=7)
    assert r.supersteps == rj.supersteps == 7
    assert r.counters.as_dict() == rj.counters.as_dict()
    assert r.trace.to_dict() == rj.trace.to_dict()
    assert r.time_s == rj.time_s


def test_default_device_is_the_card(graphs):
    g, _ = graphs
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(apps, square_grid, "bfs", g, False)


# setting -> (its EngineConfig fields, the ROADMAP item that ports it)
UNPORTED = {
    "double_buffer": (dict(double_buffer=True), "A.5b"),
    "ckpt_every_supersteps": (dict(ckpt_every_supersteps=4), "A.6"),
}


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_settings_raise(graphs, what):
    g, _ = graphs
    grid = square_grid(TILES)
    fields, item = UNPORTED[what]
    cfg = engine.EngineConfig(grid=grid, n_src=g.n_rows, n_dst=g.n_cols,
                              **fields)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        engine.DataLocalEngine(apps.BFS_SPEC, cfg, g.row_lo, g.row_hi,
                               g.col_idx, device="cpu")


def test_unported_runtime_options_raise(graphs):
    g, _ = graphs
    grid = square_grid(TILES)
    cfg = engine.EngineConfig(grid=grid, n_src=g.n_rows, n_dst=g.n_cols)
    # a multi-chip window's state is the distributed driver's
    eng = engine.DataLocalEngine(apps.BFS_SPEC, cfg, g.row_lo, g.row_hi,
                                 g.col_idx, part=ChipPartition(grid, 2, 2),
                                 device="cpu")
    with pytest.raises(ValueError, match="DistributedEngine"):
        eng.init_state(seed_idx=0, seed_val=0.0)
    with pytest.raises(NotImplementedError, match="A.5b"):
        apps.bfs(g, 0, grid, chips=4, compaction=3, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        apps.bfs(g, 0, grid, backend="pallas", device="cpu")
