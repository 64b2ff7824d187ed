"""The port's distributed runtime (``repro_torch.distrib``): its maps,
its loops, its hooks and its scaling harness, against the JAX
reference's and against the port's own monolithic engine.  The six-app
identity with the reference is ``tests/test_torch_distrib_apps.py``.

  * ``ChipPartition.chip_hops`` / ``tile_ids`` and ``proxy``'s
    ``chip_local_proxy`` / ``max_cascade_levels`` / ``region_id`` equal
    the reference's;
  * the analogues of ``tests/test_distrib.py``'s own-engine properties
    (no JAX): the monolithic trace minus the board leg on both loops,
    the chain graph whose frontier keeps crossing chips, the one-chip
    ``DistributedEngine``, off-chip traffic only when partitioned and
    growing with the chips;
  * the 4-chip observer (``tests/test_obs.py``'s sizes): hooks on are
    bit-identical to off with equal host syncs, and the recorder's
    ``pc_*`` vectors equal the reference recorder's;
  * the sanitizer at 4 chips: clean, and a planted NaN raises on both
    loops;
  * ``harness.weak_scaling`` equals the reference's at 1, 4 and 16 chips
    and is monotone to 64 chips with ``reprice_ratio == 1`` (256 chips:
    ``chip_smoke.py`` phase 10, on the card);
  * one superstep dispatches as many aten ops at 16 chips as at 2 (one
    batched window, no loop over chips);
  * the settings this slice does not run raise, naming their ROADMAP
    item.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode

from repro import obs as jobs
from repro.core import proxy as jproxy
from repro.core import tilegrid as jtilegrid
from repro.distrib import harness as jharness
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges
from repro.graph.rmat import histogram_input as jhistogram_input

from repro_torch import obs
from repro_torch.analysis.invariants import SanitizerError
from repro_torch.core import engine, proxy
from repro_torch.core.costmodel import DCRA_SRAM, board_link_provisioning
from repro_torch.core.tilegrid import ChipPartition, square_grid
from repro_torch.distrib import driver, harness
from repro_torch.graph import apps, oracles, rmat_edges
from repro_torch.graph.csr import csr_from_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.obs.metrics import default_registry

GRID = square_grid(64)                                  # 8x8 tiles
ALL_APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
MIN_APPS = ("bfs", "sssp", "wcc", "histo")
ADD_RTOL, ADD_ATOL = 1e-4, 1e-5        # tests/test_torch_addapps.py
# tests/test_distrib.py: the level-traffic vectors a proxy-free run
# shares with the monolithic engine (only the board leg is new)
EQUIV_TRACE_FIELDS = ("compute_ops", "intra_bits", "die_bits", "pkg_bits",
                      "touched_bits", "pending")


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
def g():
    return rmat_edges(9, edge_factor=8, seed=1)


@pytest.fixture(scope="module")
def root(g):
    return int(np.argmax(g.out_degree()))


# --------------------------------------------------------- maps and proxies
PARTS = ((256, 4, 4), (64, 2, 2), (64, 1, 2), (64, 4, 1), (1024, 4, 8))


@pytest.mark.parametrize("torus", (True, False))
@pytest.mark.parametrize("tiles,cy,cx", PARTS)
def test_partition_maps_match_reference(tiles, cy, cx, torus):
    part = ChipPartition(square_grid(tiles, torus=torus), cy, cx)
    jpart = jtilegrid.ChipPartition(jtilegrid.square_grid(tiles,
                                                          torus=torus), cy, cx)
    tids = np.arange(tiles)
    src, dst = np.meshgrid(tids, tids)
    got = part.chip_hops(torch.as_tensor(src), torch.as_tensor(dst))
    assert np.array_equal(got.numpy(), np.asarray(jpart.chip_hops(src, dst)))
    for c in range(part.num_chips):
        assert np.array_equal(part.tile_ids(c), jpart.tile_ids(c))
    perm = np.concatenate([part.tile_ids(c) for c in range(part.num_chips)])
    assert np.array_equal(np.sort(perm), tids)      # a permutation


@pytest.mark.parametrize("levels", (1, 2, 3))
@pytest.mark.parametrize("region_div", (2, 4, 8))
@pytest.mark.parametrize("sub", (2, 4, 8, 16, 32))
def test_chip_local_proxy_matches_reference(sub, region_div, levels):
    grid = square_grid(1024)
    px = apps.table2_proxy(grid, "spmv", region_div=region_div,
                           cascade_levels=levels)
    jpx = japps.table2_proxy(jtilegrid.square_grid(1024), "spmv",
                             region_div=region_div, cascade_levels=levels)
    got, want = (proxy.chip_local_proxy(px, sub, sub),
                 jproxy.chip_local_proxy(jpx, sub, sub))
    assert (got.region_ny, got.region_nx, got.slots, got.write_back) == (
        want.region_ny, want.region_nx, want.slots, want.write_back)
    assert (got.cascade is None) == (want.cascade is None)
    if got.cascade is not None:
        assert got.cascade.levels == want.cascade.levels
    for group in (2, 4):
        assert proxy.max_cascade_levels(sub, sub, px.region_ny,
                                        px.region_nx, group, group) == \
            jproxy.max_cascade_levels(sub, sub, px.region_ny, px.region_nx,
                                      group, group)
    tids = np.arange(1024)
    assert np.array_equal(
        proxy.region_id(grid, px, torch.as_tensor(tids)).numpy(),
        np.asarray(jproxy.region_id(jtilegrid.square_grid(1024), jpx,
                                    tids)))


# ------------------------------------- analogues of tests/test_distrib.py
def _trace_run(name, g, root, chips=0, run_chunk=0, **kw):
    """Proxy-free run of one app (``tests/test_distrib.py``'s)."""
    kw.update(oq_cap=16, run_chunk=run_chunk, device="cpu")
    if chips:
        kw["chips"] = chips
    if name == "bfs":
        return apps.bfs(g, root, GRID, **kw)
    if name == "sssp":
        return apps.sssp(g, root, GRID, **kw)
    if name == "wcc":
        return apps.wcc(g, GRID, **kw)
    if name == "pagerank":
        return apps.pagerank(g, GRID, epochs=2, **kw)
    if name == "spmv":
        x = np.random.default_rng(3).random(g.n_cols).astype(np.float32)
        return apps.spmv(g, x, GRID, **kw)
    bins = g.n_rows // 8
    return apps.histogram(histogram_input(g, bins), bins, GRID, **kw)


@pytest.mark.parametrize("name", ALL_APPS)
def test_trace_equivalence_minus_board_leg(name, g, root):
    """At 4 chips the trace equals the monolithic one on every shared
    level-traffic vector, on both loops; only the board leg is new, and
    the values are the monolithic run's."""
    mono = _trace_run(name, g, root)
    mt = mono.run.trace.to_dict()
    assert mt["chips_y"] == mt["chips_x"] == 1
    assert sum(mt["off_chip_msgs"]) == 0
    for chunk in (0, 8):
        dist = _trace_run(name, g, root, chips=4, run_chunk=chunk)
        dt = dist.run.trace.to_dict()
        for f in EQUIV_TRACE_FIELDS:
            assert dt[f] == mt[f], (name, chunk, f)
        assert sum(dt["off_chip_msgs"]) > 0, (name, chunk)
        assert sum(dt["off_chip_bits"]) > 0, (name, chunk)
        assert dt["chips_y"] * dt["chips_x"] == 4
        assert dt["board_links"] == board_link_provisioning(
            DCRA_SRAM, dt["chips_y"], dt["chips_x"])
        if name in MIN_APPS:
            assert np.array_equal(dist.values, mono.values), (name, chunk)
        else:
            np.testing.assert_allclose(dist.values, mono.values,
                                       rtol=ADD_RTOL, atol=ADD_ATOL)


def test_chain_graph_survives_boundary_crossings():
    """Termination is decided on the post-exchange state: on a path graph
    the frontier is repeatedly one record crossing the chip boundary, and
    every chip's pre-exchange queues look empty exactly then."""
    n = 64
    chain = csr_from_edges(np.arange(n - 1), np.arange(1, n), n)
    grid = square_grid(4)
    m = apps.bfs(chain, 0, grid, oq_cap=8, device="cpu")
    assert np.isfinite(m.values).all()
    for chips in (2, 4):
        for chunk in (0, 8):
            d = apps.bfs(chain, 0, grid, oq_cap=8, chips=chips,
                         run_chunk=chunk, device="cpu")
            assert np.array_equal(m.values, d.values)
            assert d.run.supersteps == m.run.supersteps


def test_distributed_engine_single_chip(g, root):
    """chips=1 through the DistributedEngine itself is the degenerate
    partition: it runs the monolithic schedule, with no off-chip leg."""
    cfg = engine.EngineConfig(grid=GRID, n_src=g.n_rows, n_dst=g.n_cols,
                              oq_cap=32)
    vals, run = driver.run_distributed(
        apps.BFS_SPEC, cfg, g.row_lo, g.row_hi, g.col_idx, g.weights,
        chips=1, seed_idx=root, seed_val=0.0, device="cpu")
    assert np.array_equal(vals[: g.n_rows], oracles.bfs_oracle(g, root))
    assert run.counters.off_chip_msgs == 0
    mono = apps.bfs(g, root, GRID, oq_cap=32, device="cpu")
    assert run.counters.as_dict() == mono.run.counters.as_dict()
    assert run.trace.to_dict() == mono.run.trace.to_dict()
    assert run.time_s == mono.run.time_s


def test_off_chip_only_when_partitioned(g, root):
    m = apps.bfs(g, root, GRID, oq_cap=32, device="cpu")
    assert m.run.counters.off_chip_msgs == 0
    d = apps.bfs(g, root, GRID, oq_cap=32, chips=4, device="cpu")
    c = d.run.counters
    assert c.off_chip_msgs > 0
    assert c.off_chip_hop_msgs >= c.off_chip_msgs   # >= 1 board hop each
    assert c.off_chip_msgs <= c.owner_msgs
    assert d.run.supersteps == m.run.supersteps


def test_more_chips_more_off_chip_traffic(g, root):
    offs = [apps.bfs(g, root, GRID, oq_cap=32, chips=c,
                     device="cpu").run.counters.off_chip_msgs
            for c in (2, 4, 16)]
    assert offs[0] < offs[1] < offs[2]


# ------------------------------------------ observer, at tests/test_obs.py
OBS_GRID, OBS_CHUNK = 16, 8


@pytest.fixture(scope="module")
def obs_inputs():
    g8, gj = (rmat_edges(8, edge_factor=8, seed=1),
              jrmat_edges(8, edge_factor=8, seed=1))
    bins = g8.n_rows // 8
    return dict(g=g8, gj=gj, bins=bins, root=int(np.argmax(g8.out_degree())),
                x=np.random.default_rng(3).random(g8.n_cols).astype(
                    np.float32),
                hv=histogram_input(g8, bins), hvj=jhistogram_input(gj, bins))


def _obs_run(name, inp, jax_side=False, **kw):
    """``tests/test_obs.py``'s ``_run`` at 4 chips."""
    pkg = japps if jax_side else apps
    grid = (jtilegrid.square_grid if jax_side else square_grid)(OBS_GRID)
    if not jax_side:
        kw["device"] = "cpu"
    kw.update(chips=4, run_chunk=OBS_CHUNK)
    g = inp["gj" if jax_side else "g"]
    if name == "bfs":
        return pkg.bfs(g, inp["root"], grid, oq_cap=16, **kw)
    if name == "sssp":
        return pkg.sssp(g, inp["root"], grid, oq_cap=16,
                        proxy=pkg.table2_proxy(grid, "sssp"), **kw)
    if name == "wcc":
        return pkg.wcc(g, grid, oq_cap=16,
                       proxy=pkg.table2_proxy(grid, "wcc"), **kw)
    if name == "pagerank":
        return pkg.pagerank(g, grid, epochs=2, oq_cap=16,
                            proxy=pkg.table2_proxy(grid, "pagerank"), **kw)
    if name == "spmv":
        return pkg.spmv(g, inp["x"], grid, oq_cap=16, proxy=pkg.table2_proxy(
            grid, "spmv", cascade_levels=1), **kw)
    return pkg.histogram(inp["hvj" if jax_side else "hv"], inp["bins"], grid,
                         oq_cap=8, proxy=pkg.table2_proxy(grid, "histo"),
                         **kw)


def _syncs() -> float:
    return default_registry().counter("engine.host_syncs").value


@pytest.mark.parametrize("name", ALL_APPS)
def test_observer_bit_identical_4chip(name, obs_inputs):
    s0 = _syncs()
    base = _obs_run(name, obs_inputs)
    syncs_off = _syncs() - s0
    rec = obs.TimelineRecorder()
    s1 = _syncs()
    r = _obs_run(name, obs_inputs, telemetry=True, observer=rec)
    assert _syncs() - s1 == syncs_off, "observer added host syncs"
    assert np.array_equal(base.values, r.values)
    assert base.run.counters.as_dict() == r.run.counters.as_dict()
    assert base.run.trace.to_dict() == r.run.trace.to_dict()
    assert base.run.supersteps == r.run.supersteps
    assert rec.meta.telemetry and rec.meta.n_chips == 4
    if name != "pagerank":            # pagerank: one span set per epoch
        assert rec.supersteps == r.run.supersteps
    jrec = jobs.TimelineRecorder()
    _obs_run(name, obs_inputs, jax_side=True, telemetry=True, observer=jrec)
    assert "pc_delivered" in rec.vec_keys()
    assert rec.vec_keys() == jrec.vec_keys()
    for key in jrec.vec_keys():
        assert np.array_equal(rec.vec_matrix(key),
                              jrec.vec_matrix(key)), key
    assert obs.run_load_matrix(rec).shape[1] == 4


# --------------------------------------------------------------- sanitizer
@pytest.mark.parametrize("chunk", (0, 8))
def test_sanitizer_4chip(g, root, chunk):
    clean = apps.sssp(g, root, GRID, proxy=apps.table2_proxy(GRID, "sssp"),
                      oq_cap=32, chips=4, run_chunk=chunk, sanitize=True,
                      device="cpu")
    assert np.allclose(clean.values, oracles.sssp_oracle(g, root))
    eng, state, _ = apps.engine_and_state("bfs", g, GRID, root=root,
                                          oq_cap=32, chips=4, sanitize=True,
                                          device="cpu")
    state["values"][2, 3] = float("nan")
    with pytest.raises(SanitizerError):
        eng.run(state, chunk=chunk)


# ------------------------------------------------------- weak scaling
def test_weak_scaling_matches_reference():
    got = harness.weak_scaling((1, 4, 16), device="cpu")
    want = jharness.weak_scaling((1, 4, 16))
    for a, b in zip(got, want):
        for key in ("chips", "tiles", "gteps", "time_s", "supersteps",
                    "off_chip_msgs", "off_chip_hop_msgs", "energy_j"):
            assert a[key] == b[key], (a["chips"], key)


# The sweep's 256-chip row (4,096 tiles) takes ~26 s on the CPU beside
# other busy processes, even on one thread; the CPU sweep stops at 64
# chips, and chip_smoke.py phase 10 runs the whole sweep on the card.
CPU_WEAK_CHIPS = (1, 4, 16, 64)


def test_weak_scaling_monotone():
    rows = harness.weak_scaling(CPU_WEAK_CHIPS, device="cpu")
    curve = [r["gteps"] for r in rows]
    assert all(b > a for a, b in zip(curve, curve[1:])), curve
    assert rows[-1]["chips"] == 64 and rows[-1]["tiles"] == 1024
    assert rows[0]["off_chip_msgs"] == 0
    for r in rows[1:]:
        assert r["off_chip_msgs"] > 0
        assert 0 < r["off_chip_j"] < r["energy_j"]
    for r in rows:
        assert r["reprice_ratio"] == 1.0, r
    assert harness.measured_gteps_curve(rows)[64] == curve[-1]


def test_strong_scaling_matches_reference():
    kw = dict(chip_counts=(1, 4, 16), n_tiles=64, scale=8)
    got = harness.strong_scaling(device="cpu", **kw)
    want = jharness.strong_scaling(**kw)
    assert [(r["chips"], r["gteps"], r["off_chip_msgs"]) for r in got] == \
        [(r["chips"], r["gteps"], r["off_chip_msgs"]) for r in want]


# --------------------------------------------------- one batched window
class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("hooks", ({}, dict(telemetry=True, sanitize=True)),
                         ids=("bare", "hooks"))
@pytest.mark.parametrize("name", ("bfs", "histo"))
def test_superstep_ops_do_not_grow_with_chips(g, root, name, hooks):
    """One superstep, with and without the flush leg, dispatches the same
    aten ops at 16 chips as at 2: every chip's tiles run as one window."""
    bins = g.n_rows // 8
    counts = {}
    for chips in (2, 16):
        eng, state, _ = apps.engine_and_state(
            name, g, GRID, None if name == "bfs" else
            apps.table2_proxy(GRID, name), root=root,
            histo_values=histogram_input(g, bins), bins=bins, chips=chips,
            oq_cap=16, device="cpu", **hooks)
        flat = eng._flat(state)
        for flush in (False, True):
            with _CountOps() as c:
                eng.kernel._superstep(flat, flush)
            counts[chips, flush] = c.n
    assert counts[2, False] == counts[16, False], counts
    assert counts[2, True] == counts[16, True], counts


# ------------------------------------------------------------- refusals
def test_unported_distributed_options_raise(g, root):
    with pytest.raises(NotImplementedError, match="A.5b"):
        apps.bfs(g, root, GRID, chips=4, compaction=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A.5b"):
        apps.bfs(g, root, GRID, chips=4, double_buffer=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        apps.bfs(g, root, GRID, chips=4, ckpt_every_supersteps=8,
                 device="cpu")
    eng, state, _ = apps.engine_and_state("bfs", g, GRID, root=root,
                                          chips=4, device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        eng.run(state, fault_injector=object())
    with pytest.raises(NotImplementedError, match="A.6"):
        eng.run(state, ckpt_dir="unused")
    kernel = eng.kernel
    for call in (lambda: kernel.init_state(),
                 lambda: kernel.activate_all(state, np.ones(g.n_rows)),
                 lambda: kernel.run(eng._flat(state))):
        with pytest.raises(ValueError, match="DistributedEngine"):
            call()
    with pytest.raises(ValueError, match="num_chips"):
        driver.DistributedEngine(apps.BFS_SPEC, kernel.cfg, g.row_lo,
                                 g.row_hi, g.col_idx, device="cpu")
    assert driver.partition(GRID, 4).num_chips == 4
