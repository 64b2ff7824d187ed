"""The port on a CUDA card: Hopper kernels against their plain versions,
the engine through the kernels against the same engine on the CPU, and
a superstep that makes no host sync of its own.

Every test here is marked ``gpu`` and skips without a CUDA device; the
decision is taken inside each test.  On a machine with a card:
``python -m pytest -m gpu tests/test_torch_gpu.py`` (needs no JAX).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
from repro_torch.kernels import deliver_fused as df
from repro_torch.kernels import ops
from repro_torch.kernels import relax_min as rx
from repro_torch.kernels import segment_combine as sc

pytestmark = pytest.mark.gpu

ADD_RTOL, ADD_ATOL = 1e-5, 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels run only there)")
    return torch.device("cuda")


def _with_inf(rng, n, p):
    x = rng.random(n).astype(np.float32) * 9
    return np.where(rng.random(n) < p, np.inf, x).astype(np.float32)


def _agree(combine, got, want):
    if combine == "min" or got.dtype != torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=ADD_RTOL, atol=ADD_ATOL)


@pytest.mark.parametrize("combine", ["min", "add"])
@pytest.mark.parametrize("n,nd", [(1, 1), (70_001, 9_999), (262_144, 1 << 20)])
def test_kernels_match_plain_on_card(combine, n, nd):
    dev = _card()
    rng = np.random.default_rng(n)

    def t(a):
        return torch.from_numpy(a).to(dev)

    v, m = t(_with_inf(rng, nd, .4)), t(_with_inf(rng, nd, .3))
    f = t(rng.random(nd) < 0.5)
    launches = rx.relax.launches
    for got, want in zip(rx.relax(v, m, f, combine), rx.plain(v, m, f,
                                                             combine)):
        assert torch.equal(got, want)
    assert rx.relax.launches == launches + 1
    seg = t(np.where(rng.random(n) < 0.25, -1,
                     rng.integers(0, nd, n)).astype(np.int32))
    val = t(rng.random(n).astype(np.float32) * 9)
    _agree(combine, sc.segment_combine(seg, val, nd, combine),
           sc.plain(seg, val, nd, combine))
    mail = t(_with_inf(rng, nd, .5) if combine == "min"
             else np.zeros(nd, np.float32))
    (gm, gc), (wm, wc) = (df.deliver_fused(seg, val, mail, combine),
                          df.plain(seg, val, mail, combine))
    _agree(combine, gm, wm)
    assert torch.equal(gc, wc)


def test_wrappers_check_their_inputs():
    dev = _card()
    x = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        sc.segment_combine(torch.zeros(8, dtype=torch.int64, device=dev), x,
                           8)
    with pytest.raises(ValueError, match="elements"):
        rx.relax(x, x[:4], x > 0)
    with pytest.raises(ValueError, match="contiguous"):
        df.deliver_fused(torch.zeros(8, dtype=torch.int32, device=dev),
                         x, torch.zeros(16, device=dev)[::2])


@pytest.mark.parametrize("proxied", [False, True], ids=["direct", "table2"])
@pytest.mark.parametrize("app", ["bfs", "sssp", "wcc"])
def test_engine_on_card_matches_cpu(app, proxied):
    dev = _card()
    g = rmat_edges(9, edge_factor=8, seed=1)
    grid = square_grid(64)
    px = apps.table2_proxy(grid, app) if proxied else None
    args = (g, grid) if app == "wcc" else (g, int(np.argmax(g.out_degree())),
                                           grid)
    fn = getattr(apps, app)
    ops.reset_launches()
    on_card = fn(*args, proxy=px, oq_cap=16, device=dev)
    steps = on_card.run.supersteps
    # the segment combine is the P$ group reduction: proxied runs only
    assert (rx.relax.launches, sc.segment_combine.launches,
            df.deliver_fused.launches) == (steps, steps if proxied else 0,
                                           steps)
    for res in (fn(*args, proxy=px, oq_cap=16, device=dev, backend="torch"),
                fn(*args, proxy=px, oq_cap=16, device="cpu")):
        assert np.array_equal(on_card.values, res.values)
        assert on_card.run.counters.as_dict() == res.run.counters.as_dict()
        assert on_card.run.trace.to_dict() == res.run.trace.to_dict()
        assert on_card.run.time_s == res.run.time_s


def test_superstep_makes_no_host_sync():
    """The run loop's one packed-stats fetch is the superstep's only
    device-to-host wait: the superstep itself makes no sync that
    PyTorch's sync debug mode detects."""
    dev = _card()
    g = rmat_edges(9, edge_factor=8, seed=1)
    grid = square_grid(64)
    cfg = engine.EngineConfig(grid=grid, n_src=g.n_rows, n_dst=g.n_cols,
                              oq_cap=16, proxy=apps.table2_proxy(grid, "bfs"))
    eng = engine.DataLocalEngine(apps.BFS_SPEC, cfg, g.row_lo, g.row_hi,
                                 g.col_idx, g.weights, device=dev)
    state = eng.init_state(seed_idx=int(np.argmax(g.out_degree())),
                           seed_val=0.0)
    state, stats = eng._superstep(state)          # builds the kernels
    engine.fetch_stats(stats)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, stats = eng._superstep(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert engine.fetch_stats(stats)["pending"] > 0
