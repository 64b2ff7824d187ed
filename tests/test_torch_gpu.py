"""The port on a CUDA card: Hopper kernels against their plain versions,
the engine through the kernels against the same engine on the CPU (the
min apps and the write-back add apps), and a superstep that makes no
host sync of its own.

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
from repro_torch.graph.rmat import histogram_input
from repro_torch.kernels import deliver_fused as df
from repro_torch.kernels import histogram_bin as hb
from repro_torch.kernels import ops
from repro_torch.kernels import relax_min as rx
from repro_torch.kernels import segment_combine as sc
from repro_torch.kernels import spmv_csr as sp

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


@pytest.mark.parametrize("n,bins", [(1, 1), (100_003, 700),
                                    (1_000_000, 12_288),
                                    (1_000_000, 524_288)])
def test_histogram_bin_matches_plain_on_card(n, bins):
    """Both the shared-memory path (bins fit in 48 KB) and the global one;
    negative ids and ids past the last bin are skipped; bitwise."""
    dev = _card()
    rng = np.random.default_rng(n + bins)
    idx = torch.from_numpy(rng.integers(-5, bins + 5, n).astype(np.int32))
    launches = hb.histogram_bin.launches
    got = hb.histogram_bin(idx.to(dev), bins)
    assert hb.histogram_bin.launches == launches + 1
    assert torch.equal(got.cpu(), hb.plain(idx, bins))
    assert torch.equal(ops.histogram(idx.to(dev), bins).cpu(),
                       hb.plain(idx, bins))


@pytest.mark.parametrize("scale,bm,bk", [(7, 32, 48), (9, 128, 128),
                                         (10, 64, 200)])
def test_spmv_bcsr_matches_plain_on_card(scale, bm, bk):
    """Ragged last block-row and block-column; rtol/atol 1e-4 as the
    reference's own spmv test."""
    dev = _card()
    g = rmat_edges(scale, edge_factor=4, seed=scale)
    mat = ops.bcsr_from_csr(g.row_ptr, g.col_idx, g.weights,
                            (g.n_rows, g.n_cols), bm=bm, bk=bk)
    x = torch.from_numpy(np.random.default_rng(scale).random(g.n_cols)
                         .astype(np.float32))
    launches = sp.spmv_bcsr.launches
    got = ops.spmv(mat.to(dev), x.to(dev))
    assert sp.spmv_bcsr.launches == launches + 1
    torch.testing.assert_close(got.cpu(), ops.spmv(mat, x), rtol=1e-4,
                               atol=1e-4)


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
    with pytest.raises(ValueError, match="dtype"):
        hb.histogram_bin(torch.zeros(8, dtype=torch.int64, device=dev), 4)
    with pytest.raises(ValueError, match="block"):
        sp.spmv_bcsr(torch.zeros((2, 1, 4, 4), device=dev),
                     torch.zeros((2, 2), dtype=torch.int32, device=dev), x,
                     8)


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


@pytest.mark.parametrize("cascade", [0, 2], ids=["no-cascade", "cascade2"])
@pytest.mark.parametrize("app", ["spmv", "histo", "pagerank"])
def test_add_app_on_card_matches_cpu(app, cascade):
    """The write-back P$, its flush and the cascade on the card: counters,
    trace, supersteps and time_s equal to the CPU run; values to f32
    re-association (Histogram bitwise)."""
    dev = _card()
    g = rmat_edges(9, edge_factor=8, seed=1)
    grid = square_grid(64)
    px = apps.table2_proxy(grid, app, cascade_levels=cascade)
    x = np.random.default_rng(0).random(g.n_cols).astype(np.float32)
    bins = g.n_rows // 8
    fn, args = dict(
        spmv=(apps.spmv, (g, x, grid)),
        histo=(apps.histogram, (histogram_input(g, bins), bins, grid)),
        pagerank=(apps.pagerank, (g, grid)))[app]
    kw = dict(proxy=px, oq_cap=16, **({"epochs": 2} if app == "pagerank"
                                     else {}))
    ops.reset_launches()
    on_card = fn(*args, device=dev, **kw)
    steps = on_card.run.supersteps
    for k in (rx.relax, sc.segment_combine, df.deliver_fused):
        assert k.launches >= steps
    cpu = fn(*args, device="cpu", **kw)
    if app == "histo":
        assert np.array_equal(on_card.values, cpu.values)
    else:
        np.testing.assert_allclose(on_card.values, cpu.values, rtol=1e-4,
                                   atol=1e-5)
    assert on_card.run.counters.as_dict() == cpu.run.counters.as_dict()
    assert on_card.run.trace.to_dict() == cpu.run.trace.to_dict()
    assert on_card.run.time_s == cpu.run.time_s


def test_superstep_makes_no_host_sync():
    """The run loop's one packed-stats fetch is the superstep's only
    device-to-host wait: the superstep itself -- write-through, or
    write-back with the cascade, flush superstep included -- makes no
    sync that PyTorch's sync debug mode detects."""
    dev = _card()
    g = rmat_edges(9, edge_factor=8, seed=1)
    grid = square_grid(64)
    for app in ("bfs", "spmv"):
        eng, state, _ = apps.engine_and_state(
            app, g, grid, apps.table2_proxy(grid, app, cascade_levels=2),
            root=int(np.argmax(g.out_degree())), oq_cap=16, device=dev)
        state, stats = eng._superstep(state)      # builds the kernels
        engine.fetch_stats(stats)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for flush in (False, False, True):
                state, stats = eng._superstep(state, flush)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert engine.fetch_stats(stats)["pending"] > 0
