"""The port on a CUDA card: Hopper kernels against their plain versions
(edge cases of the scatters, exact counts past 2^24, replay in a CUDA
graph), the engine through the kernels against the same engine on the
CPU (the min apps and the write-back add apps), a superstep that makes
no host sync of its own, and ``ops.decode_attention`` through its
kernel.

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
from repro_torch.kernels import decode_attention as da
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


def _sums64(seg, val, base):
    """``base`` plus the values of the records at each index, in f64."""
    out = base.astype(np.float64)
    ok = seg >= 0
    np.add.at(out, seg[ok], val[ok].astype(np.float64))
    return torch.from_numpy(out)


def _segments(rng, layout, n, nd):
    """int32 ids of ``n`` records into ``nd`` entries: "random" (a
    quarter padding, uniform ids), "one index" (every record on one),
    "runs" (sorted runs of 1, 31, 33 and 300 records, so runs cross warp
    and block boundaries, and a fifth of the records padding at the end)
    or "runs, padded" (those runs with padding interleaved)."""
    if layout == "random":
        ids = np.where(rng.random(n) < 0.25, -1, rng.integers(0, nd, n))
    elif layout == "one index":
        ids = np.full(n, nd // 2)
    else:
        lens = np.resize([1, 31, 33, 300], n)
        live = n - n // 5
        runs = int(np.searchsorted(np.cumsum(lens), live)) + 1
        ids = np.full(n, -1)
        ids[:live] = (np.repeat(np.arange(runs), lens[:runs])[:live] * nd
                      // max(runs, nd))
        if layout == "runs, padded":
            ids[rng.random(n) < 0.25] = -1
    return ids.astype(np.int32)


def _values(rng, layout, n, combine):
    """Record values; the run layouts mix in -0.0 and +0.0, and -inf and
    +inf for min (+inf alone for add, whose sums stay finite or +inf)."""
    val = rng.random(n).astype(np.float32) * 9
    if layout.startswith("runs"):
        pick = rng.random(n)
        val[pick < 0.05] = -0.0
        val[(pick >= 0.05) & (pick < 0.1)] = 0.0
        val[(pick >= 0.1) & (pick < 0.13)] = np.inf
        if combine == "min":
            val[(pick >= 0.13) & (pick < 0.16)] = -np.inf
    return val


@pytest.mark.parametrize("combine", ["min", "add"])
@pytest.mark.parametrize("n,nd,layout", [
    (1, 1, "random"), (70_001, 9_999, "random"),
    (262_144, 1 << 20, "random"), (5_000, 1, "random"),
    (70_001, 9_999, "one index"), (70_001, 9_999, "runs"),
    (70_001, 9_999, "runs, padded"), (262_144, 1 << 20, "runs"),
    (2_097_152, 524_288, "runs"), (2_097_152, 524_288, "runs, padded")])
def test_kernels_match_plain_on_card(combine, n, nd, layout):
    """relax, segment_combine and deliver_fused against their plain
    versions: min bitwise, counts exact; add within rtol 1e-5 / atol 1e-6
    of the f64 sums (with 70,001 records on one index the plain
    version's own f32 sum, one atomic add after another, is further off
    than that).  nd = 1, every record on one index (a whole warp of
    peers), sorted runs across warps and blocks, padding interleaved and
    at the end, +-inf and -0.0; runs again at 2,097,152 records, more
    than one batch for every thread of a resident grid, where the
    kernels fold runs within a warp."""
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
    seg_np = _segments(rng, layout, n, nd)
    val_np = _values(rng, layout, n, combine)
    mail_np = (_with_inf(rng, nd, .5) if combine == "min"
               else np.zeros(nd, np.float32))
    seg, val, mail = t(seg_np), t(val_np), t(mail_np)
    launches = sc.segment_combine.launches
    got = sc.segment_combine(seg, val, nd, combine)
    assert sc.segment_combine.launches == launches + 1
    if combine == "min":
        assert torch.equal(got, sc.plain(seg, val, nd, combine))
    else:
        torch.testing.assert_close(
            got.cpu().double(), _sums64(seg_np, val_np, np.zeros(nd)),
            rtol=ADD_RTOL, atol=ADD_ATOL)
    launches = df.deliver_fused.launches
    (gm, gc), (wm, wc) = (df.deliver_fused(seg, val, mail, combine),
                          df.plain(seg, val, mail, combine))
    assert df.deliver_fused.launches == launches + 1
    if combine == "min":
        assert torch.equal(gm, wm)
    else:
        torch.testing.assert_close(gm.cpu().double(),
                                   _sums64(seg_np, val_np, mail_np),
                                   rtol=ADD_RTOL, atol=ADD_ATOL)
    assert torch.equal(gc, wc)


@pytest.mark.parametrize("combine", ["min", "add"])
@pytest.mark.parametrize("n", [(1 << 24) - 1, (1 << 24) + 5])
def test_deliver_fused_counts_exact_on_card(n, combine):
    """Every record on one index, right below 2^24 records (f32 counts)
    and past it (int32 counts converted in place): the count equals the
    plain version's int32 count converted to f32 (2^24 + 5 rounds to
    2^24 + 4 there, where an f32 count would stop at 2^24); values
    bitwise (min) or exact (add: a few ones among zeros)."""
    dev = _card()
    rng = np.random.default_rng(5)
    assert df.counting_path(n) == ("f32" if n < 1 << 24 else "i32")
    seg = torch.full((n,), 3, dtype=torch.int32, device=dev)
    if combine == "min":
        val = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
        mail = torch.full((8,), np.inf, device=dev)
    else:
        val = torch.zeros(n, device=dev)
        val[torch.from_numpy(rng.integers(0, n, 1000)).to(dev)] = 1.0
        mail = torch.zeros(8, device=dev)
    (gm, gc), (wm, wc) = (df.deliver_fused(seg, val, mail, combine),
                          df.plain(seg, val, mail, combine))
    assert torch.equal(gm, wm)
    assert torch.equal(gc, wc)
    assert gc[3].item() == float(np.float32(n))


def test_engine_kernels_replay_in_a_cuda_graph():
    """segment_combine and deliver_fused (min and add; records fewer and
    more than the entries; 2,097,152 records, where segment_combine
    folds runs within a warp) captured in a CUDA graph: one launch each
    at capture and none at replay; a replay on fresh inputs copied into
    the captured buffers equals the eager calls on them, bitwise for min
    and the counts, within rtol 1e-5 / atol 1e-6 for add."""
    dev = _card()
    rng = np.random.default_rng(11)
    for combine, n, nd in (("min", 70_001, 9_999), ("add", 9_999, 70_001),
                           ("add", 20_000, 4_096),
                           ("min", 2_097_152, 524_288)):
        def inputs():
            return [torch.from_numpy(a).to(dev) for a in (
                _segments(rng, "runs, padded", n, nd),
                _values(rng, "runs", n, combine),
                _segments(rng, "random", n, nd),
                rng.random(n).astype(np.float32),
                _with_inf(rng, nd, .5) if combine == "min"
                else rng.random(nd).astype(np.float32))]

        def run(seg, val, dseg, dval, mail):
            return (sc.segment_combine(seg, val, nd, combine),
                    *df.deliver_fused(dseg, dval, mail, combine))

        bufs = inputs()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(*bufs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = (sc.segment_combine.launches, df.deliver_fused.launches)
        with torch.cuda.graph(graph):
            captured = run(*bufs)
        assert (sc.segment_combine.launches,
                df.deliver_fused.launches) == (before[0] + 1, before[1] + 1)
        for buf, fresh in zip(bufs, inputs()):
            buf.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert (sc.segment_combine.launches,
                df.deliver_fused.launches) == (before[0] + 1, before[1] + 1)
        eager = run(*bufs)
        _agree(combine, captured[0], eager[0])
        _agree(combine, captured[1], eager[1])
        assert torch.equal(captured[2], eager[2])


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
    q = torch.zeros((2, 4, 16), device=dev)
    kv = torch.zeros((2, 2, 40, 16), device=dev)
    lens = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, kv.transpose(2, 3).contiguous()
                            .transpose(2, 3), kv, lens)
    with pytest.raises(ValueError, match="dtype"):
        da.decode_attention(q, kv.bfloat16(), kv, lens)
    with pytest.raises(ValueError, match="dtype"):
        da.decode_attention(q.half(), kv.half(), kv.half(), lens)
    with pytest.raises(ValueError, match="multiple"):
        da.decode_attention(q[:, :3].contiguous(), kv, kv, lens)
    with pytest.raises(ValueError, match="range"):
        da.decode_attention(q[..., :12].contiguous(),
                            kv[..., :12].contiguous(),
                            kv[..., :12].contiguous(), lens)
    with pytest.raises(ValueError, match="elements"):
        da.decode_attention(q, kv, kv, lens[:1])


@pytest.mark.parametrize("length", [0, 1, 617, 1000, 1100, "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,d", [(1, 24, 2, 120), (3, 64, 1, 64),
                                       (2, 8, 8, 128), (2, 16, 4, 120),
                                       (128, 24, 2, 128)])
def test_decode_attention_matches_plain_on_card(b, h, hkv, d, dtype, length):
    """The split path (batch 1 to 3: 4 splits of 256 positions a pair)
    and one split a pair (batch 128: 256 pairs fill the card); D = 120
    (zero columns in the last k16 step) and 64; G = 12, 64 (four 16-head
    blocks), 1 and 4; lengths 0, 1, S, past S in a ragged padded block
    (S = 1000, block_s 256), and 617, which ends inside a 64-position
    tile, inside its third warp's 16 positions and inside a split; or a
    length per row from the seed (those five first at batch 128);
    rtol/atol 1e-4 in f32, 2e-2 in bf16."""
    dev = _card()
    rng = np.random.default_rng(7 if length == "ragged" else length)
    s = 1000
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dev, dt) for shape in [(b, h, d), (b, hkv, s, d),
                                          (b, hkv, s, d)])
    if length == "ragged":
        lens = rng.integers(0, s + 24, b).astype(np.int32)
        if b >= 5:
            lens[:5] = [0, 1, 617, s, s + 24]
    else:
        lens = np.full(b, length, np.int32)
    lens = torch.from_numpy(lens).to(dev)
    launches = da.decode_attention.launches
    got = ops.decode_attention(q, k, v, lens, block_s=256)
    assert da.decode_attention.launches == launches + 1
    assert got.dtype == dt and got.shape == (b, h, d)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), da.plain(q, k, v, lens,
                                                     block_s=256).float(),
                               rtol=tol, atol=tol)


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
