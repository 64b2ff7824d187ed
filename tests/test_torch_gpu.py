"""The port on a CUDA card: Hopper kernels against their plain versions
(edge cases of the scatters, exact counts past 2^24, replay in a CUDA
graph), the engine through the kernels against the same engine on the
CPU (the min apps and the write-back add apps), a superstep that makes
no host sync of its own, the chunked run loop's CUDA-graph replays
against the per-step loop (with compaction, one graph per flush value
and window: no sync in any, launch counts per graph, results equal to
dense; with telemetry, the sanitizer and an observer, results and host
syncs equal to the run without them), ``ops.decode_attention``
through its kernel, a partitioned run that recovers from a chip loss
without capturing a graph again, the dense train step on the card
against the same step on the CPU, the MoE families' decode and train
steps (granite-moe, deepseek-v3) on the card against the CPU, and
``decode_attention`` at G = 1, D = 64 with the recurrent and
encoder-decoder families' decode steps (zamba2, whisper, xlstm) on the
card against the CPU, the proxy-region collectives and the pipeline
on a one-rank NCCL group against a one-rank gloo group on the CPU, and
the sharded train step on a one-rank NCCL grid against the plain step.

Every test here is marked ``gpu`` and skips without a CUDA device; the
decision is taken inside each test.  On a machine with a card:
``python -m pytest -m gpu tests/test_torch_gpu.py`` (needs no JAX).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs
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
from repro_torch.obs.metrics import default_registry
from repro_torch.runtime import FaultInjector

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


# (n, bins, path on an H100: 232,448 B of shared memory a block)
HISTOGRAM_CASES = [
    (1, 1, "private"), (0, 700, "private"), (100_003, 700, "private"),
    (1_000_000, 12_288, "private"), (1_000_000, 58_112, "private"),
    (1_000_000, 58_113, "sliced"), (1_000_000, 100_003, "sliced"),
    (0, 524_288, "sliced"), (1_000_000, 524_288, "sliced"),
    (8_000_003, 524_288, "sliced"), (1_000_000, 524_289, "sliced"),
    (1_000_000, 929_792, "sliced"), (1_000_000, 929_793, "sliced"),
    (3_000_000, 7_438_336, "sliced"), (3_000_000, 7_438_337, "global"),
]


@pytest.mark.parametrize("n,bins,path", HISTOGRAM_CASES)
def test_histogram_bin_matches_plain_on_card(n, bins, path):
    """Every path and each boundary between them, bitwise: negative ids
    and ids past the last bin are skipped; at 524,288 bins (the Histogram
    app's) the sliced path of 16 slices of 32,768 ran."""
    dev = _card()
    rng = np.random.default_rng(n + bins)
    idx = torch.from_numpy(rng.integers(-5, bins + 5, n).astype(np.int32))
    launches = hb.histogram_bin.launches
    got = hb.histogram_bin(idx.to(dev), bins)
    assert hb.histogram_bin.launches == launches + 1
    p, resident = hb.histogram_bin.last
    assert p.path == path
    if path != "global":
        assert resident >= p.slices
    if bins == 524_288:
        assert (p.slices, p.per_block) == (16, 32_768)
    assert torch.equal(got.cpu(), hb.plain(idx, bins))
    assert torch.equal(ops.histogram(idx.to(dev), bins).cpu(),
                       hb.plain(idx, bins))


@pytest.mark.parametrize("bins", [700, 58_113, 100_003, 524_288, 929_793])
def test_histogram_bin_neighbouring_ids_on_card(bins):
    """The Histogram app's kind of ids, (i + w_i) mod bins with w_i in
    [1, 255], with padding mixed in: on the sliced path nearly every id
    falls in its block's own slice; same bits."""
    dev = _card()
    rng = np.random.default_rng(bins)
    n = 3_000_017
    idx = (np.arange(n) + rng.integers(1, 256, n)) % bins
    idx = np.where(rng.random(n) < 0.01, -1, idx).astype(np.int32)
    idx = torch.from_numpy(idx)
    assert torch.equal(hb.histogram_bin(idx.to(dev), bins).cpu(),
                       hb.plain(idx, bins))


@pytest.mark.parametrize("bins", [700, 524_288, 7_438_337])
def test_histogram_bin_unaligned_ids_on_card(bins):
    """ids that start 4 bytes past a 16-byte boundary take the scalar
    loads; same bits."""
    dev = _card()
    rng = np.random.default_rng(bins)
    idx = torch.from_numpy(rng.integers(-3, bins + 3, 300_001)
                           .astype(np.int32))
    got = hb.histogram_bin(idx.to(dev)[1:], bins)
    assert torch.equal(got.cpu(), hb.plain(idx[1:], bins))


@pytest.mark.parametrize("bins", [3, 524_288])
def test_histogram_bin_hot_bin_past_f32_on_card(bins):
    """One bin takes 2^24 + 1 ids, where f32 rounds (to 2^24): the counts
    stay int32 until the one conversion, as in the plain version."""
    dev = _card()
    idx = torch.full(((1 << 24) + 1 + 1000,), bins - 1, dtype=torch.int32)
    idx[-1000:] = torch.arange(1000, dtype=torch.int32) % (bins - 1)
    got = hb.histogram_bin(idx.to(dev), bins).cpu()
    want = hb.plain(idx, bins)
    assert torch.equal(got, want)
    assert got[bins - 1] == float(1 << 24)


def test_histogram_bin_refuses_int64_ids_on_card():
    dev = _card()
    before = hb.histogram_bin.launches
    with pytest.raises(ValueError, match="dtype"):
        hb.histogram_bin(torch.zeros(8, dtype=torch.int64, device=dev), 4)
    assert hb.histogram_bin.launches == before


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
    got, _ = ops.decode_attention(q, k, v, lens, block_s=256)
    assert da.decode_attention.launches == launches + 1
    assert got.dtype == dt and got.shape == (b, h, d)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), da.plain(q, k, v, lens,
                                                     block_s=256)[0].float(),
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
    syncs = default_registry().counter("engine.host_syncs")
    ops.reset_launches()
    before = syncs.value
    on_card = fn(*args, proxy=px, oq_cap=16, device=dev)
    # the default chunked loop ran 16 predicated supersteps a chunk (the
    # idle rows of the last one included), each kernel once in each; the
    # segment combine is the P$ group reduction: proxied runs only
    ran = 16 * (syncs.value - before)
    assert ran >= on_card.run.supersteps
    assert (rx.relax.launches, sc.segment_combine.launches,
            df.deliver_fused.launches) == (ran, ran if proxied else 0, ran)
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


# ------------------------------------------------- the chunked run loop
def _chunk_case(app, scale=12, tiles=256):
    """An app call at RMAT-``scale`` on ``tiles`` tiles: (fn, args, kw)."""
    g = rmat_edges(scale, edge_factor=8, seed=1)
    grid = square_grid(tiles)
    if app == "bfs":
        return apps.bfs, (g, int(np.argmax(g.out_degree())), grid), dict(
            proxy=apps.table2_proxy(grid, "bfs"), oq_cap=16)
    x = np.random.default_rng(0).random(g.n_cols).astype(np.float32)
    return apps.spmv, (g, x, grid), dict(
        proxy=apps.table2_proxy(grid, "spmv", cascade_levels=2), oq_cap=16)


def _same_run(a, b, app):
    if app == "bfs":
        assert np.array_equal(a.values, b.values)
    else:
        np.testing.assert_allclose(a.values, b.values, rtol=1e-4, atol=1e-5)
    assert a.run.counters.as_dict() == b.run.counters.as_dict()
    assert a.run.trace.to_dict() == b.run.trace.to_dict()
    assert a.run.supersteps == b.run.supersteps
    assert a.run.time_s == b.run.time_s


@pytest.mark.parametrize("app", ["bfs", "spmv"])
def test_chunked_graph_replays_match_per_step_on_card(app):
    """The default chunked loop (16 supersteps a host fetch, each a CUDA
    graph replay after each graph's first, eager, superstep) against the
    per-step loop at RMAT-12 on 256 tiles: BFS bitwise; SpMV (write-back,
    selective 2-level cascade) exact in counters, trace, supersteps and
    ``time_s``, values to f32 re-association of the atomic adds."""
    dev = _card()
    fn, args, kw = _chunk_case(app)
    reg = default_registry()
    syncs, replays = (reg.counter("engine.host_syncs"),
                      reg.counter("engine.graph_replays"))
    per_step = fn(*args, device=dev, run_chunk=0, **kw)
    s0, r0 = syncs.value, replays.value
    chunked = fn(*args, device=dev, **kw)
    _same_run(chunked, per_step, app)
    chunks, graphs = syncs.value - s0, 1
    if app == "bfs":
        assert chunks == -(-chunked.run.supersteps // 16)
    else:
        assert 0.0 in chunked.run.trace.pending[:-1]   # it flushed
        graphs = 2                 # the no-flush and the flush graph
    assert replays.value - r0 == 16 * chunks - graphs


def _runner(app, length, scale=9, tiles=64, **kw):
    g = rmat_edges(scale, edge_factor=8, seed=1)
    grid = square_grid(tiles)
    eng, state, _ = apps.engine_and_state(
        app, g, grid, apps.table2_proxy(
            grid, app, cascade_levels=2 if app == "spmv" else 0),
        root=int(np.argmax(g.out_degree())),
        x=np.ones(g.n_cols, np.float32), oq_cap=16, device=_card(), **kw)
    return eng.chunk_runner(state, length)


HOOKS = dict(telemetry=True, sanitize=True)


@pytest.mark.parametrize("hooks", [{}, HOOKS], ids=["bare", "hooks"])
def test_chunk_replays_make_no_host_sync(hooks):
    """Once captured, a chunk of replays -- the no-flush graph, and the
    flush graph of write-back SpMV with the cascade -- makes no sync that
    PyTorch's sync debug mode detects; its one fetch comes after.  Also
    with telemetry and the sanitizer on, whose vectors and counts the
    fetch brings too."""
    for app in ("bfs", "spmv"):
        runner = _runner(app, 4, **hooks)
        for flush in (False, True):
            runner.launch(10_000, flush)          # warm-up and capture
            runner.fetch()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for flush in (False, True):
                runner.launch(10_000, flush)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = runner.fetch()
        assert not got.done and got.rows[:, -1].sum() >= 1
        assert set(got.vecs) == (set(engine.TELEMETRY_KEYS) if hooks
                                 else set())
        assert all(v.shape == (4, 64) for v in got.vecs.values())


def test_chunk_launch_counts_are_replays_times_captures():
    """Every kernel's count after chunks of BFS (write-through P$) is the
    predicated supersteps run times its launches per graph, the first,
    eager superstep included; the capture itself adds nothing."""
    runner = _runner("bfs", 4)
    replays = default_registry().counter("engine.graph_replays")
    before = replays.value
    ops.reset_launches()
    runner.launch(10_000, False)
    runner.fetch()
    per_graph = runner.captured[False, None]
    assert per_graph == {"relax": 1, "segment_combine": 1,
                         "deliver_fused": 1}
    want = {k.__name__: 4 * per_graph.get(k.__name__, 0)
            for k in ops.KERNELS}
    assert ops.launch_counts() == want
    runner.launch(10_000, False)
    runner.fetch()
    assert replays.value - before == 7
    assert ops.launch_counts() == {k: 2 * n for k, n in want.items()}


@pytest.mark.parametrize("edge", ["last row", "first row"])
def test_flush_at_a_chunk_edge_on_card(edge):
    """SpMV's first flush scheduled by a chunk's last row (the next chunk
    starts with a replay of the flush graph) and by a chunk's first row
    (the rest of the chunk idles): both give the per-step result."""
    dev = _card()
    fn, args, kw = _chunk_case("spmv", scale=10, tiles=64)
    per_step = fn(*args, device=dev, run_chunk=0, **kw)
    d = per_step.run.trace.pending[:-1].index(0.0)
    assert d >= 2
    chunked = fn(*args, device=dev,
                 run_chunk=d + 1 if edge == "last row" else d, **kw)
    _same_run(chunked, per_step, "spmv")


# ------------------------------------------- compaction on the chunked loop
WINDOWS = (None, 16, 4, 1)     # capacity_ladder(64, 3): dense, then rungs


def _compacted_keys(app):
    return [(flush, w) for flush in ((False, True) if app == "spmv"
                                     else (False,)) for w in WINDOWS]


@pytest.mark.parametrize("app", ["bfs", "spmv"])
def test_compacted_chunk_replays_make_no_host_sync(app):
    """With compaction=3, a chunk in every (flush, window) key -- windows
    the state's active tiles outgrow included, whose rows idle -- replays
    with no sync that PyTorch's sync debug mode detects."""
    runner = _runner(app, 4, compaction=3)
    keys = _compacted_keys(app)
    for flush, w in keys:                      # warm-up and capture
        runner.launch(10_000, flush, w)
        runner.fetch()
    assert sorted(runner.captured, key=str) == sorted(keys, key=str)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for flush, w in keys:
            runner.launch(10_000, flush, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = runner.fetch()
    assert not got.done and 0 <= got.active_tiles <= 64


def test_compacted_launch_counts_per_key():
    """Each kernel's count after one chunk in each window of BFS is, per
    (flush, window) key, the predicated supersteps run times the launches
    captured in that key's graph; every graph launches each engine kernel
    once."""
    runner = _runner("bfs", 4, compaction=3)
    replays = default_registry().counter("engine.graph_replays")
    before = replays.value
    ops.reset_launches()
    keys = _compacted_keys("bfs")
    for flush, w in keys:
        runner.launch(10_000, flush, w)
        runner.fetch()
    for key in keys:
        assert runner.captured[key] == {"relax": 1, "segment_combine": 1,
                                        "deliver_fused": 1}
    want = {k.__name__: sum(4 * runner.captured[key].get(k.__name__, 0)
                            for key in keys) for k in ops.KERNELS}
    assert ops.launch_counts() == want
    for flush, w in keys:
        runner.launch(10_000, flush, w)
        runner.fetch()
    assert replays.value - before == (2 * 4 - 1) * len(keys)
    assert ops.launch_counts() == {k: 2 * n for k, n in want.items()}


@pytest.mark.parametrize("app", ["bfs", "spmv"])
def test_compacted_chunked_run_matches_dense_on_card(app):
    """A compacted run on the chunked loop (windows picked per chunk,
    replayed from one graph per flush value and window) equals the dense
    chunked run: BFS bitwise, SpMV exact in counters, trace, supersteps
    and ``time_s``, values to f32 re-association."""
    dev = _card()
    fn, args, kw = _chunk_case(app)
    reg = default_registry()
    captures = reg.counter("engine.graph_captures")
    dense = fn(*args, device=dev, **kw)
    c0 = captures.value
    comp = fn(*args, device=dev, compaction=3, **kw)
    _same_run(comp, dense, app)
    assert captures.value - c0 >= 2        # dense and at least one window


@pytest.mark.parametrize("compaction", [0, 3])
@pytest.mark.parametrize("app", ["bfs", "spmv"])
def test_chunked_run_with_hooks_equals_bare_on_card(app, compaction):
    """Graph-replayed chunks with telemetry, the sanitizer and an
    observer equal the same run without them (BFS bitwise, SpMV exact in
    counters, trace, supersteps and ``time_s``, values to f32
    re-association), with the same host syncs, and every kernel still
    launched inside the replayed graphs; the recorder holds every
    superstep, clean, with its (T,) load vectors."""
    dev = _card()
    fn, args, kw = _chunk_case(app)
    reg = default_registry()
    syncs, replays = (reg.counter("engine.host_syncs"),
                      reg.counter("engine.graph_replays"))
    s0 = syncs.value
    bare = fn(*args, device=dev, compaction=compaction, **kw)
    s1, r1 = syncs.value, replays.value
    rec = obs.TimelineRecorder()
    ops.reset_launches()
    hooked = fn(*args, device=dev, compaction=compaction, observer=rec,
                **HOOKS, **kw)
    _same_run(hooked, bare, app)
    assert syncs.value - s1 == s1 - s0
    assert replays.value - r1 > 0
    launches = ops.launch_counts()
    assert all(launches[k] >= hooked.run.supersteps
               for k in ("relax", "segment_combine", "deliver_fused"))
    assert rec.supersteps == hooked.run.supersteps
    assert not rec.stat_matrix("sanity_violations").any()
    load = rec.vec_matrix("tv_delivered")
    assert load.shape == (hooked.run.supersteps, 256)
    assert load.sum() == hooked.run.counters.owner_msgs


# ------------------------------------------------ the partitioned engine
def _chips_case(app, chips=4):
    """RMAT-9 on 8x8 tiles in ``chips`` chips under the Table-II proxy
    (SpMV with a 2-level cascade, cut at the chip boundary)."""
    g = rmat_edges(9, edge_factor=8, seed=1)
    grid = square_grid(64)
    if app == "bfs":
        return apps.bfs, (g, int(np.argmax(g.out_degree())), grid), dict(
            proxy=apps.table2_proxy(grid, "bfs"), oq_cap=16, chips=chips)
    x = np.random.default_rng(0).random(g.n_cols).astype(np.float32)
    return apps.spmv, (g, x, grid), dict(
        proxy=apps.table2_proxy(grid, "spmv", cascade_levels=2), oq_cap=16,
        chips=chips)


@pytest.mark.parametrize("app", ["bfs", "spmv"])
def test_partitioned_kernels_match_torch_on_card(app):
    """4 chips in one batched superstep on the card: the kernels backend
    equals the torch backend and the CPU run (counters, trace,
    supersteps, ``time_s`` exact; BFS values bitwise, SpMV's to f32
    re-association), records crossed chips, and every engine kernel ran
    in each superstep."""
    dev = _card()
    fn, args, kw = _chips_case(app)
    ops.reset_launches()
    on_card = fn(*args, device=dev, **kw)
    assert on_card.run.counters.off_chip_msgs > 0
    steps = on_card.run.supersteps
    assert rx.relax.launches >= steps
    assert sc.segment_combine.launches >= steps
    # on-chip delivery and the board exchange, each superstep
    assert df.deliver_fused.launches >= 2 * steps
    for other in (fn(*args, device=dev, backend="torch", **kw),
                  fn(*args, device="cpu", **kw)):
        _same_run(on_card, other, app)


def test_partitioned_chunk_replays_make_no_host_sync():
    """A 4-chip chunk of replays (BFS; SpMV's no-flush and flush graphs)
    makes no sync that PyTorch's sync debug mode detects, with the
    per-chip telemetry and the sanitizer's count in its one fetch."""
    for app in ("bfs", "spmv"):
        runner = _runner(app, 4, chips=4, **HOOKS)
        for flush in (False, True):
            runner.launch(10_000, flush)          # warm-up and capture
            runner.fetch()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for flush in (False, True):
                runner.launch(10_000, flush)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = runner.fetch()
        assert not got.done and got.rows[:, -1].sum() >= 1
        assert "pc_offchip" in got.vecs
        assert all(v.shape == (4, 4) for v in got.vecs.values())


# ------------------------- the double-buffered exchange, per-chip windows
CHIP_WINDOWS = (None, 4, 1)    # capacity_ladder(16, 3): 16 tiles a chip


def test_double_buffered_compacted_chunk_replays_make_no_host_sync():
    """A double-buffered, compacted 4-chip chunk in every (flush, window)
    key replays with no sync that PyTorch's sync debug mode detects; the
    deferred values live in one tensor that every graph of the runner
    writes in place, each graph carries the exchange in a deliver_fused
    of its own (SpMV's flush graph delivers its flush wave in one more),
    and the buffer held records between replays."""
    for app in ("bfs", "spmv"):
        runner = _runner(app, 4, chips=4, compaction=3, double_buffer=True,
                         **HOOKS)
        identity = float("inf") if app == "bfs" else 0.0
        buf = runner.state[engine.DEFERRED]
        ptr = buf.data_ptr()
        keys = [(flush, w) for flush in (False, True) for w in CHIP_WINDOWS]
        held = False
        for flush, w in keys:                     # warm-up and capture
            runner.launch(10_000, flush, w)
            runner.fetch()
            held = held or bool(torch.any(buf != identity))
        assert held
        for flush, w in keys:
            want = 3 if flush and app == "spmv" else 2
            assert runner.captured[flush, w]["deliver_fused"] == want
        torch.cuda.set_sync_debug_mode("error")
        try:
            for flush, w in keys:
                runner.launch(10_000, flush, w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = runner.fetch()
        assert runner.state[engine.DEFERRED].data_ptr() == ptr
        assert not got.done and 0 <= got.active_tiles <= 16


@pytest.mark.parametrize("app", ["bfs", "spmv"])
def test_partitioned_double_buffered_compacted_matches_on_card(app):
    """4 chips, ``double_buffer=True, compaction=3`` on the card, chunked:
    equal to the card's synchronous dense run but for the priced overlap
    (counters, the trace less its ``double_buffer`` field, supersteps;
    ``time_s`` at most the synchronous one), and to the torch backend,
    the per-step loop and the CPU run (counters, trace, supersteps,
    ``time_s`` exact; BFS values bitwise, SpMV's to f32
    re-association)."""
    dev = _card()
    fn, args, kw = _chips_case(app)
    sync = fn(*args, device=dev, **kw)
    kw = dict(kw, double_buffer=True, compaction=3)
    got = fn(*args, device=dev, **kw)
    a, b = got.run.trace.to_dict(), sync.run.trace.to_dict()
    assert a.pop("double_buffer") and not b.pop("double_buffer")
    assert a == b
    assert got.run.counters.as_dict() == sync.run.counters.as_dict()
    assert got.run.supersteps == sync.run.supersteps
    assert got.run.time_s <= sync.run.time_s
    for other in (fn(*args, device=dev, backend="torch", **kw),
                  fn(*args, device=dev, run_chunk=0, **kw),
                  fn(*args, device="cpu", **kw)):
        _same_run(got, other, app)


# ------------------------------------------------ fault tolerance, A.6
def test_fault_recovery_on_card(tmp_path):
    """A 4-chip BFS at RMAT-12 on 256 tiles on the card, chunked, with a
    checkpoint every 8 supersteps and chip 2 lost half way: values,
    counters, trace rows and supersteps equal the unfailed run's, the
    recovery is priced apart and re-priced exactly, every engine kernel
    ran, and the restore into the runner's tensors captured no graph
    that the unfailed run did not (``engine.graph_captures`` equal)."""
    from repro_torch.core.costmodel import trace_time_s
    dev = _card()
    g = rmat_edges(12, edge_factor=8, seed=1)
    grid = square_grid(256)
    kw = dict(proxy=apps.table2_proxy(grid, "bfs"), oq_cap=16, chips=4,
              root=int(np.argmax(g.out_degree())), device=dev,
              ckpt_every_supersteps=8)
    captures = default_registry().counter("engine.graph_captures")
    eng, state, _ = apps.engine_and_state("bfs", g, grid, **kw)
    c0 = captures.value
    base_state, base = eng.run(dict(state))
    base_captures = captures.value - c0
    eng, state, _ = apps.engine_and_state("bfs", g, grid, **kw)
    inj = FaultInjector(at_superstep=base.supersteps // 2, chip=2)
    ops.reset_launches()
    c0 = captures.value
    f_state, f = eng.run(dict(state), fault_injector=inj,
                         ckpt_dir=str(tmp_path))
    assert inj.fired
    assert captures.value - c0 == base_captures
    assert torch.equal(base_state["values"], f_state["values"])
    assert base.counters.as_dict() == f.counters.as_dict()
    assert base.supersteps == f.supersteps
    a, b = base.trace.to_dict(), f.trace.to_dict()
    a.pop("recovery_events"), b.pop("recovery_events")
    assert a == b
    kinds = [ev["kind"] for ev in f.trace.recovery_events]
    assert kinds.count("rollback") == 1 and kinds.count("reshard") == 1
    assert f.time_s > base.time_s
    assert trace_time_s(eng.cfg.pkg, grid, f.trace) == f.time_s
    assert rx.relax.launches >= f.supersteps
    assert sc.segment_combine.launches >= f.supersteps
    assert df.deliver_fused.launches >= 2 * f.supersteps



# ------------------------------------------------------- ranks, A.5c
@pytest.fixture
def nccl_group(tmp_path):
    """A one-rank NCCL group on a file store: the card holds one rank,
    and a group given to the engine runs its collectives even there."""
    import datetime
    import torch.distributed as dist
    _card()
    if not dist.is_nccl_available():
        pytest.skip("this PyTorch has no NCCL")
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_ranks_one_nccl_rank_matches_in_process(nccl_group, monkeypatch):
    """A 4-chip BFS at RMAT-12 on 256 tiles through a one-rank NCCL group
    equals the in-process run on both loops (values bitwise; counters,
    trace, supersteps, ``time_s``), its collectives ran (two all-gathers
    a superstep on the per-step loop: the exchange and the stats), and a
    chunk of its graphs, collectives captured, replays with no sync that
    PyTorch's sync debug mode detects."""
    from repro_torch.distrib import mesh as tmesh
    dev = _card()
    g = rmat_edges(12, edge_factor=8, seed=1)
    grid = square_grid(256)
    root = int(np.argmax(g.out_degree()))
    kw = dict(proxy=apps.table2_proxy(grid, "bfs"), oq_cap=16, chips=4,
              device=dev)
    want = apps.bfs(g, root, grid, **kw)
    gathers = []
    gather = tmesh._all_gather_single

    def counted(*a, **k):
        gathers.append(1)
        return gather(*a, **k)
    monkeypatch.setattr(tmesh, "_all_gather_single", counted)
    on_ranks = dict(kw, backend="shard_map", group=nccl_group)
    for chunk in (16, 0):
        n0 = len(gathers)
        got = apps.bfs(g, root, grid, run_chunk=chunk, **on_ranks)
        _same_run(got, want, "bfs")
    assert len(gathers) - n0 >= 2 * got.run.supersteps
    eng, state, _ = apps.engine_and_state("bfs", g, grid, root=root,
                                          **on_ranks)
    assert eng.mesh.collective and eng.mesh.ndev == 1
    runner = eng.chunk_runner(state, 4)
    runner.launch(10_000, False)                  # warm-up and capture
    runner.fetch()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.launch(10_000, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = runner.fetch()
    assert not got.done and got.rows[:, -1].sum() == 4


def test_ranks_one_nccl_rank_compacted_double_buffered(nccl_group):
    """SpMV (write-back P$, cascade, the flush graph) on 4 chips with
    ``compaction=3`` and ``double_buffer=True`` through a one-rank NCCL
    group, on both loops: equal to the in-process run (counters, trace,
    supersteps, ``time_s``; values to f32 re-association), every
    (flush, window) graph captured with its collectives."""
    dev = _card()
    fn, args, kw = _chips_case("spmv")
    kw = dict(kw, device=dev, compaction=3, double_buffer=True)
    want = fn(*args, **kw)
    for chunk in (16, 0):
        got = fn(*args, backend="shard_map", group=nccl_group,
                 run_chunk=chunk, **kw)
        _same_run(got, want, "spmv")


# ------------------------------------- collectives and pipeline, A.10d-1
def test_collectives_one_nccl_rank_equal_gloo(nccl_group):
    """On a 1 x 1 grid over the one-rank NCCL group (``proxy_psum`` takes
    its reduce-scatter -> all-reduce -> all-gather path), ``proxy_psum``,
    ``compressed_proxy_psum`` (shards of 1 and 3 blocks, the pad) and
    ``two_hop_all_to_all`` on CUDA tensors equal, bitwise, the same calls
    on a 1 x 1 grid of gloo groups with CPU tensors; ``run_pipeline`` at
    one stage (``tanh(x @ w)``, f32 GEMMs on two devices) within 1e-5.
    A gloo group handed CUDA tensors raises ``ValueError``."""
    from repro_torch.core import collectives as coll
    from repro_torch.core import pipeline as pipe
    import torch.distributed as dist
    dev = _card()
    on_card = coll.make_grid((1, 1), ("pod", "data"))
    gloo = dist.new_group([0], backend="gloo", timeout=coll.GROUP_TIMEOUT)
    on_cpu = coll.Grid(on_card.shape, on_card.names, on_card.coords,
                       {k: gloo for k in on_card.groups})
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((16, 8), (40, 33), (64,))]
    a2a = torch.from_numpy(rng.standard_normal((1, 1, 6, 5)).astype(
        np.float32))
    calls = [lambda x, g: coll.proxy_psum(x, "data", "pod", grid=g),
             lambda x, g: coll.compressed_proxy_psum(x, "data", "pod",
                                                     grid=g)]
    for x in xs:
        for call in calls:
            got = call(x.to(dev), on_card)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), call(x, on_cpu))
    got = coll.two_hop_all_to_all(a2a.to(dev), "data", "pod", grid=on_card)
    assert torch.equal(got.cpu(), coll.two_hop_all_to_all(
        a2a, "data", "pod", grid=on_cpu))
    assert torch.equal(got.cpu(), a2a)
    w = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32)
                         * 0.2)
    x_mb = torch.from_numpy(rng.standard_normal((6, 2, 3, 16)).astype(
        np.float32))

    def stage_fn(wi, xi):
        return torch.tanh(xi @ wi)
    got = pipe.run_pipeline(stage_fn, w.to(dev), x_mb.to(dev),
                            on_card.group("pod"), 1)
    want = pipe.run_pipeline(stage_fn, w, x_mb, on_cpu.group("pod"), 1)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="gloo process group cannot carry "
                                         "cuda"):
        coll.proxy_psum(xs[0].to(dev), "data", "pod", grid=on_cpu)
    with pytest.raises(ValueError, match="gloo process group cannot carry "
                                         "cuda"):
        pipe.run_pipeline(stage_fn, w.to(dev), x_mb.to(dev),
                          on_cpu.group("pod"), 1)


def test_product_sweep_on_card_equals_cpu(tmp_path):
    """``repro_torch.products`` through the kernels: a BFS sweep at
    RMAT-12 on 256 tiles over 1 and 4 chips (every memory style and
    network, board links 1 / 2 / 4) prices, row by row and field by
    field, the same as the sweep measured on the CPU; the card's run
    launches every engine kernel."""
    from repro_torch.products import MeasureSpec, ProductSearch, product_space
    dev = _card()
    spec = MeasureSpec(app="bfs", scale=12, tiles=256)
    configs = product_space(chips=(1, 4), board_links=(1, 2, 4))
    ops.reset_launches()
    card = ProductSearch(cache_dir=str(tmp_path / "card"), device=dev)
    got = card.sweep([spec], configs)
    launched = ops.launch_counts()
    cpu = ProductSearch(cache_dir=str(tmp_path / "cpu"), device="cpu")
    want = cpu.sweep([spec], configs)
    assert card.engine_runs == cpu.engine_runs == 2
    assert len(got) == len(want) == 12 + 3 * 12
    for g, w in zip(got, want):
        assert g == w, (g["product"], {k: (g[k], w[k]) for k in g
                                       if g[k] != w[k]})
    for name in ("relax", "segment_combine", "deliver_fused"):
        assert launched[name] > 0, name


# ------------------------------------------------- analysis: kernel races
def test_kernel_races_on_card():
    """``analysis.kernel_races`` on the kernels: every kernel's cases in
    their own order, reversed and permuted, three times each; min and
    count outputs bitwise equal to each other and to the plain version,
    add outputs within the kernel tests' tolerances."""
    from repro_torch.analysis import kernel_races
    dev = _card()
    before = ops.launch_counts()
    assert kernel_races.check_kernels(dev) == []
    after = ops.launch_counts()
    assert all(after[k] > before[k] for k in after), after


# ------------------------------------------------ the dense LM (serving)
DENSE_ARCHS = ["starcoder2-3b", "starcoder2-15b", "deepseek-7b",
               "h2o-danube-3-4b", "pixtral-12b"]
LM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # tests/test_torch_models.py


def _to(tree, device, dtype=None):
    return {k: _to(v, device, dtype) if isinstance(v, dict) else
            v.to(device, dtype if dtype and v.is_floating_point() else None)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_decode_step_on_card_matches_cpu(arch, dtype):
    """A reduced dense decode step through the Hopper kernel against the
    same step on the CPU (the kernel's plain version), from one seeded
    cache, at a position inside the cache and one past it (in a ring, one
    that wraps): logits and the written cache within the models tests'
    tolerances; ``decode_attention`` launched once a layer a step."""
    from repro_torch.models import registry
    dev = _card()
    cfg, fam = registry.get(arch, smoke=True)
    dt = getattr(torch, dtype)
    params = _to(fam["init"](cfg, torch.Generator().manual_seed(0), "cpu"),
                 "cpu", dt)
    gen = torch.Generator().manual_seed(1)
    cache = {k: torch.randn(v.shape, generator=gen).to(dt) for k, v in
             fam["init_cache"](cfg, 3, 24, "cpu").items()}
    card_params, card_cache = _to(params, dev), _to(cache, dev)
    tol = LM_TOL[dtype]
    for pos in (5, 30):
        toks = torch.randint(0, cfg.vocab, (3, 1), generator=gen)
        want, cache = fam["decode"](params, cache, toks, pos, cfg)
        ops.reset_launches()
        got, card_cache = fam["decode"](card_params, card_cache,
                                        toks.to(dev), pos, cfg)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == cfg.n_layers
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
        for key in ("k", "v"):
            torch.testing.assert_close(card_cache[key].cpu().float(),
                                       cache[key].float(), rtol=tol,
                                       atol=tol)


def test_scheduler_on_card_launches_once_a_layer_a_step():
    """``ServeScheduler`` on the card over a reduced deepseek-7b: every
    request completes as on the CPU (order and token counts: the control
    plane's rules), one ``decode_attention`` launch a layer a step."""
    from repro_torch.models import registry
    from repro_torch.serving import Request, ServeScheduler
    dev = _card()
    cfg, fam = registry.get("deepseek-7b", smoke=True)
    params = fam["init"](cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for where in ("cpu", dev):
        sched = ServeScheduler(cfg, fam, _to(params, where), batch_slots=2,
                               max_len=24)
        steps = []
        step = sched._step
        sched._step = lambda *a, **k: steps.append(1) or step(*a, **k)
        rng = np.random.default_rng(0)
        for rid in range(4):
            sched.submit(Request(rid, rng.integers(0, cfg.vocab, 5)
                                 .astype(np.int32), max_new=6))
        ops.reset_launches()
        done = sched.run()
        runs[str(where)] = ([(r.rid, len(r.out)) for r in done],
                            da.decode_attention.launches, len(steps))
    (cpu_done, cpu_launches, cpu_steps), (done, launches, steps) = (
        runs["cpu"], runs[str(dev)])
    assert done == cpu_done and len(done) == 4 and cpu_launches == 0
    assert steps == cpu_steps and launches == cfg.n_layers * steps


# ---------------------------------------------------------------- training
# card vs CPU, f32 (chip_smoke.py phase 16 (c)): set from the port against
# the reference on the CPU over (c)'s configuration, 1.5e-7 relative on
# the loss and grad norm and 1.1e-4 of a leaf's max |x| on the parameters
# (tok_emb: rows with gradients near AdamW's eps), with room for the
# card's other summation orders
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = 2e-3


def _leaf_errs(got, want, path=""):
    """{leaf path: max |got - want| / max |want|} of two numpy trees."""
    if isinstance(want, dict):
        out = {}
        for k in want:
            out.update(_leaf_errs(got[k], want[k], f"{path}/{k}"))
        return out
    return {path: float(np.abs(got - want).max())
            / max(float(np.abs(want).max()), 1e-30)}


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_train_step_on_card_matches_cpu(arch):
    """Two AdamW steps of the reduced arch (lr 1e-3, warmup 1: the
    second moves the parameters) from one f32 state carried by
    ``convert``, on the card and on the CPU: loss, grad norm and the
    parameters within the tolerances above; no kernel launched."""
    from repro_torch import convert
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.training import TrainState, adamw, make_train_step
    dev = _card()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, fam = registry.get(arch, smoke=True)
        params = _to(fam["init"](cfg, torch.Generator().manual_seed(0),
                                 "cpu"), "cpu", torch.float32)
        np_state = convert.train_state_to_numpy(
            TrainState.create(params, adamw(lr=1e-3, warmup=1)))
        src = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch=4)
        runs = {}
        for where in ("cpu", dev):
            state = convert.train_state_from_numpy(np_state, where)
            step = make_train_step(cfg, fam, adamw(lr=1e-3, warmup=1))
            ops.reset_launches()
            metrics = []
            for i in range(2):
                b = src.batch_at(i)
                state, m = step(state, to_device(
                    dict(tokens=b["tokens"], labels=b["labels"]), where))
                metrics.append({k: float(v) for k, v in m.items()})
            runs[str(where)] = (metrics, convert.train_state_to_numpy(state),
                                sum(ops.launch_counts().values()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cpu_m, cpu_s, _), (card_m, card_s, launches) = (runs["cpu"],
                                                     runs[str(dev)])
    assert launches == 0
    for a, b in zip(card_m, cpu_m):
        for k in ("loss", "grad_norm"):
            assert np.isfinite(a[k]) and abs(a[k] - b[k]) <= \
                TRAIN_LOSS_RTOL * abs(b[k]), (k, a, b)
    assert card_s["step"] == cpu_s["step"] == 2
    errs = _leaf_errs(card_s["params"], cpu_s["params"])
    assert max(errs.values()) <= TRAIN_PARAM_TOL, errs


def test_train_main_on_card():
    """The launcher on its default device, the card: a reduced run whose
    loss falls, through the fault-tolerant loop's checkpoints too."""
    import tempfile

    from repro_torch.launch import train
    _card()
    argv = ["--arch", "starcoder2-3b", "--smoke", "--steps", "8", "--batch",
            "4", "--seq", "32", "--lr", "3e-3"]
    losses = train.main(argv)
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < losses[0]
    with tempfile.TemporaryDirectory() as d:
        looped = train.main(argv + ["--ckpt-dir", d, "--ckpt-every", "4"])
    assert np.isfinite(looped).all() and len(looped) == 8


# ------------------------------------------- the MoE families (A.10c-1)
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v3-671b"]
# f32 copies still round to bf16 inside the MoE layer where the reference
# casts, so an f32 value whose last bits differ (another summation order)
# can round one bf16 step the other way: tests/test_torch_moe.py holds
# whole models to 2e-3 in f32 (one such rounding read 3.5e-4 on the
# logits), two steps' loss and grad norm to 1e-3 relative (1.3e-4 read).
# A leaf's update (after the steps less before) against the CPU's, over
# the CPU's update's norm: such a rounding can turn the sign of a small
# gradient, and AdamW's first moving step is sign-like, so one element
# can move 2 lr the other way; an update halved reads 0.5.  Read on an
# H100 80GB HBM3 (700 W): granite 2.8e-2 at tok_emb, deepseek-v3 6.1e-3
# (chip_smoke.py's seeds: 4.7e-2); the limit is 3x the worst reading
MOE_LM_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
MOE_STEP_RTOL = 1e-3
MOE_UPDATE_RTOL = 0.15
MOE_LR = 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_step_on_card_matches_cpu(arch, dtype):
    """A reduced MoE decode step on the card against the same step on the
    CPU, from one seeded cache, at a position inside the cache and one
    past it: logits and the written cache within ``MOE_LM_TOL``;
    granite's attention through ``decode_attention`` once a layer a step,
    deepseek-v3's MLA through no kernel."""
    from repro_torch.models import registry
    dev = _card()
    cfg, fam = registry.get(arch, smoke=True)
    dt = getattr(torch, dtype)
    params = _to(fam["init"](cfg, torch.Generator().manual_seed(0), "cpu"),
                 "cpu", dt)
    gen = torch.Generator().manual_seed(1)
    cache = {k: torch.randn(v.shape, generator=gen).to(dt) for k, v in
             fam["init_cache"](cfg, 3, 24, "cpu").items()}
    card_params, card_cache = _to(params, dev), _to(cache, dev)
    tol = MOE_LM_TOL[dtype]
    for pos in (5, 30):
        toks = torch.randint(0, cfg.vocab, (3, 1), generator=gen)
        want, cache = fam["decode"](params, cache, toks, pos, cfg)
        ops.reset_launches()
        got, card_cache = fam["decode"](card_params, card_cache,
                                        toks.to(dev), pos, cfg)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == (
            cfg.n_layers if cfg.family == "moe" else 0)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
        for key in cache:
            torch.testing.assert_close(card_cache[key].cpu().float(),
                                       cache[key].float(), rtol=tol,
                                       atol=tol)


def _update_rel_errs(got, want, start, path=""):
    """{leaf path: |got - want| / |want - start|} of three numpy trees
    (norms over the leaf): how far one run's update of each leaf lies
    from another's, over the latter."""
    if isinstance(want, dict):
        out = {}
        for k in want:
            out.update(_update_rel_errs(got[k], want[k], start[k],
                                        f"{path}/{k}"))
        return out
    return {path: float(np.linalg.norm(got - want)
                        / max(np.linalg.norm(want - start), 1e-30))}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_on_card_matches_cpu(arch):
    """Two steps of the reduced arch with the launcher's optimizer (AdamW
    for granite, Adafactor for deepseek-v3, lr 1e-3, warmup 1) from one
    f32 state carried by ``convert``, on the card and on the CPU: loss
    and grad norm within ``MOE_STEP_RTOL``, each leaf's update within
    ``MOE_UPDATE_RTOL`` of the CPU's update."""
    from repro_torch import convert
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import registry
    from repro_torch.training import TrainState, make_train_step
    dev = _card()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, fam = registry.get(arch, smoke=True)
        params = _to(fam["init"](cfg, torch.Generator().manual_seed(0),
                                 "cpu"), "cpu", torch.float32)
        np_state = convert.train_state_to_numpy(
            TrainState.create(params, make_optimizer(cfg, MOE_LR, 1)))
        src = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch=4)
        runs = {}
        for where in ("cpu", dev):
            state = convert.train_state_from_numpy(np_state, where)
            step = make_train_step(cfg, fam, make_optimizer(cfg, MOE_LR, 1))
            metrics = []
            for i in range(2):
                b = src.batch_at(i)
                state, m = step(state, to_device(
                    dict(tokens=b["tokens"], labels=b["labels"]), where))
                metrics.append({k: float(v) for k, v in m.items()})
            runs[str(where)] = (metrics, convert.train_state_to_numpy(state))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cpu_m, cpu_s), (card_m, card_s) = runs["cpu"], runs[str(dev)]
    for a, b in zip(card_m, cpu_m):
        for k in ("loss", "grad_norm"):
            assert np.isfinite(a[k]) and abs(a[k] - b[k]) <= \
                MOE_STEP_RTOL * abs(b[k]), (k, a, b)
    errs = _update_rel_errs(card_s["params"], cpu_s["params"],
                            np_state["params"])
    print(f"{arch}: worst update card vs CPU {max(errs.values()):.3e} at "
          f"{max(errs, key=errs.get)}")
    assert max(errs.values()) <= MOE_UPDATE_RTOL, errs


def test_moe_scheduler_on_card_launches_once_a_layer_a_step():
    """``ServeScheduler`` on the card over a reduced granite-moe: every
    request completes as on the CPU, one ``decode_attention`` launch a
    layer a step."""
    from repro_torch.models import registry
    from repro_torch.serving import Request, ServeScheduler
    dev = _card()
    cfg, fam = registry.get("granite-moe-1b-a400m", smoke=True)
    params = fam["init"](cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for where in ("cpu", dev):
        sched = ServeScheduler(cfg, fam, _to(params, where), batch_slots=2,
                               max_len=24)
        steps = []
        step = sched._step
        sched._step = lambda *a, **k: steps.append(1) or step(*a, **k)
        rng = np.random.default_rng(0)
        for rid in range(4):
            sched.submit(Request(rid, rng.integers(0, cfg.vocab, 5)
                                 .astype(np.int32), max_new=6))
        ops.reset_launches()
        done = sched.run()
        runs[str(where)] = ([(r.rid, len(r.out)) for r in done],
                            da.decode_attention.launches, len(steps))
    (cpu_done, cpu_launches, cpu_steps), (done, launches, steps) = (
        runs["cpu"], runs[str(dev)])
    assert done == cpu_done and len(done) == 4 and cpu_launches == 0
    assert steps == cpu_steps and launches == cfg.n_layers * steps


# ---------------- the recurrent and encoder-decoder families (A.10c-2)
RECURRENT_ARCHS = ["zamba2-1.2b", "whisper-tiny", "xlstm-1.3b"]
# a decode step card vs CPU from one cache: the models tests' tolerances
# (tests/test_torch_recurrent.py, tests/test_torch_encdec.py)
RECURRENT_LM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (B, H = Hkv, T) at D 64, G 1: zamba2's shared block in chip_smoke.py's
# served cache (8 slots of 256) and whisper's decoder self-attention
# there (8 rows of a 4-token prompt and 32 tokens)
G1_SHAPES = {"zamba2-1.2b": (8, 32, 256), "whisper-tiny": (8, 6, 36)}


def _tree_to(tree, device, dtype=None):
    """A cache of dicts and tuples of tensors on ``device`` (floating
    leaves in ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device, dtype) for v in tree)
    return tree.to(device, dtype if dtype and tree.is_floating_point()
                   else None)


@pytest.mark.parametrize("lengths", ["full", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(G1_SHAPES))
def test_decode_attention_at_g1_d64_matches_plain_on_card(arch, dtype,
                                                          lengths):
    """``ops.decode_attention`` at the head geometry zamba2 and whisper
    decode at, G = 1 and D = 64, at their served shapes: every position
    attended, or a length per row from the seed (1, T and between);
    rtol / atol 1e-4 in f32, 2e-2 in bf16."""
    dev = _card()
    b, h, t = G1_SHAPES[arch]
    rng = np.random.default_rng(31)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dev, dt) for shape in [(b, h, 64), (b, h, t, 64),
                                          (b, h, t, 64)])
    lens = np.full(b, t, np.int32)
    if lengths == "ragged":
        lens = rng.integers(1, t + 1, b).astype(np.int32)
        lens[:2] = [1, t]
    lens = torch.from_numpy(lens).to(dev)
    launches = da.decode_attention.launches
    got, _ = ops.decode_attention(q, k, v, lens)
    assert da.decode_attention.launches == launches + 1
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(),
                               da.plain(q, k, v, lens)[0].float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_decode_step_on_card_matches_cpu(arch, dtype):
    """A reduced decode step of each family on the card against the same
    step on the CPU, from one seeded cache (bf16: each leaf in its own
    dtype, the recurrent states f32), twice: logits and the cache within
    ``RECURRENT_LM_TOL``; ``decode_attention`` launched once a shared
    block (zamba2) or a decoder layer (whisper) a step, never on
    xlstm's."""
    from repro_torch.models import registry
    dev = _card()
    cfg, fam = registry.get(arch, smoke=True)
    dt = getattr(torch, dtype)
    drawn = fam["init"](cfg, torch.Generator().manual_seed(0), "cpu")
    params = _tree_to(drawn, "cpu", torch.float32) if dtype == "float32" \
        else drawn
    gen = torch.Generator().manual_seed(1)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(fill(v) for v in tree)
        return torch.randn(tree.shape, generator=gen).to(
            torch.float32 if dtype == "float32" else tree.dtype)
    cache = fill(fam["init_cache"](cfg, 3, 24, "cpu"))
    card_params, card_cache = _tree_to(params, dev), _tree_to(cache, dev)
    per_step = (cfg.n_layers // cfg.hybrid_every if cfg.family == "hybrid"
                else cfg.dec_layers if cfg.family == "encdec" else 0)
    tol = RECURRENT_LM_TOL[dtype]
    for pos in (5, 6):
        toks = torch.randint(0, cfg.vocab, (3, 1), generator=gen)
        want, cache = fam["decode"](params, cache, toks, pos, cfg)
        ops.reset_launches()
        got, card_cache = fam["decode"](card_params, card_cache,
                                        toks.to(dev), pos, cfg)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == per_step
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(_tree_to(card_cache, "cpu"), cache,
                                   rtol=tol, atol=tol)


# ------------------------------------------- the sharded step, A.10d-2
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_step_one_nccl_rank_equals_the_plain_step(nccl_group, arch):
    """On a 1 x 1 ("data", "model") grid over the one-rank NCCL group, two
    sharded steps (the state placed by the rules with ``fsdp=True``, the
    batches through ``DataPipeline(mesh=)``) equal two plain steps from
    the same bf16 state on the same batches, bitwise: losses, grad norms,
    every parameter and moment (one rank's gathers and sums are copies;
    granite with AdamW updates its blocks, deepseek-v3 with Adafactor
    its gathered leaves).  No kernel of the six launches."""
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.core import collectives as coll
    from repro_torch.data import DataPipeline
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import registry
    from repro_torch.training import Shardings, TrainState, make_train_step
    dev = _card()
    cfg, fam = registry.get(arch, smoke=True)
    grid = coll.make_grid((1, 1), ("data", "model"))
    opt = make_optimizer(cfg, MOE_LR, 1)
    plain = TrainState.create(fam["init"](
        cfg, torch.Generator(device=dev).manual_seed(0), dev), opt)
    specs = sh.train_state_specs(plain, grid, fsdp=True)
    state = sh.place(plain, specs, grid, dev)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch=4)
    step = make_train_step(cfg, fam, opt)
    sharded = make_train_step(cfg, fam, opt,
                              shardings=Shardings(grid, specs))
    pipe = DataPipeline(src, device=dev, mesh=grid, batch_axes=("data",))
    ops.reset_launches()
    try:
        for i in range(2):
            host = src.batch_at(i)
            plain, want = step(plain, to_device(host, dev))
            block = next(pipe)
            assert all(torch.equal(block[k].cpu(), torch.from_numpy(host[k]))
                       for k in host)
            state, got = sharded(state, block)
            for k in ("loss", "grad_norm"):
                assert torch.equal(got[k], want[k]), (i, k, got, want)
    finally:
        pipe.close()
    assert sum(ops.launch_counts().values()) == 0
    full = flatten(sh.gather(state, specs, grid))
    for k, v in flatten(plain).items():
        assert torch.equal(full[k], v), k


# ------------------------------------------ the dry run, A.10d-3
# phase 8's head geometries (label, B, H, Hkv, D), at 8,192 positions
CUSTOM_OP_SHAPES = ((128, 24, 2, 128), (128, 32, 8, 120), (32, 32, 32, 128),
                    (1, 24, 2, 128))


@pytest.mark.parametrize("b,h,hkv,d", CUSTOM_OP_SHAPES)
def test_decode_attention_custom_op_matches_plain_on_card(b, h, hkv, d):
    """``ops.decode_attention`` is the custom op
    ``repro_torch::decode_attention``: on CUDA tensors it launches the
    kernel once (bf16, within 2e-2 of the plain version); on fake CUDA
    tensors it launches nothing and gives a fake (B, H, D) output."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    dev = _card()
    s = 8192
    gen = torch.Generator(device=dev).manual_seed(b + h)
    q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    launches = da.decode_attention.launches
    got, _ = torch.ops.repro_torch.decode_attention(q, k, v, lens, None,
                                                    512)
    assert da.decode_attention.launches == launches + 1
    torch.testing.assert_close(got.float(),
                               da.plain(q, k, v, lens)[0].float(),
                               rtol=2e-2, atol=2e-2)
    with FakeTensorMode() as mode:
        fq, fk, fl = (mode.from_tensor(t) for t in (q, k, lens))
        out, lse = ops.decode_attention(fq, fk, fk, fl)
    assert isinstance(out, FakeTensor) and out.shape == (b, h, d)
    assert isinstance(lse, FakeTensor) and lse.shape == (b, h)
    assert da.decode_attention.launches == launches + 1


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_counts_equal_on_fake_cuda_and_fake_cpu(kind, tmp_path):
    """A reduced granite-moe cell on a 2 x 2 ``fake`` grid counts the same
    on fake ``cuda`` tensors as on fake ``cpu`` ones (the CPU tests'
    device: a build without CUDA cannot run these steps on fake CUDA
    tensors)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell
    _card()
    cell = ShapeCell(f"tiny_{kind}", kind, 128, 4)
    r = {dev: dryrun.run_cell("granite-moe-1b-a400m", cell, "single",
                              str(tmp_path), device=dev, smoke=True,
                              grid=((2, 2), ("data", "model")))
         for dev in ("cpu", "cuda")}
    for key in ("cost", "collectives", "ops", "memory"):
        assert r["cpu"][key] == r["cuda"][key], key


@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-moe-1b-a400m"])
def test_sharded_serve_one_nccl_rank_and_counts(nccl_group, arch, tmp_path):
    """On a 1 x 1 grid over the one-rank NCCL group, the sharded prefill
    and three sharded serve steps are bitwise the plain steps (tokens,
    logits, cache), the serve step launches ``decode_attention`` once a
    layer, and ``opanalysis`` counts the same FLOPs, collectives and ops
    for a real sharded serve step as for its dry run on a 1 x 1 ``fake``
    grid on fake ``cuda`` tensors."""
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import flatten, tree_map
    from repro_torch.core import collectives as coll
    from repro_torch.launch import dryrun, opanalysis
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import registry
    from repro_torch.serving.decode import make_prefill, make_serve_step
    from repro_torch.training import Shardings
    dev = _card()
    cfg, fam = registry.get(arch, smoke=True)
    grid = coll.make_grid((1, 1), ("data", "model"))
    fsdp = arch in dryrun.FSDP_ARCHS
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fam["init"](cfg, gen, dev)
    batch = dict(tokens=torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                                      device=dev, dtype=torch.int32))
    specs = sh.serve_specs(params, grid, batch=batch, fsdp=fsdp)
    want_l, want_c = make_prefill(cfg, fam)(params, batch)
    got_l, got_c = make_prefill(cfg, fam, Shardings(grid, specs))(params,
                                                                   batch)
    assert torch.equal(got_l, want_l)
    for k, v in flatten(want_c).items():
        assert torch.equal(flatten(got_c)[k], v), k
    cache = fam["init_cache"](cfg, 4, 64, dev)
    for t in flatten(cache).values():
        t.normal_(generator=gen)
    mine = tree_map(lambda t: t.clone(), cache)
    tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    specs = sh.serve_specs(params, grid, batch=dict(tokens=tok), cache=cache,
                           fsdp=fsdp)
    plain = make_serve_step(cfg, fam)
    sharded = make_serve_step(cfg, fam, shardings=Shardings(grid, specs))
    a = b = tok
    for pos in (61, 62, 63):
        a, la, cache = plain(params, cache, a, pos)
        ops.reset_launches()
        b, lb, mine = sharded(params, mine, b, pos)
        assert da.decode_attention.launches == cfg.n_layers
        assert torch.equal(a, b) and torch.equal(la, lb)
    for k, v in flatten(cache).items():
        assert torch.equal(flatten(mine)[k], v), k
    with opanalysis.StepCount() as count:
        sharded(params, mine, b, 63)
    real = count.summary()
    dist.destroy_process_group()
    try:
        fake = dryrun.run_cell(arch, ShapeCell("tiny", "decode", 64, 4),
                               "one", str(tmp_path), device=dev, smoke=True,
                               grid=((1, 1), ("data", "model")))
    finally:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp_path / 'store2'}", rank=0,
            world_size=1)
    assert fake["cost"]["flops_per_device"] == real["flops"]
    assert fake["collectives"]["counts"] == real["collective_counts"]
    assert fake["ops"] == real["ops"]


# ---------------------------------- tensor-parallel compute, A.10e-1
@pytest.mark.parametrize("b,h,hkv,d", CUSTOM_OP_SHAPES[:3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_lse_on_card(b, h, hkv, d, dtype):
    """``ops.decode_attention`` launches the kernel once: the lse beside
    the output within 1e-4 of the plain version's (-inf at a length of
    0), and 4 blocks of
    positions merged by their lse within the bf16 / f32 tolerance of the
    call on the whole cache."""
    dev = _card()
    s, n = 4096, 4
    per = s // n
    gen = torch.Generator(device=dev).manual_seed(b + h + 1)
    q = (torch.randn((b, h, d), generator=gen, device=dev) * 3).to(dtype)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0] = 0
    if b > 1:
        lens[1] = 5
    launches = da.decode_attention.launches
    out, lse = ops.decode_attention(q, k, v, lens)
    assert da.decode_attention.launches == launches + 1
    _, want = da.plain(q, k, v, lens)
    assert torch.isinf(lse[0]).all() and (lse[0] < 0).all()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(lse))
    torch.testing.assert_close(lse[fin], want[fin], rtol=1e-4, atol=1e-4)
    outs, lses = [], []
    for i in range(n):
        lb = (lens - i * per).clamp(0, per).to(torch.int32)
        o, l_ = ops.decode_attention(
            q, k[:, :, i * per:(i + 1) * per].contiguous(),
            v[:, :, i * per:(i + 1) * per].contiguous(), lb)
        outs.append(o)
        lses.append(l_)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.max(0).values)
    merged = (torch.stack(outs).float() * w[..., None]).sum(0) \
        / w.sum(0)[..., None]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    rows = lens > 0
    torch.testing.assert_close(merged[rows], out.float()[rows], rtol=tol,
                               atol=tol)
