#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no phase lets the run go
on past a failure:

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the kernel build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled
   for sm_90a from the checkout, one ``nvcc`` each, all started together;
3. the workloads: RMAT-22 (made once, shared by every RMAT-22 phase) with
   its Histogram input, RMAT-18 and RMAT-14;
4. the kernels, each against its plain PyTorch version on the card:
   relax, segment_combine and deliver_fused at the BFS path's shapes for
   min and add, and in their add form at the write-back flush wave's
   shapes (deliver_fused's counting path printed);
   histogram_bin on the Histogram input (bitwise); spmv_bcsr on
   RMAT-14 in 128x128 BCSR (rtol/atol 1e-4; its library call a
   ``torch.sparse_bsr_tensor`` product).  Each timed (CUDA events,
   inputs rotated past L2) beside its bound, its plain version and, where
   one PyTorch call computes the same function, that call;
5. BFS on RMAT-22 over one 64x64-tile package (4096 tiles) with the
   Table-II write-through proxy, backend ``kernels``; values checked
   against scipy's BFS hop distances; a ``torch.profiler`` window;
6. SpMV (write-back P$, selective 2-level cascade) and Histogram
   (write-back P$) on RMAT-22 over 4096 tiles, backend ``kernels``;
   checked against scipy's ``A @ x`` and ``np.bincount``; a profiler
   window of SpMV;
7. the kernel entry points ``ops.histogram`` on the Histogram input
   (bitwise equal to the engine's counts and ``np.bincount``) and
   ``ops.spmv`` on RMAT-14 (against scipy and the engine's SpMV);
8. the kernel entry point ``ops.decode_attention``: one layer's decode
   attention at decode_32k (a 32,768-position KV cache), bf16, at the
   head geometry of starcoder2-3b (batch 128, and one request: the
   split path), h2o-danube-3-4b (batch 128, D = 120) and deepseek-7b
   (batch cut to 32); each against the plain version on the card
   (rtol/atol 2e-2; lengths S, then ragged lengths with 0, 1, S and past
   S; the one-request shape also in f32, 1e-4), timed beside its bound,
   the plain version and ``scaled_dot_product_attention`` (its backend
   printed); which split kernel ran (bf16 on the tensor cores, f32 on
   the CUDA cores) and the bf16 error beside the CUDA-core kernel's;
9. backend agreement at RMAT-18: BFS, SpMV, Histogram and PageRank
   (epochs=3) with ``kernels`` and with ``torch``: counters, trace,
   supersteps and ``time_s`` exact, values bitwise (BFS, Histogram) or
   within rtol 1e-4 / atol 1e-5 (SpMV, PageRank); PageRank against its
   oracle;
10. one JSON line of per-kernel numbers, the ``nvidia-smi`` line, then
    the last line, ``{"ok": true, "device": {...}}``.

The engine's runs (phases 5 and 6) also print, per call shape of
segment_combine and deliver_fused, how the ids the engine hands them
fall in the kernels' 32-record warp slices (``EngineIds``): the share
of live records in runs of neighbours and repeated in their slice, and
the atomics a fold would leave.

Each main-path run (phases 5-8) sets every kernel's launch count to 0
just before it and reads the counts just after; a kernel on the path
that did not launch (at least once per superstep, on the engine's
paths) fails the run.

Without a CUDA device, or without the repo's ``src/repro_torch`` beside
it, the script prints no result and exits nonzero.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
L2_BYTES = 50 * 2**20          # H100 L2 cache

# main-path configuration: RMAT-22 (Graph500 a=0.57, b=c=0.19, edge
# factor 16, seed 42) on one 64x64-tile package
SCALE, EDGE_FACTOR, SEED = 22, 16, 42
TILES, OQ_CAP = 4096, 32
AGREE_SCALE = 18               # backend agreement and PageRank
SPMV_KERNEL_SCALE = 14         # ops.spmv: ELL-padded BCSR densifies RMAT
PAGERANK_EPOCHS = 3

ADD_RTOL, ADD_ATOL = 1e-5, 1e-6   # f32 re-association of atomic adds
SPMV_RTOL, SPMV_ATOL = 1e-4, 1e-4     # tests/test_kernels.py (spmv_bcsr)
APP_RTOL, APP_ATOL = 1e-3, 1e-3       # tests/test_engine_apps.py (spmv)
AGREE_RTOL, AGREE_ATOL = 1e-4, 1e-5   # tests/test_cascade.py
PR_RTOL, PR_ATOL = 1e-4, 1e-7         # tests/test_engine_apps.py (pagerank)

# kernel entry point ops.decode_attention: one layer's decode attention at
# decode_32k (src/repro/launch/shapes.py:40: a 32,768-position KV cache,
# batch 128) at the head geometry of src/repro/models/registry.py, bf16
DECODE_S = 32768
DECODE_SHAPES = (      # label, B, H, Hkv, D
    ("starcoder2-3b", 128, 24, 2, 128),
    ("h2o-danube-3-4b", 128, 32, 8, 120),
    ("deepseek-7b, batch cut 128 -> 32", 32, 32, 32, 128),
    ("starcoder2-3b, one request", 1, 24, 2, 128),
)
DECODE_TOL = 2e-2          # bf16 outputs (tests/test_kernels.py)
DECODE_F32_TOL = 1e-4      # f32 (tests/test_kernels.py)
DECODE_CUDA_CORE_ERR = 0.0078   # bf16 max |err| of the CUDA-core kernel
DECODE_Q_STD = 3.0         # scores of std 3: a peaked softmax, O(1) outputs
PLAIN_SLICE_BYTES = 4 * 2**30   # f32 K and V per slice of the plain version
F32_FLOP_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries that differ (inf == inf counts as
    equal; a differing pair with an inf in it gives inf)."""
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def time_cuda(fn, arg_sets, iters: int = 40) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls,
    cycling through ``arg_sets`` (copies of the inputs that together
    exceed L2, so each call reads its inputs from device memory).  A
    spin kernel first holds the stream while the host enqueues every
    call, so host overhead does not show as device time."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies(args, bytes_per_call: int):
    """Enough clones of ``args`` that cycling through them streams more
    than twice the L2 cache (the inputs themselves when one call
    already does)."""
    if bytes_per_call >= 2 * L2_BYTES:
        return [tuple(args)]
    n = max(2, math.ceil(2 * L2_BYTES / max(bytes_per_call, 1)))
    return [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args) for _ in range(n)]


def card() -> dict:
    print("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0])
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return dict(kind=kind, smi=smi[0])


def build() -> None:
    from repro_torch.kernels import _build
    print("== 2. kernel build (nvcc " + " ".join(_build.NVCC_FLAGS) + ")")
    t0 = time.perf_counter()
    info = _build.build_all()
    for stem, d in info.items():
        print(f"  {stem}.cu -> {Path(d['path']).name}: "
              f"{'built' if d['built'] else 'cached'} "
              f"in {d['seconds']:.1f} s")
    print(f"  build phase {time.perf_counter() - t0:.1f} s")


def workloads() -> dict:
    """The graphs every later phase shares, each made once."""
    from repro_torch.core.tilegrid import square_grid
    from repro_torch.graph import rmat_edges
    from repro_torch.graph.rmat import histogram_input
    print("== 3. workloads")
    wl = dict(grid=square_grid(TILES))
    for scale in (SCALE, AGREE_SCALE, SPMV_KERNEL_SCALE):
        t0 = time.perf_counter()
        g = rmat_edges(scale, edge_factor=EDGE_FACTOR, seed=SEED)
        wl[scale] = g
        print(f"  RMAT-{scale}: {g.n_rows} vertices, {g.nnz} edges, made "
              f"in {time.perf_counter() - t0:.1f} s")
    g = wl[SCALE]
    wl["bins"] = g.n_rows // 8
    wl["histo"] = histogram_input(g, wl["bins"])
    wl["x"] = np.random.default_rng(SEED).random(g.n_cols).astype(np.float32)
    print(f"  Histogram input: {wl['histo'].shape[0]} elements into "
          f"{wl['bins']} bins; SpMV x from seed {SEED}; "
          f"{wl['grid'].describe()}; oq_cap {OQ_CAP}")
    return wl


# ------------------------------------------------------------- 4. kernels
def kernel_inputs(gen, dev):
    """Synthetic inputs at the engine's shapes.  BFS path (min and add):
    Nd mailbox entries, R = T*oq_cap P$ records, 2R delivery records (the
    forwarded leg + the eviction leg).  Write-back flush wave (add): the
    T*S P$ entries of SpMV's cascade levels into as many segments, and
    Histogram's flush of T*S records into its Nd = T*Cd mailbox."""
    nd = (1 << SCALE)          # chunk_dst * T = 2**22 at RMAT-22
    r = TILES * OQ_CAP
    ts = TILES * 512           # T * P$ slots
    nd_histo = TILES * -(-(nd // 8) // TILES)

    def rand(n):
        return torch.rand(n, generator=gen, device=dev)

    def with_inf(x, p):
        return torch.where(rand(x.numel()) < p, float("inf"), x)

    def sorted_gids(n, live_share):
        # segment ids as _lex_group hands them over: sorted group ids,
        # masked records (-1) at the end
        live = int(live_share * n)
        gid = torch.sort(torch.randint(0, live, (live,), generator=gen,
                                       device=dev)).values.to(torch.int32)
        return torch.cat([gid, torch.full((n - live,), -1, dtype=torch.int32,
                                          device=dev)])

    def scattered(n, nseg, live_share):
        return torch.where(rand(n) < live_share,
                           torch.randint(0, nseg, (n,), generator=gen,
                                         device=dev), -1).to(torch.int32)

    relax_in = (with_inf(rand(nd) * 64, 0.5), with_inf(rand(nd) * 64, 0.3),
                rand(nd) < 0.5)
    dseg = torch.cat([scattered(r, nd, 0.6),
                      torch.full((r,), -1, dtype=torch.int32, device=dev)])
    return dict(
        relax=relax_in,
        relax_add=(rand(nd) * 64, rand(nd) * 64, rand(nd) < 0.5),
        seg=(sorted_gids(r, 0.6), rand(r) * 64, r),
        seg_rand=(scattered(r, r, 0.7), rand(r) * 64, r),
        seg_add=(sorted_gids(ts, 0.8), rand(ts) * 64, ts),
        deliver=(dseg, rand(2 * r) * 64, with_inf(rand(nd) * 64, 0.5)),
        deliver_add=(scattered(ts, nd_histo, 0.9), rand(ts) * 64,
                     rand(nd_histo) * 64))


def _bytes_scatter(seg, n_out_bytes):
    """Bytes a scatter must move: every 4 B segment id, the 4 B value of
    each live (seg >= 0) record only, and the outputs once."""
    return 4 * seg.numel() + 4 * int((seg >= 0).sum()) + n_out_bytes


def _agree(name, bitwise, got, want, rtol, atol):
    """Hold a kernel's outputs against its plain version's: bitwise
    (``bitwise``, and every non-f32 output) or within rtol / atol."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if bitwise or g.dtype != torch.float32:
            require(torch.equal(g, w), f"{name} differs from its plain "
                    f"version (max |err| {max_abs_err(g, w)})")
        else:
            require(torch.allclose(g, w, rtol=rtol, atol=atol),
                    f"{name} outside tolerance "
                    f"(max |err| {max_abs_err(g, w)})")
    return max(max_abs_err(g.float(), w.float()) for g, w in zip(got, want))


def _measure(name, combine, args, kernel, plain, nbytes, library=None,
             rtol=ADD_RTOL, atol=ADD_ATOL, bitwise=None, what=""):
    """Compare one kernel call with its plain version (bitwise for min,
    or when ``bitwise``), then time both (and the library call) at these
    inputs.  Returns the row's numbers."""
    kw = {} if combine is None else dict(combine=combine)
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = _agree(f"{name}/{combine}",
                 combine == "min" if bitwise is None else bitwise, got, want,
                 rtol, atol)
    sets = copies(args, nbytes)
    ms = time_cuda(lambda *a: kernel(*a, **kw), sets)
    plain_ms = time_cuda(lambda *a: plain(*a, **kw), sets)
    lib_ms = time_cuda(*library) if library is not None else None
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  {name}[{combine or '-'}] {what}: ok (max |err| {err:g}); "
          f"{ms:.4f} ms vs byte bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms, library "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=lib_ms)


def kernel_phase(dev, wl) -> list:
    from repro_torch.kernels import deliver_fused as df
    from repro_torch.kernels import histogram_bin as hb
    from repro_torch.kernels import ops
    from repro_torch.kernels import relax_min as rx
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.kernels import spmv_csr as sp
    print("== 4. kernels vs plain versions on the card "
          f"(min: bitwise; add: rtol {ADD_RTOL}, atol {ADD_ATOL}; counts "
          f"exact; spmv rtol {SPMV_RTOL}, atol {SPMV_ATOL})")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = kernel_inputs(gen, dev)
    src = "src/repro_torch/kernels/csrc/"
    rows = []

    def row(name, source, replaces, main, add=None):
        r = dict(name=name, route="cuda", source=src + source,
                 replaces=replaces, launches=0, **main)
        if add is not None:
            r["add"] = add
        rows.append(r)

    # relax: bytes 14 per element (values, mail, flag read; values,
    # improved written)
    nd = x["relax"][0].numel()
    main = _measure("relax", "min", x["relax"], rx.relax, rx.plain, 14 * nd,
                    what=f"n {nd}")
    _measure("relax", "add", x["relax"], rx.relax, rx.plain, 14 * nd,
             what=f"n {nd} (BFS shapes)")
    add = _measure("relax", "add", x["relax_add"], rx.relax, rx.plain,
                   14 * nd, what=f"n {nd} (SpMV values)")
    row("relax", "engine_kernels.cu", "src/repro/kernels/relax_min.py:32",
        main, add)

    # segment_combine; the library call is one scatter_reduce_ (min) /
    # index_add_ (add) into an identity-filled buffer with the padding
    # sent to a spare slot
    def lib_sets(seg, val, n, fill, nbytes):
        safe = torch.where(seg >= 0, seg, n).long()
        out = torch.full((n + 1,), fill, device=dev)
        return copies((out, safe, val), nbytes)

    seg, val, r = x["seg"]
    nbytes = _bytes_scatter(seg, 4 * r)
    main = _measure("segment_combine", "min", x["seg"], sc.segment_combine,
                    sc.plain, nbytes, what=f"{r} sorted records (P$)",
                    library=(lambda o, i, v: o.scatter_reduce_(0, i, v,
                                                              "amin"),
                             lib_sets(seg, val, r, float("inf"), nbytes)))
    for combine in ("min", "add"):     # unsorted ids, padding interleaved
        _agree(f"segment_combine[unsorted]/{combine}", combine == "min",
               sc.segment_combine(*x["seg_rand"], combine),
               sc.plain(*x["seg_rand"], combine), ADD_RTOL, ADD_ATOL)
    _measure("segment_combine", "add", x["seg"], sc.segment_combine,
             sc.plain, nbytes, what=f"{r} sorted records (P$)")
    seg, val, ts = x["seg_add"]
    nbytes = _bytes_scatter(seg, 4 * ts)
    add = _measure("segment_combine", "add", x["seg_add"],
                   sc.segment_combine, sc.plain, nbytes,
                   what=f"{ts} records (flush wave, cascade level)",
                   library=(lambda o, i, v: o.index_add_(0, i, v),
                            lib_sets(seg, val, ts, 0.0, nbytes)))
    row("segment_combine", "engine_kernels.cu",
        "src/repro/kernels/segment_combine.py:55", main, add)

    # deliver_fused: the mailbox read once, mailbox and counts written
    def plan(seg, mail):
        n = seg.numel()
        return f"{n} records into {mail.numel()}, {df.counting_path(n)} counts"

    dseg, dval, mail = x["deliver"]
    nbytes = _bytes_scatter(dseg, 12 * mail.numel())
    main = _measure("deliver_fused", "min", x["deliver"], df.deliver_fused,
                    df.plain, nbytes, what=plan(dseg, mail))
    _measure("deliver_fused", "add", x["deliver"], df.deliver_fused,
             df.plain, nbytes, what=plan(dseg, mail))
    dseg, dval, mail = x["deliver_add"]
    add = _measure("deliver_fused", "add", x["deliver_add"],
                   df.deliver_fused, df.plain,
                   _bytes_scatter(dseg, 12 * mail.numel()),
                   what=plan(dseg, mail) + " (Histogram flush wave)")
    row("deliver_fused", "engine_kernels.cu",
        "src/repro/kernels/deliver_fused.py:68", main, add)

    # histogram_bin on the Histogram app's input: 4 B per id read, 4 B
    # per bin written; the library call is torch.bincount (ids are all
    # non-negative here)
    idx = torch.from_numpy(wl["histo"]).to(dev)
    bins = wl["bins"]
    nbytes = 4 * idx.numel() + 4 * bins
    main = _measure("histogram_bin", None, (idx, bins), hb.histogram_bin,
                    hb.plain, nbytes, what=f"{idx.numel()} ids, {bins} bins",
                    library=(lambda i, b: torch.bincount(i, minlength=b),
                             copies((idx, bins), nbytes)), bitwise=True)
    row("histogram_bin", "histogram_bin.cu",
        "src/repro/kernels/histogram_bin.py:39", main)

    # spmv_bcsr on RMAT-14 in 128x128 BCSR
    g = wl[SPMV_KERNEL_SCALE]
    t1 = time.perf_counter()
    mat = ops.bcsr_from_csr(g.row_ptr, g.col_idx, g.weights,
                            (g.n_rows, g.n_cols))
    conv_s = time.perf_counter() - t1
    print(f"  BCSR of RMAT-{SPMV_KERNEL_SCALE}: {mat.mb} block-rows x kmax "
          f"{mat.kmax} of {mat.bm}x{mat.bk}, {mat.blocks.nbytes / 2**30:.3f} "
          f"GiB of blocks, host conversion {conv_s:.1f} s")
    dmat = mat.to(dev)
    xs = torch.from_numpy(
        np.random.default_rng(SEED).random(g.n_cols).astype(np.float32)
    ).to(dev)
    # the host copy waits for the ops phase, so the 1 GiB of blocks is
    # not resident on the card during the app runs' peak-memory readings
    wl["bcsr"], wl["bcsr_x"] = mat, xs
    nbytes = (dmat.blocks.numel() * 4 + dmat.cols.numel() * 4
              + 4 * g.n_cols + 4 * g.n_rows)
    # 2 flops per block element; f32 outside the tensor cores: 67 TFLOP/s
    flop_ms = 2 * dmat.blocks.numel() / F32_FLOP_PER_S * 1e3
    # the library call: one product of a torch.sparse_bsr_tensor over the
    # present blocks (the ELL padding, all-zero blocks of column 0, which
    # a BSR tensor cannot repeat, left out) with x as a column
    present = ~((dmat.cols == 0) & (dmat.blocks.abs().amax(dim=(2, 3)) == 0))
    kb = -(-g.n_cols // mat.bk)
    bsr = torch.sparse_bsr_tensor(
        torch.cat([present.new_zeros(1, dtype=torch.int64),
                   present.sum(1).cumsum(0)]),
        dmat.cols[present].long(), dmat.blocks[present],
        size=(mat.mb * mat.bm, kb * mat.bk), check_invariants=True)
    xcol = torch.zeros((kb * mat.bk, 1), device=dev)
    xcol[:g.n_cols, 0] = xs
    lib_y = (bsr @ xcol)[:g.n_rows, 0]
    require(torch.allclose(lib_y, sp.plain(dmat.blocks, dmat.cols, xs,
                                           g.n_rows),
                           rtol=SPMV_RTOL, atol=SPMV_ATOL),
            "spmv_bcsr: the BSR library product differs from the plain "
            "version")
    print(f"  library call: sparse_bsr_tensor @ x over "
          f"{int(present.sum())} of {present.numel()} ELL blocks")
    main = _measure("spmv_bcsr", None,
                    (dmat.blocks, dmat.cols, xs, g.n_rows), sp.spmv_bcsr,
                    sp.plain, nbytes, rtol=SPMV_RTOL, atol=SPMV_ATOL,
                    what=f"RMAT-{SPMV_KERNEL_SCALE}",
                    library=(lambda a, x: a @ x, [(bsr, xcol)]))
    del bsr, lib_y, present
    require(main["bound_ms"] >= flop_ms,
            "spmv_bcsr: the operation bound exceeds the byte bound")
    dense = torch.from_numpy(scipy_csr(g).toarray()).to(dev)
    dense_ms = time_cuda(torch.mv, [(dense, xs)])
    del dense
    print(f"  context (not the same function): torch.mv over the "
          f"dense-expanded {g.n_rows}x{g.n_cols} matrix {dense_ms:.4f} ms")
    main["dense_matmul_ms"] = dense_ms
    main["bcsr_bytes"] = int(mat.blocks.nbytes + mat.cols.nbytes)
    main["bcsr_host_conversion_s"] = conv_s
    row("spmv_bcsr", "spmv_bcsr.cu", "src/repro/kernels/spmv_csr.py:95", main)
    del dmat
    print(f"  kernel phase {time.perf_counter() - t0:.1f} s")
    return rows


# ------------------------------------------------------- the engine's ids
WARP = 32


def warp_runs(seg, limit: int) -> torch.Tensor:
    """How one call's ids fall in the scatter kernels' warp slices
    (records 32k .. 32k + 31 share a slice), as an int64 device tensor:
    [live records, runs of equal ids in neighbouring lanes (the atomics
    left after the neighbour fold), distinct ids a slice (left after a
    fold of every repeat, as ``__match_any_sync`` finds them), records in
    a run of neighbours, records whose id repeats in their slice, slices
    with a run, slices with a live record].  Ids < 0 or >= ``limit`` are
    padding."""
    s = torch.cat([seg, seg.new_full((-seg.numel() % WARP,), -1)])
    s = s.view(-1, WARP)
    s = torch.where((s >= 0) & (s < limit), s, -1)
    found = []
    for ids in (s, torch.sort(s, dim=1).values):
        live = ids >= 0
        same = (ids[:, 1:] == ids[:, :-1]) & live[:, 1:]
        edge = torch.zeros_like(same[:, :1])
        found.append((live, same, live & (torch.cat([edge, same], 1)
                                          | torch.cat([same, edge], 1))))
    (live, same, in_run), (_, rep, in_rep) = found
    n_live = live.sum()
    return torch.stack([n_live, n_live - same.sum(), n_live - rep.sum(),
                        in_run.sum(), in_rep.sum(), same.any(1).sum(),
                        live.any(1).sum()])


class EngineIds:
    """While entered, the engine's calls of ``ops.segment_combine`` and
    ``ops.deliver_fused`` run unchanged, and each call's ``warp_runs``
    is summed on the device (no host sync) per shape: (kernel, combine,
    records, segments or mailbox entries).  With ``keep`` > 0, every
    ``keep``-th call of a shape, its first included, also keeps a clone
    of its inputs (``kept``: shape -> [args])."""

    def __init__(self, keep: int = 0):
        self.keep = keep
        self.sums, self.calls, self.kept = {}, {}, {}

    def _tap(self, name, fn):
        def call(seg, val, third, combine="min"):
            limit = third if name == "segment_combine" else third.numel()
            key = (name, combine, seg.numel(), limit)
            i = self.calls.get(key, 0)
            self.calls[key] = i + 1
            runs = warp_runs(seg, limit)
            self.sums[key] = self.sums[key] + runs if i else runs
            if self.keep and i % self.keep == 0:
                self.kept.setdefault(key, []).append(tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in (seg, val, third)))
            return fn(seg, val, third, combine=combine)
        return call

    def __enter__(self):
        from repro_torch.kernels import ops
        self._saved = ops.segment_combine, ops.deliver_fused
        ops.segment_combine = self._tap("segment_combine", self._saved[0])
        ops.deliver_fused = self._tap("deliver_fused", self._saved[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.segment_combine, ops.deliver_fused = self._saved

    def report(self, label: str) -> None:
        for key in sorted(self.sums):
            name, combine, n, limit = key
            live, runs, distinct, in_run, in_rep, with_run, slices = (
                self.sums[key].tolist())
            share = lambda x: f"{x / max(live, 1):.1%}"  # noqa: E731
            print(f"    {label} ids, {name} {combine}, {n} records into "
                  f"{limit} ({self.calls[key]} calls): {live} live; in a "
                  f"run of neighbours {share(in_run)}, repeated in their "
                  f"warp slice {share(in_rep)}; atomics left by the "
                  f"neighbour fold {share(runs)}, by a fold of every "
                  f"repeat {share(distinct)}; slices with a run "
                  f"{with_run} of {slices}")


def main_path_apps(wl) -> dict:
    """The main path's RMAT-22 app calls as a user makes them:
    {label: (app, args, keyword args)}."""
    from repro_torch.graph import apps
    g, grid = wl[SCALE], wl["grid"]
    root = int(np.argmax(g.out_degree()))
    return dict(
        bfs=(apps.bfs, (g, root, grid),
             dict(proxy=apps.table2_proxy(grid, "bfs"), oq_cap=OQ_CAP)),
        spmv=(apps.spmv, (g, wl["x"], grid),
              dict(proxy=apps.table2_proxy(grid, "spmv", cascade_levels=2),
                   oq_cap=OQ_CAP)),
        histo=(apps.histogram, (wl["histo"], wl["bins"], grid),
               dict(proxy=apps.table2_proxy(grid, "histo"), oq_cap=OQ_CAP)))


# ------------------------------------------------------------ app runs
def app_run(dev, label: str, fn, *args, **kw):
    """One app call as a user makes it, timed on the host clock around
    work that ends in a synchronise; every kernel's launch count is set
    to 0 just before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import default_registry
    syncs = default_registry().counter("engine.host_syncs")
    syncs0 = syncs.value
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = fn(*args, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    run = res.run
    print(f"  {label} backend={kw.get('backend', 'kernels')}: "
          f"{run.supersteps} supersteps in {wall:.2f} s wall on the card "
          f"({wall / run.supersteps * 1e3:.3f} ms per superstep, "
          f"{syncs.value - syncs0:.0f} host syncs), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"    modelled Tascade chip (BSP cost model, not the H100): "
          f"time_s {run.time_s:.6e}, {res.gteps:.2f} GTEPS")
    print(f"    counters {json.dumps(run.counters.as_dict())}")
    print(f"    launches {json.dumps(launches)}")
    return res, launches


def require_launches(label, launches, steps, names) -> None:
    """Every kernel of the path launched at least once per superstep
    (the engine calls each one in every superstep; flush supersteps
    call segment_combine and deliver_fused more than once)."""
    for name in names:
        require(launches[name] >= steps,
                f"{label}: {name} launched {launches[name]} times in "
                f"{steps} supersteps")
    print(f"    {label}: every engine kernel launched at least once per "
          f"superstep ({steps})")


def profile_supersteps(dev, eng, state, label: str, n: int = 20) -> None:
    """Where a superstep's time goes: ``n`` supersteps of the engine
    under ``torch.profiler`` (after 5 warm-up supersteps), the
    device-busy share and the ops with the most device time.  The
    profiler adds host overhead of its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import fetch_stats
    for _ in range(5):
        state, stats = eng._superstep(state)
        fetch_stats(stats)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, stats = eng._superstep(state)
            fetch_stats(stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, host_ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            kernels.append((dev_us, e.count, e.key))
        elif e.device_type == DeviceType.CPU:
            host_ops.append((e.self_cpu_time_total, dev_us, e.count, e.key))
    # device-side entries carry each kernel and copy interval once
    busy_us = sum(k[0] for k in kernels)
    host_us = sum(h[0] for h in host_ops)
    if busy_us <= 0:
        print(f"  profile {label}: the profiler recorded no device time "
              "(device busy share not measured)")
        return
    print(f"  profile {label} ({n} supersteps, kernels backend, under the "
          f"profiler), per superstep: {wall * 1e3 / n:.3f} ms wall; device "
          f"busy {busy_us / n / 1e3:.3f} ms ({busy_us / 1e6 / wall:.1%} of "
          f"wall) in {sum(k[1] for k in kernels) / n:.0f} device entries; "
          f"host ops {host_us / n / 1e3:.3f} ms self CPU")
    print("  top device entries per superstep (us device, launches, name):")
    for dev_us, count, key in sorted(kernels, reverse=True)[:10]:
        print(f"    {dev_us / n:9.1f} {count / n:6.1f}  {key[:90]}")
    print("  top host ops per superstep (us self CPU, us device, calls, op):")
    for cpu_us, dev_us, count, key in sorted(host_ops, reverse=True)[:10]:
        print(f"    {cpu_us / n:9.1f} {dev_us / n:9.1f} {count / n:6.1f}  "
              f"{key[:70]}")


def scipy_csr(g):
    from scipy.sparse import csr_matrix
    w = g.weights if g.weights is not None else np.ones(g.nnz, np.float32)
    return csr_matrix((w, g.col_idx, g.row_ptr), shape=(g.n_rows, g.n_cols))


def check_bfs(g, root, res) -> None:
    from scipy.sparse.csgraph import shortest_path
    t0 = time.perf_counter()
    want = shortest_path(scipy_csr(g), unweighted=True, indices=root)
    require(np.array_equal(res.values.astype(np.float64), want),
            f"BFS values differ from scipy's hop distances at "
            f"{int(np.sum(res.values.astype(np.float64) != want))} vertices")
    reached = int(np.isfinite(want).sum())
    print(f"    values == scipy shortest_path(unweighted) hop distances: "
          f"{reached} reached, depth {int(want[np.isfinite(want)].max())} "
          f"(checked in {time.perf_counter() - t0:.1f} s)")


def check_close(what, got, want, rtol, atol) -> float:
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    require(got.shape == want.shape and np.all(np.isfinite(got))
            and np.allclose(got, want, rtol=rtol, atol=atol),
            f"{what}: outside rtol {rtol} / atol {atol} (max |err| {err})")
    print(f"    {what}: within rtol {rtol} / atol {atol} (max |err| "
          f"{err:g})")
    return err


def check_spmv(g, x, y, what) -> None:
    want = scipy_csr(g).astype(np.float64) @ x.astype(np.float64)
    check_close(f"{what} vs scipy A @ x", y, want, APP_RTOL, APP_ATOL)


def check_histo(hv, bins, counts, what) -> None:
    want = np.bincount(hv, minlength=bins).astype(np.float32)
    require(np.array_equal(counts, want),
            f"{what} differs from np.bincount at "
            f"{int(np.sum(counts != want))} bins")
    print(f"    {what} == np.bincount bitwise ({int(want.sum())} counted)")


def same_run(a, b, what: str, rtol=None, atol=None) -> None:
    if rtol is None:
        require(np.array_equal(a.values, b.values), f"{what}: values differ")
    else:
        require(np.allclose(a.values, b.values, rtol=rtol, atol=atol),
                f"{what}: values outside rtol {rtol} / atol {atol}")
    require(a.run.counters.as_dict() == b.run.counters.as_dict(),
            f"{what}: counters differ")
    require(a.run.trace.to_dict() == b.run.trace.to_dict(),
            f"{what}: trace differs")
    require(a.run.supersteps == b.run.supersteps,
            f"{what}: supersteps differ")
    require(a.run.time_s == b.run.time_s, f"{what}: time_s differs")
    print(f"    {what}: counters, trace, supersteps, time_s equal; values "
          + ("bitwise" if rtol is None else f"within rtol {rtol} / atol "
             f"{atol}"))


ENGINE_KERNELS = ("relax", "segment_combine", "deliver_fused")


def bfs_phase(dev, wl) -> dict:
    from repro_torch.core.engine import DataLocalEngine, EngineConfig
    from repro_torch.graph import apps
    print(f"== 5. main path: BFS, backend=kernels, RMAT-{SCALE} on {TILES} "
          f"tiles, write-through P$")
    t0 = time.perf_counter()
    g, grid = wl[SCALE], wl["grid"]
    fn, args, kw = main_path_apps(wl)["bfs"]
    root, proxy = args[1], kw["proxy"]
    print(f"  root {root}; P$ {proxy.region_ny}x{proxy.region_nx} regions, "
          f"{proxy.slots} slots, write-through")
    with EngineIds() as ids:
        res, launches = app_run(dev, "bfs", fn, *args, **kw)
    ids.report("bfs")
    check_bfs(g, root, res)
    for name in ENGINE_KERNELS:
        require(launches[name] == res.run.supersteps,
                f"bfs: {name} launched {launches[name]} times in "
                f"{res.run.supersteps} supersteps")
    print(f"    every engine kernel launched once per superstep "
          f"({res.run.supersteps})")
    cfg = EngineConfig(grid=grid, n_src=g.n_rows, n_dst=g.n_cols,
                       oq_cap=OQ_CAP, proxy=proxy)
    eng = DataLocalEngine(apps.BFS_SPEC, cfg, g.row_lo, g.row_hi, g.col_idx,
                          g.weights, device=dev)
    profile_supersteps(dev, eng, eng.init_state(seed_idx=root, seed_val=0.0),
                       "bfs")
    print(f"  BFS phase {time.perf_counter() - t0:.1f} s")
    return launches


def add_apps_phase(dev, wl) -> dict:
    from repro_torch.graph import apps
    print(f"== 6. main path: SpMV and Histogram, backend=kernels, "
          f"RMAT-{SCALE} on {TILES} tiles, write-back P$")
    g, grid = wl[SCALE], wl["grid"]
    calls = main_path_apps(wl)
    out = {}
    t0 = time.perf_counter()
    fn, args, kw = calls["spmv"]
    proxy = kw["proxy"]
    print(f"  SpMV: P$ {proxy.region_ny}x{proxy.region_nx} regions, "
          f"{proxy.slots} slots, write-back, cascade {proxy.cascade}")
    with EngineIds() as ids:
        res, launches = app_run(dev, "spmv", fn, *args, **kw)
    ids.report("spmv")
    check_spmv(g, wl["x"], res.values, "SpMV y")
    require(res.run.counters.cascade_combined > 0,
            "spmv: the cascade merged no records")
    require_launches("spmv", launches, res.run.supersteps, ENGINE_KERNELS)
    out["spmv"] = launches
    t1 = time.perf_counter()
    eng, state, _ = apps.engine_and_state("spmv", g, grid, proxy, x=wl["x"],
                                          oq_cap=OQ_CAP, device=dev)
    torch.cuda.synchronize()
    print(f"  SpMV set-up alone (engine_and_state: transpose_csr on the "
          f"host, arrays to the card): {time.perf_counter() - t1:.2f} s")
    profile_supersteps(dev, eng, state, "spmv")
    del eng, state
    print(f"  SpMV phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fn, args, kw = calls["histo"]
    proxy = kw["proxy"]
    print(f"  Histogram: P$ {proxy.region_ny}x{proxy.region_nx} regions, "
          f"{proxy.slots} slots, write-back, no cascade")
    with EngineIds() as ids:
        res, launches = app_run(dev, "histo", fn, *args, **kw)
    ids.report("histo")
    check_histo(wl["histo"], wl["bins"], res.values, "Histogram counts")
    require_launches("histo", launches, res.run.supersteps, ENGINE_KERNELS)
    wl["histo_counts"] = res.values
    out["histo"] = launches
    print(f"  Histogram phase {time.perf_counter() - t0:.1f} s")
    return out


def ops_phase(dev, wl) -> dict:
    from repro_torch.graph import apps
    from repro_torch.kernels import ops
    print("== 7. kernel entry points: ops.histogram, ops.spmv")
    t0 = time.perf_counter()
    idx = torch.from_numpy(wl["histo"]).to(dev)
    mat = wl["bcsr"].to(dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    counts = ops.histogram(idx, wl["bins"]).cpu().numpy()
    spmv_y = ops.spmv(mat, wl["bcsr_x"]).cpu().numpy()
    del idx, mat
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    print(f"  launches {json.dumps(launches)}")
    require(launches["histogram_bin"] == 1 and launches["spmv_bcsr"] == 1,
            f"ops path did not launch each kernel once: {launches}")
    check_histo(wl["histo"], wl["bins"], counts, "ops.histogram")
    require(np.array_equal(counts, wl["histo_counts"]),
            "ops.histogram differs from the engine's Histogram counts")
    print("    ops.histogram == the engine's Histogram counts bitwise")
    g = wl[SPMV_KERNEL_SCALE]
    x = wl["bcsr_x"].cpu().numpy()
    check_spmv(g, x, spmv_y, f"ops.spmv (RMAT-{SPMV_KERNEL_SCALE})")
    grid = wl["grid"]
    res = apps.spmv(g, x, grid,
                    proxy=apps.table2_proxy(grid, "spmv", cascade_levels=2),
                    oq_cap=OQ_CAP, device=dev)
    check_close("ops.spmv vs the engine's apps.spmv", spmv_y,
                res.values.astype(np.float64), APP_RTOL, APP_ATOL)
    print(f"  ops phase {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------- 8. decode attention
def plain_by_slices(q, k, v, lengths, scale=None):
    """The plain version over slices of the batch, so that its f32 copies
    of K and V stay within ``PLAIN_SLICE_BYTES``."""
    from repro_torch.kernels import decode_attention as da
    _, hkv, s, d = k.shape
    rows = max(1, PLAIN_SLICE_BYTES // (8 * hkv * s * d))
    return torch.cat([da.plain(q[i:i + rows], k[i:i + rows], v[i:i + rows],
                               lengths[i:i + rows], scale)
                      for i in range(0, q.shape[0], rows)])


def sdpa_library(q, k, v, lengths, scale):
    """``scaled_dot_product_attention`` over the same inputs (the same
    function for lengths in [1, S]): (ms, the backend PyTorch picks, its
    output)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    keep = torch.arange(k.shape[2], device=k.device)[None, :] < lengths[:, None]
    args = (q[:, :, None], k, v, keep[:, None, None, :])
    backend = SDPBackend(torch._fused_sdp_choice(
        *args, 0.0, False, scale=scale, enable_gqa=True)).name

    def call(q4, kk, vv, mask):
        return F.scaled_dot_product_attention(
            q4, kk, vv, attn_mask=mask, scale=scale, enable_gqa=True)
    out = call(*args)[:, :, 0]
    ms = time_cuda(call, copies(args, 2 * k.numel() * k.element_size()))
    return ms, backend, out


def decode_phase(dev) -> tuple:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    print(f"== 8. kernel entry point ops.decode_attention: one layer at "
          f"decode_32k (S {DECODE_S}), bf16 (rtol/atol {DECODE_TOL}; f32 "
          f"{DECODE_F32_TOL})")
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version: f32
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    s = DECODE_S
    launches = {k.__name__: 0 for k in ops.KERNELS}
    shapes = []

    def check(what, got, want, tol):
        err = max_abs_err(got.float(), want.float())
        require(got.shape == want.shape and got.dtype == want.dtype
                and bool(torch.isfinite(got).all())
                and torch.allclose(got.float(), want.float(), rtol=tol,
                                   atol=tol),
                f"decode_attention {what}: outside rtol/atol {tol} "
                f"(max |err| {err})")
        return err

    for label, b, h, hkv, d in DECODE_SHAPES:
        t1 = time.perf_counter()
        q = torch.randn((b, h, d), generator=gen, device=dev) * DECODE_Q_STD
        q = q.to(torch.bfloat16)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        out = ops.decode_attention(q, k, v, full)
        torch.cuda.synchronize()
        for kern in ops.KERNELS:
            launches[kern.__name__] += kern.launches
        require(da.decode_attention.launches == 1,
                f"{label}: ops.decode_attention launched its kernel "
                f"{da.decode_attention.launches} times")
        err = check(f"{label}, lengths S", out, plain_by_slices(q, k, v, full),
                    DECODE_TOL)
        # ragged lengths from the seed, with 0, 1, S and one past S
        specials = torch.tensor([0, 1, s, s + 100], dtype=torch.int32,
                                device=dev)
        ragged = torch.randint(0, s + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        ragged[:4] = specials[:b]
        sets = [ragged] if b >= 4 else [specials[i:i + 1] for i in range(4)]
        for lens in sets:
            err = max(err, check(f"{label}, ragged lengths",
                                 da.decode_attention(q, k, v, lens),
                                 plain_by_slices(q, k, v, lens), DECODE_TOL))
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + 4 * b
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the bf16 products run on the tensor cores
        op_ms = 4 * b * h * s * d / BF16_FLOP_PER_S * 1e3
        args = copies((q, k, v, full), nbytes)
        ms = time_cuda(da.decode_attention, args)
        plain_ms = time_cuda(plain_by_slices, args)
        del args
        lib_ms, backend, lib_out = sdpa_library(q, k, v, full,
                                                1.0 / math.sqrt(d))
        lib_err = max_abs_err(lib_out.float(), out.float())
        del lib_out
        row = dict(shape=label, B=b, H=h, Hkv=hkv, S=s, D=d,
                   kernel=da.split_kernel(q.dtype),
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(byte_ms, op_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations",
                   byte_bound_ms=byte_ms, op_bound_ms=op_ms,
                   library_ms=lib_ms, library_backend=backend,
                   library_max_abs_err=lib_err)
        if b == 1:      # the split path once more in f32
            qf, kf, vf = q.float(), k.float(), v.float()
            row["f32_kernel"] = da.split_kernel(qf.dtype)
            for n in (s, s // 3):
                lens = torch.full((1,), n, dtype=torch.int32, device=dev)
                row["f32_max_abs_err"] = max(
                    row.get("f32_max_abs_err", 0.0),
                    check(f"{label}, f32, length {n}",
                          da.decode_attention(qf, kf, vf, lens),
                          da.plain(qf, kf, vf, lens), DECODE_F32_TOL))
            del qf, kf, vf
        shapes.append(row)
        f32 = (f", f32 {row['f32_max_abs_err']:g} on the {row['f32_kernel']}"
               if b == 1 else "")
        print(f"  {label} (B {b}, H {h}, Hkv {hkv}, D {d}): {row['kernel']}, "
              f"ok (max |err| {err:g}, the CUDA-core kernel's "
              f"{DECODE_CUDA_CORE_ERR:g}{f32})"
              f"; {ms:.4f} ms vs byte bound {byte_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB; op bound {op_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms ({backend}; max "
              f"|err| vs kernel {lib_err:g}); "
              f"{time.perf_counter() - t1:.1f} s")
        del q, k, v, full, out
        torch.cuda.empty_cache()
    print(f"  launches {json.dumps(launches)}")
    print(f"  decode phase {time.perf_counter() - t0:.1f} s")
    main = {key: shapes[0][key] for key in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}
    row = dict(name="decode_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:61",
               launches=0, **main, shapes=shapes)
    return row, launches


def agreement_phase(dev, wl) -> None:
    from repro_torch.graph import apps, oracles
    from repro_torch.graph.rmat import histogram_input
    print(f"== 9. backend agreement (kernels vs torch) at RMAT-{AGREE_SCALE} "
          f"on {TILES} tiles")
    g, grid = wl[AGREE_SCALE], wl["grid"]
    bins = g.n_rows // 8
    hv = histogram_input(g, bins)
    x = np.random.default_rng(SEED).random(g.n_cols).astype(np.float32)
    root = int(np.argmax(g.out_degree()))
    cases = [
        ("bfs", apps.bfs, (g, root, grid),
         dict(proxy=apps.table2_proxy(grid, "bfs")), None),
        ("spmv", apps.spmv, (g, x, grid),
         dict(proxy=apps.table2_proxy(grid, "spmv", cascade_levels=2)),
         (AGREE_RTOL, AGREE_ATOL)),
        ("histo", apps.histogram, (hv, bins, grid),
         dict(proxy=apps.table2_proxy(grid, "histo")), None),
        ("pagerank", apps.pagerank, (g, grid),
         dict(proxy=apps.table2_proxy(grid, "pagerank"),
              epochs=PAGERANK_EPOCHS), (AGREE_RTOL, AGREE_ATOL)),
    ]
    for name, fn, args, kw, tol in cases:
        t0 = time.perf_counter()
        runs = [app_run(dev, name, fn, *args, oq_cap=OQ_CAP, backend=b,
                        **kw)[0] for b in ("kernels", "torch")]
        same_run(runs[0], runs[1], f"{name} kernels vs torch",
                 *(tol or (None, None)))
        if name == "pagerank":
            check_close("PageRank vs its oracle", runs[0].values,
                        oracles.pagerank_oracle(g, epochs=PAGERANK_EPOCHS)
                        .astype(np.float64), PR_RTOL, PR_ATOL)
        print(f"  {name} agreement {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    c = card()
    build()
    wl = workloads()
    rows = kernel_phase(dev, wl)
    by_path = dict(bfs=bfs_phase(dev, wl))
    by_path.update(add_apps_phase(dev, wl))
    by_path["ops"] = ops_phase(dev, wl)
    decode_row, by_path["decode"] = decode_phase(dev)
    rows.append(decode_row)
    agreement_phase(dev, wl)
    for row in rows:
        row["launches_by_path"] = {p: n[row["name"]]
                                   for p, n in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        require(row["launches"] > 0,
                f"{row['name']} never launched on a main path")

    print(f"== 10. done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(c["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": c["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
