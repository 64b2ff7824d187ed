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
   min and add, again at the shapes of each compaction window below the
   dense one (phase 6b's: 1024, 256 and 64 tiles), and in their add
   form at the write-back flush wave's shapes (deliver_fused's counting
   path printed);
   histogram_bin on the Histogram input and on the RMAT-22 degree
   histogram (bitwise; its path, slices and resident blocks printed);
   spmv_bcsr on
   RMAT-14 in 128x128 BCSR (rtol/atol 1e-4; its library call a
   ``torch.sparse_bsr_tensor`` product).  Each timed (CUDA events,
   inputs rotated past L2) beside its bound, its plain version and, where
   one PyTorch call computes the same function, that call;
5. BFS on RMAT-22 over one 64x64-tile package (4096 tiles) with the
   Table-II write-through proxy, backend ``kernels``, through the
   default chunked run loop (16 supersteps a host fetch, each a CUDA
   graph replay); values checked against scipy's BFS hop distances;
   two ``torch.profiler`` windows, 20 supersteps of the per-step loop
   (``run_chunk=0``) and 20 graph replays (the whole run on the per-step
   loop is phase 9's, at RMAT-18: the time limit);
6. SpMV (write-back P$, selective 2-level cascade) and Histogram
   (write-back P$) on RMAT-22 over 4096 tiles, backend ``kernels``,
   chunked; checked against scipy's ``A @ x`` and ``np.bincount``;
   Histogram also on the per-step loop (equal in counters, trace,
   supersteps, ``time_s`` and values; SpMV's is phase 9's, at RMAT-18);
   each with the two profiler windows;
6b. active-set compaction (``compaction=3``: windows of 4096, 1024, 256
   and 64 tiles) on the chunked loop: BFS, SpMV and Histogram at RMAT-22,
   each equal to its dense chunked run of phase 5 or 6 (counters, trace,
   supersteps and ``time_s``; values bitwise for BFS and Histogram,
   within rtol 1e-4 / atol 1e-5 for SpMV), BFS against scipy again; for
   each the active-tile share a superstep (mean, median, p90), the
   supersteps per reference rung and per window run, the window
   overflows, host syncs, ms a superstep (``LoopClock``), peak memory
   and graphs captured beside the dense run's; at the rung each app
   spends most supersteps in (BFS's first), from a state there: 20
   replays in that window against 20 dense replays from the same state
   (unprofiled, in turns), a ``torch.profiler`` window of 20 replays,
   and 20 eager supersteps split into ops with a full-length (T*C)
   operand and the rest;
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
9. backend agreement at RMAT-18, chunked: BFS, SpMV, Histogram and
   PageRank (epochs=3) with ``kernels`` and with ``torch``: counters,
   trace, supersteps and ``time_s`` exact, values bitwise (BFS,
   Histogram) or within rtol 1e-4 / atol 1e-5 (SpMV, PageRank);
   all four also on the per-step loop against the chunked one (BFS and
   SpMV with the ``EngineIds`` tap, timed beside the chunked run by
   ``LoopClock``: cut from phases 5 and 6's RMAT-22 by the time limit);
   BFS and PageRank with ``compaction=3`` on both loops against the
   dense chunked run (window overflows printed), and on the chunked loop
   with ``torch`` against ``kernels``; PageRank against its oracle;
9b. observability and the sanitizer: BFS at RMAT-22 on the chunked loop,
   dense and with ``compaction=3``, with ``telemetry=True``,
   ``sanitize=True`` and a ``TimelineRecorder``: each equal to its run of
   phase 5 or 6b (values bitwise; counters, trace, supersteps, ``time_s``;
   host syncs equal), then the same call without the hooks, so ms a
   superstep (``LoopClock``) is read in turns; peak memory, the
   recorder's spans and load-vector bytes, and the imbalance report's
   gini and max/mean of ``tv_delivered``.  At RMAT-18: SpMV, Histogram
   and PageRank with every hook equal to phase 9's runs, BFS on the
   per-step loop (one span per superstep), BFS's recorder written as a
   Perfetto trace (``obs.export.write_trace``) into a temporary
   directory and parsed back (events by track printed), and BFS with a
   NaN planted in ``values`` on both loops, which must raise
   ``SanitizerError``;
10. the partitioned engine in one process (``chips=4``: 2x2 chips of
   32x32 tiles, every chip's tiles in one batched superstep, the board
   exchange folded in at its end): BFS on RMAT-22 with the Table-II
   proxy, chunked, against scipy, ``off_chip_msgs > 0``, beside phase
   5's monolithic run (supersteps, host syncs, ms a superstep, wall,
   peak memory, off-chip messages, modelled ``time_s`` and GTEPS; the
   six level-traffic trace fields a partition leaves alone printed as
   equal or not); at RMAT-18, proxy-free, BFS, SpMV, Histogram and
   PageRank against their monolithic runs (those six fields equal,
   values bitwise or within rtol 1e-4 / atol 1e-5, off-chip traffic),
   ``kernels`` against ``torch`` (counters, trace, supersteps, ``time_s``
   exact) and BFS's per-step loop against its chunked one; SpMV with the
   Table-II proxy and a 2-level cascade (cut at the chip boundary, its
   levels printed) against scipy's ``A @ x`` and Histogram with the
   write-back P$ against ``np.bincount``; 20 profiled graph replays of
   BFS RMAT-18 at 1, 4 and 16 chips (device entries and busy ms a
   superstep; 16 chips at most 1.1x the 4-chip entries); and
   ``harness.weak_scaling`` at 1, 4, 16, 64 and 256 chips of 16 tiles
   (GTEPS monotone, ``reprice_ratio`` within 1e-9 of 1, each row's wall
   seconds);
10b. the partition's overlap and windows (ROADMAP A.5b; the card runs
   the deferred exchange in order, the BSP model prices the overlap):
   BFS on RMAT-22 on 4 chips with ``compaction=3`` (per-chip windows of
   1024, 256, 64 and 16 tiles), ``double_buffer=True`` and both, each
   against scipy and against phase 10's synchronous dense run (counters,
   the trace less its ``double_buffer`` field, supersteps; host syncs
   equal, or at most one more per window overflow; ``time_s`` equal
   without the double buffer, strictly below with it, its trace
   re-priced within 1e-12), with ms a superstep, wall, peak memory,
   supersteps by window and overflows, then the synchronous dense run
   again (equal to phase 10's; ms a superstep of all five in the order
   run); at RMAT-18, Table-II, BFS and
   SpMV (cascade cut at the chip boundary) with both on,
   ``compaction=2``, below their synchronous dense runs in ``time_s``
   and equal to them otherwise, on both backends and both loops
   (counters, trace, supersteps, ``time_s`` exact; BFS values bitwise,
   SpMV within rtol 1e-4 / atol 1e-5, and against scipy); 20 profiled
   graph replays of BFS RMAT-18 on 4 chips synchronous, double-buffered
   and, with both, in the per-chip window the compacted run spent most
   supersteps in (device entries and busy ms a replay); and
   ``harness.weak_scaling(double_buffer=True)`` at 1-256 chips, each
   row's GTEPS at or above phase 10's synchronous row's;
11. fault tolerance (ROADMAP A.6: checkpoints, chip-loss recovery, the
    straggler plan): phase 10's RMAT-22 BFS on 4 chips, and 10b's with
    ``compaction=3`` and ``double_buffer=True``, each with
    ``ckpt_every_supersteps=1024`` and chip 2 lost at superstep 3,000
    (``runtime.FaultInjector``) on the chunked loop, through
    ``DistributedEngine.run(fault_injector=, ckpt_dir=)``: values equal
    to scipy's; counters, trace rows and supersteps equal to the unfailed
    run's; the step-0 checkpoint, one rollback and one re-shard onto one
    device; ``cycles`` exactly the unfailed run's plus the recovery
    overhead re-priced from the events with the cost model's helpers,
    the trace re-priced within 1e-12 of ``time_s``; graphs captured
    equal to the unfailed run's (the restore goes into the runner's
    tensors), host syncs the unfailed run's plus the replayed chunks'
    (dense); the image's bytes, the seconds of each write and of the
    restore, the memory allocated around the restore, the recovery's
    wall seconds and peak memory printed.  At RMAT-18, Table-II, 4 chips,
    SpMV with its cascade, ``double_buffer`` and ``compaction=2``, with
    ``telemetry=True`` and a checkpoint just before the first flush:
    the cadence alone equal to 10b's run but for its checkpoint events,
    then the chip lost just after the flush (so the flush wave replays)
    on the chunked and per-step loops, each equal to 10b's run, its
    ``rebalance_plan()`` equal to the plan after the unfailed run.
    Checkpoints go to temporary directories the phase removes;
12. ranks (ROADMAP A.5c; ``distrib.mesh``): a one-rank NCCL group on a
    file store in a temporary directory, opened in this process (the card
    holds one rank: NCCL refuses two on one device), and phase 10's
    RMAT-22 BFS on 4 chips through ``backend="shard_map"`` on it, so the
    exchange's all-gather and the stats' all-gather run (captured in the
    CUDA graphs on the chunked loop), chunked, equal to phase 10's
    in-process run (values bitwise; counters, trace, supersteps,
    ``time_s``) with phase 10's host syncs; 10b's RMAT-18 BFS on the
    per-step loop (two NCCL calls from the host a superstep, so RMAT-18),
    equal to 10b's synchronous run, at least two all-gathers a superstep;
    ms a superstep, peak memory and graphs captured beside phase 10's;
    20 profiled replays of BFS RMAT-18 on the group beside phase 10's
    (device entries and busy ms; the all-gathers captured, none issued
    by a replay, more entries than phase 10's); SpMV RMAT-18 with
    its cascade, ``compaction=2`` and ``double_buffer=True`` on the group
    equal to phase 10b's run.  The group is destroyed before the phase
    ends;
13. product search (ROADMAP A.7; ``repro_torch.products``): BFS at
    RMAT-22 on the 4096-tile package (``MeasureSpec`` defaults: phase
    5's call) swept over the chips axis, ``chip_counts_for(4096)`` = 1,
    4, 16 and 64 chips, each chip count's products (3 memory styles x 4
    networks at 1.5 MiB SRAM, board links 1, 2 and 4 on more than one
    chip): 120 rows from 4 engine runs, the search's one RMAT-22 graph
    asked for once (and handed phase 3's, the same graph: ``DatasetTap``).
    Gates: a second sweep makes no engine run and gives equal rows from
    the cache; the 1-chip and 4-chip measurements equal phase 5's and
    phase 10's runs (counters, trace, supersteps, ``time_s``, TEPS
    edges); every measurement re-priced under its own package within
    1e-12 of its ``time_s``; one board link never faster and always
    cheaper than the default two; each measurement launches every
    engine kernel.  Printed: each chip count's supersteps, wall, peak
    memory, modelled ``time_s`` and GTEPS; the Pareto front over all
    rows; the winners by objective at each chip count and overall;
14. the analysis passes (ROADMAP A.9; ``repro_torch.analysis``): (a)
    the lint matrix (``runner.run_all``: ``steplint``, ``invariants``,
    ``deadcode``) on the kernels backend, the six apps' five cells each
    (monolithic, 4 chips, 4 chips double-buffered, and both compacted)
    at RMAT-7 on 16 tiles, through the kernels and their CUDA-graph
    captures (one graph a (flush, window) key); (b) the ``steplint``
    walk of single supersteps at RMAT-22 on 4096 tiles: BFS dense, in
    phase 6b's commonest compacted window, on 4 chips double-buffered,
    and Histogram's flush superstep (the P$'s spare-row repeats cut off,
    the window's distinct lanes); (c) ``kernel_races`` on every kernel's
    ``analysis_cases`` and on phase 4's shapes, each case in its own
    order, reversed and permuted, three times each.  Any finding outside
    ``analysis_baseline_torch.json`` fails; each part's cells, findings
    and seconds printed;
15. the dense LM served at full published width (ROADMAP A.10a;
    ``repro_torch.models``, ``serving``), random weights from the seed,
    every decode step's attention through ``ops.decode_attention``:
    (a) deepseek-7b through ``registry.get`` -> ``fam["init"]`` ->
    ``ServeScheduler`` (the calls of ``launch/serve.py``'s ``main``): 8
    slots, ``max_len`` 512, 12 seeded prompts of 3-64 tokens fed token
    by token, 32 new tokens each, greedy; every request complete,
    decode_attention launched once a layer a step, the first full-batch
    step's logits held against the same step through the plain
    attention (``SERVE_LOGIT_TOL``); (b) starcoder2-3b through
    ``generate``: B 8, a 256-token prompt, 32 tokens; (c) decode_32k:
    starcoder2-3b, B 8, a 32,768-position cache filled from the seed,
    decode steps at position 32,767 through the kernel and the plain
    attention in turns (logits held to the same tolerance), then 4
    profiled kernel steps (decode_attention's share of the device
    time).  Printed: ms a step, tokens/s, prefill ms, peak memory,
    launches, beside the ``nvidia-smi`` line;
16. dense training at full published width (ROADMAP A.10b;
    ``repro_torch.training``, ``data``, ``launch.train``), random weights
    from the seed: (a) ``launch.train.main`` on starcoder2-3b, 8 AdamW
    steps of 8 x 1,024 tokens at lr 3e-6 (the entry point a user calls;
    each block rematted); every loss and grad norm finite, the mean of the last 3
    losses below the first (step 0 runs at lr 0), peak memory below
    ``TRAIN_PEAK_GIB``; (b) the same configuration's step timed on 6
    batches made before the timing (ms a step, tokens/s, the share of
    the card's dense bf16 peak that 6 N T gives, N the parameters
    without the token embedding), the host's ``batch_at`` seconds alone,
    peak memory, the optimizer update's device span, and 2 profiled
    steps (device-busy ms, the top 10 device ops); (c) 2 AdamW steps of
    the reduced starcoder2-3b and deepseek-7b from one f32 state carried
    by ``convert``, on the card and on the CPU, within ``TRAIN_RTOL`` /
    ``TRAIN_PARAM_TOL``.  No kernel of the six runs on this path: the
    launches the wrappers count in (a) and the kernels the profiler sees
    in (b) are printed, by kernel (0 each);
17. one JSON line of per-kernel numbers, the ``nvidia-smi`` line, then
    the last line, ``{"ok": true, "device": {...}}``.

Every app run prints its supersteps, wall seconds, ms per superstep,
host syncs, CUDA-graph replays, peak device memory and launches per
kernel.  The per-step runs of phase 6 (Histogram) and phase 9 (BFS,
SpMV) also print, per call shape
of segment_combine and deliver_fused, how the ids the engine hands them
fall in the kernels' 32-record warp slices (``EngineIds``): the share
of live records in runs of neighbours and repeated in their slice, and
the atomics a fold would leave.

Each main-path run (phases 5-8, 6b, 9b, the RMAT-22 runs of 10,
10b and 11, and 15's serving runs) sets every
kernel's launch count to 0 just before it and reads the counts just
after; a kernel on the path that did not launch (at least once per
superstep, on the engine's paths) fails the run.  The JSON line counts
the compacted runs under their own path, ``compaction``, phase 9b's
RMAT-22 runs under ``hooks``, phase 10's under ``partition``, phase
10b's three under ``partition_overlap``, phase 11's two under
``fault``, phase 12's two under ``ranks``, phase 13's four
measurements under ``products``, phase 14's matrix runs and walks
under ``analysis`` (its race checks compare kernels with their plain
versions and are not counted), phase 15's (a) and (b) under ``serve``
and (c)'s kernel steps under ``serve_32k`` (its plain steps launch
nothing), and phase 16's training under ``train`` (none: the wrappers'
counts in (a) plus the kernels the profiler sees in (b)).  A graph replay counts the launches
captured in it, so on the chunked loop the counts include the idle rows
of a chunk (after the run drained, or after a flush the device
scheduled), which are printed as the surplus.

Without a CUDA device, or without the repo's ``src/repro_torch`` beside
it, the script prints no result and exits nonzero.
"""
from __future__ import annotations

import contextlib
import gc
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
def kernel_inputs(gen, dev, tiles: int = TILES):
    """Synthetic inputs at the engine's shapes over ``tiles`` tiles (the
    dense step's T, or a compaction window's W).  BFS path (min and add):
    W*Cd drained mailbox entries, R = W*oq_cap P$ records, 2R delivery
    records (the forwarded leg + the eviction leg) into the whole Nd
    mailbox.  At T only, the write-back flush wave (add), which no
    window shrinks: the T*S P$ entries of SpMV's cascade levels into as
    many segments, and Histogram's flush of T*S records into its
    Nd = T*Cd mailbox."""
    nd = (1 << SCALE)          # chunk_dst * T = 2**22 at RMAT-22
    n = tiles * (nd // TILES)
    r = tiles * OQ_CAP
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

    relax_in = (with_inf(rand(n) * 64, 0.5), with_inf(rand(n) * 64, 0.3),
                rand(n) < 0.5)
    dseg = torch.cat([scattered(r, nd, 0.6),
                      torch.full((r,), -1, dtype=torch.int32, device=dev)])
    out = dict(
        relax=relax_in,
        relax_add=(rand(n) * 64, rand(n) * 64, rand(n) < 0.5),
        seg=(sorted_gids(r, 0.6), rand(r) * 64, r),
        seg_rand=(scattered(r, r, 0.7), rand(r) * 64, r),
        deliver=(dseg, rand(2 * r) * 64, with_inf(rand(nd) * 64, 0.5)))
    if tiles == TILES:
        out.update(
            seg_add=(sorted_gids(ts, 0.8), rand(ts) * 64, ts),
            deliver_add=(scattered(ts, nd_histo, 0.9), rand(ts) * 64,
                         rand(nd_histo) * 64))
    return out


def window_readings(gen, dev) -> dict:
    """The compacted path's shapes (phase 6b): relax, segment_combine and
    deliver_fused at every window of ``capacity_ladder(TILES,
    COMPACTION)`` below the dense one, min and add, each against its
    plain version on the same inputs and timed.  Returns {kernel: {W:
    the min reading with the add one under ``add``}}."""
    from repro_torch.core.engine import capacity_ladder
    from repro_torch.kernels import deliver_fused as df
    from repro_torch.kernels import relax_min as rx
    from repro_torch.kernels import segment_combine as sc
    out = {k: {} for k in ENGINE_KERNELS}
    for w in capacity_ladder(TILES, COMPACTION)[1:]:
        x = kernel_inputs(gen, dev, tiles=w)
        n = x["relax"][0].numel()
        seg, _, r = x["seg"]
        dseg, _, mail = x["deliver"]
        cases = (
            ("relax", rx.relax, rx.plain, ("relax", "relax_add"), 14 * n,
             f"n {n}"),
            ("segment_combine", sc.segment_combine, sc.plain, ("seg",) * 2,
             _bytes_scatter(seg, 4 * r), f"{r} sorted records (P$)"),
            ("deliver_fused", df.deliver_fused, df.plain, ("deliver",) * 2,
             _bytes_scatter(dseg, 12 * mail.numel()),
             f"{dseg.numel()} records into {mail.numel()}, "
             f"{df.counting_path(dseg.numel())} counts"))
        for name, kernel, plain, keys, nbytes, what in cases:
            got = {c: _measure(name, c, x[k], kernel, plain, nbytes,
                               what=f"window {w}: {what}")
                   for c, k in zip(("min", "add"), keys)}
            out[name][w] = dict(got["min"], add=got["add"])
        # unsorted ids, padding interleaved, at the window's length too
        for combine in ("min", "add"):
            _agree(f"segment_combine[unsorted, window {w}]/{combine}",
                   combine == "min",
                   sc.segment_combine(*x["seg_rand"], combine),
                   sc.plain(*x["seg_rand"], combine), ADD_RTOL, ADD_ATOL)
        del x
    return out


def histogram_readings(wl) -> dict:
    """histogram_bin's two readings at the Histogram app's bins: the
    paper's input ((i + w_i) mod bins: a warp's ids nearly distinct and
    neighbouring) and the RMAT-22 destination ids mod bins (the degree
    histogram: hubs make hot bins)."""
    col = wl[SCALE].col_idx
    return {"Histogram input": wl["histo"],
            "degree histogram": (col % wl["bins"]).astype(np.int32)}


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
    windows = window_readings(gen, dev)
    src = "src/repro_torch/kernels/csrc/"
    rows = []

    def row(name, source, replaces, main, **readings):
        rows.append(dict(name=name, route="cuda", source=src + source,
                         replaces=replaces, launches=0, **main, **readings))

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
        main, add=add)

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
        "src/repro/kernels/segment_combine.py:55", main, add=add)

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
        "src/repro/kernels/deliver_fused.py:68", main, add=add)
    for r_ in rows:
        r_["windows"] = windows[r_["name"]]

    # histogram_bin on the Histogram app's input and on the RMAT-22
    # degree histogram (hub-heavy: hot bins), bitwise: 4 B per id read,
    # 4 B per bin written; the library call is torch.bincount (ids are
    # all non-negative here)
    bins = wl["bins"]
    readings = {}
    for label, ids in histogram_readings(wl).items():
        idx = torch.from_numpy(ids).to(dev)
        nbytes = 4 * idx.numel() + 4 * bins
        readings[label] = _measure(
            "histogram_bin", None, (idx, bins), hb.histogram_bin, hb.plain,
            nbytes, what=f"{label}: {idx.numel()} ids, {bins} bins",
            library=(lambda i, b: torch.bincount(i, minlength=b),
                     copies((idx, bins), nbytes)), bitwise=True)
        p, resident = hb.histogram_bin.last
        print(f"  histogram_bin {label}: path {p.path}, {p.slices} slices "
              f"x {p.per_block} bins, {resident} resident blocks; "
              f"{readings[label]['ms']:.4f} ms vs bound "
              f"{readings[label]['bound_ms']:.4f} ms, torch.bincount "
              f"{readings[label]['library_ms']:.4f} ms")
        readings[label].update(path=p.path, slices=p.slices,
                               resident=resident)
        del idx
    main, degrees = readings.values()
    row("histogram_bin", "histogram_bin.cu",
        "src/repro/kernels/histogram_bin.py:39", main,
        degree_histogram=degrees)

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
            # a graph replay would not run the tap: per-step runs only
            require(not torch.cuda.is_current_stream_capturing(),
                    "EngineIds taps the per-step loop (run_chunk=0) only")
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
class LoopClock:
    """While entered, sums the host-clock seconds spent inside
    ``DataLocalEngine._run``, the run loop of ``DataLocalEngine.run`` and
    ``DistributedEngine.run``: the loop alone, without the app's set-up.
    Each run ends in its last fetch, which waits for all the work it
    enqueued, so the sum is the loop's wall time."""

    def __enter__(self):
        from repro_torch.core.engine import DataLocalEngine
        self.seconds = 0.0
        self._run = run = DataLocalEngine._run

        def timed(eng, *args, **kw):
            t0 = time.perf_counter()
            try:
                return run(eng, *args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        DataLocalEngine._run = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.core.engine import DataLocalEngine
        DataLocalEngine._run = self._run


def app_run(dev, label: str, fn, *args, **kw):
    """One app call as a user makes it, timed on the host clock around
    work that ends in a synchronise, and its run loop alone
    (``LoopClock``); every kernel's launch count is set to 0 just before
    and read just after.  Returns (result, launches, readings)."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import default_registry
    reg = default_registry()
    syncs, replays, captures = (reg.counter("engine.host_syncs"),
                                reg.counter("engine.graph_replays"),
                                reg.counter("engine.graph_captures"))
    syncs0, replays0, captures0 = syncs.value, replays.value, captures.value
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with LoopClock() as clock:
        res = fn(*args, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    run = res.run
    chunk = kw.get("run_chunk", EngineConfig.run_chunk)
    loop = "per-step loop" if chunk == 0 else f"chunked loop, {chunk} a fetch"
    readings = dict(supersteps=run.supersteps, chunk=chunk, wall_s=wall,
                    loop_s=clock.seconds,
                    ms_per_superstep=clock.seconds / run.supersteps * 1e3,
                    host_syncs=syncs.value - syncs0,
                    graph_replays=replays.value - replays0,
                    graph_captures=captures.value - captures0,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"  {label} backend={kw.get('backend', 'kernels')}, {loop}: "
          f"{run.supersteps} supersteps in {wall:.2f} s wall on the card, "
          f"{clock.seconds:.2f} s of it in the run loop "
          f"({readings['ms_per_superstep']:.3f} ms per superstep, "
          f"{readings['host_syncs']:.0f} host syncs, "
          f"{readings['graph_replays']:.0f} graph replays), peak device "
          f"memory {readings['peak_gib']:.3f} GiB")
    print(f"    modelled Tascade chip (BSP cost model, not the H100): "
          f"time_s {run.time_s:.6e}, {res.gteps:.2f} GTEPS")
    print(f"    counters {json.dumps(run.counters.as_dict())}")
    print(f"    launches {json.dumps(launches)}")
    return res, launches, readings


def require_launches(label, launches, readings, names) -> None:
    """Every kernel of the path launched at least once per superstep
    (the engine calls each one in every superstep; flush supersteps
    call segment_combine and deliver_fused more than once), and relax
    exactly once in each superstep run.  The chunked loop replays CUDA
    graphs and runs each chunk's full length of predicated supersteps,
    its idle rows included: the surplus over the supersteps is
    printed."""
    steps = readings["supersteps"]
    for name in names:
        require(launches[name] >= steps,
                f"{label}: {name} launched {launches[name]} times in "
                f"{steps} supersteps")
    ran = steps
    if readings["chunk"]:
        require(readings["graph_replays"] > 0,
                f"{label}: no CUDA graph replayed")
        ran = readings["host_syncs"] * readings["chunk"]
    require(launches["relax"] == ran,
            f"{label}: relax launched {launches['relax']} times in "
            f"{ran:.0f} supersteps run")
    surplus = {n: launches[n] - steps for n in names}
    print(f"    {label}: every engine kernel launched at least once per "
          f"superstep ({steps}); surplus over the supersteps "
          f"{json.dumps(surplus)} (idle rows {ran - steps:.0f} of "
          f"{ran:.0f} predicated supersteps)")


def compare_loops(label, chunked, per_step) -> None:
    """The two run loops' readings side by side."""
    print(f"    {label} loops: ms per superstep chunked "
          f"{chunked['ms_per_superstep']:.3f} vs per-step "
          f"{per_step['ms_per_superstep']:.3f} "
          f"({per_step['loop_s'] / chunked['loop_s']:.2f}x; wall with the "
          f"set-up {chunked['wall_s']:.2f} vs {per_step['wall_s']:.2f} s); "
          f"host syncs {chunked['host_syncs']:.0f} vs "
          f"{per_step['host_syncs']:.0f}; peak GiB "
          f"{chunked['peak_gib']:.3f} vs {per_step['peak_gib']:.3f}")


def _profile_report(prof, wall: float, n: int, label: str):
    """The device-busy share of a profiled window of ``n`` supersteps
    and the entries with the most device and host time.  Returns the
    device-busy ms and the device entries a superstep (None when the
    profiler recorded no device time)."""
    from torch.autograd import DeviceType
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
        return None
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
    return dict(wall_ms=wall * 1e3 / n, busy_ms=busy_us / n / 1e3,
                entries=sum(k[1] for k in kernels) / n)


def profile_supersteps(dev, eng, state, label: str, n: int = 20) -> None:
    """Where a superstep's time goes, on both run loops, from the same
    initial state: ``n`` supersteps of the per-step loop (after 5
    warm-up supersteps), then ``n`` graph replays of the chunked loop
    (one chunk of ``n`` after a first chunk of ``n``, which runs the
    eager superstep and the capture), each under ``torch.profiler``
    with its one fetch.  The profiler adds host overhead of its own."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import fetch_stats
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    st = state
    for _ in range(5):
        st, stats = eng._superstep(st)
        fetch_stats(stats)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            st, stats = eng._superstep(st)
            fetch_stats(stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_report(prof, wall, n, f"{label}, per-step loop")
    del st, stats
    profile_replays(eng, state, label, n)


def profile_replays(eng, state, label: str, n: int = 20,
                    window=None) -> dict:
    """``n`` graph replays of the chunked loop from ``state`` (one chunk
    of ``n`` after a first chunk of ``n``, which runs the eager
    superstep and the capture) under ``torch.profiler``, with their one
    fetch; ``eng`` a ``DataLocalEngine`` or a ``DistributedEngine``.
    In a compaction ``window`` a row the state outgrows idles (it runs
    the same graph): its active rows are printed, not gated.  Returns
    ``_profile_report``'s readings, which must exist."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.metrics import default_registry
    replays = default_registry().counter("engine.graph_replays")
    runner = eng.chunk_runner(state, n)
    runner.launch(10 * n, False, window)
    runner.fetch()
    before = replays.value
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.launch(10 * n, False, window)
        rows = runner.fetch().rows
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    active = int(rows[:, -1].sum())
    require(replays.value - before == n and (window is not None
                                             or active == n),
            f"profile {label}: {replays.value - before:.0f} replays, "
            f"{active} active rows, expected {n}")
    got = _profile_report(prof, wall, n, f"{label}, {n} graph replays"
                          + ("" if window is None else
                             f" at window {window} ({active} rows active)"))
    require(got is not None, f"profile {label}: no device time recorded")
    return dict(got, active_rows=active)


def scipy_csr(g):
    from scipy.sparse import csr_matrix
    w = g.weights if g.weights is not None else np.ones(g.nnz, np.float32)
    return csr_matrix((w, g.col_idx, g.row_ptr), shape=(g.n_rows, g.n_cols))


_HOPS = {}      # (graph, root) -> scipy's hop distances, made once


def check_bfs(g, root, res) -> None:
    from scipy.sparse.csgraph import shortest_path
    t0 = time.perf_counter()
    key = (id(g), root)
    if key not in _HOPS:
        _HOPS[key] = shortest_path(scipy_csr(g), unweighted=True,
                                   indices=root)
    want = _HOPS[key]
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


def same_physics(a, b, what: str, rtol=None, atol=None) -> None:
    """Two runs equal but for how the overlap was priced: values,
    counters, the trace less its ``double_buffer`` field, supersteps."""
    if rtol is None:
        require(np.array_equal(a.values, b.values), f"{what}: values differ")
    else:
        require(np.allclose(a.values, b.values, rtol=rtol, atol=atol),
                f"{what}: values outside rtol {rtol} / atol {atol}")
    require(a.run.counters.as_dict() == b.run.counters.as_dict(),
            f"{what}: counters differ")
    ta, tb = a.run.trace.to_dict(), b.run.trace.to_dict()
    ta.pop("double_buffer"), tb.pop("double_buffer")
    require(ta == tb, f"{what}: trace differs")
    require(a.run.supersteps == b.run.supersteps,
            f"{what}: supersteps differ")


def same_run(a, b, what: str, rtol=None, atol=None) -> None:
    same_physics(a, b, what, rtol, atol)
    require(a.run.trace.double_buffer == b.run.trace.double_buffer,
            f"{what}: trace differs")
    require(a.run.time_s == b.run.time_s, f"{what}: time_s differs")
    print(f"    {what}: counters, trace, supersteps, time_s equal; values "
          + ("bitwise" if rtol is None else f"within rtol {rtol} / atol "
             f"{atol}"))


ENGINE_KERNELS = ("relax", "segment_combine", "deliver_fused")


def per_step_run(dev, label, res, fn, args, kw, rtol=None, atol=None):
    """The same call on the per-step loop (``run_chunk=0``) with the
    ``EngineIds`` tap: its launches checked, and the run equal to the
    chunked one ``res``.  Returns its readings."""
    with EngineIds() as ids:
        ref, launches, readings = app_run(dev, label, fn, *args,
                                          run_chunk=0, **kw)
    ids.report(label)
    require_launches(f"{label} per-step", launches, readings,
                     ENGINE_KERNELS)
    same_run(res, ref, f"{label} chunked vs per-step loop", rtol, atol)
    return readings


def bfs_phase(dev, wl) -> dict:
    from repro_torch.graph import apps
    print(f"== 5. main path: BFS, backend=kernels, RMAT-{SCALE} on {TILES} "
          f"tiles, write-through P$")
    t0 = time.perf_counter()
    g, grid = wl[SCALE], wl["grid"]
    fn, args, kw = main_path_apps(wl)["bfs"]
    root, proxy = args[1], kw["proxy"]
    print(f"  root {root}; P$ {proxy.region_ny}x{proxy.region_nx} regions, "
          f"{proxy.slots} slots, write-through")
    res, launches, chunked = app_run(dev, "bfs", fn, *args, **kw)
    check_bfs(g, root, res)
    require_launches("bfs", launches, chunked, ENGINE_KERNELS)
    wl["dense"] = dict(bfs=(res, chunked))
    eng, state, _ = apps.engine_and_state("bfs", g, grid, proxy, root=root,
                                          oq_cap=OQ_CAP, device=dev)
    profile_supersteps(dev, eng, state, "bfs")
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
    res, launches, chunked = app_run(dev, "spmv", fn, *args, **kw)
    check_spmv(g, wl["x"], res.values, "SpMV y")
    require(res.run.counters.cascade_combined > 0,
            "spmv: the cascade merged no records")
    require_launches("spmv", launches, chunked, ENGINE_KERNELS)
    out["spmv"] = launches
    wl["dense"]["spmv"] = (res, chunked)
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
    res, launches, chunked = app_run(dev, "histo", fn, *args, **kw)
    check_histo(wl["histo"], wl["bins"], res.values, "Histogram counts")
    require_launches("histo", launches, chunked, ENGINE_KERNELS)
    wl["histo_counts"] = res.values
    out["histo"] = launches
    wl["dense"]["histo"] = (res, chunked)
    compare_loops("histo", chunked,
                  per_step_run(dev, "histo", res, fn, args, kw))
    eng, state, _ = apps.engine_and_state(
        "histo", None, grid, proxy, histo_values=wl["histo"],
        bins=wl["bins"], oq_cap=OQ_CAP, device=dev)
    profile_supersteps(dev, eng, state, "histo")
    del eng, state
    print(f"  Histogram phase {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------- 6b. compaction
COMPACTION = 3     # capacity_ladder(4096, 3): windows of 4096, 1024, 256, 64


class CompactionRows:
    """While entered, keeps the ``active_tiles`` and ``bucket_cap`` stats
    of every superstep the chunked loop accounts (the rows its one fetch a
    chunk brought; nothing more is fetched)."""

    def __enter__(self):
        from repro_torch.core import engine
        self.active, self.rungs = [], []
        self._report = report = engine._ProgressReporter.report

        def tapped(rep, steps, stacked, n_act):
            if n_act and "active_tiles" in stacked:
                self.active.append(np.array(stacked["active_tiles"][:n_act]))
                self.rungs.append(np.array(stacked["bucket_cap"][:n_act]))
            return report(rep, steps, stacked, n_act)
        engine._ProgressReporter.report = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine
        engine._ProgressReporter.report = self._report

    def per_step(self):
        return np.concatenate(self.active), np.concatenate(self.rungs)


def counter_values(prefix: str) -> dict:
    """The registry's counters whose names start with ``prefix``."""
    from repro_torch.obs.metrics import default_registry
    return {k: v for k, v in default_registry().snapshot()["counters"]
            .items() if k.startswith(prefix)}


def counter_deltas(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def compacted_run(dev, label, fn, args, kw, dense, tol=(None, None)):
    """One compacted app call on the chunked loop, equal to the dense
    chunked ``dense = (result, readings)``, with what compaction did:
    the active-tile share, supersteps per reference rung and per window
    run, overflows, host syncs, ms a superstep and peak memory beside the
    dense run's, and the graphs captured.  Returns (result, launches,
    readings)."""
    before = counter_values("engine.")
    with CompactionRows() as rows:
        res, launches, readings = app_run(dev, f"{label} compacted", fn,
                                          *args, compaction=COMPACTION, **kw)
    moved = counter_deltas(before, counter_values("engine."))
    require_launches(f"{label} compacted", launches, readings, ENGINE_KERNELS)
    dres, dread = dense
    same_run(dres, res, f"{label} compacted vs dense chunked", *tol)
    active, rungs = rows.per_step()
    T = TILES
    require(len(active) == res.run.supersteps,
            f"{label}: {len(active)} rows for {res.run.supersteps} supersteps")
    share = active / T
    by_rung = {int(c): int(np.sum(rungs == c))
               for c in sorted(set(rungs.tolist()), reverse=True)}
    by_window = {int(k.rsplit(".", 1)[1]): int(v) for k, v in moved.items()
                 if k.startswith("engine.window_occupancy.")}
    for cap, n in by_rung.items():
        require(moved.get(f"engine.bucket_occupancy.{cap}") == n,
                f"{label}: engine.bucket_occupancy.{cap} is not the rows' "
                f"count {n}")
    require(sum(by_window.values()) == res.run.supersteps,
            f"{label}: window occupancy {by_window} does not sum to the "
            f"supersteps")
    overflows = int(moved.get("engine.window_overflows", 0))
    captures = int(moved.get("engine.graph_captures", 0))
    capture_s = moved.get("engine.graph_capture_seconds", 0.0)
    readings.update(
        active_share_mean=float(share.mean()),
        active_share_median=float(np.median(share)),
        active_share_p90=float(np.percentile(share, 90)),
        supersteps_by_rung=by_rung, supersteps_by_window=by_window,
        overflows=overflows, graphs_captured=captures,
        graph_capture_s=capture_s,
        dense_ms_per_superstep=dread["ms_per_superstep"],
        dense_host_syncs=dread["host_syncs"], dense_peak_gib=dread["peak_gib"],
        rungs=rungs)
    print(f"    {label} active tiles per superstep: mean "
          f"{share.mean():.1%}, median {np.median(share):.1%}, p90 "
          f"{np.percentile(share, 90):.1%} of {T}")
    print(f"    {label} supersteps by reference rung {json.dumps(by_rung)}; "
          f"by window run {json.dumps(by_window)}; overflows {overflows}; "
          f"graphs captured {captures} ({capture_s:.3f} s of host time "
          f"capturing)")
    print(f"    {label} compacted vs dense chunked (this call): ms per "
          f"superstep {readings['ms_per_superstep']:.3f} vs "
          f"{dread['ms_per_superstep']:.3f} "
          f"({dread['ms_per_superstep'] / readings['ms_per_superstep']:.2f}x)"
          f"; host syncs {readings['host_syncs']:.0f} vs "
          f"{dread['host_syncs']:.0f}; peak GiB {readings['peak_gib']:.3f} "
          f"vs {dread['peak_gib']:.3f}")
    return res, launches, readings


def full_length_share(prof, full_n: int):
    """(device us of ops with an operand of at least ``full_n`` elements,
    device us of all ops) in a profile taken with ``record_shapes``: each
    host op's own device time (the kernels it launched), so each kernel
    counts once."""
    from torch.autograd import DeviceType
    full = total = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type != DeviceType.CPU or dev_us <= 0:
            continue
        total += dev_us
        if any(math.prod(sh) >= full_n for sh in e.input_shapes
               if isinstance(sh, (list, tuple)) and sh
               and all(isinstance(d, int) for d in sh)):
            full += dev_us
    return full, total


def replay_ms(eng, state, window, n: int):
    """Host ms a superstep of ``n`` graph replays in ``window`` (None:
    dense), unprofiled, from the state ``n`` supersteps after ``state``
    (a first chunk runs the eager superstep, the capture and replays).
    Returns (ms, active rows, the runner)."""
    runner = eng.chunk_runner(state, n)
    runner.launch(10 * n, False, window)
    runner.fetch()
    t0 = time.perf_counter()
    runner.launch(10 * n, False, window)
    got = runner.fetch()
    return ((time.perf_counter() - t0) / n * 1e3,
            int(got.rows[:, -1].sum()), runner)


def profile_window(eng, state, window, label: str, n: int = 20) -> dict:
    """Where a compacted superstep's time goes at ``window`` tiles, from
    ``state``: below the dense window, ``n`` replays in the window
    against ``n`` dense replays from the same state, unprofiled and in
    turns (window, dense, dense, window); ``n`` graph replays in the
    window under the profiler; then ``n`` eager windowed supersteps with
    their operands' shapes, which split the device time into ops with a
    full-length (T*C) operand and the rest."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import fetch_stats
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = dict(window=window)
    if window is not None:
        ms, rows = {window: [], None: []}, {}
        for w in (window, None, None, window):
            t, rows[w], runner = replay_ms(eng, state, w, n)
            ms[w].append(t)
            del runner
        out.update(window_ms=float(np.mean(ms[window])),
                   dense_ms=float(np.mean(ms[None])))
        print(f"  {label}, same state, {n} replays unprofiled, in turns: "
              f"window {window} {ms[window][0]:.3f} / {ms[window][1]:.3f} "
              f"ms a replay ({rows[window]} rows active), dense "
              f"{ms[None][0]:.3f} / {ms[None][1]:.3f} ({rows[None]} active; "
              f"{out['dense_ms'] / out['window_ms']:.2f}x)")
    runner = eng.chunk_runner(state, n)
    runner.launch(10 * n, False, window)
    runner.fetch()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        runner.launch(10 * n, False, window)
        got = runner.fetch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    active_rows = int(got.rows[:, -1].sum())
    print(f"  profile {label}: window {window}, {active_rows} of {n} rows "
          f"active, overflow {got.overflow}")
    _profile_report(prof, wall, n, f"{label}, {n} graph replays at window "
                    f"{window}")
    del runner
    # as a graph replay does: the window's rows written in place
    st = {k: v.clone() for k, v in state.items()}
    commit = torch.ones((), dtype=torch.bool, device=eng.device)
    with profile(activities=activities, record_shapes=True) as prof:
        for _ in range(n):
            st, stats = eng._superstep(st, False, window, commit)
            fetch_stats(stats, eng.stat_keys)
        torch.cuda.synchronize()
    full_n = eng.T * min(eng.Cd, eng.Cs)
    full, total = full_length_share(prof, full_n)
    print(f"  {label}, {n} eager supersteps at window {window}: device "
          f"{total / n / 1e3:.3f} ms a superstep, of it {full / n / 1e3:.3f} "
          f"ms ({full / max(total, 1e-9):.1%}) in ops with an operand of "
          f">= {full_n} elements (T*C, full length)")
    return dict(out, active_rows=active_rows, eager_busy_ms=total / n / 1e3,
                full_length_ms=full / n / 1e3)


def commonest_rung(label: str, rungs, below=None):
    """The rung of the per-superstep reference rungs ``rungs`` (those
    below ``below``, when given) that holds most supersteps, and the
    first superstep and length of the longest stretch of supersteps at
    it (printed)."""
    caps, counts = np.unique(rungs if below is None
                             else rungs[rungs < below], return_counts=True)
    cap = int(caps[np.argmax(counts)])
    at = np.flatnonzero(rungs == cap)
    breaks = np.flatnonzero(np.diff(at) > 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [len(at) - 1]])
    i = int(np.argmax(ends - starts))
    start, length = int(at[starts[i]]), int(ends[i] - starts[i] + 1)
    print(f"  {label} spends most supersteps ({int(counts.max())}) at rung "
          f"{cap}; longest stretch there: {length} supersteps from "
          f"superstep {start}")
    return cap, start, length


def profile_rung(dev, wl, label: str, rungs) -> dict:
    """``profile_window`` at the rung ``label`` spends most supersteps in
    (per-superstep reference rungs ``rungs``), from the state at the
    start of the longest stretch of supersteps at that rung."""
    from repro_torch.graph import apps
    cap, start, length = commonest_rung(label, rungs)
    g, grid = wl[SCALE], wl["grid"]
    kw = main_path_apps(wl)[label][2]
    eng, state, _ = apps.engine_and_state(
        label, g, grid, kw["proxy"], root=int(np.argmax(g.out_degree())),
        x=wl["x"], histo_values=wl["histo"], bins=wl["bins"], oq_cap=OQ_CAP,
        device=dev, compaction=COMPACTION)
    if start:
        state, _ = eng.run(state, max_supersteps=start)
    return dict(profile_window(eng, state, None if cap == TILES else cap,
                               f"{label} compacted"),
                rung=cap, stretch=length, start=start)


def compaction_phase(dev, wl) -> dict:
    from repro_torch.core.engine import capacity_ladder
    print(f"== 6b. active-set compaction={COMPACTION} (windows "
          f"{capacity_ladder(TILES, COMPACTION)}), chunked: BFS, SpMV and "
          f"Histogram at RMAT-{SCALE} on {TILES} tiles, each against its "
          f"dense chunked run of phases 5 and 6")
    g = wl[SCALE]
    calls = main_path_apps(wl)
    launches, out = {}, {}
    for label, tol in (("bfs", (None, None)),
                       ("spmv", (AGREE_RTOL, AGREE_ATOL)),
                       ("histo", (None, None))):
        t0 = time.perf_counter()
        fn, args, kw = calls[label]
        res, n, readings = compacted_run(dev, label, fn, args, kw,
                                         wl["dense"][label], tol)
        wl.setdefault("compacted", {})[label] = (res, dict(readings))
        if label == "bfs":
            check_bfs(g, args[1], res)
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        out[label] = readings
        print(f"  {label} compacted {time.perf_counter() - t0:.1f} s")
    # a profiler window at the rung each app spends most supersteps in
    # (BFS's first), from a state inside the longest stretch there
    t0 = time.perf_counter()
    for label in ("bfs", "spmv", "histo"):
        out[label]["profile"] = profile_rung(dev, wl, label,
                                             out[label].pop("rungs"))
    print(f"  compaction profiles {time.perf_counter() - t0:.1f} s")
    print(f"  compaction readings {json.dumps(out)}")
    return launches


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
    launches = ops.launch_counts()
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
    from repro_torch.core.engine import EngineConfig
    from repro_torch.graph import apps, oracles
    from repro_torch.graph.rmat import histogram_input
    print(f"== 9. backend agreement (kernels vs torch) at RMAT-{AGREE_SCALE} "
          f"on {TILES} tiles, chunked; all four also against the per-step "
          f"loop; BFS and PageRank with compaction={COMPACTION} on both "
          f"loops")
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
        got = [app_run(dev, name, fn, *args, oq_cap=OQ_CAP, backend=b, **kw)
               for b in ("kernels", "torch")]
        runs = [r[0] for r in got]
        same_run(runs[0], runs[1], f"{name} kernels vs torch",
                 *(tol or (None, None)))
        wl.setdefault("agree", {})[name] = (runs[0], fn, args, kw, tol)
        if name in ("bfs", "spmv"):
            # the per-step loop against the chunked run, with the
            # EngineIds tap (cut from phases 5 and 6's RMAT-22 to
            # RMAT-18 by the time limit)
            compare_loops(name, got[0][2], per_step_run(
                dev, name, runs[0], fn, args,
                dict(kw, oq_cap=OQ_CAP, backend="kernels"),
                *(tol or (None, None))))
        if name in ("histo", "pagerank"):
            per_step = app_run(dev, name, fn, *args, oq_cap=OQ_CAP,
                               run_chunk=0, **kw)[0]
            same_run(runs[0], per_step, f"{name} chunked vs per-step loop",
                     *(tol or (None, None)))
        if name in ("bfs", "pagerank"):
            # the per-step loop's window chosen every superstep, and the
            # chunked loop's overflows, against the dense chunked run
            # the chunked loop's also with the torch backend: the
            # kernels at the windows' shapes against torch's ops there
            for chunk, backend in ((0, "kernels"),
                                   (EngineConfig.run_chunk, "kernels"),
                                   (EngineConfig.run_chunk, "torch")):
                before = counter_values("engine.window_overflows")
                comp = app_run(dev, f"{name} compacted", fn, *args,
                               oq_cap=OQ_CAP, run_chunk=chunk,
                               compaction=COMPACTION, backend=backend,
                               **kw)[0]
                moved = counter_deltas(
                    before, counter_values("engine.window_overflows"))
                same_run(runs[0], comp, f"{name} compacted (run_chunk "
                         f"{chunk}, {backend}) vs dense chunked",
                         *(tol or (None, None)))
                if backend == "torch":
                    same_run(comp_kernels, comp, f"{name} compacted "
                             f"kernels vs torch", *(tol or (None, None)))
                comp_kernels = comp
                print(f"    {name} compacted, run_chunk {chunk}, {backend}: "
                      f"overflows "
                      f"{moved.get('engine.window_overflows', 0):.0f}")
        if name == "pagerank":
            check_close("PageRank vs its oracle", runs[0].values,
                        oracles.pagerank_oracle(g, epochs=PAGERANK_EPOCHS)
                        .astype(np.float64), PR_RTOL, PR_ATOL)
        print(f"  {name} agreement {time.perf_counter() - t0:.1f} s")


# ------------------------------------------ 9b. observability, sanitizer
def track_counts(trace: dict) -> dict:
    """Event counts of a Chrome trace by track: ``process / thread`` from
    its metadata events, for every span ("X") and counter ("C")
    event."""
    procs, threads, counts = {}, {}, {}
    for e in trace["traceEvents"]:
        if e["ph"] == "M" and e["name"] == "process_name":
            procs[e["pid"]] = e["args"]["name"]
        elif e["ph"] == "M":
            threads[e["pid"], e["tid"]] = e["args"]["name"]
    for e in trace["traceEvents"]:
        if e["ph"] in ("X", "C"):
            track = procs.get(e["pid"], str(e["pid"]))
            if (e["pid"], e["tid"]) in threads:
                track += " / " + threads[e["pid"], e["tid"]]
            key = f"{track} [{e['ph']}]"
            counts[key] = counts.get(key, 0) + 1
    return counts


def hooks_phase(dev, wl, smi: str) -> dict:
    """BFS at RMAT-22, dense and compacted, with telemetry, the sanitizer
    and a ``TimelineRecorder``, equal to phases 5 and 6b and timed beside
    a run without them (in turns); the RMAT-18 apps with every hook
    against phase 9's runs, the per-step loop's spans, a Perfetto trace
    written and parsed back, and a planted NaN raising on both loops.
    Returns the RMAT-22 runs' launches."""
    import tempfile
    from repro_torch import obs
    from repro_torch.analysis.invariants import SanitizerError
    from repro_torch.core.engine import EngineConfig
    from repro_torch.graph import apps
    print(f"== 9b. observability and the sanitizer (telemetry=True, "
          f"sanitize=True, observer=TimelineRecorder()), backend=kernels: "
          f"BFS RMAT-{SCALE} on {TILES} tiles, chunked, dense and "
          f"compaction={COMPACTION}, each equal to phase 5 or 6b and timed "
          f"beside a run without the hooks; RMAT-{AGREE_SCALE} apps "
          f"against phase 9")
    print(f"  card: {smi}")
    hooks = dict(telemetry=True, sanitize=True)
    fn, args, kw = main_path_apps(wl)["bfs"]
    launches, out = {}, {}
    for comp, (want, want_read) in ((0, wl["dense"]["bfs"]),
                                    (COMPACTION, wl["compacted"]["bfs"])):
        t0 = time.perf_counter()
        label = "bfs" if comp == 0 else "bfs compacted"
        rec = obs.TimelineRecorder()
        on, n, on_read = app_run(dev, f"{label} hooks", fn, *args,
                                 compaction=comp, observer=rec, **hooks,
                                 **kw)
        require_launches(f"{label} hooks", n, on_read, ENGINE_KERNELS)
        same_run(want, on, f"{label} hooks vs phase "
                 f"{'5' if comp == 0 else '6b'}")
        require(on_read["host_syncs"] == want_read["host_syncs"],
                f"{label}: {on_read['host_syncs']} host syncs with the "
                f"hooks, {want_read['host_syncs']} without")
        require(rec.supersteps == on.run.supersteps
                and not rec.stat_matrix("sanity_violations").any(),
                f"{label}: the recorder missed supersteps or saw "
                f"violations")
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        off, _, off_read = app_run(dev, f"{label} bare", fn, *args,
                                   compaction=comp, **kw)
        same_run(want, off, f"{label} bare vs phase "
                 f"{'5' if comp == 0 else '6b'}")
        rep = obs.imbalance_report(rec)
        load = rec.vec_matrix("tv_delivered")
        require(load.sum() == on.run.counters.owner_msgs,
                f"{label}: tv_delivered does not sum to owner_msgs")
        out[label] = dict(
            ms_hooks=on_read["ms_per_superstep"],
            ms_bare=off_read["ms_per_superstep"],
            ms_bare_earlier=want_read["ms_per_superstep"],
            peak_gib_hooks=on_read["peak_gib"],
            peak_gib_bare=off_read["peak_gib"],
            host_syncs=on_read["host_syncs"], spans=len(rec.spans),
            recorder_mib=sum(v.nbytes for s in rec.spans
                             for v in s.vecs.values()) / 2**20,
            total_gini=rep["total_gini"],
            total_max_over_mean=rep["total_max_over_mean"],
            mean_step_gini=rep["mean_step_gini"],
            mean_step_max_over_mean=rep["mean_step_max_over_mean"])
        print(f"    {label}: ms per superstep with the hooks "
              f"{on_read['ms_per_superstep']:.3f} vs without "
              f"{off_read['ms_per_superstep']:.3f} (phase "
              f"{'5' if comp == 0 else '6b'}: "
              f"{want_read['ms_per_superstep']:.3f}), in turns in this "
              f"call on {smi}; peak GiB {on_read['peak_gib']:.3f} vs "
              f"{off_read['peak_gib']:.3f}; {len(rec.spans)} spans, "
              f"{out[label]['recorder_mib']:.1f} MiB of load vectors")
        print(f"    {label} tv_delivered imbalance: total gini "
              f"{rep['total_gini']:.4f}, total max/mean "
              f"{rep['total_max_over_mean']:.3f}; per superstep mean gini "
              f"{rep['mean_step_gini']:.4f}, mean max/mean "
              f"{rep['mean_step_max_over_mean']:.3f}")
        del rec, load, on, off
        print(f"  {label} hooks {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for name in ("spmv", "histo", "pagerank"):
        want, afn, aargs, akw, tol = wl["agree"][name]
        rec = obs.TimelineRecorder()
        got = app_run(dev, f"{name} hooks", afn, *aargs, oq_cap=OQ_CAP,
                      observer=rec, **hooks, **akw)[0]
        same_run(want, got, f"{name} hooks vs phase 9",
                 *(tol or (None, None)))
        require(sum(s.n_steps for s in rec.spans) == got.run.supersteps,
                f"{name}: spans do not cover the supersteps")
    want, afn, aargs, akw, _ = wl["agree"]["bfs"]
    rec = obs.TimelineRecorder()
    got = app_run(dev, "bfs hooks per-step", afn, *aargs, oq_cap=OQ_CAP,
                  run_chunk=0, observer=rec, **hooks, **akw)[0]
    same_run(want, got, "bfs hooks per-step vs phase 9 chunked")
    require(len(rec.spans) == got.run.supersteps
            and all(s.n_steps == 1 for s in rec.spans),
            "bfs per-step: not one span per superstep")
    print(f"    bfs per-step: {len(rec.spans)} spans for "
          f"{got.run.supersteps} supersteps")
    rec = obs.TimelineRecorder()
    got = app_run(dev, "bfs hooks", afn, *aargs, oq_cap=OQ_CAP,
                  observer=rec, **hooks, **akw)[0]
    same_run(want, got, "bfs hooks vs phase 9")
    with tempfile.TemporaryDirectory() as tmp:
        path = obs.write_trace(rec, str(Path(tmp) / "bfs.json"))
        size = Path(path).stat().st_size
        trace = json.loads(Path(path).read_text())
    counts = track_counts(trace)
    require(any("sim load" in k for k in counts),
            "the trace holds no load track")
    print(f"    bfs RMAT-{AGREE_SCALE} Perfetto trace: {size / 2**20:.1f} "
          f"MiB, {len(trace['traceEvents'])} events, parsed back; by "
          f"track {json.dumps(counts)}")
    for chunk in (0, EngineConfig.run_chunk):
        eng, state, _ = apps.engine_and_state(
            "bfs", aargs[0], aargs[2], akw["proxy"], root=aargs[1],
            oq_cap=OQ_CAP, device=dev, sanitize=True)
        state["values"][1] = float("nan")
        try:
            eng.run(state, chunk=chunk)
        except SanitizerError as e:
            print(f"    planted NaN, run_chunk {chunk}: SanitizerError "
                  f"({str(e).splitlines()[0]})")
        else:
            raise SmokeFailure(f"planted NaN, run_chunk {chunk}: no "
                               f"SanitizerError")
        del eng, state
    print(f"  RMAT-{AGREE_SCALE} hooks {time.perf_counter() - t0:.1f} s")
    print(f"  hooks readings {json.dumps(out)}")
    return launches


# --------------------------------------------- 10. the partitioned engine
PART_CHIPS = 4                  # 2x2 chips of 32x32 tiles on the package
NODE_CHIPS = (1, 4, 16)         # 16: 4x4 chips of 16x16 tiles
NODE_GROWTH = 1.1               # 16-chip entries over 4-chip, at most
EQUIV_FIELDS = ("compute_ops", "intra_bits", "die_bits", "pkg_bits",
                "touched_bits", "pending")


def trace_fields_equal(a, b) -> dict:
    """Which of a proxy-free run's shared level-traffic vectors (those
    that partitioning leaves alone) two runs have equal."""
    ta, tb = a.run.trace.to_dict(), b.run.trace.to_dict()
    return {f: ta[f] == tb[f] for f in EQUIV_FIELDS}


def side_by_side(label, mono, mono_read, dist, dist_read) -> None:
    """A partitioned run's readings beside its monolithic run's."""
    def row(res, r):
        c = res.run.counters
        return (f"{res.run.supersteps} supersteps, {r['host_syncs']:.0f} "
                f"host syncs, {r['ms_per_superstep']:.3f} ms a superstep, "
                f"wall {r['wall_s']:.2f} s, peak {r['peak_gib']:.3f} GiB, "
                f"off-chip msgs {c.off_chip_msgs:.0f} (hop-msgs "
                f"{c.off_chip_hop_msgs:.0f}), time_s {res.run.time_s:.6e}, "
                f"{res.gteps:.3f} GTEPS")
    print(f"    {label} monolithic:  {row(mono, mono_read)}")
    print(f"    {label} {PART_CHIPS} chips: {row(dist, dist_read)}")
    print(f"    {label} trace fields equal to the monolithic run's "
          f"(printed, not gated): "
          f"{json.dumps(trace_fields_equal(mono, dist))}")


def partition_phase(dev, wl) -> dict:
    """The distributed engine in one process (every chip's tiles in one
    batched superstep, the board exchange): BFS at RMAT-22 on 4 chips
    beside phase 5; the RMAT-18 apps proxy-free against their monolithic
    runs and across backends and loops; SpMV with a cascade cut at the
    chip boundary and Histogram with the write-back P$; graph nodes
    against the chip count; the weak-scaling sweep.  Returns the
    RMAT-22 run's launches."""
    from repro_torch.distrib import harness
    from repro_torch.graph import apps
    from repro_torch.graph.rmat import histogram_input
    t_phase = time.perf_counter()
    print(f"== 10. the partitioned engine, one process: {PART_CHIPS} chips "
          f"of the {TILES}-tile package, every chip's tiles in one batched "
          f"superstep, backend=kernels")
    fn, args, kw = main_path_apps(wl)["bfs"]
    g, root = args[0], args[1]
    t0 = time.perf_counter()
    res, launches, read = app_run(dev, f"bfs {PART_CHIPS} chips", fn, *args,
                                  chips=PART_CHIPS, **kw)
    check_bfs(g, root, res)
    require(res.run.counters.off_chip_msgs > 0,
            "bfs 4 chips: no record left its chip")
    require_launches(f"bfs {PART_CHIPS} chips", launches, read,
                     ENGINE_KERNELS)
    side_by_side(f"bfs RMAT-{SCALE}", *wl["dense"]["bfs"], res, read)
    wl["partition"] = dict(bfs=(res, read))
    print(f"  RMAT-{SCALE} BFS on {PART_CHIPS} chips "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    g18 = wl[AGREE_SCALE]
    grid = wl["grid"]
    bins = g18.n_rows // 8
    hv = histogram_input(g18, bins)
    x = np.random.default_rng(SEED).random(g18.n_cols).astype(np.float32)
    root18 = int(np.argmax(g18.out_degree()))
    print(f"  RMAT-{AGREE_SCALE}, proxy-free, {PART_CHIPS} chips against "
          f"the monolithic run, kernels against torch")
    cases = (("bfs", apps.bfs, (g18, root18, grid), {}, None),
             ("spmv", apps.spmv, (g18, x, grid), {},
              (AGREE_RTOL, AGREE_ATOL)),
             ("histo", apps.histogram, (hv, bins, grid), {}, None),
             ("pagerank", apps.pagerank, (g18, grid),
              dict(epochs=PAGERANK_EPOCHS), (AGREE_RTOL, AGREE_ATOL)))
    for name, fn, args, kw, tol in cases:
        tol = tol or (None, None)
        mono = app_run(dev, f"{name} monolithic", fn, *args, oq_cap=OQ_CAP,
                       **kw)[0]
        dist = app_run(dev, f"{name} {PART_CHIPS} chips", fn, *args,
                       oq_cap=OQ_CAP, chips=PART_CHIPS, **kw)[0]
        equal = trace_fields_equal(mono, dist)
        require(all(equal.values()),
                f"{name}: trace fields differ from the monolithic run's: "
                f"{equal}")
        require(dist.run.counters.off_chip_msgs > 0,
                f"{name} {PART_CHIPS} chips: no record left its chip")
        if tol[0] is None:
            require(np.array_equal(mono.values, dist.values),
                    f"{name}: values differ from the monolithic run's")
        else:
            check_close(f"{name} {PART_CHIPS} chips vs monolithic",
                        dist.values, mono.values.astype(np.float64), *tol)
        print(f"    {name}: the six shared trace fields equal the "
              f"monolithic run's; off-chip msgs "
              f"{dist.run.counters.off_chip_msgs:.0f}")
        ref = app_run(dev, f"{name} {PART_CHIPS} chips", fn, *args,
                      oq_cap=OQ_CAP, chips=PART_CHIPS, backend="torch",
                      **kw)[0]
        same_run(dist, ref, f"{name} {PART_CHIPS} chips kernels vs torch",
                 *tol)
        if name == "bfs":
            per_step = app_run(dev, f"{name} {PART_CHIPS} chips", fn, *args,
                               oq_cap=OQ_CAP, chips=PART_CHIPS, run_chunk=0,
                               **kw)[0]
            same_run(dist, per_step, f"{name} {PART_CHIPS} chips chunked vs "
                     f"per-step loop")
    spmv_px = apps.table2_proxy(grid, "spmv", cascade_levels=2)
    dist = app_run(dev, f"spmv {PART_CHIPS} chips, cascade", apps.spmv, g18,
                   x, grid, proxy=spmv_px, oq_cap=OQ_CAP,
                   chips=PART_CHIPS)[0]
    check_spmv(g18, x, dist.values, f"SpMV {PART_CHIPS} chips y")
    wl["partition"]["spmv"] = dist
    from repro_torch.core.proxy import chip_local_proxy
    from repro_torch.core.tilegrid import partition_grid
    part = partition_grid(grid, PART_CHIPS)
    cut = chip_local_proxy(spmv_px, part.sub_ny, part.sub_nx)
    print(f"    SpMV cascade levels {spmv_px.cascade.levels} on the package, "
          f"{cut.cascade.levels if cut.cascade else 0} on a "
          f"{part.sub_ny}x{part.sub_nx} chip; merged "
          f"{dist.run.counters.cascade_combined:.0f} records")
    dist = app_run(dev, f"histo {PART_CHIPS} chips, write-back",
                   apps.histogram, hv, bins, grid,
                   proxy=apps.table2_proxy(grid, "histo"), oq_cap=OQ_CAP,
                   chips=PART_CHIPS)[0]
    check_histo(hv, bins, dist.values, f"Histogram {PART_CHIPS} chips")
    print(f"  RMAT-{AGREE_SCALE} runs {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    nodes = {}
    for chips in NODE_CHIPS:
        eng, state, _ = apps.engine_and_state(
            "bfs", g18, grid, apps.table2_proxy(grid, "bfs"), root=root18,
            oq_cap=OQ_CAP, chips=chips, device=dev)
        nodes[chips] = profile_replays(eng, state, f"bfs RMAT-{AGREE_SCALE} "
                                       f"{chips} chip(s)")
        del eng, state
    print(f"  graph replays by chip count "
          f"{json.dumps({c: r for c, r in nodes.items()})}")
    wl["partition"]["nodes"] = nodes
    require(nodes[16]["entries"] <= NODE_GROWTH * nodes[4]["entries"],
            f"16 chips: {nodes[16]['entries']:.0f} device entries a "
            f"superstep against {nodes[4]['entries']:.0f} at 4 chips")
    print(f"  node readings {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = []
    for chips in harness.WEAK_CHIP_COUNTS:
        t1 = time.perf_counter()
        row = harness.weak_scaling((chips,), backend="kernels",
                                   device=dev)[0]
        row["wall_s"] = time.perf_counter() - t1
        rows.append(row)
        print(f"    weak scaling {chips} chip(s): {row['tiles']} tiles, "
              f"RMAT over {row['n_vertices']} vertices, "
              f"{row['supersteps']} supersteps, {row['gteps']:.4f} GTEPS, "
              f"off-chip msgs {row['off_chip_msgs']:.0f}, energy "
              f"{row['energy_j']:.4e} J, reprice ratio "
              f"{row['reprice_ratio']!r}, wall {row['wall_s']:.2f} s")
    curve = [r["gteps"] for r in rows]
    require(all(b > a for a, b in zip(curve, curve[1:])),
            f"weak scaling: GTEPS not monotone {curve}")
    require(all(abs(r["reprice_ratio"] - 1.0) < 1e-9 for r in rows),
            "weak scaling: a re-priced trace differs from its run")
    wl["partition"]["weak"] = rows
    print(f"  weak scaling {time.perf_counter() - t0:.1f} s")
    print(f"  partition phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------- 10b. the partition's overlap and windows
OVERLAP_RUNS = (("compaction=3", dict(compaction=COMPACTION)),
                ("double_buffer", dict(double_buffer=True)),
                ("both", dict(compaction=COMPACTION, double_buffer=True)))
OVERLAP_AGREE_COMPACTION = 2    # capacity_ladder(1024, 2): 1024, 256, 64
REPRICE_TOL = 1e-12


def reprice_ratio(g, grid, res) -> float:
    """The run's trace re-priced under its own package over its
    ``time_s`` (``distrib.harness``'s check)."""
    from repro_torch.core.costmodel import DCRA_SRAM, price
    rep = price(DCRA_SRAM, grid, res.run.counters,
                mem_bits_sram=float(g.footprint_bytes() * 8),
                per_superstep_peak=res.run.trace)
    return rep.time_s / res.run.time_s


def overlap_gates(label, g, grid, sync, res, extra) -> float:
    """A run of phase 10b against the synchronous dense run ``sync``:
    the same physics; ``time_s`` equal without ``double_buffer``,
    strictly below with it where records left their chips (and its
    trace re-prices to its ``time_s``).  Returns the re-price ratio."""
    same_physics(sync, res, f"{label} vs synchronous dense")
    ratio = reprice_ratio(g, grid, res)
    require(abs(ratio - 1.0) < REPRICE_TOL,
            f"{label}: reprice ratio {ratio!r}")
    if not extra.get("double_buffer"):
        require(res.run.time_s == sync.run.time_s,
                f"{label}: time_s {res.run.time_s!r} against the "
                f"synchronous {sync.run.time_s!r}")
    elif sync.run.counters.off_chip_msgs > 0:
        require(res.run.time_s < sync.run.time_s,
                f"{label}: time_s {res.run.time_s!r} not below the "
                f"synchronous {sync.run.time_s!r}")
    print(f"    {label}: values, counters, trace (less double_buffer), "
          f"supersteps equal to the synchronous dense run; time_s "
          f"{res.run.time_s:.6e} against {sync.run.time_s:.6e} "
          f"({res.run.time_s / sync.run.time_s:.4f}x), reprice ratio "
          f"{ratio!r}")
    return ratio


def advance(eng, state, steps: int):
    """The flat state ``steps`` dense supersteps after ``state``, from
    one chunk of ``eng``'s runner (``DistributedEngine.chunk_runner``
    takes it back)."""
    if not steps:
        return state
    runner = eng.chunk_runner(state, steps)
    runner.launch(steps, False)
    got = runner.fetch()
    require(int(got.rows[:, -1].sum()) == steps,
            f"advance: {got.rows[:, -1].sum():.0f} of {steps} supersteps")
    return runner.state


def overlap_phase(dev, wl) -> dict:
    """ROADMAP A.5b on the card: BFS at RMAT-22 on 4 chips compacted,
    double-buffered and both, beside phase 10's synchronous dense run;
    BFS and SpMV at RMAT-18 with both on, across backends and loops;
    graph replays synchronous, double-buffered and in a compacted
    window; the weak-scaling sweep double-buffered beside phase 10's.
    Returns the RMAT-22 runs' launches, summed."""
    from repro_torch.core.engine import capacity_ladder
    from repro_torch.distrib import harness
    from repro_torch.graph import apps
    t_phase = time.perf_counter()
    tl = TILES // PART_CHIPS
    print(f"== 10b. the partition's overlap and windows: {PART_CHIPS} chips, "
          f"per-chip ladder {capacity_ladder(tl, COMPACTION)}, the "
          f"double-buffered exchange (priced: the card runs both halves in "
          f"order), backend=kernels")
    fn, args, kw = main_path_apps(wl)["bfs"]
    g, root, grid = args
    sync, sync_read = wl["partition"]["bfs"]
    launches, readings = {}, {}
    t0 = time.perf_counter()
    for label, extra in OVERLAP_RUNS:
        name = f"bfs {PART_CHIPS} chips {label}"
        before = counter_values("engine.")
        res, got, read = app_run(dev, name, fn, *args, chips=PART_CHIPS,
                                 **extra, **kw)
        moved = counter_deltas(before, counter_values("engine."))
        require_launches(name, got, read, ENGINE_KERNELS)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        check_bfs(g, root, res)
        overlap_gates(name, g, grid, sync, res, extra)
        overflows = int(moved.get("engine.window_overflows", 0))
        syncs, dense = read["host_syncs"], sync_read["host_syncs"]
        require(dense <= syncs <= dense + overflows,
                f"{name}: {syncs:.0f} host syncs against {dense:.0f} dense "
                f"and {overflows} overflows")
        by_window = {int(k.rsplit(".", 1)[1]): int(v)
                     for k, v in moved.items()
                     if k.startswith("engine.window_occupancy.")}
        wl["partition"][label] = (res, read)
        readings[label] = dict(
            ms_per_superstep=read["ms_per_superstep"], wall_s=read["wall_s"],
            peak_gib=read["peak_gib"], host_syncs=syncs,
            supersteps_by_window=by_window, overflows=overflows,
            time_s=res.run.time_s)
        print(f"    {name}: {read['ms_per_superstep']:.3f} ms a superstep "
              f"(phase 10 synchronous dense "
              f"{sync_read['ms_per_superstep']:.3f}), wall "
              f"{read['wall_s']:.2f} s, peak {read['peak_gib']:.3f} GiB, host "
              f"syncs {syncs:.0f} (dense {dense:.0f}); supersteps by window "
              f"a chip {json.dumps(by_window) if by_window else 'all dense'}"
              f", overflows {overflows}")
    # the synchronous dense run again, so that the three runs above lie
    # between two readings of it in this call
    again, got, read = app_run(dev, f"bfs {PART_CHIPS} chips synchronous "
                               f"dense again", fn, *args, chips=PART_CHIPS,
                               **kw)
    same_run(sync, again, f"bfs {PART_CHIPS} chips synchronous dense again "
             f"vs phase 10")
    readings["synchronous"] = [sync_read["ms_per_superstep"],
                               read["ms_per_superstep"]]
    print(f"    bfs {PART_CHIPS} chips ms a superstep, in this order: "
          f"synchronous {sync_read['ms_per_superstep']:.3f}, "
          + ", ".join(f"{k} {v['ms_per_superstep']:.3f}"
                      for k, v in readings.items() if k != "synchronous")
          + f", synchronous again {read['ms_per_superstep']:.3f}")
    print(f"  RMAT-{SCALE} runs {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    g18 = wl[AGREE_SCALE]
    root18 = int(np.argmax(g18.out_degree()))
    x = np.random.default_rng(SEED).random(g18.n_cols).astype(np.float32)
    both = dict(double_buffer=True, compaction=OVERLAP_AGREE_COMPACTION,
                chips=PART_CHIPS, oq_cap=OQ_CAP)
    print(f"  RMAT-{AGREE_SCALE}, Table-II, {PART_CHIPS} chips, "
          f"double_buffer and compaction={OVERLAP_AGREE_COMPACTION}: both "
          f"backends, both loops")
    bfs_px = apps.table2_proxy(grid, "bfs")
    bfs_sync, _, bfs_read = app_run(
        dev, f"bfs {PART_CHIPS} chips synchronous dense", apps.bfs, g18,
        root18, grid, proxy=bfs_px, oq_cap=OQ_CAP, chips=PART_CHIPS)
    wl["partition"][f"bfs RMAT-{AGREE_SCALE}"] = (bfs_sync, bfs_read)
    cases = (("bfs", apps.bfs, (g18, root18, grid), bfs_px, bfs_sync,
              (None, None)),
             ("spmv", apps.spmv, (g18, x, grid),
              apps.table2_proxy(grid, "spmv", cascade_levels=2),
              wl["partition"]["spmv"], (AGREE_RTOL, AGREE_ATOL)))
    rungs = None
    for name, afn, aargs, px, want, tol in cases:
        label = f"{name} {PART_CHIPS} chips both"
        with CompactionRows() as rows:
            base = app_run(dev, label, afn, *aargs, proxy=px, **both)[0]
        if name == "bfs":
            rungs = rows.per_step()[1]
        wl["partition"][f"{name} RMAT-{AGREE_SCALE} both"] = base
        same_physics(want, base, f"{label} vs synchronous dense", *tol)
        require(base.run.time_s < want.run.time_s,
                f"{label}: time_s not below the synchronous run's")
        ratio = reprice_ratio(aargs[0], grid, base)
        require(abs(ratio - 1.0) < REPRICE_TOL,
                f"{label}: reprice ratio {ratio!r}")
        for backend, chunk in (("torch", 16), ("kernels", 0), ("torch", 0)):
            other = app_run(dev, label, afn, *aargs, proxy=px,
                            backend=backend, run_chunk=chunk, **both)[0]
            same_run(base, other, f"{label} kernels chunked vs {backend} "
                     f"run_chunk={chunk}", *tol)
        if name == "spmv":
            check_spmv(g18, x, base.values, f"SpMV {PART_CHIPS} chips both y")
    print(f"  RMAT-{AGREE_SCALE} runs {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cap, start, _ = commonest_rung(f"bfs RMAT-{AGREE_SCALE} {PART_CHIPS} "
                                   f"chips compacted (rungs a chip)", rungs)
    nodes = {}
    for label, extra, window in (
            ("synchronous", {}, None),
            ("double_buffer", dict(double_buffer=True), None),
            (f"both, window {cap}",
             dict(double_buffer=True, compaction=OVERLAP_AGREE_COMPACTION),
             None if cap == tl else cap)):
        eng, state, _ = apps.engine_and_state(
            "bfs", g18, grid, bfs_px, root=root18, oq_cap=OQ_CAP,
            chips=PART_CHIPS, device=dev, **extra)
        if window is not None:
            state = advance(eng, state, start)
        nodes[label] = profile_replays(
            eng, state, f"bfs RMAT-{AGREE_SCALE} {PART_CHIPS} chips {label}",
            window=window)
        del eng, state
    print(f"  graph replays {json.dumps(nodes)}")
    print(f"  replays {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for row in wl["partition"]["weak"]:
        chips = row["chips"]
        got = harness.weak_scaling((chips,), backend="kernels", device=dev,
                                   double_buffer=True)[0]
        require(got["gteps"] >= row["gteps"],
                f"weak scaling {chips} chip(s): double-buffered GTEPS "
                f"{got['gteps']!r} below the synchronous {row['gteps']!r}")
        require(abs(got["reprice_ratio"] - 1.0) < 1e-9,
                f"weak scaling {chips} chip(s): reprice ratio "
                f"{got['reprice_ratio']!r}")
        print(f"    weak scaling {chips} chip(s) double-buffered: "
              f"{got['gteps']:.4f} GTEPS against {row['gteps']:.4f} "
              f"synchronous ({got['gteps'] / row['gteps']:.4f}x), "
              f"{got['supersteps']} supersteps, reprice ratio "
              f"{got['reprice_ratio']!r}")
    print(f"  weak scaling {time.perf_counter() - t0:.1f} s")
    print(f"  overlap readings {json.dumps(readings)}")
    print(f"  overlap phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------- 11. fault tolerance (A.6)
FAULT_EVERY = 1024              # RMAT-22: checkpoints every 1,024 supersteps
FAULT_AT, FAULT_CHIP = 3000, 2
FAULT_LEAD_18 = 32              # RMAT-18 SpMV: a checkpoint this far
                                # before the first flush superstep


class CheckpointClock:
    """While entered, the host seconds of each checkpoint
    ``DistributedEngine`` writes (``_FaultTolerance.checkpoint``: the
    fold, the copy to the host and the atomic write) and of each restore
    (the read and the copy to the device, ``reshard_checkpoint``), and
    the device memory allocated (GiB) just before and just after each
    restore."""

    def __enter__(self):
        from repro_torch.distrib import driver
        self.writes, self.restores, self.allocated = [], [], []
        self._saved = (driver._FaultTolerance.checkpoint,
                       driver.reshard_checkpoint)
        write, restore = self._saved

        def timed_write(ft, *args, **kw):
            t0 = time.perf_counter()
            write(ft, *args, **kw)
            self.writes.append(time.perf_counter() - t0)

        def timed_restore(*args, **kw):
            before = torch.cuda.memory_allocated() / 2**30
            t0 = time.perf_counter()
            out = restore(*args, **kw)
            torch.cuda.synchronize()
            self.restores.append(time.perf_counter() - t0)
            self.allocated.append(
                [before, torch.cuda.memory_allocated() / 2**30])
            return out
        driver._FaultTolerance.checkpoint = timed_write
        driver.reshard_checkpoint = timed_restore
        return self

    def __exit__(self, *exc):
        from repro_torch.distrib import driver
        (driver._FaultTolerance.checkpoint,
         driver.reshard_checkpoint) = self._saved


def faulted_app(name, g, grid, proxy, *, device, fault_injector, ckpt_dir,
                teps, **kw):
    """An app run as a user asks for fault tolerance: the engine and its
    state from ``apps.engine_and_state``, then ``DistributedEngine.run``
    with the fault injector and the checkpoint directory.  Returns an
    ``AppResult`` with the engine's ``rebalance_plan()`` beside it (None
    without telemetry); the engine itself, which holds the graph on the
    device, is not kept."""
    from repro_torch.graph import apps
    eng, state, _ = apps.engine_and_state(name, g, grid, proxy,
                                          device=device, **kw)
    state, run = eng.run(state, fault_injector=fault_injector,
                         ckpt_dir=ckpt_dir)
    res = apps.AppResult(values=state["values"][:g.n_rows].cpu().numpy(),
                         run=run, teps_edges=teps)
    res.plan = eng.rebalance_plan() if eng.cfg.telemetry else None
    return res


def same_rows(a, b, what: str, rtol=None, atol=None) -> None:
    """A faulted run against the unfailed one: values, counters, the
    trace less its recovery events, supersteps."""
    if rtol is None:
        require(np.array_equal(a.values, b.values), f"{what}: values differ")
    else:
        require(np.allclose(a.values, b.values, rtol=rtol, atol=atol),
                f"{what}: values outside rtol {rtol} / atol {atol}")
    require(a.run.counters.as_dict() == b.run.counters.as_dict(),
            f"{what}: counters differ")
    ta, tb = a.run.trace.to_dict(), b.run.trace.to_dict()
    ta.pop("recovery_events", None), tb.pop("recovery_events", None)
    require(ta == tb, f"{what}: trace rows differ")
    require(a.run.supersteps == b.run.supersteps,
            f"{what}: supersteps differ")


def recovery_gates(label, grid, res, base) -> dict:
    """The faulted run's events (the step-0 checkpoint, one rollback,
    one re-shard onto one device) and its price against ``base``, the
    unfailed run with no checkpoints: ``cycles`` exactly ``base``'s plus
    the recovery overhead re-priced from the events with the cost
    model's own helpers, in their order (the run keeps that overhead
    apart and adds it last); the whole trace re-priced within
    ``REPRICE_TOL`` of ``time_s``, the bound the unfailed runs are held
    to (at these sizes the cost model's vectorized sum over the
    supersteps differs from the run's sequential one in the last bits).
    Returns the rollback event."""
    from repro_torch.core.costmodel import (DCRA_SRAM, checkpoint_leg_cycles,
                                            recovery_waste_cycles,
                                            trace_time_s)
    trace = res.run.trace
    events = trace.recovery_events
    kinds = [ev["kind"] for ev in events]
    require(kinds[:1] == ["checkpoint"] and events[0]["step"] == 0,
            f"{label}: no step-0 checkpoint ({kinds})")
    require(kinds.count("rollback") == 1 and kinds.count("reshard") == 1,
            f"{label}: events {kinds}")
    reshard = next(ev for ev in events if ev["kind"] == "reshard")
    require(reshard["devices"] == 1, f"{label}: re-shard {reshard}")
    overhead = 0.0
    for ev in events:
        if ev["kind"] == "rollback":
            overhead += recovery_waste_cycles(DCRA_SRAM, grid, trace,
                                              ev["from_step"], ev["at_step"])
        else:
            overhead += checkpoint_leg_cycles(DCRA_SRAM, ev["bits"],
                                              trace.board_links)
    require(res.run.cycles == base.run.cycles + overhead,
            f"{label}: cycles {res.run.cycles!r} against the unfailed "
            f"{base.run.cycles!r} plus the re-priced overhead {overhead!r}")
    require(res.run.time_s > base.run.time_s,
            f"{label}: time_s {res.run.time_s!r} not above the unfailed "
            f"{base.run.time_s!r}")
    ratio = trace_time_s(DCRA_SRAM, grid, trace) / res.run.time_s
    base_ratio = trace_time_s(DCRA_SRAM, grid, base.run.trace) / \
        base.run.time_s
    require(abs(ratio - 1.0) < REPRICE_TOL,
            f"{label}: trace re-priced at {ratio!r} of time_s")
    print(f"    {label}: cycles exactly the unfailed run's plus the "
          f"overhead re-priced from {len(events)} events "
          f"({overhead / base.run.cycles:.4f}x the unfailed cycles); trace "
          f"re-priced at {ratio!r} of time_s (unfailed {base_ratio!r})")
    return next(ev for ev in events if ev["kind"] == "rollback")


def fault_phase(dev, wl) -> dict:
    """ROADMAP A.6 on the card: phase 10's RMAT-22 BFS on 4 chips, and
    10b's with both options, each with a checkpoint cadence and chip 2
    lost at superstep 3,000, against their unfailed runs; SpMV with its
    cascade at RMAT-18 (a write-back app: the flush wave replays) on both
    loops with telemetry, its straggler plan after the loss against the
    plan after an unfailed run with the cadence alone.  Returns the
    RMAT-22 runs' launches, summed."""
    import tempfile
    from repro_torch.graph import apps
    from repro_torch.runtime import FaultInjector
    t_phase = time.perf_counter()
    print(f"== 11. fault tolerance: {PART_CHIPS} chips, checkpoints every "
          f"{FAULT_EVERY} supersteps, chip {FAULT_CHIP} lost at superstep "
          f"{FAULT_AT}, backend=kernels")
    fn, args, kw = main_path_apps(wl)["bfs"]
    g, root, grid = args
    reached = np.isfinite(wl["partition"]["bfs"][0].values)
    teps = float(g.out_degree()[reached].sum())
    launches, readings = {}, {}
    t0 = time.perf_counter()
    for label, extra, (base, base_read) in (
            ("dense", {}, wl["partition"]["bfs"]),
            ("both", dict(compaction=COMPACTION, double_buffer=True),
             wl["partition"]["both"])):
        name = f"bfs {PART_CHIPS} chips {label}, chip lost"
        inj = FaultInjector(at_superstep=FAULT_AT, chip=FAULT_CHIP)
        with tempfile.TemporaryDirectory() as ckpt_dir, \
                CheckpointClock() as clock:
            res, got, read = app_run(
                dev, name, faulted_app, "bfs", g, grid, kw["proxy"],
                fault_injector=inj, ckpt_dir=ckpt_dir, teps=teps,
                root=root, oq_cap=OQ_CAP, chips=PART_CHIPS,
                ckpt_every_supersteps=FAULT_EVERY, **extra)
        require(inj.fired, f"{name}: the injector never fired")
        require_launches(name, got, read, ENGINE_KERNELS)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        check_bfs(g, root, res)
        same_rows(res, base, f"{name} vs the unfailed run")
        rollback = recovery_gates(name, grid, res, base)
        replayed = rollback["at_step"] - rollback["from_step"]
        syncs, base_syncs = read["host_syncs"], base_read["host_syncs"]
        if not extra:
            require(syncs == base_syncs + replayed // 16,
                    f"{name}: {syncs:.0f} host syncs against "
                    f"{base_syncs:.0f} unfailed and {replayed} supersteps "
                    f"replayed")
        require(read["graph_captures"] == base_read["graph_captures"],
                f"{name}: {read['graph_captures']:.0f} graphs captured "
                f"against {base_read['graph_captures']:.0f} unfailed")
        bits = next(ev["bits"] for ev in res.run.trace.recovery_events
                    if ev["kind"] == "checkpoint")
        readings[label] = dict(
            image_mb=bits / 8 / 1e6, writes=len(clock.writes),
            write_s=clock.writes, restore_s=clock.restores,
            allocated_at_restore_gib=clock.allocated,
            recovery_wall_s=read["wall_s"] - base_read["wall_s"],
            recovery_loop_s=read["loop_s"] - base_read["loop_s"],
            host_syncs=syncs, unfailed_host_syncs=base_syncs,
            replayed=replayed, rollback=[rollback["from_step"],
                                         rollback["at_step"]],
            graph_captures=read["graph_captures"],
            peak_gib=read["peak_gib"], unfailed_peak_gib=base_read["peak_gib"],
            time_s=res.run.time_s, unfailed_time_s=base.run.time_s)
        print(f"    {name}: values, counters, trace rows, supersteps equal "
              f"to the unfailed run's; image {bits / 8 / 1e6:.1f} MB, "
              f"{len(clock.writes)} writes of "
              f"{', '.join(f'{t:.3f}' for t in clock.writes)} s, restore "
              f"{', '.join(f'{t:.3f}' for t in clock.restores)} s "
              f"(allocated GiB before -> after "
              f"{', '.join(f'{a:.3f} -> {b:.3f}' for a, b in clock.allocated)}"
              f"); "
              f"rollback {rollback['from_step']} <- {rollback['at_step']} "
              f"({replayed} supersteps replayed); recovery wall "
              f"{read['wall_s'] - base_read['wall_s']:.2f} s (loop "
              f"{read['loop_s'] - base_read['loop_s']:.2f} s); host syncs "
              f"{syncs:.0f} against {base_syncs:.0f}; graphs captured "
              f"{read['graph_captures']:.0f} as unfailed; peak "
              f"{read['peak_gib']:.3f} GiB against "
              f"{base_read['peak_gib']:.3f}; time_s {res.run.time_s:.6e} "
              f"against {base.run.time_s:.6e} "
              f"({res.run.time_s / base.run.time_s:.4f}x)")
    print(f"  RMAT-{SCALE} runs {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    g18 = wl[AGREE_SCALE]
    x = np.random.default_rng(SEED).random(g18.n_cols).astype(np.float32)
    want = wl["partition"][f"spmv RMAT-{AGREE_SCALE} both"]
    px = apps.table2_proxy(grid, "spmv", cascade_levels=2)
    tol = (AGREE_RTOL, AGREE_ATOL)
    # the first flush superstep (a trace row): the one after the first
    # that left nothing pending.  A checkpoint lands just before it and
    # the chip is lost just after it, so the flush wave replays
    pending = want.run.trace.pending
    first_flush = next(i for i, p in enumerate(pending) if p == 0) + 1
    every = max(first_flush - FAULT_LEAD_18, 1)
    both = dict(double_buffer=True, compaction=OVERLAP_AGREE_COMPACTION,
                chips=PART_CHIPS, oq_cap=OQ_CAP, telemetry=True,
                ckpt_every_supersteps=every, x=x)
    print(f"  RMAT-{AGREE_SCALE} SpMV + cascade, {PART_CHIPS} chips, "
          f"double_buffer, compaction={OVERLAP_AGREE_COMPACTION}, telemetry, "
          f"checkpoints every {every}: the first flush is superstep "
          f"{first_flush + 1} of {want.run.supersteps}")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        plain = app_run(dev, "spmv, cadence alone", faulted_app, "spmv",
                        g18, grid, px, fault_injector=None,
                        ckpt_dir=ckpt_dir, teps=float(g18.nnz), **both)[0]
    same_rows(plain, want, "spmv, cadence alone vs phase 10b", *tol)
    kinds = {ev["kind"] for ev in plain.run.trace.recovery_events}
    require(kinds == {"checkpoint"}, f"spmv, cadence alone: events {kinds}")
    plan = plain.plan
    for chunk in (16, 0):
        name = f"spmv run_chunk={chunk}, chip lost after the flush"
        inj = FaultInjector(at_superstep=first_flush + 1, chip=FAULT_CHIP)
        with tempfile.TemporaryDirectory() as ckpt_dir:
            res = app_run(dev, name, faulted_app, "spmv", g18, grid, px,
                          fault_injector=inj, ckpt_dir=ckpt_dir,
                          teps=float(g18.nnz), run_chunk=chunk, **both)[0]
        require(inj.fired, f"{name}: the injector never fired")
        same_rows(res, want, f"{name} vs phase 10b", *tol)
        check_spmv(g18, x, res.values, f"{name} y")
        rollback = recovery_gates(name, grid, res, want)
        require(rollback["from_step"] <= first_flush < rollback["at_step"],
                f"{name}: the flush at {first_flush} is not in the replayed "
                f"window {rollback}")
        got = res.plan
        for k, v in plan.items():
            require(np.array_equal(np.asarray(got[k]), np.asarray(v)),
                    f"{name}: rebalance_plan()[{k!r}] differs from the "
                    f"unfailed run's")
        print(f"    {name}: equal to phase 10b's run; rollback "
              f"{rollback['from_step']} <- {rollback['at_step']} with the "
              f"flush wave; rebalance_plan equal to the unfailed run's "
              f"(imbalance {plan['imbalance']:.4f}, predicted after "
              f"{plan['predicted_imbalance']:.4f})")
    print(f"  RMAT-{AGREE_SCALE} runs {time.perf_counter() - t0:.1f} s")
    print(f"  fault readings {json.dumps(readings)}")
    print(f"  fault phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------- 12. ranks
RANKS_TIMEOUT_S = 300           # the group's: a stuck collective raises


class GatherCount:
    """While entered, counts the mesh's all-gathers that the host issues
    (eager ones: a CUDA-graph replay issues its captured collectives
    without a call)."""

    def __enter__(self):
        from repro_torch.distrib import mesh
        self.n = 0
        self._fn = fn = mesh._all_gather_single

        def counted(*args, **kw):
            self.n += 1
            return fn(*args, **kw)
        mesh._all_gather_single = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.distrib import mesh
        mesh._all_gather_single = self._fn


def ranks_phase(dev, wl) -> dict:
    """ROADMAP A.5c on the card: phase 10's RMAT-22 BFS on 4 chips through
    a one-rank NCCL group on the chunked loop, equal to phase 10's
    in-process run, and 10b's RMAT-18 BFS on the per-step loop, equal to
    10b's synchronous run; profiled replays at RMAT-18 beside phase 10's;
    SpMV RMAT-18 with both options equal to phase 10b's run.  Returns the
    two BFS runs' launches, summed."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.graph import apps
    t_phase = time.perf_counter()
    print(f"== 12. ranks: {PART_CHIPS} chips on a one-rank NCCL group "
          f"(backend=shard_map, its collectives run), backend=kernels")
    fn, args, kw = main_path_apps(wl)["bfs"]
    grid = args[2]
    g18 = wl[AGREE_SCALE]
    root18 = int(np.argmax(g18.out_degree()))
    # the per-step loop makes two NCCL calls from the host a superstep
    # (~19 ms a superstep at RMAT-22): it runs at RMAT-18
    runs = ((SCALE, None, args, wl["partition"]["bfs"], "phase 10"),
            (AGREE_SCALE, 0, (g18, root18, grid),
             wl["partition"][f"bfs RMAT-{AGREE_SCALE}"], "phase 10b"))
    launches, readings = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/store", rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
        try:
            on = dict(chips=PART_CHIPS, backend="shard_map",
                      group=dist.group.WORLD)
            t0 = time.perf_counter()
            for scale, chunk, bargs, (want, want_read), was in runs:
                extra = {} if chunk is None else dict(run_chunk=chunk)
                loop = "chunked" if chunk is None else "per-step"
                name = (f"bfs RMAT-{scale} {PART_CHIPS} chips one nccl "
                        f"rank, {loop}")
                with GatherCount() as gathers:
                    res, got, read = app_run(dev, name, fn, *bargs, **on,
                                             **extra, **kw)
                require_launches(name, got, read, ENGINE_KERNELS)
                for k, n in got.items():
                    launches[k] = launches.get(k, 0) + n
                same_run(want, res, f"{name} vs {was}")
                if chunk is None:
                    require(read["host_syncs"] == want_read["host_syncs"],
                            f"{name}: {read['host_syncs']:.0f} host syncs "
                            f"against {was}'s "
                            f"{want_read['host_syncs']:.0f}")
                else:
                    require(gathers.n >= 2 * res.run.supersteps,
                            f"{name}: {gathers.n} all-gathers in "
                            f"{res.run.supersteps} supersteps")
                readings[loop] = dict(
                    ms_per_superstep=read["ms_per_superstep"],
                    peak_gib=read["peak_gib"],
                    host_syncs=read["host_syncs"],
                    graph_captures=read["graph_captures"],
                    eager_all_gathers=gathers.n)
                print(f"    {name}: {read['ms_per_superstep']:.3f} ms a "
                      f"superstep ({was} in-process chunked "
                      f"{want_read['ms_per_superstep']:.3f}), peak "
                      f"{read['peak_gib']:.3f} GiB "
                      f"({want_read['peak_gib']:.3f}), host syncs "
                      f"{read['host_syncs']:.0f} "
                      f"({want_read['host_syncs']:.0f}), graphs captured "
                      f"{read['graph_captures']:.0f} "
                      f"({want_read['graph_captures']:.0f}), all-gathers "
                      f"issued from the host {gathers.n}")
            print(f"  BFS runs {time.perf_counter() - t0:.1f} s")

            t0 = time.perf_counter()
            eng, state, _ = apps.engine_and_state(
                "bfs", g18, grid, apps.table2_proxy(grid, "bfs"),
                root=root18, oq_cap=OQ_CAP, device=dev, **on)
            require(eng.mesh.collective and eng.mesh.ndev == 1,
                    f"the engine's mesh is not the one-rank group: "
                    f"{eng.mesh}")
            # the first chunk steps once eagerly and captures the step:
            # two all-gathers each; the replays issue none from the host,
            # they run the captured ones (on one rank NCCL's all-gather
            # is a device copy, which a replay must run: the gathered
            # buffer is new)
            with GatherCount() as gathers:
                nodes = profile_replays(eng, state, f"bfs RMAT-"
                                        f"{AGREE_SCALE} {PART_CHIPS} chips "
                                        f"one nccl rank")
            del eng, state
            before = wl["partition"]["nodes"][PART_CHIPS]
            require(gathers.n == 4,
                    f"profiled replays: {gathers.n} all-gathers issued from "
                    f"the host, expected 2 eager and 2 captured")
            require(nodes["entries"] > before["entries"],
                    f"profiled replays: {nodes['entries']:.1f} device "
                    f"entries a superstep, no more than phase 10's "
                    f"{before['entries']:.1f}")
            readings["replays"] = dict(nodes, phase10=before)
            print(f"    replays on the rank: {nodes['entries']:.1f} device "
                  f"entries a superstep, busy {nodes['busy_ms']:.3f} ms, "
                  f"wall {nodes['wall_ms']:.3f} ms (the all-gathers "
                  f"captured, none issued by a replay); phase 10 "
                  f"in-process {before['entries']:.1f} entries, busy "
                  f"{before['busy_ms']:.3f} ms, wall "
                  f"{before['wall_ms']:.3f} ms")

            x = np.random.default_rng(SEED).random(g18.n_cols).astype(
                np.float32)
            spmv = app_run(dev, f"spmv {PART_CHIPS} chips both, one nccl "
                           f"rank", apps.spmv, g18, x, grid,
                           proxy=apps.table2_proxy(grid, "spmv",
                                                   cascade_levels=2),
                           oq_cap=OQ_CAP, double_buffer=True,
                           compaction=OVERLAP_AGREE_COMPACTION, **on)[0]
            same_run(wl["partition"][f"spmv RMAT-{AGREE_SCALE} both"], spmv,
                     f"spmv {PART_CHIPS} chips both, one nccl rank vs phase "
                     f"10b", AGREE_RTOL, AGREE_ATOL)
            check_spmv(g18, x, spmv.values, "SpMV one nccl rank y")
            print(f"  RMAT-{AGREE_SCALE} runs {time.perf_counter() - t0:.1f}"
                  f" s")
        finally:
            dist.destroy_process_group()
    print(f"  ranks readings {json.dumps(readings)}")
    print(f"  ranks phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------- 13. product search (A.7)
PRODUCT_BOARD_LINKS = (1, 2, 4)     # on more than one chip; 2 the default
WINNER_OBJECTIVES = ("time", "energy", "cost")


class DatasetTap:
    """While entered, counts the calls of ``graph.rmat.rmat_edges`` (the
    product search's dataset) and answers the call for phase 3's RMAT-22
    graph with that graph (``rmat_edges`` is a function of its
    arguments: the graph the call would make, without its ~35-70 s on
    the host); any other call makes its graph."""

    def __init__(self, wl):
        self.wl = wl

    def __enter__(self):
        from repro_torch.graph import rmat
        self.calls = 0
        self._made = made = rmat.rmat_edges

        def tap(*args, **kw):
            self.calls += 1
            if args == (SCALE,) and kw == dict(edge_factor=EDGE_FACTOR,
                                                seed=SEED):
                return self.wl[SCALE]
            return made(*args, **kw)
        rmat.rmat_edges = tap
        return self

    def __exit__(self, *exc):
        from repro_torch.graph import rmat
        rmat.rmat_edges = self._made


def same_measurement(m, res, what: str) -> None:
    """A product-search measurement equal to an app run of an earlier
    phase: counters, trace, supersteps, ``time_s`` and TEPS edges."""
    run = res.run
    require(m.counters.as_dict() == run.counters.as_dict(),
            f"{what}: counters differ")
    require(m.trace.to_dict() == run.trace.to_dict(),
            f"{what}: trace differs")
    require(m.supersteps == run.supersteps, f"{what}: supersteps differ")
    require(m.time_s == run.time_s, f"{what}: time_s differs")
    require(m.teps_edges == res.teps_edges, f"{what}: TEPS edges differ")
    print(f"    {what}: counters, trace, supersteps, time_s, TEPS edges "
          f"equal")


def products_phase(dev, wl, smi: str) -> dict:
    """ROADMAP A.7 on the card: BFS at RMAT-22 measured through
    ``products.ProductSearch`` at every chip count of the 4096-tile
    package and priced over each count's products; the 1- and 4-chip
    measurements equal to phases 5 and 10.  Returns the four
    measurements' launches, summed."""
    import dataclasses
    import tempfile
    from repro_torch.core.costmodel import DCRA_SRAM
    from repro_torch.kernels import ops
    from repro_torch.products import (DEFAULT_BOARD_LINKS, OBJECTIVES,
                                      MeasureSpec, ProductSearch,
                                      chip_counts_for, pareto_front,
                                      product_space, select_products)
    t_phase = time.perf_counter()
    spec = MeasureSpec(app="bfs", scale=SCALE, tiles=TILES,
                       edge_factor=EDGE_FACTOR, seed=SEED)
    counts = chip_counts_for(TILES)
    configs = [cfg for n in counts for cfg in product_space(
        chips=(n,),
        board_links=PRODUCT_BOARD_LINKS if n > 1 else DEFAULT_BOARD_LINKS)]
    print(f"== 13. product search: {spec.label} (oq_cap {spec.oq_cap}, "
          f"{spec.slots} P$ slots, region_div {spec.region_div}: phase 5's "
          f"call), chips {list(counts)}, {len(configs)} products, "
          f"backend=kernels ({smi})")
    launches, measured = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ps = ProductSearch(cache_dir=tmp, device=dev)
        measure = ps.measure

        def timed(s, run_chunk=None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            with LoopClock() as clock:
                m = measure(s, run_chunk)
            torch.cuda.synchronize()
            got = ops.launch_counts()
            n = max(s.chips, 1)
            measured[n] = (m, dict(
                wall_s=time.perf_counter() - t0, loop_s=clock.seconds,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=got))
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            return m
        ps.measure = timed
        with DatasetTap(wl) as data:
            t0 = time.perf_counter()
            rows = ps.sweep([spec], configs)
            sweep_s = time.perf_counter() - t0
        require(ps.engine_runs == len(counts),
                f"first sweep: {ps.engine_runs} engine runs for "
                f"{len(counts)} chip counts")
        require(data.calls == 1, f"first sweep asked for {data.calls} RMAT "
                f"graphs, expected one")
        print(f"  first sweep: {len(rows)} rows from {ps.engine_runs} "
              f"engine runs in {sweep_s:.1f} s; the RMAT-{SCALE} graph "
              f"asked for once (phase 3's)")
        for n in counts:
            m, r = measured[n]
            require(not m.from_cache, f"{n} chip(s): measured from cache")
            for name in ENGINE_KERNELS:
                require(r["launches"][name] >= m.supersteps,
                        f"{n} chip(s): {name} launched "
                        f"{r['launches'][name]} times in {m.supersteps} "
                        f"supersteps")
            print(f"    {n} chip(s), {m.spec.label}: {m.supersteps} "
                  f"supersteps, wall {r['wall_s']:.2f} s on the card "
                  f"({r['loop_s']:.2f} s in the run loop, "
                  f"{r['loop_s'] / m.supersteps * 1e3:.3f} ms a superstep), "
                  f"peak {r['peak_gib']:.3f} GiB; modelled time_s "
                  f"{m.time_s:.6e}, "
                  f"{m.teps_edges / m.time_s / 1e9:.2f} GTEPS; off-chip "
                  f"msgs {m.counters.off_chip_msgs:.0f}; launches "
                  + json.dumps({k: r["launches"][k] for k in ENGINE_KERNELS}))
        same_measurement(measured[1][0], wl["dense"]["bfs"][0],
                         "1 chip vs phase 5")
        same_measurement(measured[PART_CHIPS][0],
                         wl["partition"]["bfs"][0],
                         f"{PART_CHIPS} chips vs phase 10")

        ps.measure = measure
        t0 = time.perf_counter()
        again = ps.sweep([spec], configs)
        require(ps.engine_runs == len(counts),
                f"second sweep ran the engine "
                f"{ps.engine_runs - len(counts)} times")
        require(len(again) == len(rows)
                and all(b["from_cache"] for b in again)
                and all(dict(a, from_cache=True) == b
                        for a, b in zip(rows, again)),
                "second sweep: rows differ from the first or not cached")
        print(f"  second sweep: {len(again)} rows equal field by field, "
              f"all from the cache, no engine run, in "
              f"{time.perf_counter() - t0:.2f} s")

        worst = 0.0
        for n in counts:
            s = ps.spec_for_product(spec, dataclasses.replace(DCRA_SRAM,
                                                              chips=n))
            for m in (measured[n][0], ps.measure(s)):
                rep = ps.price_product(m, dataclasses.replace(DCRA_SRAM,
                                                              chips=n))
                err = abs(rep.time_s - m.time_s) / m.time_s
                require(err <= REPRICE_TOL,
                        f"{n} chip(s): re-priced time_s {rep.time_s!r} vs "
                        f"{m.time_s!r}")
                worst = max(worst, err)
        require(ps.engine_runs == len(counts), "re-pricing ran the engine")
    print(f"  re-priced under its own package, live and cached, at every "
          f"chip count: within {worst:.1e} relative (limit {REPRICE_TOL})")

    links = {}
    for cfg, row in zip(configs, rows):
        if cfg.chips > 1:
            base = cfg.name.split("/bl")[0]
            links.setdefault((cfg.chips, base), {})[cfg.board_links_y] = row
    for (n, base), by in links.items():
        one, two = by[1], by[DEFAULT_BOARD_LINKS[0]]
        require(one["time_s"] >= two["time_s"]
                and one["cost_usd"] < two["cost_usd"],
                f"{base}: one board link time {one['time_s']!r} / cost "
                f"{one['cost_usd']!r} vs two {two['time_s']!r} / "
                f"{two['cost_usd']!r}")
    slow = {n: max(by[1]["time_s"] / by[DEFAULT_BOARD_LINKS[0]]["time_s"]
                   for (c, _), by in links.items() if c == n)
            for n in counts if n > 1}
    print(f"  board links: one never faster and always cheaper than two, "
          f"in all {len(links)} products; largest time_s one / two by "
          f"chip count {json.dumps(slow)}")

    front = pareto_front(rows)
    print(f"  Pareto front (throughput / $ x efficiency / $) over "
          f"{len(rows)} rows: {len(front)} products, chip counts "
          f"{sorted({r['chips'] for r in front})}")
    for r in front:
        print(f"    {r['product']}: {r['thr_per_usd']:.6e} TEPS/s/$, "
              f"{r['eff_per_usd']:.6e} TEPS/J/$, time_s "
              f"{r['time_s']:.6e}, ${r['cost_usd']:.2f}")
    for n in counts:
        sel = select_products([r for r in rows if r["chips"] == n],
                              WINNER_OBJECTIVES)
        print(f"  winners at {n} chip(s): " + "; ".join(
            f"{k} {v['product']} ({v[OBJECTIVES[k][0]]:.6e})"
            for k, v in sel.items()))
    sel = select_products(rows)
    print("  winners overall: " + "; ".join(
        f"{k} {v['product']} ({v[OBJECTIVES[k][0]]:.6e})"
        for k, v in sel.items()))
    print(f"  products phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------ 14. analysis passes (A.9)
ANALYSIS_BUDGET_S = 90          # the phase's budget, printed beside it
WALK_AT = 64                    # supersteps into a run before a walk


def walk_readings(label, eng, state, plan, t_setup) -> list:
    """One ``steplint`` walk (both loops) of ``plan``'s supersteps from
    ``state``; prints its ops, spare-row cuts, its seconds and those of
    its set-up since ``t_setup``.  Returns its findings."""
    from repro_torch.analysis import steplint
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    findings, got = steplint.lint_steps(eng, state, label, plan)
    torch.cuda.synchronize()
    print(f"    {label}: {len(findings)} finding(s); aten ops a walk "
          f"{json.dumps(got['ops'])}; spare-row repeats cut off "
          f"{got['spare_row_cuts']}; set-up {t0 - t_setup:.1f} s, walk "
          f"{time.perf_counter() - t0:.1f} s")
    return findings


def full_width_walks(dev, wl) -> list:
    """(b): the ``steplint`` walk of single supersteps at RMAT-22 on 4096
    tiles, as phases 5, 6b, 10b and 6 run them: BFS dense, BFS in the
    window of phase 6b's commonest compacted rung below the dense one,
    BFS on 4 chips double-buffered, and Histogram's flush superstep (the
    write-back P$ and the add kernels); each ``WALK_AT`` supersteps into
    its run, the compacted one at the first superstep at that rung.
    SpMV is left out: its ``transpose_csr`` set-up alone takes ~22 s."""
    from repro_torch.graph import apps
    g, grid = wl[SCALE], wl["grid"]
    calls = main_path_apps(wl)
    root, proxy = calls["bfs"][1][1], calls["bfs"][2]["proxy"]
    findings = []
    bfs = dict(proxy=proxy, root=root, oq_cap=OQ_CAP, device=dev)
    t0 = time.perf_counter()
    eng, state, _ = apps.engine_and_state("bfs", g, grid, **bfs)
    findings += walk_readings(f"bfs/kernels/RMAT-{SCALE} dense", eng,
                              advance(eng, state, WALK_AT), [(False, None)],
                              t0)
    del eng, state
    t0 = time.perf_counter()
    rungs = wl["compacted"]["bfs"][1]["rungs"]
    cap = commonest_rung("bfs", rungs, below=TILES)[0]
    start = int(np.flatnonzero(rungs == cap)[0])
    print(f"    the first superstep at rung {cap}: {start}")
    eng, state, _ = apps.engine_and_state("bfs", g, grid,
                                          compaction=COMPACTION, **bfs)
    findings += walk_readings(f"bfs/kernels/RMAT-{SCALE} window {cap}", eng,
                              advance(eng, state, start), [(False, cap)], t0)
    del eng, state
    t0 = time.perf_counter()
    eng, state, _ = apps.engine_and_state("bfs", g, grid, chips=PART_CHIPS,
                                          double_buffer=True, **bfs)
    findings += walk_readings(
        f"bfs/kernels/RMAT-{SCALE} {PART_CHIPS}chips-db", eng,
        advance(eng, state, WALK_AT), [(False, None)], t0)
    del eng, state
    t0 = time.perf_counter()
    hkw = calls["histo"][2]
    eng, state, _ = apps.engine_and_state(
        "histo", None, grid, hkw["proxy"], histo_values=wl["histo"],
        bins=wl["bins"], oq_cap=OQ_CAP, device=dev)
    findings += walk_readings(f"histo/kernels/RMAT-{SCALE} flush", eng,
                              advance(eng, state, WALK_AT), [(True, None)],
                              t0)
    del eng, state
    return findings


def race_cases_at_phase4(gen, dev) -> list:
    """(c)'s cases at phase 4's shapes (``kernel_inputs``, 4096 tiles):
    relax (elementwise), segment_combine (the P$ job, unsorted ids too,
    and the flush wave) and deliver_fused (the BFS delivery and the
    flush wave), min and add."""
    from repro_torch.kernels import ops, ref
    x = kernel_inputs(gen, dev, tiles=TILES)
    cases = []
    for key, c in (("relax", "min"), ("relax_add", "add")):
        cases.append(ref.Case(f"relax:phase4:{c}", ops.relax, ref.relax_ref,
                              x[key] + (c,), (0, 1, 2),
                              ("overwrite", "overwrite"), positional=True))
    for key in ("seg", "seg_rand", "seg_add"):
        for c in (("add",) if key == "seg_add" else ("min", "add")):
            cases.append(ref.Case(f"segment_combine:phase4:{key}:{c}",
                                  ops.segment_combine,
                                  ref.segment_combine_ref, x[key] + (c,),
                                  (0, 1), (c,), tol=(ADD_RTOL, ADD_ATOL)))
    for key in ("deliver", "deliver_add"):
        for c in (("add",) if key == "deliver_add" else ("min", "add")):
            cases.append(ref.Case(f"deliver_fused:phase4:{key}:{c}",
                                  ops.deliver_fused, ref.deliver_fused_ref,
                                  x[key] + (c,), (0, 1), (c, "count"),
                                  tol=(ADD_RTOL, ADD_ATOL)))
    return cases


def analysis_phase(dev, wl, smi: str) -> dict:
    """ROADMAP A.9 on the card: (a) the port's lint matrix
    (``analysis.runner.run_all``) on the kernels backend, every app's
    five cells, through the kernels and their CUDA-graph captures; (b)
    the ``steplint`` walk at full width (``full_width_walks``); (c)
    ``kernel_races`` on every kernel's ``analysis_cases`` and at phase
    4's shapes.  Any finding outside ``analysis_baseline_torch.json``
    fails the phase.  Returns the launches of (a) and (b) (engine runs
    and walks; (c)'s are comparisons with the plain versions)."""
    from repro_torch.analysis import kernel_races, load_baseline
    from repro_torch.analysis.runner import APP_NAMES, run_all
    from repro_torch.kernels import ops
    repo = Path(__file__).resolve().parent
    baseline = load_baseline(repo / "analysis_baseline_torch.json")
    t_phase = time.perf_counter()
    print(f"== 14. analysis passes: the lint matrix on backend=kernels, "
          f"steplint at RMAT-{SCALE}, kernel races ({smi}; budget "
          f"{ANALYSIS_BUDGET_S} s)")
    ops.reset_launches()
    t0 = time.perf_counter()
    secs = {}
    report = run_all(repo, app_names=APP_NAMES,
                     passes=("steplint", "invariants", "deadcode"),
                     device=dev, backends=("kernels",), seconds=secs)
    torch.cuda.synchronize()
    print(f"  (a) matrix: {len(report.matrix)} cells "
          f"({report.matrix[0]} ... {report.matrix[-1]}), "
          f"{len(report.findings)} finding(s), "
          f"{time.perf_counter() - t0:.1f} s; seconds by part "
          + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    findings = list(report.findings)
    t0 = time.perf_counter()
    print(f"  (b) steplint at RMAT-{SCALE} on {TILES} tiles:")
    findings += full_width_walks(dev, wl)
    torch.cuda.synchronize()
    print(f"  (b) {time.perf_counter() - t0:.1f} s")
    launches = ops.launch_counts()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    suites = (("analysis_cases", ops.analysis_cases()),
              ("phase 4 shapes", race_cases_at_phase4(gen, dev)))
    for label, cases in suites:
        t1 = time.perf_counter()
        got = kernel_races.check_kernels(dev, cases)
        torch.cuda.synchronize()
        findings += got
        print(f"  (c) kernel_races, {label}: {len(cases)} cases x 3 orders "
              f"x {kernel_races.REPEATS} runs, {len(got)} finding(s), "
              f"{time.perf_counter() - t1:.1f} s")
    print(f"  (c) {time.perf_counter() - t0:.1f} s")
    for f in findings:
        print(f"    {f.key}{' [baselined]' if f.key in baseline else ''}: "
              f"{f.message}")
    new = [f.key for f in findings if f.key not in baseline]
    require(not new, f"analysis: {len(new)} finding(s) outside the "
            f"baseline: {new[:4]}")
    for name in ENGINE_KERNELS:
        require(launches[name] > 0, f"analysis: {name} never launched")
    took = time.perf_counter() - t_phase
    print(f"    launches {json.dumps(launches)}")
    print(f"  analysis phase {took:.1f} s (budget {ANALYSIS_BUDGET_S} s"
          f"{', over' if took > ANALYSIS_BUDGET_S else ''})")
    return launches


# ----------------------------------------------------- 15. the LM served
# ROADMAP A.10a: the dense family at the full published widths of
# src/repro/models/registry.py, random weights from the seed, served
# through the calls src/repro/launch/serve.py:20 makes (registry.get ->
# fam["init"] -> ServeScheduler) and through serving.decode.generate
SERVE_A = dict(arch="deepseek-7b", slots=8, max_len=512, requests=12,
               prompt=(3, 64), max_new=32)
SERVE_B = dict(arch="starcoder2-3b", batch=8, prompt=256, tokens=32)
SERVE_C = dict(arch="starcoder2-3b", batch=8, cache_len=32768, steps=8,
               profiled=4)
# kernel vs plain step: max |logit difference| at most this many standard
# deviations of the plain step's logits.  Set before the first chip run
# from the CPU comparison of two bf16 roundings of the same step (the
# reference's bf16 P.V against the port's f32, tests/test_torch_models.py)
# at d 1024 over 6 layers: 0.037-0.063 sigma
SERVE_LOGIT_TOL = 0.25


@contextlib.contextmanager
def plain_attention():
    """The port's decode steps with ``ops.decode_attention`` swapped for
    its plain version (no launch), to hold a step through the kernel
    against the same step without it."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    kernel = ops.decode_attention

    def plain(q, k, v, lengths, scale=None, block_s=512):
        return da.plain(q, k, v, lengths, scale, block_s)
    ops.decode_attention = plain
    try:
        yield
    finally:
        ops.decode_attention = kernel


def logits_agree(label, got, want, vocab) -> dict:
    """A decode step's logits through the kernel (``got``) against the
    same step's through the plain version (``want``), (B, V_pad): finite,
    max |difference| within ``SERVE_LOGIT_TOL`` of the plain logits'
    standard deviation, and the same greedy token in every row whose
    top-2 margin exceeds twice that (where the bound cannot flip it)."""
    g, w = got.float()[:, :vocab], want.float()[:, :vocab]
    sigma = float(w.std())
    tol = SERVE_LOGIT_TOL * sigma
    err = float((g - w).abs().max())
    top2 = w.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = g.argmax(-1) == w.argmax(-1)
    require(bool(torch.isfinite(g).all()) and err <= tol,
            f"{label}: kernel vs plain logits max |err| {err:.4g} > "
            f"{SERVE_LOGIT_TOL} sigma = {tol:.4g}")
    require(bool(same[clear].all()),
            f"{label}: a greedy token differs where the top-2 margin "
            f"exceeds {2 * tol:.4g}")
    return dict(max_abs_err=err, sigma=sigma, tol=tol,
                err_sigmas=err / sigma, rows=int(g.shape[0]),
                rows_clear=int(clear.sum()), tokens_equal=int(same.sum()))


def weight_bytes(params) -> int:
    """Bytes of the parameters a decode step reads whole (all but the
    token embedding, of which it gathers B rows)."""
    def leaves(t):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v)
            elif k != "tok_emb":
                yield v
    return sum(t.numel() * t.element_size() for t in leaves(params))


class StepClock:
    """Wraps a serve step: host seconds of each call (ending in a
    synchronise), split by kind."""

    def __init__(self, fn):
        self.fn, self.kind, self.s = fn, "step", {}

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.s.setdefault(self.kind, []).append(time.perf_counter() - t0)
        return out

    def ms(self, kind):
        got = self.s.get(kind, [])
        return 1e3 * sum(got) / max(len(got), 1)


def serve_scheduler(dev, smi) -> tuple:
    """(a) deepseek-7b through ``ServeScheduler``; its first full-batch
    step held against the plain attention.  Returns (readings, launch
    counts of the run)."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serving import Request, ServeScheduler
    a = SERVE_A
    cfg, fam = registry.get(a["arch"])
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = fam["init"](cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sched = ServeScheduler(cfg, fam, params, batch_slots=a["slots"],
                           max_len=a["max_len"])
    kernel_step, advance, checked = sched._step, sched._advance, {}
    clock = StepClock(kernel_step)

    def step(params, cache, tokens, pos, gen=None):
        if clock.kind == "decode" and not checked:
            # the first full-batch step, once more through the plain
            # attention on a copy of the cache (no launch, not timed)
            copy = {k: v.clone() for k, v in cache.items()}
            with plain_attention():
                want = kernel_step(params, copy, tokens, pos, gen)[1]
            del copy
            out = clock(params, cache, tokens, pos, gen)
            checked.update(logits_agree(f"{a['arch']} first full-batch step",
                                        out[1], want, cfg.vocab))
            return out
        return clock(params, cache, tokens, pos, gen)

    def advance_by_kind(only_slot=None):
        clock.kind = "decode" if only_slot is None else "admit"
        return advance(only_slot)
    sched._step, sched._advance = step, advance_by_kind
    rng = np.random.default_rng(SEED)
    for rid in range(a["requests"]):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(
            a["prompt"][0], a["prompt"][1] + 1))).astype(np.int32)
        sched.submit(Request(rid=rid, prompt=prompt, max_new=a["max_new"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = sum(len(v) for v in clock.s.values())
    require(sorted(r.rid for r in done) == list(range(a["requests"])),
            f"{a['arch']}: served {len(done)} of {a['requests']} requests")
    for r in done:
        require(len(r.out) == a["max_new"] or len(r.prompt) + len(r.out)
                >= a["max_len"] - 1,
                f"{a['arch']}: request {r.rid} stopped at {len(r.out)} "
                f"tokens")
        require(all(0 <= t < cfg.vocab for t in r.out),
                f"{a['arch']}: request {r.rid} has a token outside the "
                f"vocabulary")
    require(launches["decode_attention"] == cfg.n_layers * steps,
            f"{a['arch']}: decode_attention launched "
            f"{launches['decode_attention']} times in {steps} steps of "
            f"{cfg.n_layers} layers")
    tokens = sum(len(r.out) for r in done)
    decode_s = sum(clock.s.get("decode", []))
    floor_ms = weight_bytes(params) / HBM_BYTES_PER_S * 1e3
    read = dict(arch=a["arch"], params=cfg.param_count(),
                init_s=init_s, requests=len(done), tokens=tokens,
                prompt_tokens=int(sum(len(r.prompt) for r in done)),
                steps=steps, admit_steps=len(clock.s.get("admit", [])),
                decode_steps=len(clock.s.get("decode", [])), wall_s=wall,
                ms_per_step=1e3 * sum(sum(v) for v in clock.s.values())
                / steps,
                ms_per_admit_step=clock.ms("admit"),
                ms_per_decode_step=clock.ms("decode"),
                tokens_per_s=tokens / wall,
                decode_tokens_per_s=tokens / decode_s,
                weight_floor_ms=floor_ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=launches["decode_attention"],
                check=dict(checked))
    print(f"  (a) {a['arch']} (L {cfg.n_layers}, d {cfg.d_model}, H "
          f"{cfg.n_heads}/{cfg.n_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{cfg.param_count() / 1e9:.2f} B parameters drawn in "
          f"{init_s:.1f} s), ServeScheduler: {a['slots']} slots, max_len "
          f"{a['max_len']}, {a['requests']} requests of "
          f"{a['prompt'][0]}-{a['prompt'][1]} prompt tokens, max_new "
          f"{a['max_new']}, greedy [{smi}]")
    print(f"      served {len(done)} requests, {tokens} tokens "
          f"({read['prompt_tokens']} prompt tokens fed) in {wall:.2f} s: "
          f"{read['tokens_per_s']:.1f} tok/s ({read['decode_tokens_per_s']:.1f}"
          f" in the full-batch steps); {steps} steps ({read['admit_steps']} "
          f"admitting, {read['decode_steps']} full-batch), "
          f"{read['ms_per_step']:.3f} ms a step ({read['ms_per_admit_step']:.3f}"
          f" / {read['ms_per_decode_step']:.3f}; weight floor "
          f"{floor_ms:.3f}); peak {read['peak_gib']:.2f} GiB; "
          f"decode_attention {launches['decode_attention']} launches = "
          f"{cfg.n_layers} x {steps}")
    print(f"      first full-batch step vs plain attention: max |err| "
          f"{checked['max_abs_err']:.4g} = {checked['err_sigmas']:.4f} sigma "
          f"(tolerance {SERVE_LOGIT_TOL}); greedy tokens equal in "
          f"{checked['tokens_equal']}/{checked['rows']} rows "
          f"({checked['rows_clear']} clear of the bound)")
    sched._step, sched._advance = kernel_step, advance  # no cycle holds it
    del sched, params, clock, step, advance, advance_by_kind
    gc.collect()
    torch.cuda.empty_cache()
    return read, launches


def serve_generate(dev, smi) -> tuple:
    """(b) starcoder2-3b through ``generate``.  Returns (readings, launch
    counts of the run, params and config for (c))."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serving import generate
    b = SERVE_B
    cfg, fam = registry.get(b["arch"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    t0 = time.perf_counter()
    params = fam["init"](cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab, (b["batch"], b["prompt"]),
                           generator=gen, device=dev)
    prefill, decode = StepClock(fam["prefill"]), StepClock(fam["decode"])
    timed = dict(fam, prefill=prefill, decode=decode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = generate(cfg, timed, params, dict(tokens=prompt), b["tokens"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = b["tokens"] - 1
    require(tuple(out.shape) == (b["batch"], b["tokens"])
            and out.dtype == torch.int32
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            f"{b['arch']}: generate gave {tuple(out.shape)} {out.dtype}")
    require(len(decode.s["step"]) == steps
            and launches["decode_attention"] == cfg.n_layers * steps,
            f"{b['arch']}: decode_attention launched "
            f"{launches['decode_attention']} times in "
            f"{len(decode.s['step'])} steps of {cfg.n_layers} layers")
    read = dict(arch=b["arch"], params=cfg.param_count(), init_s=init_s,
                batch=b["batch"], prompt=b["prompt"], tokens=b["tokens"],
                wall_s=wall, prefill_ms=prefill.ms("step"),
                ms_per_decode_step=decode.ms("step"),
                weight_floor_ms=weight_bytes(params) / HBM_BYTES_PER_S * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=launches["decode_attention"])
    print(f"  (b) {b['arch']} (L {cfg.n_layers}, d {cfg.d_model}, H "
          f"{cfg.n_heads}/{cfg.n_kv}, LayerNorm, GELU; "
          f"{cfg.param_count() / 1e9:.2f} B parameters drawn in "
          f"{init_s:.1f} s), generate: B {b['batch']}, prompt "
          f"{b['prompt']}, {b['tokens']} tokens [{smi}]")
    print(f"      prefill {read['prefill_ms']:.3f} ms, {steps} decode steps "
          f"at {read['ms_per_decode_step']:.3f} ms (weight floor "
          f"{read['weight_floor_ms']:.3f}); {wall:.2f} s in all; peak "
          f"{read['peak_gib']:.2f} GiB; decode_attention "
          f"{launches['decode_attention']} launches = {cfg.n_layers} x "
          f"{steps}")
    return read, launches, (cfg, fam, params)


def serve_long_cache(dev, smi, model) -> tuple:
    """(c) decode_32k: starcoder2-3b, a 32,768-position cache filled from
    the seed, decode steps at position 32,767 through the kernel and the
    plain attention in turns, then a profiled window of kernel steps.
    Each step writes its own token's K/V into the last slot before
    attending, so every step sees the same inputs.  Returns (readings,
    launch counts of the kernel steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    c = SERVE_C
    cfg, fam, params = model
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cache = fam["init_cache"](cfg, c["batch"], c["cache_len"], dev)
    for t in cache.values():
        t.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab, (c["batch"], 1), generator=gen,
                           device=dev)
    pos = c["cache_len"] - 1
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    step = StepClock(fam["decode"])
    for kind in ("kernel", "plain"):          # warm-up, not timed
        with plain_attention() if kind == "plain" else contextlib.nullcontext():
            want = step.fn(params, cache, tokens, pos, cfg)[0]
    torch.cuda.synchronize()
    ops.reset_launches()
    errs = []
    for i in range(2 * c["steps"]):
        step.kind = ("kernel", "plain", "plain", "kernel")[i % 4]
        if step.kind == "plain":
            with plain_attention():
                want = step(params, cache, tokens, pos, cfg)[0]
        else:
            got = step(params, cache, tokens, pos, cfg)[0]
        if i % 4 in (1, 3):
            errs.append(logits_agree(f"decode_32k step {i // 2}", got, want,
                                     cfg.vocab))
    launches = ops.launch_counts()
    require(launches["decode_attention"] == cfg.n_layers * c["steps"],
            f"decode_32k: decode_attention launched "
            f"{launches['decode_attention']} times in {c['steps']} kernel "
            f"steps of {cfg.n_layers} layers")
    n = c["profiled"]
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fam["decode"](params, cache, tokens, pos, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for name, count in ops.launch_counts().items():
        launches[name] += count
    busy = attn = 0.0
    entries = 0
    top = []
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us = getattr(e, "self_device_time_total", 0.0)
            busy += us
            entries += e.count
            top.append((us, e.count, e.key))
            if "decode_split" in e.key or "decode_merge" in e.key:
                attn += us          # the kernels' names come mangled
    require(busy > 0, "decode_32k: the profiler recorded no device time")
    floor_ms = (weight_bytes(params) + cache_bytes) / HBM_BYTES_PER_S * 1e3
    read = dict(arch=cfg.arch, batch=c["batch"], cache_len=c["cache_len"],
                cache_gib=cache_bytes / 2**30, pos=pos,
                ms_per_step=step.ms("kernel"),
                plain_ms_per_step=step.ms("plain"),
                byte_floor_ms=floor_ms,
                profiled_wall_ms=wall * 1e3 / n,
                device_busy_ms=busy / n / 1e3,
                attention_ms=attn / n / 1e3,
                attention_share=attn / max(busy, 1e-9),
                device_entries=entries / n,
                max_err_sigmas=max(e["err_sigmas"] for e in errs),
                max_abs_err=max(e["max_abs_err"] for e in errs),
                launches=launches["decode_attention"])
    print(f"  (c) decode_32k: {cfg.arch}, B {c['batch']}, a "
          f"{c['cache_len']}-position cache from the seed "
          f"({read['cache_gib']:.2f} GiB of K/V), position {pos} "
          f"[{smi}]")
    print(f"      {c['steps']} steps each way in turns: kernel "
          f"{read['ms_per_step']:.3f} ms, plain attention "
          f"{read['plain_ms_per_step']:.3f} ms a step (byte floor "
          f"{floor_ms:.3f}: weights and the cache once); logits max |err| "
          f"{read['max_abs_err']:.4g} = {read['max_err_sigmas']:.4f} sigma "
          f"(tolerance {SERVE_LOGIT_TOL})")
    print(f"      profiled, {n} kernel steps: {read['profiled_wall_ms']:.3f} "
          f"ms wall, device busy {read['device_busy_ms']:.3f} ms in "
          f"{entries / n:.0f} entries a step, decode_attention "
          f"{read['attention_ms']:.3f} ms ({read['attention_share']:.1%} of "
          f"the busy time); top device entries a step (us, launches, "
          f"name):")
    for us, count, key in sorted(top, reverse=True)[:6]:
        print(f"        {us / n:9.1f} {count / n:6.1f}  {key[:80]}")
    del cache
    torch.cuda.empty_cache()
    return read, launches


def serve_phase(dev, smi) -> tuple:
    """ROADMAP A.10a on the card: (a), (b) and (c) above.  Returns the
    readings and the launch counts of the main-path runs by path:
    ``serve`` ((a) and (b)) and ``serve_32k`` ((c)'s kernel steps)."""
    print(f"== 15. the dense LM served at full width (repro_torch.models, "
          f"serving; decode attention through ops.decode_attention) [{smi}]")
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    parts = [time.perf_counter()]
    read_a, launches = serve_scheduler(dev, smi)
    parts.append(time.perf_counter())
    read_b, more, model = serve_generate(dev, smi)
    launches = {k: launches[k] + more[k] for k in launches}
    parts.append(time.perf_counter())
    read_c, long_launches = serve_long_cache(dev, smi, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(time.perf_counter())
    took = time.perf_counter() - t_phase
    part_s = [b - a for a, b in zip(parts, parts[1:])]
    print(f"  serve phase {took:.1f} s ((a) {part_s[0]:.1f}, (b) "
          f"{part_s[1]:.1f}, (c) {part_s[2]:.1f})")
    return dict(a=read_a, b=read_b, c=read_c, seconds=took,
                part_seconds=part_s), dict(serve=launches,
                                           serve_32k=long_launches)


# -------------------------------------------------- 16. the LM trained
# ROADMAP A.10b: starcoder2-3b at the full published widths of
# src/repro/models/registry.py (3.18 B parameters; deepseek-7b's AdamW
# state does not fit one 80 GB card), random weights from the seed,
# trained through the calls src/repro/launch/train.py:42 makes
# lr 3e-6: the launcher's default (3e-4, with its automatic warmup of one
# step at 8 steps) diverged here at full width (loss 11.42 -> 12.44 at
# step 5, grad norm 35.8), as did 1e-4 and a 4-step warmup; a 2,000-step
# warmup to 3e-4 and 1e-6 stayed flat within 0.03; 3e-6 fell at every
# step but one (11.421 -> 11.340; PERF.md, Findings)
TRAIN = dict(arch="starcoder2-3b", steps=8, batch=8, seq=1024, lr=3e-6,
             timed=6, profiled=2)
TRAIN_PEAK_GIB = 75.0
# (c): the reduced archs, 2 AdamW steps (lr 1e-3, warmup 1: the second
# moves the parameters) of 4 x 64 tokens, card vs CPU in f32.  Set before
# the first chip run from the port against the reference on the CPU over
# this configuration: loss and grad norm 1.5e-7 relative, parameters
# 1.1e-4 of a leaf's max |x| (tok_emb, rows whose gradients sit near
# AdamW's eps), with room for the card's other summation orders
TRAIN_SMALL = dict(archs=("starcoder2-3b", "deepseek-7b"), steps=2,
                   batch=4, seq=64, lr=1e-3)
TRAIN_RTOL = 1e-5
TRAIN_PARAM_TOL = 2e-3
# the six kernels' device symbols, as the profiler names them
KERNEL_SYMBOLS = dict(relax=("relax_kernel",),
                      segment_combine=("segment_combine_kernel",),
                      deliver_fused=("deliver_fused_kernel",),
                      histogram_bin=("histogram_slice_kernel",
                                     "histogram_global_kernel"),
                      spmv_bcsr=("spmv_bcsr_kernel",),
                      decode_attention=("decode_split", "decode_merge"))


def train_entry(dev, smi) -> tuple:
    """(a) ``launch.train.main`` at full width.  Returns (readings,
    launch counts of the run)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    t = TRAIN
    seen = []
    make = train.make_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def wrapped(state, batch):
            out = step(state, batch)
            seen.append(out[1])
            return out
        return wrapped
    argv = ["--arch", t["arch"], "--steps", str(t["steps"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--lr", str(t["lr"])]
    print(f"  (a) launch.train.main({argv}, device={dev.type!r}) [{smi}]")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    train.make_train_step = recording
    t0 = time.perf_counter()
    try:
        losses = train.main(argv, device=dev.type)
    finally:
        train.make_train_step = make
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    gnorms = [float(m["grad_norm"]) for m in seen]
    require(len(losses) == t["steps"] and len(gnorms) == t["steps"],
            f"train: {len(losses)} losses, {len(gnorms)} grad norms of "
            f"{t['steps']} steps")
    require(all(math.isfinite(x) for x in losses + gnorms),
            f"train: a loss or grad norm is not finite: {losses} {gnorms}")
    last = float(np.mean(losses[-3:]))
    require(last < losses[0],
            f"train: the last 3 losses' mean {last:.4f} is not below the "
            f"first {losses[0]:.4f}")
    require(peak < TRAIN_PEAK_GIB,
            f"train: peak {peak:.2f} GiB >= {TRAIN_PEAK_GIB} GiB")
    read = dict(arch=t["arch"], steps=t["steps"], batch=t["batch"],
                seq=t["seq"], losses=losses, grad_norms=gnorms, wall_s=wall,
                s_per_step=wall / t["steps"], peak_gib=peak)
    print(f"      losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 3) for x in gnorms]}; last-3 mean {last:.4f} < first "
          f"{losses[0]:.4f}; {wall:.2f} s in all ({read['s_per_step']:.3f} s "
          f"a step with init and the host's batches); peak {peak:.2f} GiB "
          f"(limit {TRAIN_PEAK_GIB})")
    return read, launches


def kernel_symbols_seen(prof) -> dict:
    """{kernel name: device launches the profiler saw of its symbols}."""
    from torch.autograd import DeviceType
    seen = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name, symbols in KERNEL_SYMBOLS.items():
            if any(sym in e.key for sym in symbols):
                seen[name] += e.count
    return seen


def train_timing(dev, smi) -> tuple:
    """(b) The full-width step on batches made before the timing.
    Returns (readings, kernel launches the profiler saw)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch.train import batch_source, make_optimizer
    from repro_torch.models import registry
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.training.optimizer import Optimizer, tree_leaves
    t = TRAIN
    cfg, fam = registry.get(t["arch"])
    warmup = min(100, max(1, t["steps"] // 10))      # (a)'s, as main's
    opt = make_optimizer(cfg, t["lr"], warmup)
    spans = []

    def update(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = opt.update(*args)
        b.record()
        spans.append((a, b))
        return out
    timed_opt = Optimizer(init=opt.init, update=update, name=opt.name)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fam["init"](cfg, gen, dev)
    n_all = sum(p.numel() for p in tree_leaves(params))
    n_mm = n_all - params["tok_emb"].numel()
    state = TrainState.create(params, timed_opt)
    del params
    step = make_train_step(cfg, fam, timed_opt)
    _, host_batch = batch_source(cfg, t["seq"], t["batch"])
    t0 = time.perf_counter()
    host_batch(t["timed"])
    host_s = time.perf_counter() - t0
    batches = [to_device(host_batch(i), dev) for i in range(t["timed"])]
    state, _ = step(state, batches[0])                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spans.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / len(batches)
    opt_ms = sum(a.elapsed_time(b) for a, b in spans) / len(spans)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(math.isfinite(float(x)) for x in losses),
            "train timing: a loss is not finite")
    tokens = t["batch"] * t["seq"]
    flop = 6 * n_mm * tokens
    n = t["profiled"]
    # device activity only: the host's ~20,000 ops a step would cost the
    # phase seconds in tracing and nothing this reading uses
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[:n]:
            state, m = step(state, b)
        torch.cuda.synchronize()
    busy = 0.0
    top = []
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us = getattr(e, "self_device_time_total", 0.0)
            busy += us
            top.append((us, e.count, e.key))
    require(busy > 0, "train: the profiler recorded no device time")
    seen = kernel_symbols_seen(prof)
    read = dict(arch=t["arch"], params=n_all, params_matmul=n_mm,
                tokens=tokens, ms_per_step=ms, wall_ms_per_step=wall * 1e3
                / len(batches), tokens_per_s=tokens / (ms / 1e3),
                flop_6nt=flop, peak_share=flop / (ms / 1e3)
                / BF16_FLOP_PER_S, host_batch_s=host_s,
                optimizer_ms=opt_ms, optimizer_share=opt_ms / ms,
                peak_gib=peak, device_busy_ms=busy / n / 1e3,
                profiled_steps=n,
                top=[(us / n / 1e3, c / n, k) for us, c, k
                     in sorted(top, reverse=True)[:10]],
                kernels_seen=seen)
    print(f"  (b) {t['arch']} (L {cfg.n_layers}, d {cfg.d_model}, H "
          f"{cfg.n_heads}/{cfg.n_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_all / 1e9:.3f} B parameters, {n_mm / 1e9:.3f} B without the "
          f"token embedding), AdamW, {t['batch']} x {t['seq']} tokens, "
          f"{len(batches)} steps on batches made before the timing "
          f"[{smi}]")
    print(f"      {ms:.2f} ms a step (host wall {read['wall_ms_per_step']:.2f}"
          f"), {read['tokens_per_s']:.0f} tokens/s; 6NT = "
          f"{flop / 1e12:.1f} TFLOP a step = {read['peak_share']:.1%} of "
          f"the dense bf16 peak ({BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; "
          f"remat's extra forward not counted); optimizer update "
          f"{opt_ms:.2f} ms device span ({read['optimizer_share']:.1%}); "
          f"host batch_at {host_s:.3f} s alone; peak {peak:.2f} GiB")
    print(f"      profiled, {n} steps: device busy "
          f"{read['device_busy_ms']:.2f} ms a step; six kernels seen "
          f"{json.dumps(seen)}; top device ops a step (ms, calls, name):")
    for ms_, calls, key in read["top"]:
        print(f"        {ms_:9.3f} {calls:7.1f}  {key[:90]}")
    del state, batches, m, losses
    gc.collect()
    torch.cuda.empty_cache()
    return read, seen


def _leaf_rel_errs(got, want, path="") -> dict:
    """{leaf path: max |got - want| / max |want|} of two numpy trees."""
    if isinstance(want, dict):
        out = {}
        for k in want:
            out.update(_leaf_rel_errs(got[k], want[k], f"{path}/{k}"))
        return out
    return {path: float(np.abs(got - want).max())
            / max(float(np.abs(want).max()), 1e-30)}


def train_card_vs_cpu(dev) -> dict:
    """(c) 2 AdamW steps of the reduced archs from one f32 state carried
    by ``convert``, on the card and on the CPU."""
    from repro_torch import convert
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.training import TrainState, adamw, make_train_step
    from repro_torch.training.optimizer import tree_map
    c = TRAIN_SMALL
    out = {}
    for arch in c["archs"]:
        cfg, fam = registry.get(arch, smoke=True)
        gen = torch.Generator().manual_seed(SEED)
        params = tree_map(lambda p: p.float(), fam["init"](cfg, gen, "cpu"))
        np_state = convert.train_state_to_numpy(TrainState.create(
            params, adamw(lr=c["lr"], warmup=1)))
        src = SyntheticLM(vocab=cfg.vocab, seq_len=c["seq"],
                          batch=c["batch"])
        runs = []
        for where in (dev, torch.device("cpu")):
            state = convert.train_state_from_numpy(np_state, where)
            step = make_train_step(cfg, fam, adamw(lr=c["lr"], warmup=1))
            ms = []
            for i in range(c["steps"]):
                b = src.batch_at(i)
                state, m = step(state, to_device(
                    dict(tokens=b["tokens"], labels=b["labels"]), where))
                ms.append({k: float(v) for k, v in m.items()})
            runs.append((ms, convert.train_state_to_numpy(state)))
        (card_m, card_s), (cpu_m, cpu_s) = runs
        rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(card_m, cpu_m)
                  for k in ("loss", "grad_norm"))
        errs = _leaf_rel_errs(card_s["params"], cpu_s["params"])
        worst = max(errs, key=errs.get)
        require(all(math.isfinite(a[k]) for a in card_m
                    for k in ("loss", "grad_norm")) and rel <= TRAIN_RTOL,
                f"train (c) {arch}: loss / grad norm card vs CPU {rel:.3g} "
                f"> {TRAIN_RTOL}")
        require(errs[worst] <= TRAIN_PARAM_TOL,
                f"train (c) {arch}: parameters card vs CPU {errs[worst]:.3g}"
                f" of {worst}'s max > {TRAIN_PARAM_TOL}")
        out[arch] = dict(loss_rel=rel, param_rel=errs[worst],
                         param_leaf=worst,
                         losses=[m["loss"] for m in card_m])
        print(f"  (c) {arch} reduced (L {cfg.n_layers}, d {cfg.d_model}), "
              f"f32, {c['steps']} AdamW steps of {c['batch']} x {c['seq']}: "
              f"card vs CPU loss / grad norm {rel:.3g} (tolerance "
              f"{TRAIN_RTOL}), parameters {errs[worst]:.3g} of {worst}'s "
              f"max (tolerance {TRAIN_PARAM_TOL})")
    return out


def train_phase(dev, smi) -> tuple:
    """ROADMAP A.10b on the card: (a), (b) and (c) above.  Returns the
    readings and the launch counts of the path ``train``."""
    print(f"== 16. the dense LM trained at full width (repro_torch."
          f"training, data, launch.train; no kernel on this path) [{smi}]")
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = [time.perf_counter()]
    read_a, launches = train_entry(dev, smi)
    parts.append(time.perf_counter())
    read_b, seen = train_timing(dev, smi)
    parts.append(time.perf_counter())
    read_c = train_card_vs_cpu(dev)
    parts.append(time.perf_counter())
    launches = {k: launches[k] + seen[k] for k in launches}
    took = time.perf_counter() - t_phase
    part_s = [b - a for a, b in zip(parts, parts[1:])]
    print(f"    launches on the train path {json.dumps(launches)}")
    print(f"  train phase {took:.1f} s ((a) {part_s[0]:.1f}, (b) "
          f"{part_s[1]:.1f}, (c) {part_s[2]:.1f})")
    return dict(a=read_a, b=read_b, c=read_c, seconds=took,
                part_seconds=part_s), launches


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
    by_path["compaction"] = compaction_phase(dev, wl)
    by_path["ops"] = ops_phase(dev, wl)
    decode_row, by_path["decode"] = decode_phase(dev)
    rows.append(decode_row)
    agreement_phase(dev, wl)
    by_path["hooks"] = hooks_phase(dev, wl, c["smi"])
    by_path["partition"] = partition_phase(dev, wl)
    by_path["partition_overlap"] = overlap_phase(dev, wl)
    by_path["fault"] = fault_phase(dev, wl)
    by_path["ranks"] = ranks_phase(dev, wl)
    by_path["products"] = products_phase(dev, wl, c["smi"])
    by_path["analysis"] = analysis_phase(dev, wl, c["smi"])
    serve, serve_launches = serve_phase(dev, c["smi"])
    by_path.update(serve_launches)
    decode_row["serve"] = serve
    _, by_path["train"] = train_phase(dev, c["smi"])
    for row in rows:
        row["launches_by_path"] = {p: n[row["name"]]
                                   for p, n in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        require(row["launches"] > 0,
                f"{row['name']} never launched on a main path")

    print(f"== 17. done in {time.perf_counter() - t_start:.1f} s")
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
