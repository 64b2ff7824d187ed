#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no phase lets the run go
on past a failure:

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the kernel build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled
   for sm_90a from the checkout, timed;
3. the kernels: relax, segment_combine and deliver_fused, each against
   its plain PyTorch version on the card at the main path's shapes, for
   min and add, with padding and +inf entries in the inputs; each timed
   (CUDA events) beside its byte bound, its plain version and, where one
   PyTorch call computes the same function, that call;
4. the main path: ``apps.bfs`` on RMAT-22 over one 64x64-tile package
   (4096 tiles) with the Table-II write-through proxy, through the
   kernels; values checked against scipy's BFS hop distances, each
   kernel's launch count against the superstep count;
5. the same run with ``backend="torch"``, which must agree bit for bit;
6. one JSON line of per-kernel numbers, then the last line,
   ``{"ok": true, "device": {...}}``.

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

ADD_RTOL, ADD_ATOL = 1e-5, 1e-6   # f32 re-association of atomic adds


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
    than twice the L2 cache."""
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


def kernel_inputs(gen, dev):
    """Main-path shapes: Nd mailbox entries, R = T*oq_cap P$ records,
    2R delivery records (the forwarded leg + the masked eviction leg)."""
    nd = (1 << SCALE)          # chunk_dst * T = 2**22 at RMAT-22
    r = TILES * OQ_CAP

    def rand(n):
        return torch.rand(n, generator=gen, device=dev)

    def with_inf(x, p):
        return torch.where(rand(x.numel()) < p, float("inf"), x)

    relax_in = (with_inf(rand(nd) * 64, 0.5), with_inf(rand(nd) * 64, 0.3),
                rand(nd) < 0.5)
    # segment ids as the engine feeds them: sorted group ids, masked
    # records (-1) at the end; plus an unsorted stream with interleaved
    # padding, which the kernel's contract also covers
    live = int(0.6 * r)
    gid = torch.sort(torch.randint(0, live, (live,), generator=gen,
                                   device=dev)).values.to(torch.int32)
    seg_sorted = torch.cat([gid, torch.full((r - live,), -1,
                                            dtype=torch.int32, device=dev)])
    seg_rand = torch.where(rand(r) < 0.3, -1,
                           torch.randint(0, r, (r,), generator=gen,
                                         device=dev)).to(torch.int32)
    seg_val = rand(r) * 64
    # delivery: the forwarded leg (60% live mailbox indices), then the
    # all-masked eviction leg of the write-through P$
    fwd = torch.where(rand(r) < 0.6,
                      torch.randint(0, nd, (r,), generator=gen, device=dev),
                      -1).to(torch.int32)
    dseg = torch.cat([fwd, torch.full((r,), -1, dtype=torch.int32,
                                      device=dev)])
    dval = rand(2 * r) * 64
    mail = with_inf(rand(nd) * 64, 0.5)
    return dict(nd=nd, r=r, relax=relax_in, seg_sorted=seg_sorted,
                seg_rand=seg_rand, seg_val=seg_val, dseg=dseg, dval=dval,
                mail=mail)


def kernel_phase(dev) -> list:
    from repro_torch.kernels import deliver_fused as df
    from repro_torch.kernels import relax_min as rx
    from repro_torch.kernels import segment_combine as sc
    print("== 3. kernels vs plain versions on the card "
          f"(min: bitwise; add: rtol {ADD_RTOL}, atol {ADD_ATOL}; "
          "counts exact)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = kernel_inputs(gen, dev)
    nd, r = x["nd"], x["r"]
    rows = []

    def agree(name, combine, got, want):
        for g, w in zip(got, want):
            if combine == "min" or g.dtype != torch.float32:
                require(torch.equal(g, w), f"{name}/{combine} differs from "
                        f"its plain version (max |err| {max_abs_err(g, w)})")
            else:
                require(torch.allclose(g, w, rtol=ADD_RTOL, atol=ADD_ATOL),
                        f"{name}/{combine} outside tolerance "
                        f"(max |err| {max_abs_err(g, w)})")
        return max(max_abs_err(g.float(), w.float()) for g, w in zip(got, want))

    def record(name, replaces, args, kernel, plain, nbytes, library=None):
        err = {}
        for combine in ("min", "add"):
            got = kernel(*args, combine=combine)
            want = plain(*args, combine=combine)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err[combine] = agree(name, combine, got, want)
        sets = copies(args, nbytes)
        ms = time_cuda(lambda *a: kernel(*a, combine="min"), sets)
        plain_ms = time_cuda(lambda *a: plain(*a, combine="min"), sets)
        lib_ms = time_cuda(*library) if library is not None else None
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  {name}: ok (max |err| min {err['min']:g}, add "
              f"{err['add']:g}); {ms:.4f} ms vs byte bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/engine_kernels.cu",
            replaces=replaces, launches=0, max_abs_err=err["min"], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
            library_ms=lib_ms))

    record("relax", "src/repro/kernels/relax_min.py:32", x["relax"],
           rx.relax, rx.plain, 14 * nd)

    # bytes the scatters must move: every segment id, the values of the
    # live (seg >= 0) records only, and the outputs (and mailbox) once
    live = int((x["seg_sorted"] >= 0).sum())
    seg_bytes = 4 * r + 4 * live + 4 * r
    # one PyTorch call of the same function: scatter_reduce_ amin into a
    # +inf-filled buffer with the padding sent to a spare slot
    safe = torch.where(x["seg_sorted"] >= 0, x["seg_sorted"], r).long()
    lib_out = torch.full((r + 1,), float("inf"), device=dev)
    lib_sets = copies((lib_out, safe, x["seg_val"]), seg_bytes)
    record("segment_combine", "src/repro/kernels/segment_combine.py:55",
           (x["seg_sorted"], x["seg_val"], r), sc.segment_combine, sc.plain,
           seg_bytes,
           library=(lambda o, i, v: o.scatter_reduce_(0, i, v, "amin"),
                    lib_sets))
    for combine in ("min", "add"):     # unsorted ids, padding interleaved
        agree("segment_combine[unsorted]", combine,
              (sc.segment_combine(x["seg_rand"], x["seg_val"], r, combine),),
              (sc.plain(x["seg_rand"], x["seg_val"], r, combine),))

    live = int((x["dseg"] >= 0).sum())
    record("deliver_fused", "src/repro/kernels/deliver_fused.py:68",
           (x["dseg"], x["dval"], x["mail"]), df.deliver_fused, df.plain,
           4 * 2 * r + 4 * live + 12 * nd)
    return rows


def workload():
    """The main path's graph, grid and P$, made once for both runs."""
    from repro_torch.core.tilegrid import square_grid
    from repro_torch.graph import apps, rmat_edges
    t0 = time.perf_counter()
    g = rmat_edges(SCALE, edge_factor=EDGE_FACTOR, seed=SEED)
    grid = square_grid(TILES)
    proxy = apps.table2_proxy(grid, "bfs")
    root = int(np.argmax(g.out_degree()))
    print(f"  RMAT-{SCALE}: {g.n_rows} vertices, {g.nnz} edges, root "
          f"{root}, made in {time.perf_counter() - t0:.1f} s; "
          f"{grid.describe()}; P$ {proxy.region_ny}x{proxy.region_nx} "
          f"regions, {proxy.slots} slots, write-through; oq_cap {OQ_CAP}")
    return dict(g=g, grid=grid, proxy=proxy, root=root)


def bfs_run(dev, wl, backend: str):
    """One ``apps.bfs`` call as a user makes it, timed on the host clock
    around work that ends in a synchronise."""
    from repro_torch.graph import apps
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import default_registry
    syncs = default_registry().counter("engine.host_syncs")
    syncs0 = syncs.value
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = apps.bfs(wl["g"], wl["root"], wl["grid"], proxy=wl["proxy"],
                   oq_cap=OQ_CAP, device=dev, backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    run = res.run
    print(f"  backend={backend}: {run.supersteps} supersteps in {wall:.2f} s "
          f"wall on the card ({wall / run.supersteps * 1e3:.3f} ms per "
          f"superstep, {syncs.value - syncs0:.0f} host syncs), peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  modelled Tascade chip (BSP cost model, not the H100): "
          f"time_s {run.time_s:.6e}, {res.gteps:.2f} GTEPS")
    print(f"  counters {json.dumps(run.counters.as_dict())}")
    print(f"  launches {json.dumps(launches)}")
    return res, launches


def profile_supersteps(dev, wl, n: int = 20) -> None:
    """Where a superstep's time goes: ``n`` supersteps of the kernels
    backend under ``torch.profiler`` (after 5 warm-up supersteps), the
    device-busy share and the ops with the most device time.  The dense
    superstep does the same work whatever the frontier, so any window
    stands for the run.  The profiler adds host overhead of its own."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import (DataLocalEngine, EngineConfig,
                                         fetch_stats)
    from repro_torch.graph import apps
    g = wl["g"]
    cfg = EngineConfig(grid=wl["grid"], n_src=g.n_rows, n_dst=g.n_cols,
                       oq_cap=OQ_CAP, proxy=wl["proxy"])
    eng = DataLocalEngine(apps.BFS_SPEC, cfg, g.row_lo, g.row_hi, g.col_idx,
                          g.weights, device=dev)
    state = eng.init_state(seed_idx=wl["root"], seed_val=0.0)
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
        print("  profile: the profiler recorded no device time "
              "(device busy share not measured)")
        return
    print(f"  profile ({n} supersteps, kernels backend, under the "
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


def check_values(g, root, res) -> None:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    t0 = time.perf_counter()
    a = csr_matrix((np.ones(g.nnz, np.float32), g.col_idx, g.row_ptr),
                   shape=(g.n_rows, g.n_rows))
    want = shortest_path(a, unweighted=True, indices=root)
    require(np.array_equal(res.values.astype(np.float64), want),
            f"BFS values differ from scipy's hop distances at "
            f"{int(np.sum(res.values.astype(np.float64) != want))} vertices")
    reached = int(np.isfinite(want).sum())
    print(f"  values == scipy shortest_path(unweighted) hop distances: "
          f"{reached} reached, depth {int(want[np.isfinite(want)].max())} "
          f"(checked in {time.perf_counter() - t0:.1f} s)")


def same_run(a, b, what: str) -> None:
    require(np.array_equal(a.values, b.values), f"{what}: values differ")
    require(a.run.counters.as_dict() == b.run.counters.as_dict(),
            f"{what}: counters differ")
    require(a.run.trace.to_dict() == b.run.trace.to_dict(),
            f"{what}: trace differs")
    require(a.run.supersteps == b.run.supersteps,
            f"{what}: supersteps differ")
    require(a.run.time_s == b.run.time_s, f"{what}: time_s differs")


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
    rows = kernel_phase(dev)

    print(f"== 4. main path: BFS, backend=kernels, RMAT-{SCALE} on "
          f"{TILES} tiles")
    wl = workload()
    res_k, launches = bfs_run(dev, wl, "kernels")
    check_values(wl["g"], wl["root"], res_k)
    for row in rows:
        row["launches"] = launches[row["name"]]
        require(row["launches"] == res_k.run.supersteps,
                f"{row['name']} launched {row['launches']} times in "
                f"{res_k.run.supersteps} supersteps")
    print(f"  every kernel launched once per superstep "
          f"({res_k.run.supersteps})")
    profile_supersteps(dev, wl)

    print(f"== 5. same run, backend=torch, RMAT-{SCALE} on {TILES} tiles")
    res_t, launches_t = bfs_run(dev, wl, "torch")
    require(not any(launches_t.values()),
            f"backend=torch launched kernels: {launches_t}")
    same_run(res_k, res_t, "kernels vs torch backend")
    print("  kernels and torch backends agree bitwise: values, counters, "
          "trace, supersteps, time_s")

    print(f"== 6. done in {time.perf_counter() - t_start:.1f} s")
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
