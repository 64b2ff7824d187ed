#!/usr/bin/env python3
"""Time the engine's observability and sanitizer hooks on one CUDA card:
BFS at RMAT-22 on 4096 tiles, ``chip_smoke.py``'s main path, on the
chunked loop (16 supersteps a fetch, each a CUDA graph replay).

    python3 scripts/hooks_overhead.py [--turns N]

Variants: ``bare``; ``telemetry`` (``telemetry=True``); ``sanitize``
(``sanitize=True``); ``observer`` (a ``TimelineRecorder``); ``all``
(the three together).  Each turn runs every variant once, forward
through the list on even turns and backward on odd ones (2 turns by
default); every run is held against the first bare run (values
bitwise; counters, trace, supersteps, ``time_s``, host syncs).  Per run:
ms a superstep of the run loop (``chip_smoke.LoopClock``), and of that
the host seconds ``invariants.check_run`` took after the loop.

Then, from one state 20 supersteps into the run, 20 graph replays of
the bare step and of the step with telemetry and the sanitizer: in
turns, unprofiled (host ms a replay, its one fetch included), and once
each under ``torch.profiler`` (device-busy ms and device entries a
superstep).  Prints one JSON line per reading and the ``nvidia-smi``
name and power limit; exits nonzero if a run differs from the bare run.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                  # noqa: E402
from repro_torch import obs                               # noqa: E402
from repro_torch.analysis import invariants               # noqa: E402
from repro_torch.core import engine                       # noqa: E402
from repro_torch.core.tilegrid import square_grid         # noqa: E402
from repro_torch.graph import apps, rmat_edges            # noqa: E402
from repro_torch.obs.metrics import default_registry      # noqa: E402

VARIANTS = ("bare", "telemetry", "sanitize", "observer", "all")
HOOKS = dict(telemetry=True, sanitize=True)
REPLAYS = 20


def hooks_of(name: str) -> dict:
    """The app keywords of a variant (a fresh recorder each call)."""
    if name == "bare":
        return {}
    if name == "observer":
        return dict(observer=obs.TimelineRecorder())
    if name == "all":
        return dict(HOOKS, observer=obs.TimelineRecorder())
    return {name: True}


class CheckRunClock:
    """While entered, sums the host seconds ``invariants.check_run``
    takes (the sanitizer's checks after a run)."""

    def __enter__(self):
        self.seconds = 0.0
        self._check = check = invariants.check_run

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return check(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        invariants.check_run = timed
        return self

    def __exit__(self, *exc):
        invariants.check_run = self._check


def runs(dev, g, grid, root, turns: int) -> bool:
    """Every variant ``turns`` times, in turns; True if all equal bare."""
    syncs = default_registry().counter("engine.host_syncs")
    kw = dict(proxy=apps.table2_proxy(grid, "bfs"), oq_cap=cs.OQ_CAP,
              device=dev)
    want, ok = None, True
    for turn in range(turns):
        order = VARIANTS if turn % 2 == 0 else VARIANTS[::-1]
        for name in order:
            s0 = syncs.value
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with cs.LoopClock() as loop, CheckRunClock() as check:
                res = apps.bfs(g, root, grid, **kw, **hooks_of(name))
            torch.cuda.synchronize()
            host_syncs = syncs.value - s0
            if want is None:
                want = (res, host_syncs)
            try:
                cs.same_run(want[0], res, f"{name} vs bare")
                cs.require(host_syncs == want[1],
                           f"{name}: {host_syncs} host syncs, bare "
                           f"{want[1]}")
            except cs.SmokeFailure as e:
                print(f"DIFFERS: {e}", flush=True)
                ok = False
            n = res.run.supersteps
            print(json.dumps(dict(
                run=name, turn=turn, supersteps=n, host_syncs=host_syncs,
                loop_s=loop.seconds,
                ms_per_superstep=loop.seconds / n * 1e3,
                check_run_s=check.seconds,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)),
                flush=True)
    return ok


def replays(dev, g, grid, root) -> None:
    """``REPLAYS`` replays of the bare step and of the hooked one from
    the same state, in turns, then each under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    runners = {}
    for name, kw in (("bare", {}), ("telemetry+sanitize", HOOKS)):
        eng, state, _ = apps.engine_and_state(
            "bfs", g, grid, apps.table2_proxy(grid, "bfs"), root=root,
            oq_cap=cs.OQ_CAP, device=dev, **kw)
        runner = eng.chunk_runner(state, REPLAYS)
        runner.launch(10 ** 6, False)        # eager step, capture, replays
        runner.fetch()
        runners[name] = runner
    ms = {name: [] for name in runners}
    for name in list(runners) + list(runners)[::-1]:
        runner = runners[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.launch(10 ** 6, False)
        got = runner.fetch()
        ms[name].append((time.perf_counter() - t0) / REPLAYS * 1e3)
        cs.require(got.rows[:, -1].sum() == REPLAYS,
                   f"{name}: a replay was idle")
    print(json.dumps(dict(reading=f"{REPLAYS} replays, unprofiled, in "
                                  f"turns", ms_per_replay=ms,
                          fetch_bytes={n: r.rows.numel() * 8
                                       + r.vecs.numel() * 4
                                       for n, r in runners.items()})),
          flush=True)
    for name, runner in runners.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.launch(10 ** 6, False)
            runner.fetch()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        cs._profile_report(prof, wall, REPLAYS, f"bfs, {name}")


def main() -> int:
    if not torch.cuda.is_available():
        print("hooks_overhead: no CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    turns = int(argv[argv.index("--turns") + 1]) if "--turns" in argv else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cs.build()
    t0 = time.perf_counter()
    g = rmat_edges(cs.SCALE, edge_factor=cs.EDGE_FACTOR, seed=cs.SEED)
    grid = square_grid(cs.TILES)
    root = int(np.argmax(g.out_degree()))
    print(f"RMAT-{cs.SCALE} made in {time.perf_counter() - t0:.1f} s; "
          f"{grid.describe()}; oq_cap {cs.OQ_CAP}; chunk "
          f"{engine.EngineConfig.run_chunk}", flush=True)
    ok = runs(dev, g, grid, root, turns)
    replays(dev, g, grid, root)
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
