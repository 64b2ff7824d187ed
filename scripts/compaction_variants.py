#!/usr/bin/env python3
"""Time variants of active-set compaction's chunked loop on one CUDA
card: the rule that picks each chunk's window, and the write-back of the
window's rows.

    python3 scripts/compaction_variants.py [--apps bfs,spmv] [--turns 2]

The apps run as ``chip_smoke.py``'s main path runs them (RMAT-22 on a
64x64-tile package, Table-II proxies, backend ``kernels``, 16
supersteps a fetch), with ``compaction=3`` (windows 4096 / 1024 / 256 /
64) except ``dense``.  Variants (``VARIANTS``):

* ``dense``: compaction off, the reference point;
* ``x4``: the committed rule, the smallest window that holds four times
  the active tiles the last fetch counted (``engine.CHUNK_HEADROOM``:
  one rung of headroom, rungs are 4x apart);
* ``exact`` / ``x2``: the smallest window that holds that count / twice
  it;
* ``dense_after_overflow``: the ``exact`` rule, but a chunk after one
  that overflowed runs dense;
* ``copy_write_back``: the committed rule, with the window's rows of
  ``values`` and the cursors written into a full-length copy that the
  chunk runner then selects from (``_front_compact`` without
  ``commit``), where the committed step writes them into the runner's
  static tensors.

Each variant's run is held against the dense run of the same turn
(counters, trace, supersteps and ``time_s`` exact; values bitwise for
BFS, within rtol 1e-4 / atol 1e-5 for SpMV).  The variants run in
turns, forward then backward through the list.  Per run: ms a superstep
of the run loop (``chip_smoke.LoopClock``), host syncs, overflows, idle
rows (the rows of the chunks launched less the supersteps), supersteps
per window run and graphs captured; then each variant's mean over its
turns beside dense's.  Prints one JSON line per run, the means, and the
``nvidia-smi`` name and power limit; exits nonzero if a run disagrees.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                  # noqa: E402
from repro_torch.core import engine                      # noqa: E402
from repro_torch.core.engine import DataLocalEngine      # noqa: E402

VARIANTS = ("dense", "x4", "exact", "x2", "dense_after_overflow",
            "copy_write_back")
HEADROOM = dict(exact=1, x2=2, dense_after_overflow=1)


@contextlib.contextmanager
def patched(variant: str):
    """The engine with ``variant``'s window rule or write-back."""
    window, count = DataLocalEngine._window, DataLocalEngine._count_window
    superstep, headroom = DataLocalEngine._superstep, engine.CHUNK_HEADROOM
    engine.CHUNK_HEADROOM = HEADROOM.get(variant, headroom)
    if variant == "dense_after_overflow":
        def _count_window(eng, w, steps, overflow):
            eng._overflowed = overflow
            return count(eng, w, steps, overflow)

        def _window(eng, n_active):
            return None if eng._overflowed else window(eng, n_active)
        DataLocalEngine._count_window = _count_window
        DataLocalEngine._window = _window
    elif variant == "copy_write_back":
        def _superstep(eng, state, flush=False, w=None, commit=None):
            return superstep(eng, state, flush, w)
        DataLocalEngine._superstep = _superstep
    try:
        yield
    finally:
        DataLocalEngine._window, DataLocalEngine._count_window = window, count
        DataLocalEngine._superstep = superstep
        engine.CHUNK_HEADROOM = headroom


def one_run(dev, app, variant, call):
    fn, args, kw = call
    comp = {} if variant == "dense" else dict(compaction=cs.COMPACTION)
    before = cs.counter_values("engine.")
    with patched(variant):
        res, _, r = cs.app_run(dev, f"{app} {variant}", fn, *args, **comp,
                               **kw)
    moved = cs.counter_deltas(before, cs.counter_values("engine."))
    windows = {int(k.rsplit(".", 1)[1]): int(v) for k, v in moved.items()
               if k.startswith("engine.window_occupancy.")}
    row = dict(app=app, variant=variant, supersteps=r["supersteps"],
               ms_per_superstep=r["ms_per_superstep"],
               host_syncs=int(r["host_syncs"]),
               overflows=int(moved.get("engine.window_overflows", 0)),
               idle_rows=int(r["host_syncs"] * r["chunk"] - r["supersteps"]),
               supersteps_by_window=windows,
               graphs_captured=int(moved.get("engine.graph_captures", 0)),
               peak_gib=r["peak_gib"])
    print(json.dumps(row))
    return res, row


def compare(dev, wl, apps, turns: int, variants) -> list:
    """Every variant of ``variants`` and dense, in turns, for each app of
    ``apps``; prints the runs and the means.  Returns the failures."""
    calls = cs.main_path_apps(wl)
    variants = [v for v in variants if v != "dense"]
    tol = dict(bfs=(None, None), spmv=(cs.AGREE_RTOL, cs.AGREE_ATOL),
               histo=(None, None))
    rows, bad = [], []
    for app in apps:
        for turn in range(turns):
            order = variants if turn % 2 == 0 else variants[::-1]
            dense, row = one_run(dev, app, "dense", calls[app])
            rows.append(row)
            for v in order:
                res, row = one_run(dev, app, v, calls[app])
                rows.append(row)
                try:
                    cs.same_run(dense, res, f"{app} {v} vs dense",
                                *tol[app])
                except cs.SmokeFailure as e:
                    bad.append(str(e))
                del res
            del dense
    print("== means over the turns (ms a superstep; overflows; idle rows; "
          "host syncs)")
    for app in apps:
        dense = np.mean([r["ms_per_superstep"] for r in rows
                         if r["app"] == app and r["variant"] == "dense"])
        for v in ["dense"] + variants:
            mine = [r for r in rows if r["app"] == app and r["variant"] == v]
            ms = [r["ms_per_superstep"] for r in mine]
            print(json.dumps(dict(
                app=app, variant=v, ms_per_superstep=float(np.mean(ms)),
                each=ms, vs_dense=float(dense / np.mean(ms)),
                overflows=[r["overflows"] for r in mine],
                idle_rows=[r["idle_rows"] for r in mine],
                host_syncs=[r["host_syncs"] for r in mine])))
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--apps", default="bfs,spmv")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("compaction_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    c = cs.card()
    cs.build()
    bad = compare(dev, cs.workloads(), a.apps.split(","), a.turns,
                  a.variants.split(","))
    print(c["smi"])
    if bad:
        print("compaction_variants: FAILED: " + "; ".join(bad),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
