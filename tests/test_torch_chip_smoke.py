"""``chip_smoke.warp_runs``: how the ids of one scatter call fall in the
engine kernels' 32-record warp slices (the numbers behind the kernels'
choice of warp fold), against a count made slice by slice in Python;
and ``chip_smoke.track_counts``, the events of a Perfetto trace by
track."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _by_slice(seg, limit):
    """[live, runs of neighbours, distinct ids a slice, records in a run
    of neighbours, records repeated in their slice, slices with a run,
    slices with a live record], one 32-record slice at a time."""
    s = np.where((seg >= 0) & (seg < limit), seg, -1)
    out = [0] * 7
    for b in range(0, len(s), 32):
        w = s[b:b + 32]
        live = w >= 0
        near = [bool(live[i] and ((i > 0 and w[i - 1] == w[i])
                                  or (i + 1 < len(w) and w[i + 1] == w[i])))
                for i in range(len(w))]
        out[0] += int(live.sum())
        out[1] += sum(1 for i in range(len(w))
                      if live[i] and (i == 0 or w[i] != w[i - 1]))
        out[2] += len(set(w[live].tolist()))
        out[3] += sum(near)
        out[4] += sum(1 for i in range(len(w))
                      if live[i] and int((w[live] == w[i]).sum()) > 1)
        out[5] += int(any(near))
        out[6] += int(live.any())
    return out


@pytest.mark.parametrize("layout", ["random", "sorted", "all padding",
                                    "one id", "past the limit"])
def test_warp_runs_counts_each_slice(layout):
    rng = np.random.default_rng(3)
    n, limit = 1000, 40          # 31 whole slices and a part of one
    if layout == "all padding":
        seg = np.full(n, -1)
    elif layout == "one id":
        seg = np.full(n, 7)
    else:
        seg = rng.integers(-5, limit + (9 if layout == "past the limit"
                                        else 0), n)
        if layout == "sorted":
            seg = np.sort(seg)
    seg = seg.astype(np.int32)
    got = chip_smoke.warp_runs(torch.from_numpy(seg), limit).tolist()
    assert got == _by_slice(seg, limit)


def test_track_counts_of_a_recorded_trace():
    """``chip_smoke.track_counts``: every span and counter event of a
    recorded BFS run's trace, by its process and thread names."""
    from repro_torch import obs
    from repro_torch.core.tilegrid import square_grid
    from repro_torch.graph import apps, rmat_edges
    g = rmat_edges(7, edge_factor=8, seed=1)
    rec = obs.TimelineRecorder()
    apps.bfs(g, 0, square_grid(16), oq_cap=8, run_chunk=4, telemetry=True,
             observer=rec, device="cpu")
    trace = obs.trace_dict(rec)
    counts = chip_smoke.track_counts(trace)
    events = [e for e in trace["traceEvents"] if e["ph"] in ("X", "C")]
    assert sum(counts.values()) == len(events)
    for phase in ("dispatch", "fetch", "account"):
        assert counts[f"host wall-clock / {phase} [X]"] == len(rec.spans)
    assert counts["chip 0 (sim load) [C]"] == sum(
        1 for e in events if e["pid"] == obs.export.PID_CHIP0)
