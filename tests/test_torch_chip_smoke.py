"""``chip_smoke.warp_runs``: how the ids of one scatter call fall in the
engine kernels' 32-record warp slices (the numbers behind the kernels'
choice of warp fold), against a count made slice by slice in Python."""
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
