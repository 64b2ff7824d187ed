"""The six apps on ranks: 4 chips on 2 gloo ranks against the same call
in one process (``repro_torch.distrib.mesh``, ROADMAP A.5c).

RMAT-8 on 8x8 tiles (4x4 a chip), ``oq_cap=8``; BFS proxy-free, the
others with their Table-II proxies (SpMV with a one-level cascade cut at
the chip boundary), PageRank one epoch.  Each app on both loops (chunks
of 8, and the per-step loop), dense and synchronous, then with
``compaction=2``, ``double_buffer=True``, telemetry and the sanitizer,
on the ``torch`` backend and, chunked with every option, on ``kernels``
(their plain versions here).  Every case must equal its one-process run
bit for bit, add apps included: values, counters, trace, supersteps,
``time_s`` and the summed per-chip ``pc_*`` vectors, on both ranks.

The whole matrix runs in one spawn of two ranks
(``tests/_torch_ranks.py``); each rank first runs every case with no
group, then joins the group and runs it again, and prints one line a
case.  Each case is one parametrised test over the parsed lines.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks

APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
CASES = ([(a, c, o, "torch") for a in APPS for c in (8, 0)
          for o in ("dense", "both")]
         + [(a, 8, "both", "kernels") for a in APPS])

_SNIPPET = r'''
import json
import numpy as np
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
from repro_torch.graph.rmat import histogram_input

g = rmat_edges(8, edge_factor=8, seed=1)
grid = square_grid(64)
bins = g.n_rows // 8
root = int(np.argmax(g.out_degree()))
x = np.random.default_rng(3).random(g.n_cols).astype(np.float32)
hv = histogram_input(g, bins)
OPTS = dict(dense={}, both=dict(compaction=2, double_buffer=True,
                                telemetry=True, sanitize=True))
CASES = json.loads(%r)


def case(name, chunk, opts, backend):
    px = None if name == "bfs" else apps.table2_proxy(
        grid, name, **({"cascade_levels": 1} if name == "spmv" else {}))
    eng, state, _ = apps.engine_and_state(
        name, g, grid, px, root=root, x=x, histo_values=hv, bins=bins,
        chips=4, oq_cap=8, backend=backend, device="cpu", **OPTS[opts])
    st, run = eng.run(state, chunk=chunk)
    vecs = {k: np.asarray(v).tolist()
            for k, v in sorted((eng.last_load_vecs or {}).items())}
    return eng.mesh.ndev, dict(
        counters=run.counters.as_dict(), trace=run.trace.to_dict(),
        steps=run.supersteps, time=repr(run.time_s),
        vals=st["values"].cpu().numpy().tobytes().hex(), vecs=vecs)


one = [case(*c) for c in CASES]
init_group()
for c, (n1, want) in zip(CASES, one):
    ndev, got = case(*c)
    diff = sorted(k for k in want if got[k] != want[k])
    print("CASE", "-".join(map(str, c)), n1, ndev, json.dumps(diff))
'''


def _case_id(c):
    return "-".join(map(str, c))


@pytest.fixture(scope="module")
def case_lines():
    """{case id: [each rank's line]} of the one spawn."""
    outs = run_ranks(_SNIPPET % json.dumps(CASES), 2, group=False)
    lines = {}
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("CASE "):
                _, cid, rest = ln.split(" ", 2)
                lines.setdefault(cid, []).append(rest)
    return lines


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_app_on_two_ranks_equals_one_process(case_lines, case):
    """One process ran the 4 chips with no collective, and each of the
    two ranks ran its 2 chips; nothing differs on either rank."""
    got = case_lines.get(_case_id(case))
    assert got == ["1 2 []", "1 2 []"], got
