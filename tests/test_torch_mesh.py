"""The port's ``ExecMesh`` (``repro_torch.distrib.mesh``): placement, and
the partitioned engine on ranks of a gloo process group against one
process and against the JAX reference (the counterpart of
``tests/test_mesh.py``).

  * ``largest_dividing_devices`` and ``ExecMesh.build``'s placements
    equal the reference's, with its fallback warning; a non-dividing
    placement raises; without a group every helper is the identity;
  * the reference's 4-chip SSSP snippet (RMAT-8, edge factor 8, seed 1,
    16 tiles, ``oq_cap=32``, synchronous and double-buffered) on 1, 2
    and 4 ranks: every rank prints the same counters, trace, ``time_s``
    and value bytes, those equal across rank counts and equal to the
    reference's same call, run here through JAX;
  * ``gather_records`` hands every rank each sub-stream in chip order,
    sub-stream after sub-stream (the stream one process makes), and a
    group whose backend cannot carry the engine's tensors is refused;
  * 4 chips on 3 ranks warn, run on 2 (the third holds no chip and
    returns no result) and equal the monolithic run.

The ranks run as subprocesses (``tests/_torch_ranks.py``), each pinned to
one thread.
"""
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks

from repro.core.tilegrid import square_grid as jsquare_grid
from repro.distrib.mesh import ExecMesh as JExecMesh
from repro.distrib.mesh import largest_dividing_devices as jlargest
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges

from repro_torch.distrib.mesh import ExecMesh, largest_dividing_devices

RANK_COUNTS = (1, 2, 4)


# --------------------------------------------------------------- placement
def test_largest_dividing_devices():
    for chips in (1, 4, 5, 6, 12, 16):
        for count in range(1, 18):
            assert largest_dividing_devices(chips, count) == \
                jlargest(chips, count), (chips, count)
    assert largest_dividing_devices(4, 3) == 2


def test_build_fallback_warns_and_subsets():
    with pytest.warns(RuntimeWarning, match="largest dividing subset"):
        m = ExecMesh.build(4, "shard_map", device_count=3)
    assert (m.ndev, m.per) == (2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JExecMesh.build(4, "shard_map", device_count=3)
    assert (m.ndev, m.per) == (want.ndev, want.per)


def test_build_modes():
    for backend, dc in (("vmap", 8), ("shard_map", 1), ("auto", 1),
                        ("shard_map", 2), ("auto", 4), ("auto", 3)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = ExecMesh.build(4, backend, device_count=dc)
            want = JExecMesh.build(4, backend, device_count=dc)
        assert (got.ndev, got.per, got.is_sharded) == \
            (want.ndev, want.per, want.is_sharded), (backend, dc)
    m = ExecMesh.build(4, "shard_map", device_count=1)
    assert (m.ndev, m.backend_name, m.collective) == (1, "vmap", False)
    with pytest.raises(ValueError, match="unknown distributed backend"):
        ExecMesh.build(4, "bogus")


def test_mesh_rejects_non_dividing_placement():
    with pytest.raises(ValueError, match="do not divide"):
        ExecMesh(4, 3)


def test_identity_helpers_without_a_group():
    m = ExecMesh(4, 1)
    assert m.chip_ids().tolist() == [0, 1, 2, 3]
    assert m.axis_index() == 0 and m.ranks == (0,)
    x = torch.arange(3.0)
    assert m.psum(x) is x and m.pmax(x) is x and m.all_gather(x) is x
    parts = (torch.arange(3, dtype=torch.int32), x)
    got = m.gather_records(parts, (3,))
    assert got[0] is parts[0] and got[1] is parts[1]
    m.barrier()                               # nothing to wait for


# ------------------------------------------------- runs on gloo ranks
_RUN_SNIPPET = """
import json
import numpy as np
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
g = rmat_edges(8, edge_factor=8, seed=1)
grid = square_grid(16)
root = int(np.argmax(g.out_degree()))
for db in (False, True):
    r = apps.sssp(g, root, grid, oq_cap=32, chips=4, backend="shard_map",
                  double_buffer=db, device="cpu")
    tr = r.run.trace.to_dict()
    tr.pop("double_buffer")
    vals = np.asarray(r.values, np.float32)
    print("COUNTERS", db, json.dumps(r.run.counters.as_dict(),
                                     sort_keys=True))
    print("TRACE", db, json.dumps(tr, sort_keys=True))
    print("TIME", db, repr(r.run.time_s))
    print("VALS", db, vals.tobytes().hex())
"""

# every rank sends rank-stamped records in two sub-streams of 2 and 3
_GATHER_SNIPPET = """
from repro_torch.distrib.mesh import ExecMesh
mesh = ExecMesh.build(WORLD * 2, "shard_map", device="cpu")
base = torch.arange(5, dtype=torch.int32) + 100 * RANK
val = base.to(torch.float32) / 4
idx, v = mesh.gather_records((base, val), (2, 3))
print("GATHER", mesh.rank, mesh.ndev, idx.tolist(), v.tolist())
print("SUMS", mesh.psum(torch.tensor([RANK + 1.0])).tolist(),
      mesh.pmax(torch.tensor([RANK + 1.0])).tolist(),
      mesh.all_gather(mesh.chip_ids()).tolist())
try:
    ExecMesh.build(4, "shard_map", device="cuda")
except ValueError as e:
    print("REFUSED", "gloo" in str(e) and "nccl" in str(e))
"""


def _result_lines(out: str):
    keep = ("COUNTERS", "TRACE", "TIME", "VALS")
    return [ln for ln in out.splitlines() if ln.startswith(keep)]


@pytest.fixture(scope="module")
def rank_runs():
    """{ranks: every rank's stdout} of the snippets, each spawn once."""
    return {n: run_ranks(_RUN_SNIPPET + _GATHER_SNIPPET, n)
            for n in RANK_COUNTS}


@pytest.fixture(scope="module")
def reference_lines():
    """The reference's same 4-chip calls in this process, through JAX."""
    g = jrmat_edges(8, edge_factor=8, seed=1)
    grid = jsquare_grid(16)
    root = int(np.argmax(g.out_degree()))
    lines = []
    for db in (False, True):
        r = japps.sssp(g, root, grid, oq_cap=32, chips=4,
                       backend="shard_map", double_buffer=db)
        tr = r.run.trace.to_dict()
        tr.pop("double_buffer")
        vals = np.asarray(r.values, np.float32)
        lines += [f"COUNTERS {db} " + json.dumps(r.run.counters.as_dict(),
                                                 sort_keys=True),
                  f"TRACE {db} " + json.dumps(tr, sort_keys=True),
                  f"TIME {db} {r.run.time_s!r}",
                  f"VALS {db} {vals.tobytes().hex()}"]
    return lines


@pytest.mark.parametrize("n", RANK_COUNTS)
def test_every_rank_prints_the_same_run(rank_runs, n):
    outs = [_result_lines(o) for o in rank_runs[n]]
    assert len(outs) == n and len(outs[0]) == 8, rank_runs[n][0]
    assert all(o == outs[0] for o in outs[1:])


@pytest.mark.parametrize("n", RANK_COUNTS[1:])
def test_counters_trace_equal_across_rank_counts(rank_runs, n):
    """The same 4-chip run on 1 and on ``n`` ranks: counters, trace,
    ``time_s`` and values bit-identical, synchronous and double-buffered
    alike."""
    assert _result_lines(rank_runs[n][0]) == \
        _result_lines(rank_runs[1][0])


def test_ranks_equal_the_reference(rank_runs, reference_lines):
    assert _result_lines(rank_runs[4][0]) == reference_lines


def test_gather_records_keeps_the_one_process_order(rank_runs):
    """Each sub-stream comes out in rank (so chip) order, sub-stream
    after sub-stream, on every rank; psum, pmax and all_gather reduce and
    gather in rank order."""
    for n in RANK_COUNTS[1:]:
        for rank, out in enumerate(rank_runs[n]):
            got = [ln for ln in out.splitlines()
                   if ln.startswith("GATHER")][0]
            want_idx = ([100 * r + j for r in range(n) for j in (0, 1)]
                        + [100 * r + j for r in range(n) for j in (2, 3, 4)])
            assert got == (f"GATHER {rank} {n} {want_idx} "
                           f"{[i / 4 for i in want_idx]}")
            sums = [ln for ln in out.splitlines()
                    if ln.startswith("SUMS")][0]
            assert sums == (f"SUMS [{n * (n + 1) / 2}] [{float(n)}] "
                            f"{list(range(2 * n))}")


def test_a_group_that_cannot_carry_the_tensors_is_refused(rank_runs):
    for n in RANK_COUNTS[1:]:
        for out in rank_runs[n]:
            assert "REFUSED True" in out.splitlines()


def test_engine_fallback_on_non_dividing_group():
    """4 chips on a 3-rank group: the engine warns, runs on the first 2
    ranks and matches the monolithic run bitwise; the third rank holds
    no chip and returns no result."""
    outs = run_ranks("""
import warnings
import numpy as np
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
g = rmat_edges(8, edge_factor=8, seed=1)
grid = square_grid(16)
root = int(np.argmax(g.out_degree()))
m = apps.bfs(g, root, grid, oq_cap=32, device="cpu")
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    d = apps.bfs(g, root, grid, oq_cap=32, chips=4, backend="shard_map",
                 device="cpu")
warned = any("largest dividing subset" in str(x.message) for x in w)
if d.values is None:
    print("IDLE", warned, d.run is None)
else:
    print("OK", warned, np.array_equal(m.values, d.values),
          bool(d.run.counters.off_chip_msgs > 0))
""", 3)
    assert [o.split() for o in outs] == [["OK", "True", "True", "True"]] * 2 \
        + [["IDLE", "True", "True"]]
