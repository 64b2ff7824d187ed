"""Chip-loss recovery on ranks (``repro_torch.distrib``, ROADMAP A.5c;
the counterpart of ``tests/test_fault.py::test_chip_loss_on_4_device_mesh``).

A 4-chip BFS (RMAT-8, edge factor 8, seed 1, 16 tiles, ``oq_cap=16``) on
4 gloo ranks, a checkpoint every 3 supersteps, chip 3 lost at superstep 5
on the chunked loop (chunks of 8), against the unfailed run on the same
ranks and against the same faulted run in one process:

  * the mesh is rebuilt on 2 ranks (the largest subset of the 3 others
    that divides 4 chips), the ``reshard`` event says ``devices == 2``,
    and the 2 ranks left out leave the run with no result and no error;
  * values, counters and supersteps equal the unfailed run's, the trace
    rows too, and re-pricing the trace gives ``time_s`` exactly;
  * the checkpoint files the 4-rank run writes (every chip's block,
    written once) equal the one-process run's byte for byte, and the
    JAX package's ``restore_checkpoint`` reads them.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks

from repro.checkpoint.ckpt import restore_checkpoint as jrestore

from repro_torch.checkpoint.ckpt import latest_step

_SNIPPET = r'''
import json
import numpy as np
from repro_torch.core.costmodel import trace_time_s
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import rmat_edges
from repro_torch.graph.apps import engine_and_state
from repro_torch.runtime import FaultInjector

g = rmat_edges(8, edge_factor=8, seed=1)
grid = square_grid(16)
kw = dict(chips=4, oq_cap=16, backend="shard_map", ckpt_every_supersteps=3,
          root=int(np.argmax(g.out_degree())), device="cpu")


def faulted(ckpt_dir):
    eng, state, _ = engine_and_state("bfs", g, grid, **kw)
    inj = FaultInjector(at_superstep=5, chip=3)
    st, run = eng.run(dict(state), chunk=8, fault_injector=inj,
                      ckpt_dir=ckpt_dir)
    return eng, inj, st, run


if RANK == 0:                              # one process, no group
    faulted(%(one)r)
init_group()
eng, state, _ = engine_and_state("bfs", g, grid, **kw)
base_state, base = eng.run(dict(state), chunk=8)
eng2, inj, f_state, f = faulted(%(ranks)r)
print("BUILT", eng.mesh.ndev, inj.fired)
if f is None:
    print("LEFT", eng2.mesh.member, f_state is None)
else:
    ta, tb = base.trace.to_dict(), f.trace.to_dict()
    ta.pop("recovery_events"), tb.pop("recovery_events")
    print("MESH", eng2.mesh.ndev, eng2.mesh.rank, eng2.backend)
    print("EVENTS", json.dumps(f.trace.recovery_events))
    print("EQUAL", np.array_equal(base_state["values"].numpy(),
                                  f_state["values"].numpy()),
          base.counters.as_dict() == f.counters.as_dict(),
          base.supersteps == f.supersteps, ta == tb,
          f.time_s > base.time_s,
          trace_time_s(eng2.cfg.pkg, grid, f.trace) == f.time_s)
'''


@pytest.fixture(scope="module")
def faulted_run(tmp_path_factory):
    """Every rank's stdout and the two checkpoint directories."""
    one = str(tmp_path_factory.mktemp("ckpt_one_process"))
    ranks = str(tmp_path_factory.mktemp("ckpt_ranks"))
    outs = run_ranks(_SNIPPET % dict(one=one, ranks=ranks), 4, group=False)
    return dict(outs=outs, one=one, ranks=ranks)


def _line(out, head):
    got = [ln.split(" ", 1)[1] for ln in out.splitlines()
           if ln.startswith(head + " ")]
    assert len(got) == 1, out
    return got[0]


def test_mesh_rebuilt_on_two_ranks(faulted_run):
    outs = faulted_run["outs"]
    for out in outs:
        assert _line(out, "BUILT") == "4 True"
    assert [_line(o, "MESH") for o in outs[:2]] == \
        ["2 0 shard_map", "2 1 shard_map"]
    for out in outs[:2]:
        ev = json.loads(_line(out, "EVENTS"))
        resh = [e for e in ev if e["kind"] == "reshard"]
        assert len(resh) == 1 and resh[0]["devices"] == 2, ev
        assert resh[0]["chip"] == 3
        assert [e["kind"] for e in ev].count("rollback") == 1


def test_left_out_ranks_leave_cleanly(faulted_run):
    """Ranks 2 and 3 (chip 3's rank, and the one the 2-rank mesh does
    not need) return no result; every rank exited 0."""
    for out in faulted_run["outs"][2:]:
        assert _line(out, "LEFT") == "False True"
        assert "MESH" not in out


def test_faulted_run_equals_unfailed_and_reprices(faulted_run):
    """Values, counters, supersteps and trace rows equal the unfailed
    run's; the recovery is priced apart and re-priced exactly."""
    for out in faulted_run["outs"][:2]:
        assert _line(out, "EQUAL") == "True True True True True True"
    ev = [_line(o, "EVENTS") for o in faulted_run["outs"][:2]]
    assert ev[0] == ev[1]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_checkpoint_bytes_equal_one_process(faulted_run):
    one, ranks = _files(faulted_run["one"]), _files(faulted_run["ranks"])
    assert sorted(one) == sorted(ranks) and len(one) >= 6, sorted(one)
    for name in one:
        assert one[name] == ranks[name], name


def test_reference_reads_the_checkpoint(faulted_run):
    """The JAX package restores the ranks' image: the reference's layout,
    every chip's block stacked in chip order."""
    d = faulted_run["ranks"]
    step = latest_step(d)
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    tmpl = dict(state={k[len("['state']['"):-2]: np.zeros(v["shape"])
                       for k, v in leaves.items()
                       if k.startswith("['state']")},
                flush=np.zeros(()))
    got = jrestore(d, tmpl, step=step)
    assert got["state"]["values"].shape[0] == 4
    assert got["state"]["mail_flag"].dtype == np.bool_
