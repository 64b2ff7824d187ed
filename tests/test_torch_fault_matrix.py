"""The port's chip-loss recovery across its loops and options against
the JAX reference's (``tests/test_fault.py``'s matrix, re-pricing and
cadence tests and its straggler plan; the apps are
``tests/test_torch_fault_parity.py``).

RMAT-8 (edge factor 8) on 16 tiles at 4 chips, ``oq_cap=16``,
``ckpt_every_supersteps=3``: the reference test's sizes.

  * the matrix chunk 0 / 8 x ``double_buffer`` x ``compaction`` 0 / 2
    for BFS lost at superstep 5 on chip 2: equal to the reference's
    faulted run and to the port's unfailed one, at a higher cost;
  * re-pricing a faulted trace gives its ``time_s`` exactly, double
    buffer on and off; a cadence with no loss changes nothing but the
    event log;
  * ``rebalance_plan`` equals the reference's (and, after a faulted
    run, the unfailed run's: the summed vectors roll back), and raises
    ``ValueError`` without telemetry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_fault_runs import (CHIPS, GRID, assert_matches_reference,
                               assert_same_run, base_run, faulted,
                               make_graphs)

from repro_torch.core.costmodel import trace_time_s


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: beside other test workers, many-threaded ops
    wait on threads that are not scheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graphs():
    return make_graphs()


@pytest.mark.parametrize("chunk", (0, 8))
@pytest.mark.parametrize("double_buffer", (False, True))
@pytest.mark.parametrize("compaction", (0, 2))
def test_chip_loss_matrix(graphs, chunk, double_buffer, compaction):
    kw = dict(chunk=chunk, at=5, chip=2, double_buffer=double_buffer,
              compaction=compaction)
    got = faulted(graphs, "bfs", False, **kw)
    want = faulted(graphs, "bfs", True, **kw)
    assert_matches_reference(got, want, "bfs")
    base = base_run(graphs, "bfs", False, chunk=chunk,
                 double_buffer=double_buffer, compaction=compaction)
    assert_same_run(base, got)
    # the faulted run costs strictly more: overhead is priced, not lost
    assert got[1].cycles > base[1].cycles


@pytest.mark.parametrize("double_buffer", (False, True))
def test_faulted_run_reprices_exactly(graphs, double_buffer):
    f_state, f, eng = faulted(graphs, "bfs", False, chunk=8, at=5,
                               double_buffer=double_buffer)
    t = trace_time_s(eng.cfg.pkg, GRID, f.trace)
    assert t == f.time_s
    _, base, _ = base_run(graphs, "bfs", False, chunk=8,
                       double_buffer=double_buffer)
    assert trace_time_s(eng.cfg.pkg, GRID, base.trace) == \
        base.time_s
    want = faulted(graphs, "bfs", True, chunk=8, at=5,
                    double_buffer=double_buffer)
    assert f.time_s == want[1].time_s


def test_checkpoint_cadence_alone_is_inert(graphs):
    base = base_run(graphs, "bfs", False, chunk=8, ckpt_every_supersteps=0)
    cad = base_run(graphs, "bfs", False, chunk=8, ckpt_every_supersteps=2)
    assert_same_run(base, cad)
    events = cad[1].trace.recovery_events
    assert all(ev["kind"] == "checkpoint" for ev in events)
    assert len(events) > 1 and not base[1].trace.recovery_events
    assert cad[1].cycles > base[1].cycles
    assert trace_time_s(cad[2].cfg.pkg, GRID,
                        cad[1].trace) == cad[1].time_s
    want = base_run(graphs, "bfs", True, chunk=8, ckpt_every_supersteps=2)
    assert_matches_reference(cad, want, "bfs")


@pytest.mark.parametrize("chunk", (0, 8))
def test_rebalance_plan_matches_reference(graphs, chunk):
    _, _, eng = base_run(graphs, "bfs", False, chunk=chunk, telemetry=True)
    _, _, jeng = base_run(graphs, "bfs", True, chunk=chunk, telemetry=True)
    plan, want = eng.rebalance_plan(), jeng.rebalance_plan()
    assert sorted(plan) == sorted(want)
    for k in plan:
        assert np.array_equal(np.asarray(plan[k]), np.asarray(want[k])), k
    assert plan["load"].shape == (CHIPS,)
    assert plan["boundaries"][-1] == GRID.num_tiles * eng.Cd
    # a faulted run's plan is its unfailed run's: the sums roll back
    f = faulted(graphs, "bfs", False, chunk=chunk, at=5, telemetry=True)
    fplan = f[2].rebalance_plan()
    for k in plan:
        assert np.array_equal(np.asarray(fplan[k]), np.asarray(plan[k])), k
    _, _, off = base_run(graphs, "bfs", False, chunk=chunk)
    with pytest.raises(ValueError):
        off.rebalance_plan()
