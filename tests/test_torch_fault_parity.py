"""The port's chip-loss recovery against the JAX reference's faulted runs
(``tests/test_fault.py``'s app scenarios; its matrix, re-pricing,
cadence and straggler plan are ``tests/test_torch_fault_matrix.py``).

RMAT-8 (edge factor 8) on 16 tiles at 4 chips, ``oq_cap=16``,
``ckpt_every_supersteps=3``: the reference test's sizes.

  * every app on the per-step loop with a seeded injector, and BFS,
    SSSP and WCC on the chunked loop (``chunk=8``): values (min apps
    bitwise, add apps within ``tests/test_distrib.py``'s tolerance),
    counters, trace, supersteps, ``time_s`` and ``recovery_events``
    equal to the reference's faulted run;
  * the write-back apps on the chunked loop: a chunk of the port ends
    where the device schedules a flush (ROADMAP C, "Span boundaries"),
    so their checkpoints may fall on other supersteps; the events agree
    in everything but the steps, and the run equals the port's unfailed
    one (``tests/test_torch_fault.py``).
"""
import zlib

import pytest

torch = pytest.importorskip("torch")

from _torch_fault_runs import (ALL_APPS, GRID, MIN_APPS,
                               assert_matches_reference, faulted,
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


# ---------------------------------------------------- against the reference
@pytest.mark.parametrize("name", ALL_APPS)
def test_per_step_recovery_matches_reference(graphs, name):
    seed = zlib.crc32(name.encode())
    got = faulted(graphs, name, False, chunk=0, seed=seed)
    want = faulted(graphs, name, True, chunk=0, seed=seed)
    assert_matches_reference(got, want, name)
    kinds = [ev["kind"] for ev in got[1].trace.recovery_events]
    assert kinds[0] == "checkpoint" and "rollback" in kinds
    assert any(ev["kind"] == "reshard" and ev["devices"] == 1
               for ev in got[1].trace.recovery_events)


@pytest.mark.parametrize("name", MIN_APPS)
def test_chunked_recovery_matches_reference(graphs, name):
    seed = zlib.crc32(name.encode())
    got = faulted(graphs, name, False, chunk=8, seed=seed)
    want = faulted(graphs, name, True, chunk=8, seed=seed)
    assert_matches_reference(got, want, name)


@pytest.mark.parametrize("name", ("pagerank", "spmv", "histo"))
def test_write_back_events_differ_only_in_steps(graphs, name):
    """Trap of the span boundaries: the write-back apps' checkpoints may
    fall on other supersteps than the reference's on the chunked loop;
    the run itself still equals the reference's."""
    seed = zlib.crc32(name.encode())
    got = faulted(graphs, name, False, chunk=8, seed=seed)
    want = faulted(graphs, name, True, chunk=8, seed=seed)
    assert_matches_reference(got, want, name, events=False)
    steps = ("step", "from_step", "at_step")
    ev_g, ev_w = (r[1].trace.recovery_events for r in (got, want))
    assert [{k: v for k, v in e.items() if k not in steps} for e in ev_g] \
        == [{k: v for k, v in e.items() if k not in steps} for e in ev_w]
    assert trace_time_s(got[2].cfg.pkg, GRID,
                        got[1].trace) == got[1].time_s
