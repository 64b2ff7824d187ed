"""The port's fault tolerance (``repro_torch.runtime``, the partitioned
engine's checkpoints and chip-loss recovery) on its own, and its
numpy-only runtime pieces against the JAX reference's (the counterpart
of ``tests/test_fault.py``; the recovery runs against the reference's
are ``tests/test_torch_fault_parity.py``).

RMAT-8 (edge factor 8) on 16 tiles at 4 chips, ``oq_cap=16``: the
reference test's sizes.

  * the copied ``straggler`` functions equal the reference's on seeded
    loads, ``FaultInjector.seeded`` draws the reference's loss point and
    chip, and ``FaultTolerantLoop`` rolls its history back with the
    state, budgets retries per step and gives up on a step that always
    fails (``tests/test_fault.py``'s three loop tests, on tensors);
  * every app on the chunked loop (``torch`` backend) recovers from a
    seeded chip loss bitwise equal to its unfailed run: values,
    counters, trace, supersteps; the recovery priced apart and
    re-priced exactly;
  * the restore goes into the chunk runner's tensors (every static
    tensor keeps its ``data_ptr()``), a double-buffered checkpoint holds
    no ``DEFERRED`` buffer and the folded ``mail_val``, and a resume
    from it equals the run that went on;
  * ``ckpt_every_supersteps`` on the monolithic engine is accepted and
    has no effect: the run equals the reference's.
"""
import json
import os
import tempfile
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.tilegrid import square_grid as jsquare_grid
from repro.graph import apps as japps
from repro.graph import rmat_edges as jrmat_edges
from repro.runtime import fault as jfault
from repro.runtime import straggler as jstraggler

from repro_torch.core import engine
from repro_torch.core.costmodel import trace_time_s
from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.runtime import fault, straggler
from repro_torch.runtime import (FaultInjector, FaultTolerantLoop,
                                 SimulatedFailure)

GRID = square_grid(16)
CHIPS = 4
ALL_APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: beside other test workers, many-threaded ops
    wait on threads that are not scheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def g():
    return rmat_edges(8, edge_factor=8, seed=1)


def _engine(name, g, **kw):
    """``tests/test_fault.py``'s ``_engine``, on the CPU."""
    kw.setdefault("chips", CHIPS)
    kw.setdefault("oq_cap", 16)
    kw.setdefault("device", "cpu")
    if name in ("bfs", "sssp"):
        kw.setdefault("root", int(np.argmax(g.out_degree())))
    if name == "histo":
        bins = g.n_rows // 8
        return apps.engine_and_state(name, g, GRID,
                                     histo_values=histogram_input(g, bins),
                                     bins=bins, **kw)
    return apps.engine_and_state(name, g, GRID, **kw)


def assert_same_run(base_state, base, f_state, f):
    """Values, counters, supersteps and the trace's rows bitwise."""
    assert torch.equal(base_state["values"], f_state["values"])
    assert base.counters.as_dict() == f.counters.as_dict()
    assert base.supersteps == f.supersteps
    tb, tf = base.trace.to_dict(), f.trace.to_dict()
    tb.pop("recovery_events", None), tf.pop("recovery_events", None)
    assert tb == tf


# ------------------------------------------------- the copied runtime
@pytest.mark.parametrize("seed", range(4))
def test_straggler_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        t = int(rng.integers(2, 65))
        n_items = int(rng.integers(t, 5000))
        load = rng.random(t) * 10 ** rng.integers(0, 6)
        if seed == 3:
            load[rng.integers(0, t)] = 1e9        # one molten-hot chunk
        ratio = float(rng.uniform(1.05, 4.0))
        got = straggler.rebalance_chunks(load, n_items, max_ratio=ratio)
        want = jstraggler.rebalance_chunks(load, n_items, max_ratio=ratio)
        assert np.array_equal(got, want)
        assert got[0] == 0 and got[-1] == n_items
        assert (np.diff(got) >= 0).all()
        for thr in (1.5, 2.0):
            m, r = straggler.detect_stragglers(load, thr)
            jm, jr = jstraggler.detect_stragglers(load, thr)
            assert np.array_equal(m, jm) and r == jr
    cap = rng.random(16) * 100
    assert np.array_equal(straggler.rebalance_experts(cap, 8),
                          jstraggler.rebalance_experts(cap, 8))


@pytest.mark.parametrize("seed", (0, 1, 7, 12345))
def test_injector_seeded_matches_reference(seed):
    for steps, chips in ((1, 1), (40, 4), (5950, 16)):
        got = FaultInjector.seeded(seed, steps, chips)
        want = jfault.FaultInjector.seeded(seed, steps, chips)
        assert (got.at_superstep, got.chip) == (want.at_superstep,
                                                want.chip)
        assert 1 <= got.at_superstep <= steps and 0 <= got.chip < chips
    inj = FaultInjector(at_superstep=5, chip=2)
    inj.poll(4)
    with pytest.raises(fault.ChipLostError) as err:
        inj.poll(8)
    assert (err.value.chip, err.value.at_step) == (2, 8)
    inj.poll(9)                                   # fires once


def _loop(tmp_path, hook=None, **kw):
    def train_step(state, batch):
        s = state + batch
        return s, {"loss": s.clone()}

    return FaultTolerantLoop(
        train_step=train_step,
        batch_at=lambda step: torch.tensor(float(step + 1),
                                           dtype=torch.float64),
        ckpt_dir=str(tmp_path), failure_hook=hook, **kw)


def _zero():
    return torch.zeros((), dtype=torch.float64)


def test_loop_history_rolls_back_with_state(tmp_path):
    """A rollback replays steps; their metrics must not double-count."""
    fails = {5: 1}

    def hook(step):
        if fails.get(step, 0) > 0:
            fails[step] -= 1
            raise SimulatedFailure(f"step {step}")

    state, history = _loop(tmp_path / "a", hook, ckpt_every=2).run(_zero(),
                                                                     8)
    ref_state, ref_history = _loop(tmp_path / "b", ckpt_every=2).run(
        _zero(), 8)
    assert torch.equal(state, ref_state)
    assert [h["loss"].item() for h in history] == \
        [h["loss"].item() for h in ref_history]   # one entry per step
    assert len(history) == 8


def test_loop_retry_budget_is_per_step(tmp_path):
    """Two different flaky steps each get the full budget."""
    fails = {2: 2, 5: 2}

    def hook(step):
        if fails.get(step, 0) > 0:
            fails[step] -= 1
            raise SimulatedFailure(f"step {step}")

    state, history = _loop(tmp_path / "c", hook, ckpt_every=2,
                           max_retries_per_step=2).run(_zero(), 8)
    assert len(history) == 8
    assert state.item() == float(sum(range(1, 9)))


def test_loop_gives_up_on_persistent_step(tmp_path):
    """A step that always fails exhausts its budget even though the
    rollback replays earlier (succeeding) steps in between."""
    calls = [0]

    def hook(step):
        if step == 3:
            calls[0] += 1
            raise SimulatedFailure("always")

    loop = _loop(tmp_path / "d", hook, ckpt_every=2, max_retries_per_step=3)
    with pytest.raises(SimulatedFailure):
        loop.run(_zero(), 8)
    assert calls[0] == 4                   # initial try + 3 retries


# ------------------------------------- recovery against the unfailed run
@pytest.mark.parametrize("name", ALL_APPS)
def test_chip_loss_recovers_bitwise_chunked(name, g, tmp_path):
    """A seeded loss on the chunked loop, ``torch`` backend: bitwise the
    unfailed run, the overhead priced apart and re-priced exactly."""
    kw = dict(ckpt_every_supersteps=3, backend="torch")
    eng, state, _ = _engine(name, g, **kw)
    base_state, base = eng.run(dict(state), chunk=8)
    eng2, state2, _ = _engine(name, g, **kw)
    inj = FaultInjector.seeded(zlib.crc32(name.encode()),
                               max_superstep=base.supersteps,
                               num_chips=CHIPS)
    f_state, f = eng2.run(dict(state2), chunk=8, fault_injector=inj,
                          ckpt_dir=str(tmp_path / name))
    assert inj.fired
    assert_same_run(base_state, base, f_state, f)
    assert all(ev["kind"] == "checkpoint"
               for ev in base.trace.recovery_events)
    kinds = [ev["kind"] for ev in f.trace.recovery_events]
    assert kinds[0] == "checkpoint" and kinds.count("rollback") == 1
    reshard = [ev for ev in f.trace.recovery_events
               if ev["kind"] == "reshard"]
    assert len(reshard) == 1 and reshard[0]["devices"] == 1
    assert f.cycles > base.cycles
    assert trace_time_s(eng2.cfg.pkg, GRID, f.trace) == f.time_s


def test_default_checkpoint_dir_is_removed(g, monkeypatch):
    """Without ``ckpt_dir`` the run writes into a fresh temporary
    directory and removes it when it ends."""
    made = []
    real = tempfile.mkdtemp

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    monkeypatch.setattr(tempfile, "mkdtemp", spy)
    eng, state, _ = _engine("bfs", g, ckpt_every_supersteps=2)
    _, f = eng.run(dict(state), chunk=8, fault_injector=FaultInjector(5))
    assert len(made) == 1 and not os.path.exists(made[0])
    assert [ev["kind"] for ev in f.trace.recovery_events][:3] == [
        "checkpoint", "rollback", "reshard"]


# ------------------------------------------------ the port's mechanics
def test_restore_keeps_runner_tensors(g):
    """``ChunkRunner.load`` copies a state into the static tensors the
    graphs replay over: every ``data_ptr()`` stays, the carry restarts,
    and a chunk from the loaded state equals one from a fresh runner."""
    eng, state, _ = _engine("spmv", g, double_buffer=True, compaction=2)
    runner = eng.chunk_runner(state, 4)
    ptrs = {k: v.data_ptr() for k, v in runner.state.items()}
    flags = [t.data_ptr() for t in (runner.flush, runner.done,
                                    runner.overflow)]
    runner.launch(1000, False)
    mid = runner.fetch()
    image = eng.kernel.checkpoint_image(
        {k: v.clone() for k, v in runner.state.items()})
    runner.launch(1000, mid.flush)
    want = runner.fetch()
    runner.load(eng.kernel._with_deferred(image), mid.flush)
    assert {k: v.data_ptr() for k, v in runner.state.items()} == ptrs
    assert [t.data_ptr() for t in (runner.flush, runner.done,
                                   runner.overflow)] == flags
    assert not runner.done.item() and runner.flush.item() == mid.flush
    runner.launch(1000, mid.flush)
    got = runner.fetch()
    assert np.array_equal(got.rows, want.rows)
    with pytest.raises(ValueError):
        runner.load(image, False)              # no DEFERRED buffer


def test_db_checkpoint_holds_folded_mailbox(g, tmp_path):
    """A double-buffered chunked run's checkpoints hold the reference's
    carry keys (no ``DEFERRED``) with the deferred values folded into
    ``mail_val``."""
    eng, state, _ = _engine("sssp", g, double_buffer=True,
                            ckpt_every_supersteps=2)
    runner = eng.chunk_runner(state, 3)
    runner.launch(1000, False)
    runner.fetch()
    raw = runner.state
    assert torch.any(raw[engine.DEFERRED] != float("inf"))
    image = eng.kernel.checkpoint_image(raw)
    assert engine.DEFERRED not in image
    assert torch.equal(image["mail_val"], torch.minimum(
        raw["mail_val"], raw[engine.DEFERRED]))
    f_state, f = eng.run(dict(state), chunk=3, ckpt_dir=str(tmp_path))
    steps = [ev["step"] for ev in f.trace.recovery_events]
    assert len(steps) > 2
    with open(os.path.join(tmp_path, f"step_{steps[1]:08d}",
                           "manifest.json")) as fh:
        leaves = json.load(fh)["leaves"]
    assert sorted(leaves) == sorted(
        ["['flush']"] + [f"['state'][{k!r}]" for k in state])
    assert leaves["['state']['mail_val']"]["shape"] == \
        list(state["mail_val"].shape)


@pytest.mark.parametrize("chunk", (0, 8))
def test_monolithic_cadence_is_inert(g, chunk):
    """The monolithic engine accepts ``ckpt_every_supersteps`` and, as
    the reference's, never reads it: the run equals the port's run
    without it and the reference's run with it."""
    base = apps.bfs(g, 0, GRID, oq_cap=16, run_chunk=chunk, device="cpu")
    got = apps.bfs(g, 0, GRID, oq_cap=16, run_chunk=chunk,
                   ckpt_every_supersteps=2, device="cpu")
    want = japps.bfs(jrmat_edges(8, edge_factor=8, seed=1), 0,
                     jsquare_grid(16), oq_cap=16, run_chunk=chunk,
                     ckpt_every_supersteps=2)
    for other in (base, want):
        assert np.array_equal(got.values, np.asarray(other.values))
        assert got.run.counters.as_dict() == other.run.counters.as_dict()
        assert got.run.trace.to_dict() == other.run.trace.to_dict()
        assert got.run.time_s == other.run.time_s
