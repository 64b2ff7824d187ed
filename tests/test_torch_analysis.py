"""The port's analysis passes (``repro_torch.analysis``): one planted
fault a rule, each giving exactly its finding; the spare-row discipline
accepted on both sides of its line; the engine's own cells clean; the
whole CPU gate (``scripts/lint_engine_torch.py --device cpu --ci``)
against the committed baseline; the device rule.  The parity of the
copied ``deadcode`` and of the ``invariants`` cells with the reference
is in ``test_torch_analysis_parity.py``.

Every module is imported by its own name, so the reference's dead-code
walk reaches it."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import deadcode, kernel_races, runner, steplint  # noqa: E402,F401
from repro_torch.analysis.findings import Finding  # noqa: E402
from repro_torch.core import chunk, engine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import lint_engine_torch  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    return runner._inputs()


def _cell(inputs, name="sssp", backend="torch", chips=0, db=False, comp=0):
    return runner._cell_engine(name, backend, chips, inputs, CPU, db,
                               comp)[:2]


def _rules(findings):
    return sorted({f.rule for f in findings})


def _wrap_step(monkeypatch, after):
    """``DataLocalEngine._step`` with ``after(self, new_state, stats)``
    run inside it, before it returns."""
    real = engine.DataLocalEngine._step

    def step(self, *args, **kw):
        new_state, stats = real(self, *args, **kw)
        after(self, new_state, stats)
        return new_state, stats
    monkeypatch.setattr(engine.DataLocalEngine, "_step", step)


# ---------------------------------------------------------------- host-sync
@pytest.mark.parametrize("plant", ["item", "bool", "nonzero", "mask",
                                   "unique"])
def test_planted_host_sync_is_found(monkeypatch, inputs, plant):
    def after(self, new_state, stats):
        v = stats["pending"]
        if plant == "item":
            v.item()
        elif plant == "bool":
            bool(v > 0)
        elif plant == "nonzero":
            torch.nonzero(new_state["mail_flag"])
        elif plant == "mask":
            new_state["values"][new_state["mail_flag"]]
        else:
            torch.unique(new_state["values"])
    _wrap_step(monkeypatch, after)
    eng, state = _cell(inputs)
    findings, _ = steplint.lint_steps(eng, state, "sssp/torch/mono")
    assert _rules(findings) == ["host-sync"]
    # both loops' steps: the chunk runner's and the per-step superstep
    assert {f.message.split(" inside the ")[1].split("'")[0]
            for f in findings} == {"chunked loop", "per-step loop"}


def test_copy_to_the_cpu_is_a_host_sync():
    meta = torch.zeros(3, device="meta")
    assert "to the CPU" in steplint._host_sync(
        "_to_copy", (meta,), dict(device=CPU))
    assert steplint._host_sync("_to_copy", (torch.zeros(3),),
                               dict(device=CPU)) is None
    assert "into a CPU one" in steplint._host_sync(
        "copy_", (torch.zeros(3), meta), {})


# ------------------------------------------------------------- scatter-mode
@pytest.mark.parametrize("op", ["index_put", "index_put_", "index_copy_",
                                "scatter", "setitem"])
def test_planted_repeated_overwrite_on_a_live_row_is_found(
        monkeypatch, inputs, op):
    def after(self, new_state, stats):
        v = new_state["values"]
        idx = torch.tensor([0, 3, 0])          # row 0 written twice
        src = torch.tensor([1.0, 2.0, 3.0])
        if op == "index_put":
            new_state["values"] = v.index_put((idx,), src)
        elif op == "index_put_":
            v.clone().index_put_((idx,), src).sum()
        elif op == "index_copy_":
            new_state["values"] = v.clone().index_copy_(0, idx, src)
        elif op == "scatter":
            new_state["values"] = v.scatter(0, idx, src)
        else:
            w = v.clone()
            w[idx] = src
            new_state["values"] = w
    _wrap_step(monkeypatch, after)
    eng, state = _cell(inputs, "bfs")
    findings, _ = steplint.lint_steps(eng, state, "bfs/torch/mono")
    assert _rules(findings) == ["scatter-mode"]
    assert all("rows [0]" in f.message for f in findings)


def test_combining_and_distinct_writes_are_not_findings():
    t = torch.zeros(5, 2)
    idx = torch.tensor([1, 1, 4])
    with steplint.StepWalk("x") as w:
        a = t.index_put((idx,), torch.ones(3, 2), accumulate=True)
        b = t.index_add(0, idx, torch.ones(3, 2))
        c = t.scatter_reduce(0, torch.tensor([[1, 0], [1, 0]]),
                             torch.ones(2, 2), "amin")
        d = t.clone().index_copy_(0, torch.tensor([4, 0, 2]),
                                  torch.ones(3, 2))
        e = t.scatter(0, torch.tensor([[1, 1]]), 7.0)     # a scalar
        (a + b + c + d + e).sum()
    assert w.findings == [] and w.ops["index_put"] == 1


def test_spare_row_repeats_are_accepted_when_cut_off():
    """The P$ install's discipline: non-writers to one spare row past the
    end, then the row cut off.  Cut before any read: no finding; read
    first, or cut elsewhere: a finding."""
    live = torch.zeros(4, 3)
    spare = torch.tensor([4, 1, 4, 4])       # rows 4 (spare) repeat
    slot = torch.tensor([0, 2, 0, 0])
    vals = torch.arange(4.0)

    def install(read_first=False, cut=4):
        ext = torch.cat([live, live.new_zeros((1, 3))])
        out = ext.index_put((spare, slot), vals)
        if read_first:
            out.sum()
        return out[:cut]
    with steplint.StepWalk("x") as w:
        install()
    assert w.findings == [] and len(w.cut) == 1 and w.cut[0][1] == (4,)
    with steplint.StepWalk("x") as w:
        install(read_first=True)
    assert _rules(w.findings) == ["scatter-mode"]
    with steplint.StepWalk("x") as w:
        install(cut=5)                      # the spare row kept
    assert _rules(w.findings) == ["scatter-mode"]
    with steplint.StepWalk("x") as w:
        ext = torch.cat([live, live.new_zeros((1, 3))])
        ext.index_put((spare, slot), vals)  # never cut: live at the end
    assert _rules(w.findings) == ["scatter-mode"]


@pytest.mark.parametrize("name", ["sssp", "histo"])
def test_engine_pcache_install_cuts_its_spare_row(inputs, name):
    """The engine's P$ install repeats indices only on the spare row: the
    walk sees the repeats and their cut on every step of the plan, and
    finds nothing."""
    eng, state = _cell(inputs, name, comp=2)
    findings, got = steplint.lint_steps(eng, state, f"{name}/torch/mono-c2")
    assert findings == []
    # two installs (tags, values) a step, on both loops, every step
    assert got["spare_row_cuts"] > 0


# ---------------------------------------------------------- bucket-coverage
def _compacted_run(inputs, name, chips=0, db=False):
    rec = steplint.RunRecord()
    with rec:
        runner._run_app(name, "torch", chips, inputs, CPU, rec, db, 2)
    return rec


@pytest.mark.parametrize("name,chips", [("histo", 0), ("spmv", 4),
                                        ("pagerank", 0)])
def test_compacted_engine_forced_dense_is_found(monkeypatch, inputs, name,
                                                chips):
    dense = inputs[1].num_tiles // max(chips, 1)
    rec = _compacted_run(inputs, name, chips, chips > 0)
    assert min(rec.windows) < dense
    assert steplint.lint_bucket_coverage(rec, dense, 2, "x", False) == []
    monkeypatch.setattr(engine.DataLocalEngine, "_window",
                        lambda self, n: None)
    rec = _compacted_run(inputs, name, chips, chips > 0)
    assert set(rec.windows) == {dense}
    findings = steplint.lint_bucket_coverage(rec, dense, 2, "x", False)
    assert _rules(findings) == ["bucket-coverage"] and len(findings) == 1


def test_compaction_switched_off_is_found(inputs):
    rec = steplint.RunRecord()
    with rec:
        runner._run_app("histo", "torch", 0, inputs, CPU, rec)
    findings = steplint.lint_bucket_coverage(rec, 16, 2, "x", False)
    assert [f.message.split(":")[0] for f in findings] == [
        "the compacted run counted no window at all "
        "(engine.window_occupancy.<W>)"]


def test_one_graph_a_key_on_the_card():
    rec = steplint.RunRecord()
    from collections import Counter
    rec.graphs = [dict(steps=Counter({(False, None): 5, (True, 4): 1}),
                       captures=Counter({(False, None): 1}))]
    findings = steplint.lint_bucket_coverage(rec, 16, 0, "x", True)
    assert len(findings) == 1 and "(True, 4)" in findings[0].message
    assert steplint.lint_bucket_coverage(rec, 16, 0, "x", False) == []


# --------------------------------------------------------- int-stat-f32-row
def test_f32_stats_buffer_is_found(monkeypatch, inputs):
    monkeypatch.setattr(chunk, "STATS_DTYPE", torch.float32)
    eng, state = _cell(inputs, "bfs")
    findings, _ = steplint.lint_steps(eng, state, "bfs/torch/mono")
    assert _rules(findings) == ["int-stat-f32-row"]
    assert {f.where for f in findings} >= {"bfs/torch/mono:pending"}


# ------------------------------------------------------ backend-dtype-drift
def test_backend_drift_is_found(monkeypatch, inputs):
    def after(self, new_state, stats):
        if self.cfg.backend == "kernels":
            stats["edges_processed"] = stats["edges_processed"].to(
                torch.float64)
    _wrap_step(monkeypatch, after)
    findings = runner.drift_cell("bfs", inputs, CPU, "bfs/drift")
    assert [f.key for f in findings] == [
        "steplint:backend-dtype-drift:bfs/drift:stats.edges_processed"]


def test_backends_agree_in_step_shapes(inputs):
    for name in ("bfs", "histo"):
        assert runner.drift_cell(name, inputs, CPU, f"{name}/drift") == []


# ------------------------------------------------------- order-dependent-write
def _last_writer_wins(seg, val, n):
    """A planted scatter that overwrites: the last record of a segment
    wins, so the result follows the records' order."""
    ok = seg >= 0
    out = torch.full((n + 1,), float("inf"))
    out[torch.where(ok, seg, n).to(torch.int64)] = val
    return out[:n]


def test_planted_order_dependent_kernel_is_found():
    seg = torch.tensor([0, 3, 3, 7, 1, 0], dtype=torch.int32)
    val = torch.arange(6.0)
    case = ref.Case("planted:min", _last_writer_wins, ref.segment_combine_ref,
                    (seg, val, 8), (0, 1), ("min",))
    findings = kernel_races.check_kernels(CPU, [case])
    assert [f.key for f in findings] == [
        "kernel_races:order-dependent-write:kernels/planted:min[out0]"]


def test_add_outputs_within_tolerance_are_not_findings():
    seg = torch.zeros(1000, dtype=torch.int32)
    val = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    case = ref.Case("sum:add", ops.segment_combine, ref.segment_combine_ref,
                    (seg, val, 1, "add"), (0, 1), ("add",))
    assert kernel_races.check_kernels(CPU, [case]) == []
    exact = case._replace(outs=("min",))          # re-association is seen
    assert _rules(kernel_races.check_kernels(CPU, [exact])) == [
        "order-dependent-write"]


def test_kernel_cases_cover_every_kernel():
    names = {c.name.split(":")[0] for c in ops.analysis_cases()}
    assert names == {k.__name__ for k in ops.KERNELS}


@pytest.mark.parametrize("case", ops.analysis_cases(), ids=lambda c: c.name)
def test_kernel_cases_are_order_free_on_the_cpu(case):
    assert kernel_races.check_case(case, CPU) == []


# --------------------------------------------------------------- the gate
def test_cpu_gate_is_clean_against_the_committed_baseline(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert lint_engine_torch.main(["--device", "cpu", "--ci", "-q",
                                   "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert len(rep["matrix"]) == 60 == len(set(rep["matrix"]))
    base = json.loads((REPO / "analysis_baseline_torch.json").read_text())
    assert {f"{f['pass_name']}:{f['rule']}:{f['where']}"
            for f in rep["findings"]} <= set(base["keys"])
    assert rep["passes"] == list(runner.PASSES)
    assert "OK:" in capsys.readouterr().out


def test_gate_fails_on_a_finding_outside_the_baseline(monkeypatch, tmp_path):
    monkeypatch.setattr(
        runner.deadcode, "check_repo",
        lambda root: ([Finding("deadcode", "dead-module", "m", "x")], {}))
    argv = ["--device", "cpu", "-q", "--apps", "bfs", "--passes",
            "deadcode", "--baseline", str(tmp_path / "none.json")]
    assert lint_engine_torch.main(argv) == 1
    base = tmp_path / "base.json"
    assert lint_engine_torch.main(argv[:-1] + [str(base),
                                               "--update-baseline"]) == 0
    assert json.loads(base.read_text())["keys"] == [
        "deadcode:dead-module:m"]
    assert lint_engine_torch.main(argv[:-1] + [str(base)]) == 0


def test_run_all_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_all(REPO, passes=["deadcode"])
    with pytest.raises(ValueError, match="unknown pass"):
        runner.run_all(REPO, passes=["jaxprlint"], device="cpu")


def test_matrix_names_match_the_reference_layout():
    cells = [runner.cell_name("bfs", b, c, d, k) for b in runner.BACKENDS
             for c, d, k in runner.MATRIX]
    assert cells[:5] == ["bfs/torch/mono", "bfs/torch/4chips",
                         "bfs/torch/4chips-db", "bfs/torch/mono-c2",
                         "bfs/torch/4chips-db-c2"]
    assert np.unique(cells).size == 10
