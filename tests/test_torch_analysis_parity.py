"""The port's analysis passes against the reference's: the copied
``deadcode`` gives the reference's findings and metadata, on this repo
and on a small tree of its own; the ``invariants`` findings of the
port's BFS and SpMV matrix cells equal the reference's ``run_all(
passes=["invariants"])`` for the corresponding cells (``torch`` against
``jnp`` on every row, ``kernels`` against ``pallas`` on the monolithic
one, the only row the reference's Pallas backend takes)."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import deadcode as ref_deadcode  # noqa: E402
from repro.analysis import runner as ref_runner  # noqa: E402
from repro_torch.analysis import deadcode, runner  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _view(findings):
    return [(f.pass_name, f.rule, f.where, f.message, f.severity)
            for f in findings]


def test_deadcode_copy_matches_the_reference_on_the_repo():
    got, got_meta = deadcode.check_repo(REPO)
    want, want_meta = ref_deadcode.check_repo(REPO)
    assert _view(got) == _view(want) and got_meta == want_meta
    assert deadcode.MARKER == ref_deadcode.MARKER
    assert deadcode.ENTRY_DIRS == ref_deadcode.ENTRY_DIRS


def test_deadcode_copy_matches_the_reference_on_a_tree(tmp_path):
    src = tmp_path / "src" / "pkg"
    (src / "sub").mkdir(parents=True)
    (src / "__init__.py").write_text("from . import used\n")
    (src / "used.py").write_text("from .sub import leaf\n")
    (src / "sub" / "__init__.py").write_text("")
    (src / "sub" / "leaf.py").write_text("X = 1\n")
    (src / "dead.py").write_text("Y = 2\n")
    (src / "broken.py").write_text("def (:\n")
    (src / "quar.py").write_text(f"{deadcode.MARKER} kept\nZ = 3\n")
    (tmp_path / "scripts").mkdir()
    (tmp_path / "scripts" / "run.py").write_text("import pkg\n")
    got, got_meta = deadcode.check_repo(tmp_path)
    want, want_meta = ref_deadcode.check_repo(tmp_path)
    assert _view(got) == _view(want) and got_meta == want_meta
    assert got_meta == dict(dead=["pkg.broken", "pkg.dead"],
                            quarantined=["pkg.quar"])


@pytest.fixture(scope="module")
def reference_invariants():
    rep = ref_runner.run_all(REPO, app_names=["bfs", "spmv"],
                             passes=["invariants"])
    return rep


@pytest.mark.parametrize("name", ["bfs", "spmv"])
def test_invariants_cells_match_the_reference(reference_invariants, name):
    torch.set_num_threads(1)
    inputs = runner._inputs()
    pairs = [(b, {"jnp": "torch", "pallas": "kernels"}[b], c, d, k)
             for b, c, d, k in ref_runner.MATRIX]
    cpu = torch.device("cpu")
    for ref_backend, backend, chips, db, comp in pairs:
        where = runner.cell_name(name, backend, chips, db, comp)
        want_where = runner.cell_name(name, ref_backend, chips, db, comp)
        assert want_where in reference_invariants.matrix
        got = runner.run_cell(name, backend, chips, inputs, cpu, where,
                              ["invariants"], db, comp)
        want = [f for f in reference_invariants.findings
                if f.where == want_where]
        assert [(f.rule, f.message) for f in got] == [
            (f.rule, f.message) for f in want], where
