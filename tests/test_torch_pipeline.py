"""The port's GPipe schedule (``repro_torch.core.pipeline``) on gloo ranks
against the JAX reference's ``repro.core.pipeline`` on fake XLA devices
(the counterpart of ``tests/test_pipeline_compression.py``'s pipeline
tests).

  * S 4, M 6, MB 2, D 16 with ``tanh(x @ w)`` stages on 4 ranks against
    the reference on 4 devices: every rank's output matches its
    device's, the last stage within 1e-5 (and the sequential stack), the
    others bitwise zeros;
  * S 2 on a two-rank subgroup (ranks 2 and 3 of the four: stage s is
    group rank s, global rank 2 + s) and S 1 on a one-rank subgroup (no
    send: its buffer is its own output), each equal to the sequential
    stack of its stages within 1e-5; a stage count that is not the
    group's size is refused;
  * ``pipeline_bubble_fraction`` equal to the reference's over a table.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _subproc import run_devices
from _torch_ranks import run_ranks

from repro.core import pipeline as J

from repro_torch.core import pipeline as P

S, M, MB, D = 4, 6, 2, 16
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.2).astype(np.float32)
    x = rng.standard_normal((M, MB, 3, D)).astype(np.float32)
    return w, x


def _sequential(w, x):
    for wi in w:
        x = np.tanh(x.astype(np.float64) @ wi)
    return x


_REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.pipeline import run_pipeline
S = {S}
z = np.load({inputs!r})
mesh = jax.make_mesh((S,), ("stage",))


def stage_fn(wi, xi):
    return jnp.tanh(xi @ wi)


def pipe(w_all, x_mb):
    return run_pipeline(stage_fn, w_all[0], x_mb, "stage", S)[None]


f = jax.jit(jax.shard_map(pipe, mesh=mesh, in_specs=(P("stage"), P()),
                          out_specs=P("stage"), check_vma=False))
np.save({dest!r}, np.asarray(f(jnp.asarray(z["w"]), jnp.asarray(z["x"]))))
print("OK")
"""

_PORT = """
import numpy as np
from repro_torch.core.pipeline import run_pipeline, stage_index
z = np.load({inputs!r})
w, x = torch.from_numpy(z["w"]), torch.from_numpy(z["x"])


def stage_fn(wi, xi):
    return torch.tanh(xi @ wi)


out = dict(s4=run_pipeline(stage_fn, w[RANK], x, dist.group.WORLD, 4),
           stage4=stage_index(dist.group.WORLD))
groups = [dist.new_group([2, 3]), dist.new_group([3])]
if RANK >= 2:
    s = stage_index(groups[0])
    out["s2"] = run_pipeline(stage_fn, w[s], x, groups[0], 2)
    out["stage2"] = s
if RANK == 3:
    out["s1"] = run_pipeline(stage_fn, w[0], x, groups[1], 1)
    try:
        run_pipeline(stage_fn, w[0], x, groups[1], 2)
    except ValueError as e:
        out["refused"] = "2 stages on a group of 1 ranks" in str(e)
np.savez({outdir!r} + f"/rank{{RANK}}.npz", **out)
print("DONE", json.dumps(sorted(out)))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    w, x = _inputs()
    np.savez(tmp / "inputs.npz", w=w, x=x)
    out = run_devices(_REFERENCE.format(S=S, inputs=str(tmp / "inputs.npz"),
                                        dest=str(tmp / "ref.npy")), n=S)
    assert "OK" in out
    texts = run_ranks("import json\n" + _PORT.format(
        inputs=str(tmp / "inputs.npz"), outdir=str(tmp)), 4)
    assert all("DONE" in t for t in texts)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return dict(w=w, x=x, ref=np.load(tmp / "ref.npy"), ranks=ranks)


@pytest.mark.parametrize("rank", range(S))
def test_four_stages_match_reference_per_rank(runs, rank):
    got = runs["ranks"][rank]["s4"]
    want = runs["ref"][rank]
    assert got.shape == want.shape == runs["x"].shape
    assert int(runs["ranks"][rank]["stage4"]) == rank
    if rank == S - 1:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, _sequential(runs["w"], runs["x"]),
                                   rtol=TOL, atol=TOL)
    else:
        np.testing.assert_array_equal(want, np.zeros_like(want))
        np.testing.assert_array_equal(got, np.zeros_like(got))


def test_two_stages_on_a_subgroup(runs):
    first, last = runs["ranks"][2], runs["ranks"][3]
    assert (int(first["stage2"]), int(last["stage2"])) == (0, 1)
    np.testing.assert_array_equal(first["s2"], np.zeros_like(first["s2"]))
    np.testing.assert_allclose(last["s2"],
                               _sequential(runs["w"][:2], runs["x"]),
                               rtol=TOL, atol=TOL)
    assert "s2" not in runs["ranks"][0] and "s2" not in runs["ranks"][1]


def test_one_stage_on_a_one_rank_group(runs):
    got = runs["ranks"][3]["s1"]
    np.testing.assert_allclose(got, _sequential(runs["w"][:1], runs["x"]),
                               rtol=TOL, atol=TOL)
    assert bool(runs["ranks"][3]["refused"])


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8, 64])
def test_bubble_fraction_equals_reference(n_stages):
    for m in (1, 2, 6, 12, 100):
        assert P.pipeline_bubble_fraction(n_stages, m) == \
            J.pipeline_bubble_fraction(n_stages, m)
    assert P.pipeline_bubble_fraction(4, 12) == pytest.approx(3 / 15)
