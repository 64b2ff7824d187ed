"""The port's checkpoints (``repro_torch.checkpoint.ckpt``,
``repro_torch.runtime.elastic``) against the JAX reference's
(the counterpart of ``tests/test_checkpoint.py``).

  * trees of f32, int32, bool, f16 and bf16 tensors (and numpy arrays)
    in nested dicts, lists and tuples round-trip bit for bit;
  * ``latest_step`` picks the newest of several steps and ignores a
    ``.tmp`` left by a write that died; a template of another shape is
    rejected;
  * the on-disk layout is the reference's: a checkpoint that
    ``repro.checkpoint.ckpt.save_checkpoint`` wrote (bf16 included) is
    restored by the port bit-equal, and the reverse;
  * ``AsyncCheckpointer`` lands its writes in order, each the tree as
    it was when ``save`` returned; ``reshard_checkpoint`` places every
    leaf where ``placement`` says;
  * ``FaultTolerantLoop`` on a small torch regression: it recovers from
    an injected failure (the analogue of ``test_fault_tolerant_loop_
    recovers``) and gives up after its retries.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import ml_dtypes

from repro.checkpoint import ckpt as jckpt

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.runtime import elastic, fault


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f32 = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    return dict(
        state=dict(values=f32, ids=torch.arange(7, dtype=torch.int32),
                   mask=torch.from_numpy(rng.random(6) < 0.5)),
        half=[f32.to(torch.float16), (f32.to(torch.bfloat16),
                                      np.float32(2.5))],
        flush=np.asarray(True), skipped=None)


def _bits(x):
    """A leaf's bytes and logical dtype, whatever package made it."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), name
        return x.numpy().tobytes(), name
    a = np.asarray(x)
    return a.tobytes(), a.dtype.name


def _leaves(tree):
    return {k: _bits(v) for k, v in ckpt.flatten(tree).items()}


def test_roundtrip_dtypes(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(str(tmp_path), 7, tree, dict(note="x"))
    assert os.path.basename(path) == "step_00000007"
    assert latest_step(str(tmp_path)) == 7
    back = restore_checkpoint(str(tmp_path), tree)
    assert isinstance(back["half"][1], tuple) and back["skipped"] is None
    assert _leaves(back) == _leaves(tree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["extra"] == dict(note="x")
    assert manifest["leaves"]["['half'][1][0]"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["['state']['values']"]["shape"] == [4, 5]
    # the reference's key strings, dict keys sorted
    assert list(manifest["leaves"]) == [
        "['flush']", "['half'][0]", "['half'][1][0]", "['half'][1][1]",
        "['state']['ids']", "['state']['mask']", "['state']['values']"]


def test_latest_step_skips_tmp(tmp_path):
    tree = _tree()
    for s in (1, 5, 3):
        ckpt.save_checkpoint(str(tmp_path), s, tree)
    os.makedirs(tmp_path / "step_00000009.tmp")     # a write that died
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "absent"), tree)


def test_shape_mismatch_rejected(tmp_path):
    tree = _tree()
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    bad = ckpt.tree_map(
        lambda x: torch.zeros((3,) + tuple(np.shape(x))), tree)
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), bad)
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), dict(extra=torch.zeros(2)))


def test_reference_checkpoint_restored_bit_equal(tmp_path):
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((3, 8)).astype(np.float32)
    jtree = dict(state=dict(values=jnp.asarray(vals),
                            bf=jnp.asarray(vals, jnp.bfloat16),
                            ids=np.arange(5, dtype=np.int32),
                            mask=np.array([True, False, True])),
                 flush=np.asarray(False))
    jckpt.save_checkpoint(str(tmp_path), 4, jtree)
    template = dict(state=dict(
        values=torch.empty((3, 8), device="meta"),
        bf=torch.empty((3, 8), dtype=torch.bfloat16, device="meta"),
        ids=torch.empty(5, dtype=torch.int32, device="meta"),
        mask=torch.empty(3, dtype=torch.bool, device="meta")),
        flush=torch.empty((), dtype=torch.bool, device="meta"))
    got = restore_checkpoint(str(tmp_path), template)
    assert got["state"]["bf"].dtype == torch.bfloat16
    assert got["state"]["mask"].dtype == torch.bool
    assert _leaves(got) == _leaves(jtree)


def test_port_checkpoint_restored_by_reference_bit_equal(tmp_path):
    tree = _tree(2)
    ckpt.save_checkpoint(str(tmp_path), 6, tree)
    template = ckpt.tree_map(np.asarray, ckpt.tree_map(
        lambda x: x.float() if isinstance(x, torch.Tensor) else x, tree))
    back = jckpt.restore_checkpoint(str(tmp_path), template)
    got = _leaves(back)
    want = _leaves(tree)
    assert got == want
    assert back["half"][1][0].dtype == ml_dtypes.bfloat16


def test_async_checkpointer_lands_in_order(tmp_path):
    writer = ckpt.AsyncCheckpointer(str(tmp_path))
    x = torch.zeros(1000)
    for step in range(1, 5):
        x += 1                       # the tree as save() saw it is kept
        writer.save(step, dict(x=x), extra_meta=dict(step=step))
    writer.wait()
    assert writer.last_path.endswith("step_00000004")
    assert latest_step(str(tmp_path)) == 4
    for step in range(1, 5):
        got = restore_checkpoint(str(tmp_path), dict(x=x), step=step)
        assert torch.equal(got["x"], torch.full((1000,), float(step)))
    # a write that fails raises at the next wait, not in the thread
    (tmp_path / "file").write_text("")
    bad = ckpt.AsyncCheckpointer(str(tmp_path / "file"))
    bad.save(1, dict(x=x))
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()


def test_reshard_checkpoint_onto_cpu(tmp_path):
    tree = _tree(3)
    ckpt.save_checkpoint(str(tmp_path), 2, tree)
    placed = []

    def placement(path, shape):
        placed.append((path, shape))
        return torch.device("cpu") if path.startswith("['state']") else None

    got = elastic.reshard_checkpoint(str(tmp_path), tree, placement)
    assert _leaves(got) == _leaves(tree)
    assert all(v.device.type == "cpu"
               for v in ckpt.flatten(got["state"]).values())
    assert ("['state']['values']", (4, 5)) in placed
    assert len(placed) == len(ckpt.flatten(tree))


# ------------------------------------- FaultTolerantLoop on torch tensors
def _regression():
    gen = torch.Generator().manual_seed(0)
    w_true = torch.randn(8, generator=gen)

    def batch_at(step):
        g = torch.Generator().manual_seed(1000 + step)
        x = torch.randn(16, 8, generator=g)
        return x, x @ w_true

    def train_step(state, batch):
        x, y = batch
        err = x @ state["w"] - y
        grad = 2.0 * x.T @ err / x.shape[0]
        return (dict(w=state["w"] - 0.05 * grad, step=state["step"] + 1),
                dict(loss=torch.mean(err * err)))

    return train_step, batch_at, dict(w=torch.zeros(8),
                                      step=torch.zeros((), dtype=torch.int64))


def test_fault_tolerant_loop_recovers(tmp_path):
    train_step, batch_at, state = _regression()
    fails = {"at": 12, "done": False}

    def hook(i):
        if i == fails["at"] and not fails["done"]:
            fails["done"] = True
            raise fault.SimulatedFailure(f"injected at step {i}")

    loop = fault.FaultTolerantLoop(train_step, batch_at, str(tmp_path),
                                   ckpt_every=5, failure_hook=hook)
    got, history = loop.run(dict(state), 15)
    ref, ref_history = fault.FaultTolerantLoop(
        train_step, batch_at, str(tmp_path / "ref"), ckpt_every=5).run(
        dict(state), 15)
    assert fails["done"]
    assert latest_step(str(tmp_path)) == 15
    assert len(history) == 15
    assert torch.equal(got["w"], ref["w"]) and int(got["step"]) == 15
    assert [h["loss"].item() for h in history] == \
        [h["loss"].item() for h in ref_history]
    assert history[-1]["loss"] < history[0]["loss"]


def test_loop_gives_up_after_retries(tmp_path):
    train_step, batch_at, state = _regression()

    def hook(i):
        raise fault.SimulatedFailure("permanent")

    loop = fault.FaultTolerantLoop(train_step, batch_at, str(tmp_path),
                                   ckpt_every=5, failure_hook=hook,
                                   max_retries_per_step=2)
    with pytest.raises(fault.SimulatedFailure):
        loop.run(state, 5)
