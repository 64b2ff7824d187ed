"""The port's sharded train step (``repro_torch.training.make_train_step``
with ``shardings=``), ``shard_batch`` / ``DataPipeline(mesh=)`` and
elastic restore onto a grid, on 4 gloo ranks against the port's and
the JAX reference's single-device steps (the counterpart of
``tests/test_collectives.py::test_sharded_equals_single_device`` and
``tests/test_checkpoint.py::test_elastic_restore_different_mesh``).

The port's init draws the parameters from a seed (the reference's
shapes, dtypes and scales, ``tests/test_torch_moe.py``), which both
packages start from (reduced configs, batch 4 x 16 from a numpy seed);
one spawn of 4 ranks runs every case on a (2, 2) ``data`` x ``model``
grid (one case on a (2, 1, 2) ``pod`` x ``data`` x ``model`` grid over
the same ranks), while this process runs the reference's single-device
steps (deepseek-v3's, the longest to compile, in a subprocess beside
them).  Each case's single-device port step runs on one rank.

  * ``gate``: granite-moe in bf16, ``fsdp=False``, one step: the loss
    within 1e-2 of the reference's (the reference's own gate);
  * f32 runs (both packages' ``layers.DTYPE`` set to f32, so the MoE
    layer rounds nowhere), two AdamW steps (lr 1e-3, warmup 1: the
    second moves), or Adafactor for deepseek-v3: granite-moe with
    ``MOE_GROUP`` as it is (one group of 64 tokens spans both data
    ranks: capacity and drops across ranks), patched to 16 in both
    modules (groups within ranks), and on the pod grid; deepseek-7b and
    deepseek-v3, ``fsdp=True``.  Loss and grad norm within ``RTOL``
    (1e-5 relative) of the port's single-device step and of the
    reference's; every parameter and moment after the steps within
    ``LEAF_TOL`` (1e-5) of its leaf's max |x| of the port's
    single-device step (measured at most 2.5e-6: the ranks sum their
    gradients in another order than one device's backward) and within
    ``REF_LEAF_TOL`` (1e-4) of the reference's (measured 1.4e-5: the
    port's single-device step itself stands that far from the
    reference's, on ``tok_emb`` rows whose gradients are near AdamW's
    eps, where its second step's m / sqrt(v) amplifies the last bits);
  * every rank gathers the same state bitwise;
  * each rank's ``shard_batch`` and ``DataPipeline(mesh=)`` blocks are
    the row-major slices of the host batch; an undividing batch raises;
  * a checkpoint saved from one device restores onto the (2, 2) grid by
    the rules with ``fsdp=True``: each block its slice, gathered back
    bitwise.

Every new module is imported by its own name (the reference's dead-code
gate walks ``src/``).
"""
import concurrent.futures
import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from _subproc import run_devices  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402

import repro_torch.launch.shardings as sh  # noqa: E402
import repro_torch.training.train_step as ts_mod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.models import layers, lm, registry  # noqa: E402
from repro_torch.training import Shardings, adamw  # noqa: E402

B, S = 4, 16
GATE_TOL = 1e-2
RTOL = 1e-5
LEAF_TOL = 1e-5
REF_LEAF_TOL = 1e-4
# tag -> (arch, f32, fsdp, optimizer, MOE_GROUP (0: as it is), grid, steps)
CASES = {
    "gate": ("granite-moe-1b-a400m", False, False, "adamw", 0, "2x2", 1),
    "span": ("granite-moe-1b-a400m", True, True, "adamw", 0, "2x2", 2),
    "group16": ("granite-moe-1b-a400m", True, True, "adamw", 16, "2x2", 2),
    "pod": ("granite-moe-1b-a400m", True, True, "adamw", 0, "2x1x2", 2),
    "dense": ("deepseek-7b", True, True, "adamw", 0, "2x2", 2),
    "v3": ("deepseek-v3-671b", True, True, "adafactor", 0, "2x2", 2),
}
F32 = [t for t, c in CASES.items() if c[1]]
# the reference run a case is held to ("pod" computes "span"'s function)
REF_OF = {t: ("span" if t == "pod" else t) for t in CASES}
CKPT_ARCH = "granite-moe-1b-a400m"
# reference runs made in a subprocess, beside this process's
REF_APART = ("v3",)


def _opt(mod, name, steps):
    return getattr(mod, name)(lr=1e-3, warmup=1 if steps > 1 else 100)


def _batches(tag, vocab):
    out = []
    for i in range(CASES[tag][6]):
        rng = np.random.default_rng(10 + i)
        out.append(dict(
            tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
            labels=rng.integers(0, vocab, (B, S)).astype(np.int32)))
    return out


def _draw(arch) -> dict:
    """{key string: tensor} of the port's seeded parameters."""
    cfg, fam = registry.get(arch, smoke=True)
    return ckpt.flatten(fam["init"](cfg, torch.Generator().manual_seed(0),
                                    "cpu"))


def _store(flat) -> dict:
    """The npz entries of ``flat``: bf16 as its 16 bits under "b:",
    anything else under "f:"."""
    return {("b:" if t.dtype == torch.bfloat16 else "f:") + k:
            (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
             else t.numpy()) for k, t in flat.items()}


def _jax_params(flat, f32: bool):
    """``flat`` as the reference's nested dict of arrays (each leaf's
    dtype, or f32)."""
    tree = {}
    for k, t in flat.items():
        keys = k[2:-2].split("']['")
        d = tree
        for key in keys[:-1]:
            d = d.setdefault(key, {})
        a = jnp.asarray(t.float().numpy())
        d[keys[-1]] = a if f32 or t.dtype != torch.bfloat16 else \
            a.astype(jnp.bfloat16)
    return tree


def _reference(tag, flat, batches):
    """(losses, grad norms, {key: f32 array} of params and opt_state) of
    the reference's single-device steps; the loss alone for a one-step
    case (the step reports the loss before its update)."""
    arch, f32, _, optname, group, _, steps = CASES[tag]
    cfg, fam = jreg.get(arch, smoke=True)
    params = _jax_params(flat, f32)
    opt = _opt(jopt, optname, steps)
    state = jts.TrainState.create(params, opt)
    saved = (jlayers.DTYPE, jlayers.MOE_GROUP)
    jlayers.DTYPE = jnp.float32 if f32 else jnp.bfloat16
    jlayers.MOE_GROUP = group or saved[1]
    try:
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        if steps == 1:
            loss = jax.jit(jts.make_loss_fn(cfg, fam))(params, jb[0])
            return [float(loss)], [], {}
        step = jax.jit(jts.make_train_step(cfg, fam, opt))
        losses, norms = [], []
        for b in jb:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        jlayers.DTYPE, jlayers.MOE_GROUP = saved
    leaves = {}
    for name in ("params", "opt_state"):
        for p, leaf in jtu.tree_flatten_with_path(getattr(state, name))[0]:
            leaves[f".{name}{jtu.keystr(p)}"] = np.asarray(
                jnp.asarray(leaf, jnp.float32))
    return losses, norms, leaves


_RANKS = """
import re
import numpy as np
from repro_torch.checkpoint import ckpt
from repro_torch.core.collectives import make_grid
from repro_torch.data import DataPipeline, shard_batch
from repro_torch.launch import shardings as sh
from repro_torch.models import layers, registry
from repro_torch.runtime.elastic import reshard_checkpoint
from repro_torch.training import Shardings, TrainState, make_train_step
from repro_torch.training import optimizer as opt_mod
CASES = {cases!r}
out = {{}}
GRIDS = dict(grid2x2=make_grid((2, 2), ("data", "model")))
GRIDS["grid2x1x2"] = make_grid((2, 1, 2), ("pod", "data", "model"))
for name, g in GRIDS.items():
    out[f"coords__{{name}}"] = np.array(g.coords)


def nest(flat, f32):
    tree = {{}}
    for key, a in flat.items():
        kind, path = key.split(":", 1)
        t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
             if kind == "b" else torch.from_numpy(a))
        if f32:
            t = t.float()
        keys = re.findall(r"\\['([^']+)'\\]", path)
        d = tree
        for k in keys[:-1]:
            d = d.setdefault(k, {{}})
        d[keys[-1]] = t
    return tree


def params_of(arch, f32):
    return nest(dict(np.load({inputs!r} + f"/{{arch}}.npz")), f32)


def batches_of(tag):
    z = np.load({inputs!r} + f"/batches_{{tag}}.npz")
    return [dict(tokens=z[f"tokens{{i}}"], labels=z[f"labels{{i}}"])
            for i in range(CASES[tag][6])]


def record(prefix, losses, norms, state):
    out[prefix + "__loss"] = np.array(losses)
    out[prefix + "__gn"] = np.array(norms)
    for k, v in ckpt.flatten(state).items():
        if k != ".step":
            out[prefix + k] = v.detach().float().numpy()


for i, (tag, (arch, f32, fsdp, optname, group, gname, steps)) in enumerate(
        CASES.items()):
    layers.DTYPE = torch.float32 if f32 else torch.bfloat16
    layers.MOE_GROUP = group or 2048
    cfg, fam = registry.get(arch, smoke=True)
    opt = getattr(opt_mod, optname)(lr=1e-3, warmup=1 if steps > 1 else 100)
    full = TrainState.create(params_of(arch, f32), opt)
    grid = GRIDS["grid" + gname]
    specs = sh.train_state_specs(full, grid, fsdp)
    state = sh.place(full, specs, grid, "cpu")
    step = make_train_step(cfg, fam, opt, shardings=Shardings(grid, specs))
    axes = sh.batch_axes(grid)
    losses, norms = [], []
    for b in batches_of(tag):
        state, m = step(state, shard_batch(b, grid, axes, device="cpu"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    record(tag, losses, norms, sh.gather(state, specs, grid))
    out[tag + "__sharded_leaves"] = np.array(sum(
        any(e is not None for e in s) for s in specs.values()))
    if RANK == i % WORLD:                     # the single-device port step
        step1 = make_train_step(cfg, fam, opt)
        losses, norms = [], []
        for b in batches_of(tag):
            full, m = step1(full, {{k: torch.from_numpy(v)
                                   for k, v in b.items()}})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        record("single_" + tag, losses, norms, full)
layers.DTYPE, layers.MOE_GROUP = torch.bfloat16, 2048

# shard_batch and DataPipeline(mesh=) on the (2, 2) grid
grid = GRIDS["grid2x2"]
from repro_torch.data.synthetic import SyntheticLM
src = SyntheticLM(vocab=64, seq_len=5, batch=4)
host = src.batch_at(2)
got = shard_batch(host, grid, ("data",), device="cpu")
out["shard__tokens"] = got["tokens"].numpy()
out["shard__labels"] = got["labels"].numpy()
pipe = DataPipeline(src, device="cpu", mesh=grid, batch_axes=("data",),
                    start_step=2)
try:
    first = next(pipe)
    out["pipe__tokens"] = first["tokens"].numpy()
finally:
    pipe.close()
try:
    shard_batch(dict(tokens=np.zeros((3, 5), np.int32)), grid, ("data",),
                device="cpu")
    out["undividing_raised"] = np.array(False)
except ValueError:
    out["undividing_raised"] = np.array(True)

# elastic restore onto the grid
arch = {ckpt_arch!r}
expect = TrainState.create(params_of(arch, False), opt_mod.adamw())
specs = sh.train_state_specs(expect, grid, True)
template = ckpt.tree_map(lambda t: torch.empty(t.shape, device="meta"),
                         expect)


def rule(path, shape):
    if path.startswith(".params"):
        return sh.param_spec(path, shape, grid, True)
    if path.startswith(".opt_state"):
        return sh.opt_spec(path, shape, grid, True)
    return ()


st = reshard_checkpoint({ckpt_dir!r}, template, grid, rule, device="cpu")
blocks_ok, cut = [], 0
for k, full_leaf in ckpt.flatten(expect).items():
    block = ckpt.flatten(st)[k]
    idx = sh.block_index(specs[k], tuple(full_leaf.shape), grid)
    blocks_ok.append(block.dtype == full_leaf.dtype
                     and torch.equal(block, full_leaf[idx]))
    cut += block.numel() < full_leaf.numel()
back = sh.gather(st, specs, grid)
out["elastic__blocks_ok"] = np.array(blocks_ok)
out["elastic__cut"] = np.array(cut)
out["elastic__gather_ok"] = np.array(all(
    torch.equal(a, b) for a, b in zip(ckpt.flatten(back).values(),
                                      ckpt.flatten(expect).values())))
np.savez({outdir!r} + f"/rank{{RANK}}.npz", **out)
print("DONE")
"""


_REF_APART = """
import pickle
sys.path.insert(0, {tests!r})
import test_torch_sharded as T
from repro.models import registry
out = {{}}
for tag in T.REF_APART:
    arch = T.CASES[tag][0]
    vocab = registry.get(arch, smoke=True)[0].vocab
    out[tag] = T._reference(tag, T._draw(arch), T._batches(tag, vocab))
with open({dest!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": {tag: (losses, norms, leaves)}, "ranks": [each rank's
    outputs], "inputs": {tag: batches}}."""
    tmp = tmp_path_factory.mktemp("sharded")
    params = {}
    for arch in sorted({c[0] for c in CASES.values()}):
        params[arch] = _draw(arch)
        np.savez(tmp / f"{arch}.npz", **_store(params[arch]))
    batches = {}
    for tag, c in CASES.items():
        cfg, _ = jreg.get(c[0], smoke=True)
        batches[tag] = _batches(tag, cfg.vocab)
        np.savez(tmp / f"batches_{tag}.npz", **{
            f"{k}{i}": v for i, b in enumerate(batches[tag])
            for k, v in b.items()})
    # a single-device checkpoint of the port's state, from the same draw
    cfg, fam = registry.get(CKPT_ARCH, smoke=True)
    state = ts_mod.TrainState.create(fam["init"](
        cfg, torch.Generator().manual_seed(0), "cpu"), adamw())
    ckpt.save_checkpoint(str(tmp / "ckpt"), 3, state)
    outdir = tmp / "out"
    outdir.mkdir()
    snippet = _RANKS.format(cases=CASES, inputs=str(tmp), outdir=str(outdir),
                            ckpt_arch=CKPT_ARCH, ckpt_dir=str(tmp / "ckpt"))
    apart = _REF_APART.format(tests=os.path.dirname(__file__),
                              dest=str(tmp / "ref_apart.pkl"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawn = pool.submit(run_ranks, snippet, 4)
        sub = pool.submit(run_devices, apart, 1)
        ref = {tag: _reference(tag, params[CASES[tag][0]], batches[tag])
               for tag in CASES if REF_OF[tag] == tag
               and tag not in REF_APART}
        texts = spawn.result()
        assert "OK" in sub.result()
    with open(tmp / "ref_apart.pkl", "rb") as f:
        ref.update(pickle.load(f))
    assert all("DONE" in t for t in texts)
    ranks = [dict(np.load(outdir / f"rank{r}.npz")) for r in range(4)]
    return dict(ref=ref, ranks=ranks, inputs=batches)


def _single(runs, tag):
    """The single-device port run's outputs (on rank ``i % 4``)."""
    i = list(CASES).index(tag)
    return {k[len("single_"):]: v for k, v in runs["ranks"][i % 4].items()
            if k.startswith(f"single_{tag}")}


def _leaves_close(got, want, tag, what, tol):
    keys = sorted(k for k in want if k.startswith("."))
    assert keys and keys == sorted(k[len(tag):] for k in got
                                   if k.startswith(tag + "."))
    for k in keys:
        g, w = got[tag + k], want[k]
        assert g.shape == w.shape, (what, k)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} {k}: {err} > {tol} x {scale}"


def test_gate_loss_within_the_reference(runs):
    """granite-moe 2x2, ``fsdp=False``, bf16: the reference's gate."""
    got = runs["ranks"][0]["gate__loss"]
    losses, _, _ = runs["ref"]["gate"]
    assert abs(float(got[0]) - losses[0]) < GATE_TOL
    single = _single(runs, "gate")
    assert abs(float(got[0]) - float(single["gate__loss"][0])) <= \
        RTOL * abs(float(single["gate__loss"][0]))


@pytest.mark.parametrize("tag", F32)
def test_f32_steps_equal_the_single_device_steps(runs, tag):
    sharded = runs["ranks"][0]
    single = _single(runs, tag)
    r_loss, r_gn, r_leaves = runs["ref"][REF_OF[tag]]
    for key, ref in (("loss", r_loss), ("gn", r_gn)):
        got = sharded[f"{tag}__{key}"]
        for want in (single[f"{tag}__{key}"], np.array(ref)):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                       err_msg=f"{tag} {key}")
    want_single = {k[len(tag):]: v for k, v in single.items()
                   if k.startswith(tag + ".")}
    _leaves_close(sharded, want_single, tag, "against the port's step",
                  LEAF_TOL)
    _leaves_close(sharded, r_leaves, tag, "against the reference's step",
                  REF_LEAF_TOL)
    assert int(sharded[f"{tag}__sharded_leaves"]) > 0


@pytest.mark.parametrize("tag", list(CASES))
def test_every_rank_gathers_the_same_state(runs, tag):
    first = runs["ranks"][0]
    for r in runs["ranks"][1:]:
        for k, v in first.items():
            if k.startswith(tag + ".") or k.startswith(tag + "__"):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_losses_differ_with_groups_across_and_within_ranks(runs):
    """Patching ``MOE_GROUP`` to 16 changes the capacity (and with it the
    function): the two granite runs are not the same computation."""
    span, group = runs["ref"]["span"], runs["ref"]["group16"]
    assert span[0][0] != group[0][0]


def test_shard_batch_and_pipeline_blocks_on_ranks(runs):
    from repro_torch.data.synthetic import SyntheticLM
    host = SyntheticLM(vocab=64, seq_len=5, batch=4).batch_at(2)
    for r in runs["ranks"]:
        d = int(r["coords__grid2x2"][0])
        rows = slice(2 * d, 2 * d + 2)
        np.testing.assert_array_equal(r["shard__tokens"], host["tokens"][rows])
        np.testing.assert_array_equal(r["shard__labels"], host["labels"][rows])
        np.testing.assert_array_equal(r["pipe__tokens"], host["tokens"][rows])
        assert bool(r["undividing_raised"])


def test_elastic_restore_onto_the_grid(runs):
    for r in runs["ranks"]:
        assert r["elastic__blocks_ok"].all()
        assert int(r["elastic__cut"]) > 0
        assert bool(r["elastic__gather_ok"])


# ------------------------------------------------------ in-process parts
def test_microbatches_under_shardings_raise():
    cfg, fam = registry.get("deepseek-7b", smoke=True)
    shard = Shardings(sh.MeshShape(("data", "model"), (2, 2), (0, 0)), {})
    with pytest.raises(NotImplementedError, match="A.10f"):
        ts_mod.make_train_step(cfg, fam, adamw(), microbatches=2,
                               shardings=shard)


def test_batch_axes_out_of_the_grid_order_raise():
    cfg, fam = registry.get("deepseek-7b", smoke=True)
    shard = Shardings(sh.MeshShape(("data", "pod"), (2, 2), (0, 0)), {})
    with pytest.raises(ValueError, match="grid's order"):
        ts_mod.make_train_step(cfg, fam, adamw(), shardings=shard)


def test_moe_groups_straddling_a_rank_raise():
    """Groups of 4 over ranks of 6 tokens: neither nests in the other."""
    cfg, fam = registry.get("granite-moe-1b-a400m", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=1)
    params = fam["init"](cfg, torch.Generator().manual_seed(0), "cpu")
    grid = sh.MeshShape(("data",), (2,), (0,))
    x = torch.zeros((1, 6, cfg.d_model), dtype=torch.bfloat16)
    with layers.batch_grid(grid, ("data",)):
        with pytest.raises(ValueError, match="straddle"):
            layers.moe(lm.layer(params["layers"], 0)["moe"], x, cfg, 4)
    assert layers.BATCH_GRID is None


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_convert_puts_the_reference_state_into_the_blocks(coords):
    """The reference's ``TrainState`` as numpy (``jax.device_get``: bf16
    leaves as ml_dtypes arrays) goes through ``train_state_from_numpy``
    with a grid straight into that position's blocks: each the slice of
    the port's full state, in its dtype."""
    cfg, fam = registry.get(CKPT_ARCH, smoke=True)
    params = fam["init"](cfg, torch.Generator().manual_seed(0), "cpu")
    jstate = jax.device_get(jts.TrainState.create(
        _jax_params(ckpt.flatten(params), False), jopt.adamw()))
    grid = sh.MeshShape(("data", "model"), (2, 2), coords)
    full = ts_mod.TrainState.create(params, adamw())
    specs = sh.train_state_specs(full, grid, fsdp=True)
    got = ckpt.flatten(convert.train_state_from_numpy(jstate, "cpu", grid,
                                                      specs))
    want = ckpt.flatten(sh.place(full, specs, grid, "cpu"))
    assert list(got) == list(want)
    cut = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        cut += w.numel() < ckpt.flatten(full)[k].numel()
    assert cut > 0
