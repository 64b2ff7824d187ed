"""The port's sharding rules and placement (``repro_torch.launch.shardings``,
``repro_torch.launch.mesh``) against the JAX reference's
``repro.launch.shardings``, in one process with no fake devices.

The reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, so they take a stand-in mesh (a namespace over
``np.empty(shape)``); the port's take a ``MeshShape``.  Every leaf of
every registry arch, reduced and at full size (shapes from the
reference's ``jax.eval_shape``, never allocated), goes through both:

  * ``param_spec``, ``opt_spec`` (AdamW's ``mu`` / ``nu``, Adafactor's
    ``vr`` / ``vc`` / ``v``), ``cache_spec`` (the family's decode cache)
    and ``batch_spec`` equal ``tuple()`` of the reference's spec, over
    the meshes (2, 2), (4, 1), (1, 4), (16, 16) ``data`` x ``model`` and
    (2, 16, 16) ``pod`` x ``data`` x ``model``, both ``fsdp`` values;
  * every axis a rule assigns divides its dim (the counterpart of
    ``tests/test_system.py::test_sharding_rules_divisibility``);
  * at reduced size the port's own parameter and optimizer trees have
    the reference's key strings and shapes.

``block_index`` is held against a numpy slicing of the full leaf at
every rank of a grid, ``place`` / ``gather``'s layout against the same,
and the mesh module's functions on a one-rank gloo group.
"""
import datetime
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from repro.launch import shardings as jsh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402

import repro_torch.launch.mesh as mesh  # noqa: E402
import repro_torch.launch.shardings as sh  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCH_SHAPES = ((4, 16), (3, 16), (1024, 64, 8), (512,), ())
CACHE = {True: (4, 32), False: (32, 4096)}      # smoke: (batch, cache_len)


def _ref_mesh(shape, names):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


_SHAPES = {}


def _abstract(arch, smoke):
    """{"params" | "adamw" | "adafactor" | "cache": [(key string, shape)]}
    of the reference's trees, by ``jax.eval_shape``."""
    key = (arch, smoke)
    if key not in _SHAPES:
        cfg, fam = jreg.get(arch, smoke=smoke)
        params = jax.eval_shape(lambda: fam["init"](cfg,
                                                    jax.random.PRNGKey(0)))
        batch, cache_len = CACHE[smoke]
        trees = dict(
            params=params,
            adamw=jax.eval_shape(lambda: jopt.adamw().init(params)),
            adafactor=jax.eval_shape(lambda: jopt.adafactor().init(params)),
            cache=jax.eval_shape(lambda: fam["init_cache"](cfg, batch,
                                                           cache_len)))
        _SHAPES[key] = {
            name: [(jtu.keystr(p), tuple(leaf.shape))
                   for p, leaf in jtu.tree_flatten_with_path(t)[0]]
            for name, t in trees.items()}
    return _SHAPES[key]


def _axis_sizes(entry, sizes):
    names = (entry,) if isinstance(entry, str) else entry
    return int(np.prod([sizes[a] for a in names]))


CASES = [pytest.param(arch, smoke, id=f"{arch}-{'reduced' if smoke else 'full'}")
         for arch in jreg.ARCHS for smoke in (True, False)]


@pytest.mark.parametrize("arch,smoke", CASES)
def test_rules_equal_reference_on_every_leaf(arch, smoke):
    trees = _abstract(arch, smoke)
    n = 0
    for shape, names in MESHES.values():
        jm, tm = _ref_mesh(shape, names), sh.MeshShape(names, shape)
        for fsdp in (True, False):
            for path, s in trees["params"]:
                assert sh.param_spec(path, s, tm, fsdp) == tuple(
                    jsh.param_spec(path, s, jm, fsdp)), (path, s, shape)
                n += 1
            for name in ("adamw", "adafactor"):
                for path, s in trees[name]:
                    assert sh.opt_spec(path, s, tm, fsdp) == tuple(
                        jsh.opt_spec(path, s, jm, fsdp)), (name, path, s)
                    n += 1
        for path, s in trees["cache"]:
            assert sh.cache_spec(path, s, tm) == tuple(
                jsh.cache_spec(path, s, jm)), (path, s, shape)
        for s in BATCH_SHAPES:
            assert sh.batch_spec("['tokens']", s, tm) == tuple(
                jsh.batch_spec("['tokens']", s, jm)), (s, shape)
    assert n > 0


@pytest.mark.parametrize("arch,smoke", CASES)
def test_every_assigned_axis_divides(arch, smoke):
    trees = _abstract(arch, smoke)
    for shape, names in MESHES.values():
        tm = sh.MeshShape(names, shape)
        sizes = dict(zip(names, shape))
        for fsdp in (True, False):
            leaves = [(p, s, sh.param_spec(p, s, tm, fsdp))
                      for p, s in trees["params"]]
            leaves += [(p, s, sh.opt_spec(p, s, tm, fsdp))
                       for name in ("adamw", "adafactor")
                       for p, s in trees[name]]
            leaves += [(p, s, sh.cache_spec(p, s, tm))
                       for p, s in trees["cache"]]
            for path, s, spec in leaves:
                assert len(spec) <= len(s), (path, s, spec)
                for size, entry in zip(s, spec):
                    if entry is not None:
                        assert size % _axis_sizes(entry, sizes) == 0, (
                            arch, path, s, spec, shape)


@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_port_trees_have_the_reference_keys_and_shapes(arch):
    """The port's reduced parameters and both optimizers' states, keyed
    by ``ckpt.flatten``, are the reference's key strings and shapes (so
    a spec by key string reaches the same leaf)."""
    trees = _abstract(arch, True)
    cfg, fam = registry.get(arch, smoke=True)
    params = fam["init"](cfg, torch.Generator().manual_seed(0), "cpu")

    def keyed(tree):
        return [(k, tuple(v.shape)) for k, v in ckpt.flatten(tree).items()]
    assert keyed(params) == trees["params"]
    assert keyed(opt_mod.adamw().init(params)) == trees["adamw"]
    assert keyed(opt_mod.adafactor().init(params)) == trees["adafactor"]
    specs = sh.tree_specs(params, sh.param_spec, sh.MeshShape(
        ("data", "model"), (2, 2)), fsdp=True)
    assert list(specs) == [k for k, _ in trees["params"]]


# ---------------------------------------------------------------- placement
SPECS = [((), (6, 4)), (("data",), (8, 3)), ((None, "model"), (3, 8)),
         ((("data", "model"),), (8, 2)), (("model", "data"), (4, 6)),
         ((("pod", "data"), None, "model"), (8, 3, 4)),
         ((None, ("data", "model")), (2, 16)),
         ((("model", "data"),), (8, 1))]
GRIDS = [((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
         ((1, 4), ("data", "model"))]


def _numpy_block(full, spec, sizes, at):
    """The block by ``np.split``: each dim cut into its axes' product of
    equal parts, the part at the row-major index of ``at`` along them."""
    out = full
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        idx = 0
        for a in names:
            idx = idx * sizes[a] + at[a]
        out = np.split(out, _axis_sizes(entry, sizes), axis=dim)[idx]
    return out


@pytest.mark.parametrize("grid_shape,names", GRIDS)
def test_block_index_and_place_equal_numpy_slicing(grid_shape, names):
    sizes = dict(zip(names, grid_shape))
    rng = np.random.default_rng(3)
    for spec, shape in SPECS:
        if any(a not in names for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        full = rng.standard_normal(shape).astype(np.float32)
        blocks = []
        for coords in itertools.product(*(range(s) for s in grid_shape)):
            g = sh.MeshShape(names, grid_shape, coords)
            want = _numpy_block(full, spec, sizes, dict(zip(names, coords)))
            got = full[sh.block_index(spec, shape, g)]
            np.testing.assert_array_equal(got, want)
            placed = sh.place(dict(w=full), {"['w']": spec}, g, "cpu")["w"]
            assert placed.is_contiguous()
            np.testing.assert_array_equal(placed.numpy(), want)
            blocks.append(want)
        # the blocks tile the leaf: every element in exactly one block of
        # the ranks that differ along the spec's axes
        named = {a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)}
        copies = int(np.prod([s for a, s in sizes.items()
                              if a not in named]))
        assert sum(b.size for b in blocks) == full.size * copies


def test_block_index_refuses_an_undividing_dim():
    with pytest.raises(ValueError, match="does not divide"):
        sh.block_index(("data",), (5, 2), sh.MeshShape(("data",), (2,)))


def test_member_blocks_follow_the_spec_order():
    """A group's members come in the grid's row-major order; an entry
    naming the axes the other way round numbers its blocks by them."""
    g = sh.MeshShape(("data", "model"), (2, 3))
    assert sh._member_blocks(g, ("data", "model")) == list(range(6))
    assert sh._member_blocks(g, ("model", "data")) == [0, 2, 4, 1, 3, 5]


def test_train_state_specs_split_params_and_state():
    cfg, fam = registry.get("granite-moe-1b-a400m", smoke=True)
    params = fam["init"](cfg, torch.Generator().manual_seed(0), "cpu")
    from repro_torch.training import TrainState
    state = TrainState.create(params, opt_mod.adamw())
    g = sh.MeshShape(("data", "model"), (2, 2))
    specs = sh.train_state_specs(state, g, fsdp=True)
    assert list(specs) == list(ckpt.flatten(state))
    assert specs[".step"] == ()
    for k, p in ckpt.flatten(params).items():
        want = sh.param_spec(k, tuple(p.shape), g, True)
        assert specs[".params" + k] == want
        assert specs[".opt_state['mu']" + k] == want
        assert specs[".opt_state['nu']" + k] == want


# -------------------------------------------------------------------- mesh
def test_mesh_functions_on_a_one_rank_group(tmp_path):
    import torch.distributed as dist
    g = sh.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert mesh.mesh_axis_sizes(g) == dict(pod=2, data=16, model=16)
    assert mesh.batch_axes(g) == ("pod", "data")
    assert mesh.batch_axes(sh.MeshShape(("data", "model"), (4, 1))) == (
        "data",)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for multi_pod, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks"):
                mesh.make_production_mesh(multi_pod=multi_pod)
        grid = mesh.make_host_mesh()
        assert (grid.shape, grid.names, grid.coords) == (
            (1, 1), ("data", "model"), (0, 0))
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh.make_host_mesh(model=4)
    finally:
        dist.destroy_process_group()
