"""The port's shape cells and abstract specs (``repro_torch.launch.shapes``)
against the JAX reference's ``repro.launch.shapes``.

``SHAPES``, ``WHISPER_DEC`` and ``applicable`` equal the reference's for
every arch; ``batch_specs`` gives the reference's leaves, shapes and
dtypes for every arch x cell at full width; ``cache_specs`` the shapes
and dtypes of ``jax.eval_shape`` of the reference's ``init_cache`` for
every arch at full width (the port's attention K / V leaves are (L, B,
Hkv, T, D), the reference's (L, B, T, Hkv, D): the two middle axes are
swapped, as ``repro_torch.convert`` swaps them); ``param_specs`` the
reference's parameter shapes.  Every spec is a fake tensor made under
the caller's ``FakeTensorMode``: a full-width cache of terabytes
allocates nothing, and a spec made without a mode raises.
"""
import resource

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode  # noqa: E402,E501

from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import registry as jreg  # noqa: E402

from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ARCHS = sorted(registry.ARCHS)
KV = ("['k']", "['v']", "['shared']['k']", "['shared']['v']")


def _jax_leaves(tree) -> dict:
    return {jtu.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jtu.tree_flatten_with_path(tree)[0]}


def _torch_leaves(tree) -> dict:
    out = {}
    for k, t in flatten(tree).items():
        assert isinstance(t, FakeTensor), k
        out[k] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


def test_cells_and_whisper_context_equal_the_reference():
    assert shapes.WHISPER_DEC == jshapes.WHISPER_DEC
    assert {k: (c.name, c.kind, c.seq, c.batch)
            for k, c in shapes.SHAPES.items()} == {
        k: (c.name, c.kind, c.seq, c.batch)
        for k, c in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_and_batch_specs_equal_the_reference(arch):
    cfg, _ = registry.get(arch)
    jcfg, _ = jreg.get(arch)
    with FakeTensorMode():
        for name, cell in shapes.SHAPES.items():
            assert shapes.applicable(cfg, name) == jshapes.applicable(
                jcfg, name)
            got = _torch_leaves(shapes.batch_specs(cfg, cell, "cpu"))
            want = _jax_leaves(jshapes.batch_specs(jcfg,
                                                   jshapes.SHAPES[name]))
            assert got == want, (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_eval_shape_at_full_width(arch):
    cfg, fam = registry.get(arch)
    jcfg, jfam = jreg.get(arch)
    cell = shapes.SHAPES["decode_32k"]
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with FakeTensorMode():
        cache, tokens, pos, gen = shapes.decode_specs(cfg, fam, cell, "cuda")
        got = _torch_leaves(cache)
        assert all(t.device.type == "cuda" for t in flatten(cache).values())
        assert tuple(tokens.shape) == (cell.batch, 1)
        assert tokens.dtype == torch.int32
    assert (pos, gen) == (cell.seq - 1, None)
    nbytes = sum(t.numel() * t.element_size() for t in flatten(cache).values())
    assert nbytes > 2**30
    # nothing of it was allocated
    grew = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
    assert grew * 1024 < 2**28, grew
    want = _jax_leaves(jshapes.cache_specs(jcfg, jfam, cell))
    for k in KV:
        if k in got:
            (l, b, h, t, d), dt = got[k]
            got[k] = ((l, b, t, h, d), dt)
    assert got == want


@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-moe-1b-a400m",
                                  "whisper-tiny", "xlstm-1.3b",
                                  "zamba2-1.2b", "h2o-danube-3-4b"])
def test_param_specs_equal_eval_shape(arch):
    cfg, fam = registry.get(arch)
    jcfg, jfam = jreg.get(arch)
    with FakeTensorMode():
        got = _torch_leaves(shapes.param_specs(cfg, fam, "cuda"))
    want = _jax_leaves(jax.eval_shape(
        lambda: jfam["init"](jcfg, jax.random.PRNGKey(0))))
    assert got == want


def test_specs_refuse_without_a_fake_mode():
    cfg, fam = registry.get("whisper-tiny", smoke=True)
    cell = shapes.SHAPES["train_4k"]
    for call in (lambda: shapes.batch_specs(cfg, cell, "cpu"),
                 lambda: shapes.cache_specs(cfg, fam, cell, "cpu"),
                 lambda: shapes.param_specs(cfg, fam, "cpu")):
        with pytest.raises(RuntimeError, match="FakeTensorMode"):
            call()
