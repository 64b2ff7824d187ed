"""The port's sharded prefill and serve steps (``repro_torch.serving.decode``
``make_prefill`` / ``make_serve_step`` with ``shardings=``, the
counterparts of the reference's ``jax.jit(prefill / serve,
in_shardings=...)`` in ``launch/dryrun.py``'s ``build_cell``) on 4 gloo
ranks against the single-device plain steps.

One spawn of 4 ranks runs every case on a (2, 2) and a (4, 1) ``data`` x
``model`` grid over the same ranks, reduced configs in f32 (the model
modules' ``DTYPE`` set to f32), batch 4 x 16 from a numpy seed:

  * prefill: each rank's logits equal its rows of the single-device
    prefill's within ``TOL`` (1e-5), and its cache blocks, gathered by
    ``port_cache_spec`` over the grid (the reference's placement of the
    K / V heads or positions), each leaf of the single-device cache
    within ``TOL`` of the leaf's max |x|;
  * serve: three greedy steps from a seeded cache at its last positions;
    each rank's next tokens exactly its rows of the single-device
    step's, its logits within ``TOL``, and the cache blocks gathered
    after the steps the single-device cache within ``TOL`` of each
    leaf's max |x| (zamba2's SSM state read 1.2e-5 absolute on one row
    a rank: a product over 1 row sums in another order than over 4).

The archs cover every family: dense (starcoder2-3b, ``fsdp=True``), MoE
(granite-moe: its groups span the data ranks), MLA (deepseek-v3),
hybrid (zamba2), xlstm (its mLSTM states hold the batch on dim 2, which
``cache_spec`` leaves whole: every rank holds every row and the step
all-gathers its rows after writing them) and encoder-decoder (whisper).
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402

import repro_torch.serving.decode as decode  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402

ARCHS = ("starcoder2-3b", "granite-moe-1b-a400m", "deepseek-v3-671b",
         "zamba2-1.2b", "xlstm-1.3b", "whisper-tiny")
GRIDS = ("2x2", "4x1")
B, S, T, STEPS = 4, 16, 24, 3
TOL = 1e-5

_SNIPPET = """
import numpy as np
from repro_torch.checkpoint import ckpt
from repro_torch.core.collectives import make_grid
from repro_torch.data import shard_batch
from repro_torch.launch import dryrun, shardings as sh
from repro_torch.models import encdec, layers, lm, registry
from repro_torch.serving.decode import make_prefill, make_serve_step
from repro_torch.training import Shardings
ARCHS, B, S, T, STEPS = {archs!r}, {b}, {s}, {t}, {steps}
GRIDS = dict(g2x2=make_grid((2, 2), ("data", "model")),
             g4x1=make_grid((4, 1), ("data", "model")))
layers.DTYPE = lm.DTYPE = encdec.DTYPE = torch.float32
out = {{}}


def err(a, b):
    return float((a.double() - b.double()).abs().max())


def leaf_err(a, b):
    # relative to the leaf's largest value
    return err(a, b) / max(float(b.abs().max()), 1e-30)


def mine(full, grid):
    # this rank's rows of a single-device result (whole where the batch
    # axes do not cut it)
    return shard_batch(dict(x=full.numpy()), grid, sh.batch_axes(grid),
                       device="cpu")["x"]


for arch in ARCHS:
    cfg, fam = registry.get(arch, smoke=True)
    fsdp = arch in dryrun.FSDP_ARCHS
    params = ckpt.tree_map(lambda t: t.float(), fam["init"](
        cfg, torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(1)
    host = dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.family == "encdec":
        host["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    batch = {{k: torch.from_numpy(v) for k, v in host.items()}}
    logits1, cache1 = fam["prefill"](params, batch, cfg)
    cache0 = fam["init_cache"](cfg, B, T, device="cpu")
    for t in ckpt.flatten(cache0).values():
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(
            np.float32)))
    tok0 = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32))
    plain = make_serve_step(cfg, fam)
    want = ckpt.tree_map(lambda t: t.clone(), cache0)
    tok, steps1 = tok0, []
    for i in range(STEPS):
        tok, lg, want = plain(params, want, tok, T - STEPS + i)
        steps1.append((tok, lg))
    for gname, grid in GRIDS.items():
        tag = f"{{arch}}__{{gname}}"
        axes = sh.batch_axes(grid)
        specs = sh.serve_specs(params, grid, batch=batch, fsdp=fsdp)
        pspecs = {{k[len(".params"):]: v for k, v in specs.items()
                  if k.startswith(".params")}}
        blocks = sh.place(params, pspecs, grid)
        prefill = make_prefill(cfg, fam, shardings=Shardings(grid, specs))
        logits, cblocks = prefill(blocks, shard_batch(host, grid, axes,
                                                      device="cpu"))
        out[tag + "__prefill_logits"] = np.array(
            err(logits, mine(logits1, grid)))
        full1 = ckpt.flatten(cache1)
        worst = 0.0
        for k, b in ckpt.flatten(cblocks).items():
            spec = sh.port_cache_spec(".cache" + k, tuple(full1[k].shape),
                                      grid)
            worst = max(worst, leaf_err(sh.gather_leaf(b, spec, grid),
                                        full1[k]))
        out[tag + "__prefill_cache"] = np.array(worst)

        specs = sh.serve_specs(params, grid, batch=dict(tokens=tok0),
                               cache=cache0, fsdp=fsdp)
        cspecs = {{k[len(".cache"):]: v for k, v in specs.items()
                  if k.startswith(".cache")}}
        cache = sh.place(cache0, cspecs, grid)
        step = make_serve_step(cfg, fam, shardings=Shardings(grid, specs))
        tok = mine(tok0, grid)
        same, worst = True, 0.0
        for i in range(STEPS):
            tok, lg, cache = step(blocks, cache, tok, T - STEPS + i)
            same &= torch.equal(tok, mine(steps1[i][0], grid))
            worst = max(worst, err(lg, mine(steps1[i][1], grid)))
        out[tag + "__tokens_equal"] = np.array(same)
        out[tag + "__serve_logits"] = np.array(worst)
        got = sh.gather(cache, cspecs, grid)
        out[tag + "__serve_cache"] = np.array(max(
            leaf_err(a, b) for a, b in zip(ckpt.flatten(got).values(),
                                      ckpt.flatten(want).values())))
        out[tag + "__cut_leaves"] = np.array(sum(
            any(e is not None for e in s) for s in cspecs.values()))
np.savez({outdir!r} + f"/rank{{RANK}}.npz", **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(_SNIPPET.format(archs=ARCHS, b=B, s=S, t=T,
                                         steps=STEPS, outdir=tmp), 4,
                         timeout=400)
        assert all("DONE" in o for o in outs)
        yield [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(4)]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_equals_the_single_device_prefill(ranks, arch, grid):
    tag = f"{arch}__g{grid}"
    for r, out in enumerate(ranks):
        assert out[tag + "__prefill_logits"] <= TOL, (r, out)
        assert out[tag + "__prefill_cache"] <= TOL, r


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_equals_the_single_device_step(ranks, arch, grid):
    tag = f"{arch}__g{grid}"
    for r, out in enumerate(ranks):
        assert out[tag + "__tokens_equal"], r
        assert out[tag + "__serve_logits"] <= TOL, r
        assert out[tag + "__serve_cache"] <= TOL, r
        assert out[tag + "__cut_leaves"] > 0, r


def test_cache_batch_dims_find_each_leafs_batch():
    from repro_torch.models import registry
    cfg, fam = registry.get("xlstm-1.3b", smoke=True)
    dims = decode.cache_batch_dims(cfg, fam)
    assert dims == {"[0][0]": 2, "[0][1]": 2, "[0][2]": 2, "[1][0]": 1,
                    "[1][1]": 1, "[1][2]": 1, "[1][3]": 1}
    cfg, fam = registry.get("starcoder2-3b", smoke=True)
    assert decode.cache_batch_dims(cfg, fam) == {"['k']": 1, "['v']": 1}
    assert sh.names_only(("pod", "data"), ("pod", "data"))
    assert not sh.names_only(("data", "model"), ("pod", "data"))
    assert not sh.names_only(None, ("data",))
