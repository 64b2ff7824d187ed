"""Tensor-parallel compute over ``model`` for the dense family: the port's
sharded train, prefill and serve steps (``make_train_step`` /
``make_prefill`` / ``make_serve_step`` with ``shardings=``) on gloo
ranks against the port's and the JAX reference's single-device steps,
in f32 (both packages' ``DTYPE`` set to f32), reduced configs, batch
4 x 16 from a numpy seed, the same weights in both (``convert``).

One spawn of 4 ranks per grid, ``data`` x ``model`` (1, 4) and (2, 2)
and ``pod`` x ``data`` x ``model`` (2, 1, 2), each running every case:

  * archs: the reduced starcoder2-3b (one KV head: ``wk`` / ``wv``
    gathered over ``model``, a cache cut on its positions),
    deepseek-7b (4 KV heads: the heads-cut cache at m = 2 and 4),
    h2o-danube-3-4b (its 8-slot ring cut on its positions) and
    ``split``, starcoder2-3b with 6 heads, whose ``wq`` block of 24
    columns over m = 4 splits a head (``wq`` gathered);
  * training: a first AdamW step, and a first Adafactor step on
    deepseek-7b: loss and grad norm within ``TOL`` (1e-5, relative)
    and every leaf of the state within ``TOL`` of its leaf's max |x| of
    both single-device steps.  The first step runs at lr 0 (the
    warmup's), so its state holds the gradients in the moments (mu, nu;
    Adafactor's factored ones) and the parameters stay as they were: a
    step that moves them turns f32 rounding of near-zero gradients into
    a part of lr (AdamW's g / (|g| + eps)), 1.3e-5 of ``w_out``'s max
    at (1, 4) in the step after this one; ``tests/test_torch_sharded.py``
    holds two moving steps of deepseek-7b on the (2, 2) grid to its own
    gates;
  * serving: the prefill's logits (this rank's rows) within ``TOL`` and
    its cache, gathered by ``port_cache_spec``, within ``TOL`` of each
    leaf's max; three greedy decode steps from a seeded cache at
    positions 4-6 of 24 (a plain cache's later blocks of positions
    still empty: length 0 on those ranks), tokens equal, logits within
    ``TOL``, the cache after them within ``TOL`` of each leaf's max.

On the (1, 4) grid, ``launch.opanalysis.StepCount`` logs the train
step's collectives: the only all-gathers over the ``model`` group are
one layer's ``wk`` / ``wv`` block (and ``wq``'s where it splits a head),
where the step of the other families gathers every parameter over it.

``ops.decode_attention``'s log-sum-exp and its merge over blocks of
positions are in ``tests/test_torch_decode_attention.py``.
"""
import concurrent.futures
import dataclasses
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from _torch_ranks import run_ranks  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402

import repro_torch.launch.opanalysis as opanalysis  # noqa: E402
import repro_torch.launch.shardings as sh  # noqa: E402
import repro_torch.models.layers as layers  # noqa: E402
import repro_torch.models.lm as lm  # noqa: E402
import repro_torch.serving.decode as decode  # noqa: E402
import repro_torch.training.train_step as ts_mod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.models import registry  # noqa: E402

B, S, T, STEPS, POS0 = 4, 16, 24, 3, 4
TOL = 1e-5
GRIDS = {"1x4": ((1, 4), ("data", "model")),
         "2x2": ((2, 2), ("data", "model")),
         "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
ARCHS = ("starcoder2-3b", "deepseek-7b", "h2o-danube-3-4b", "split")
# (arch, optimizer) of each training case
TRAIN = [(a, "adamw") for a in ARCHS] + [("deepseek-7b", "adafactor")]


def _cfgs(name):
    """(port cfg, fam, reference cfg, fam) of a case's arch."""
    arch = "starcoder2-3b" if name == "split" else name
    cfg, fam = registry.get(arch, smoke=True)
    jcfg, jfam = jreg.get(arch, smoke=True)
    if name == "split":
        cfg = dataclasses.replace(cfg, n_heads=6)
        jcfg = dataclasses.replace(jcfg, n_heads=6)
    return cfg, fam, jcfg, jfam


def _inputs(name):
    """The case's f32 parameters (the port's seeded draw), batch, decode
    cache in the reference's layout and first tokens, as numpy."""
    cfg, fam, jcfg, jfam = _cfgs(name)
    params = {k: t.float().numpy() for k, t in ckpt.flatten(fam["init"](
        cfg, torch.Generator().manual_seed(0), "cpu")).items()}
    rng = np.random.default_rng(3)
    batch = dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 labels=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    shapes = jax.eval_shape(lambda: jfam["init_cache"](jcfg, B, T))
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in shapes.items()}
    tok0 = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    return params, batch, cache, tok0


def _nest(flat):
    tree = {}
    for k, a in flat.items():
        keys = k[2:-2].split("']['")
        d = tree
        for key in keys[:-1]:
            d = d.setdefault(key, {})
        d[keys[-1]] = a
    return tree


def _opt(mod, name):
    return getattr(mod, name)(lr=1e-3, warmup=1)


def _reference(name, inputs):
    """The reference's single-device results in f32: per optimizer the
    loss, grad norm and state leaves of its first step; the
    prefill's logits and cache; the decode steps' tokens and logits and
    the cache after them (the port's layout)."""
    cfg, fam, jcfg, jfam = _cfgs(name)
    params, batch, cache, tok0 = inputs
    jp = jax.tree.map(jnp.asarray, _nest(params))
    out = {}
    saved = jlayers.DTYPE
    jlayers.DTYPE = jnp.float32
    try:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for a, optname in TRAIN:
            if a != name:
                continue
            opt = _opt(jopt, optname)
            state = jts.TrainState(params=jp, opt_state=opt.init(jp),
                                   step=jnp.zeros((), jnp.int32))
            state, m = jax.jit(jts.make_train_step(jcfg, jfam, opt))(state,
                                                                     jb)
            out[f"{optname}__loss"] = float(m["loss"])
            out[f"{optname}__gn"] = float(m["grad_norm"])
            for part in ("params", "opt_state"):
                for p, leaf in jtu.tree_flatten_with_path(
                        getattr(state, part))[0]:
                    out[f"{optname}.{part}{jtu.keystr(p)}"] = np.asarray(
                        leaf, np.float32)
        logits, jc = jax.jit(jfam["prefill"], static_argnums=2)(
            jp, dict(tokens=jb["tokens"]), jcfg)
        out["prefill__logits"] = np.asarray(logits, np.float32)
        for k, v in convert.lm_cache_from_numpy(
                jax.tree.map(np.asarray, jc), "cpu").items():
            out[f"prefill.cache['{k}']"] = v.numpy()
        step = jax.jit(jfam["decode"], static_argnums=4)
        jc = jax.tree.map(jnp.asarray, cache)
        tok = jnp.asarray(tok0)
        for i in range(STEPS):
            logits, jc = step(jp, jc, tok, POS0 + i, jcfg)
            tok = jnp.argmax(jnp.where(jnp.arange(logits.shape[-1])
                                       < jcfg.vocab, logits, -jnp.inf),
                             axis=-1).astype(jnp.int32)[:, None]
            out[f"serve{i}__tokens"] = np.asarray(tok)
            out[f"serve{i}__logits"] = np.asarray(logits, np.float32)
        for k, v in convert.lm_cache_from_numpy(
                jax.tree.map(np.asarray, jc), "cpu").items():
            out[f"serve.cache['{k}']"] = v.numpy()
    finally:
        jlayers.DTYPE = saved
    return out


def _single(name, inputs):
    """The port's single-device results, the keys of ``_reference``."""
    cfg, fam, _, _ = _cfgs(name)
    params, batch, cache, tok0 = inputs
    layers.DTYPE = lm.DTYPE = torch.float32
    try:
        return _port_single(cfg, fam, name, params, batch, cache, tok0)
    finally:
        layers.DTYPE = lm.DTYPE = torch.bfloat16


def _port_single(cfg, fam, name, params, batch, cache, tok0):
    from repro_torch.serving.decode import make_prefill, make_serve_step
    from repro_torch.training import TrainState, optimizer as opt_mod
    out = {}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def tree():
        return _nest({k: torch.from_numpy(v.copy())
                      for k, v in params.items()})
    for a, optname in TRAIN:
        if a != name:
            continue
        opt = _opt(opt_mod, optname)
        p = tree()
        state = TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32))
        state, m = ts_mod.make_train_step(cfg, fam, opt)(state, tb)
        out[f"{optname}__loss"] = float(m["loss"])
        out[f"{optname}__gn"] = float(m["grad_norm"])
        for k, v in ckpt.flatten(state).items():
            if k != ".step":
                out[f"{optname}{k}"] = v.numpy()
    p = tree()
    logits, c = make_prefill(cfg, fam)(p, dict(tokens=tb["tokens"]))
    out["prefill__logits"] = logits.numpy()
    for k, v in c.items():
        out[f"prefill.cache['{k}']"] = v.numpy()
    c = convert.lm_cache_from_numpy(cache, "cpu")
    tok = torch.from_numpy(tok0)
    step = make_serve_step(cfg, fam)
    for i in range(STEPS):
        tok, logits, c = step(p, c, tok, POS0 + i)
        out[f"serve{i}__tokens"] = tok.numpy()
        out[f"serve{i}__logits"] = logits.numpy()
    for k, v in c.items():
        out[f"serve.cache['{k}']"] = v.numpy()
    return out


_RANKS = """
import dataclasses
import numpy as np
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core.collectives import make_grid
from repro_torch.data import shard_batch
from repro_torch.launch import opanalysis, shardings as sh
from repro_torch.models import layers, lm, registry
from repro_torch.serving.decode import make_prefill, make_serve_step
from repro_torch.training import Shardings, TrainState, make_train_step
from repro_torch.training import optimizer as opt_mod
ARCHS, TRAIN, B, S, T, STEPS, POS0 = ({archs!r}, {train!r}, {b}, {s}, {t},
                                      {steps}, {pos0})
grid = make_grid({shape!r}, {names!r})
axes = sh.batch_axes(grid)
layers.DTYPE = lm.DTYPE = torch.float32
out = {{}}


def cfg_of(name):
    arch = "starcoder2-3b" if name == "split" else name
    cfg, fam = registry.get(arch, smoke=True)
    if name == "split":
        cfg = dataclasses.replace(cfg, n_heads=6)
    return cfg, fam


def nest(flat):
    tree = {{}}
    for k, a in flat.items():
        keys = k[2:-2].split("']['")
        d = tree
        for key in keys[:-1]:
            d = d.setdefault(key, {{}})
        d[keys[-1]] = torch.from_numpy(a.copy())
    return tree


def mine(full):
    return shard_batch(dict(x=np.asarray(full)), grid, axes,
                       device="cpu")["x"]


for name in ARCHS:
    cfg, fam = cfg_of(name)
    z = dict(np.load({inputs!r} + f"/{{name}}.npz"))
    params = {{k[2:]: v for k, v in z.items() if k.startswith("p:")}}
    host = dict(tokens=z["tokens"], labels=z["labels"])
    for a, optname in TRAIN:
        if a != name:
            continue
        opt = getattr(opt_mod, optname)(lr=1e-3, warmup=1)
        p = nest(params)
        full = TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32))
        specs = sh.train_state_specs(full, grid, True)
        state = sh.place(full, specs, grid, "cpu")
        step = make_train_step(cfg, fam, opt,
                               shardings=Shardings(grid, specs))
        batch = shard_batch(host, grid, axes, device="cpu")
        if {count!r} and optname == "adamw":
            with opanalysis.StepCount() as count:
                state, m = step(state, batch)
            out[f"{{name}}__log"] = np.array(repr(count.collective_log))
        else:
            state, m = step(state, batch)
        tag = f"{{name}}__{{optname}}"
        out[tag + "__loss"] = np.array(float(m["loss"]))
        out[tag + "__gn"] = np.array(float(m["grad_norm"]))
        for k, v in ckpt.flatten(sh.gather(state, specs, grid)).items():
            if k != ".step":
                out[tag + k] = v.numpy()
    p = nest(params)
    tokens = dict(tokens=host["tokens"])
    specs = sh.serve_specs(p, grid, batch=tokens, fsdp=True)
    pspecs = {{k[len(".params"):]: v for k, v in specs.items()
              if k.startswith(".params")}}
    blocks = sh.place(p, pspecs, grid)
    logits, cache = make_prefill(cfg, fam, Shardings(grid, specs))(
        blocks, shard_batch(tokens, grid, axes, device="cpu"))
    out[f"{{name}}__prefill__logits"] = logits.numpy()
    for k, b in cache.items():
        shape = list(b.shape)
        shape[1] = B
        shape[2] = cfg.n_kv
        shape[3] = S
        spec = sh.port_cache_spec(f".cache['{{k}}']", tuple(shape), grid)
        out[f"{{name}}__prefill.cache['{{k}}']"] = sh.gather_leaf(
            b, spec, grid).numpy()
    cache0 = convert.lm_cache_from_numpy(
        {{k[2:]: v for k, v in z.items() if k.startswith("c:")}}, "cpu")
    tok = torch.from_numpy(z["tok0"])
    specs = sh.serve_specs(p, grid, batch=dict(tokens=tok), cache=cache0,
                           fsdp=True)
    cspecs = {{k[len(".cache"):]: v for k, v in specs.items()
              if k.startswith(".cache")}}
    out[f"{{name}}__cache_spec"] = np.array(repr(cspecs["['k']"]))
    cache = sh.place(cache0, cspecs, grid)
    step = make_serve_step(cfg, fam, shardings=Shardings(grid, specs))
    tok = mine(tok)
    for i in range(STEPS):
        tok, logits, cache = step(blocks, cache, tok, POS0 + i)
        out[f"{{name}}__serve{{i}}__tokens"] = tok.numpy()
        out[f"{{name}}__serve{{i}}__logits"] = logits.numpy()
    for k, v in sh.gather(cache, cspecs, grid).items():
        out[f"{{name}}__serve.cache['{{k}}']"] = v.numpy()
np.savez({outdir!r} + f"/rank{{RANK}}.npz", **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def runs():
    """{"ref": {arch: results}, "single": {arch: results}, grid name:
    [each rank's outputs]}."""
    with tempfile.TemporaryDirectory() as tmp:
        inputs = {}
        for name in ARCHS:
            inputs[name] = _inputs(name)
            params, batch, cache, tok0 = inputs[name]
            np.savez(os.path.join(tmp, f"{name}.npz"),
                     **{"p:" + k: v for k, v in params.items()},
                     **{"c:" + k: v for k, v in cache.items()},
                     tok0=tok0, **batch)

        def spawn():
            outs = {}
            for gname, (shape, names) in GRIDS.items():
                outdir = os.path.join(tmp, gname)
                os.mkdir(outdir)
                texts = run_ranks(_RANKS.format(
                    archs=ARCHS, train=TRAIN, b=B, s=S, t=T, steps=STEPS,
                    pos0=POS0, shape=shape, names=names, inputs=tmp,
                    outdir=outdir, count=gname == "1x4"), 4, timeout=300)
                assert all("DONE" in t for t in texts)
                outs[gname] = [dict(np.load(os.path.join(outdir,
                                                         f"rank{r}.npz")))
                               for r in range(4)]
            return outs
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(spawn)
            ref = {n: _reference(n, inputs[n]) for n in ARCHS}
            single = {n: _single(n, inputs[n]) for n in ARCHS}
            out = ranks.result()
    out.update(ref=ref, single=single)
    return out


def _rows(full, grid, rank):
    """Rank ``rank``'s rows (along dim 0) of a single-device result."""
    shape, names = GRIDS[grid]
    coords = np.unravel_index(rank, shape)
    n, r = 1, 0
    for name, size, c in zip(names, shape, coords):
        if name in ("pod", "data"):
            r, n = r * size + int(c), n * size
    per = full.shape[0] // n
    return full[r * per:(r + 1) * per]


def _leaf_close(got, want, what):
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("case", TRAIN, ids=lambda c: "-".join(c))
def test_tp_train_step_equals_single_device_steps(runs, grid, case):
    name, optname = case
    tag = f"{name}__{optname}"
    for want in (runs["single"][name], runs["ref"][name]):
        keys = sorted(k[len(optname):] for k in want
                      if k.startswith(optname + "."))
        assert keys
        for rank in runs[grid]:
            for m in ("loss", "gn"):
                got = float(rank[f"{tag}__{m}"])
                assert abs(got - want[f"{optname}__{m}"]) <= TOL * abs(
                    want[f"{optname}__{m}"]), (grid, tag, m)
            for k in keys:
                _leaf_close(rank[tag + k], want[optname + k],
                            f"{grid} {tag}{k}")


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", ARCHS)
def test_tp_prefill_and_decode_equal_single_device_steps(runs, grid, name):
    for want in (runs["single"][name], runs["ref"][name]):
        for r, rank in enumerate(runs[grid]):
            got = rank[f"{name}__prefill__logits"]
            err = np.abs(got - _rows(want["prefill__logits"], grid, r)).max()
            assert err <= TOL, (grid, name, r, err)
            for i in range(STEPS):
                np.testing.assert_array_equal(
                    rank[f"{name}__serve{i}__tokens"],
                    _rows(want[f"serve{i}__tokens"], grid, r))
                err = np.abs(rank[f"{name}__serve{i}__logits"] - _rows(
                    want[f"serve{i}__logits"], grid, r)).max()
                assert err <= TOL, (grid, name, r, i, err)
            for part in ("prefill", "serve"):
                for k in ("k", "v"):
                    key = f"{part}.cache['{k}']"
                    _leaf_close(rank[f"{name}__{key}"], want[key],
                                f"{grid} {name} {key}")


def test_the_caches_are_cut_as_the_reference_cuts_them(runs):
    """deepseek-7b's 4 KV heads are cut over ``model`` (port dim 2); the
    other archs' single KV head is not, so their positions are (dim 3)."""
    for grid in GRIDS:
        for name in ARCHS:
            spec = eval(str(runs[grid][0][f"{name}__cache_spec"]))
            assert spec[2 if name == "deepseek-7b" else 3] == "model", (
                grid, name, spec)


def _model_gathers(log):
    """The operand shapes of the all-gathers over the 4-rank group."""
    return [shapes[0] for cls, n, shapes in eval(str(log))
            if cls == "all-gather" and n == 4]


@pytest.mark.parametrize("name", ARCHS)
def test_no_whole_parameter_is_gathered_over_model(runs, name):
    """On the (1, 4) grid the dense train step's only all-gathers over
    ``model`` are of one layer's ``wk`` / ``wv`` block where it is not
    whole KV heads (and ``wq``'s where it splits a head): those of item
    3, each (d, cols / 4); deepseek-7b's step gathers nothing over it."""
    cfg, _, _, _ = _cfgs(name)
    d, hd = cfg.d_model, cfg.head_dim
    allowed = set()
    if (cfg.n_kv * hd // 4) % hd:
        allowed.add((cfg.n_kv * hd // 4, d))    # (cols, d): moved to dim 0
    if (cfg.n_heads * hd // 4) % hd:
        allowed.add((cfg.n_heads * hd // 4, d))
    for rank in runs["1x4"]:
        got = _model_gathers(rank[f"{name}__log"])
        assert set(got) == allowed, (name, set(got))
        # forward, the remat's forward again: one a layer each time
        per = (1 if (cfg.n_heads * hd // 4) % hd else 0) + 2 * (
            1 if (cfg.n_kv * hd // 4) % hd else 0)
        assert len(got) == 2 * cfg.n_layers * per


def test_the_other_families_gather_every_parameter_over_model():
    """Without tensor-parallel leaves a family's step gathers each
    parameter whole over ``model``: the family table declares only the
    dense family's."""
    assert set(lm.TP_LEAVES) == {"dense"}
    assert {"wq", "wo", "w_in", "w_out", "tok_emb",
            "lm_head"} <= set(lm.TP_LEAVES["dense"])


def test_query_heads_read_their_kv_heads():
    """``layers._kv_for``: the KV heads a rank's query heads read, one
    KV head a query head where they do not group evenly (12 heads on 3
    KV heads, rank 1 of 4: heads 3-5 read KV heads 0, 1, 1)."""
    k = torch.arange(3.0).reshape(1, 1, 3, 1).expand(2, 5, 3, 4)
    kq, vq = layers._kv_for(k, k + 10, 3, 3, 0, 4)
    assert kq[0, 0, :, 0].tolist() == [0.0, 1.0, 1.0]
    assert vq[0, 0, :, 0].tolist() == [10.0, 11.0, 11.0]
    kq, _ = layers._kv_for(k, k, 4, 4, 0, 4)         # one group: a view
    assert kq.shape[2] == 1 and kq[0, 0, 0, 0] == 1.0


def test_drop_axis_and_port_cache_spec():
    grid = sh.MeshShape(("data", "model"), (2, 4))
    assert sh.drop_axis((None, "data", "model"), "model") == (None, "data",
                                                              None)
    assert sh.names_axis(("model", None), "model")
    assert not sh.names_axis((None, "data"), "model")
    with pytest.raises(ValueError, match="other axes"):
        sh.drop_axis((("data", "model"),), "model")
    # (L, B, Hkv, T, D): 8 heads over 4 are cut; 2 heads are not, T is
    assert sh.port_cache_spec(".cache['k']", (2, 4, 8, 16, 8), grid) == (
        None, "data", "model", None, None)
    assert sh.port_cache_spec(".cache['k']", (2, 4, 2, 16, 8), grid) == (
        None, "data", None, "model", None)
    assert [sh.kv_cut(sh.port_cache_spec(".cache['k']", shape, grid))
            for shape in ((2, 4, 8, 16, 8), (2, 4, 2, 16, 8),
                          (2, 4, 2, 6, 8))] == ["heads", "positions", "whole"]
    assert decode.cache_batch_dims(*registry.get("deepseek-7b", smoke=True)
                                   ) == {"['k']": 1, "['v']": 1}


def test_model_grid_restores_the_context_before_it():
    """``layers.model_grid`` sets this rank's ``model`` block (size,
    coordinate, the cache's cut) for its ``with`` block only; outside it
    the layers compute on one device (``LOCAL``)."""
    assert layers.MODEL_GRID is layers.LOCAL
    assert layers.LOCAL.grid is None and layers.LOCAL.m == 1
    grid = sh.MeshShape(("data", "model"), (1, 2), (0, 1))
    with layers.model_grid(grid, "positions"):
        tp = layers.MODEL_GRID
        assert (tp.m, tp.r, tp.kv_cut) == (2, 1, "positions")
        assert tp.t_global(8) == 16
    assert layers.MODEL_GRID is layers.LOCAL
    with pytest.raises(ValueError, match="kv_cut"):
        with layers.model_grid(grid, "rows"):
            pass
