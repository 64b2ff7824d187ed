"""The port's dense LM family (``repro_torch.models``) against the JAX
reference's (``repro.models``), on the CPU.

Parameters are drawn by the reference's ``fam["init"]`` and carried
across with ``convert.lm_params_from_numpy``; inputs come from a numpy
seed.  The reduced configs (``registry.reduced``) of the five dense
archs run; on the CPU the port's ``attention_decode`` takes
``ops.decode_attention``'s plain version.

Tolerances:
* f32 (the reference's parameters cast to f32 in the test): rtol / atol
  1e-4, the two summing in other orders;
* bf16 (the parameters as drawn): rtol / atol 5e-2 on logits and
  activations, a few bf16 roundings apart (bf16 keeps 8 bits: a
  rounding is up to 0.4% of the value), and on caches.  The reference
  rounds its decode attention's probabilities to bf16 before the P.V
  product (``layers.py:295``); the kernel and its plain version keep
  them in f32.

Every new module is imported by its own name (the reference's dead-code
gate walks ``src/``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving.kvcache import pad_cache as jpad_cache  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, lm, registry  # noqa: E402
from repro_torch.serving.kvcache import pad_cache  # noqa: E402

DENSE = ["starcoder2-3b", "starcoder2-15b", "deepseek-7b", "h2o-danube-3-4b",
         "pixtral-12b"]
F32_TOL = 1e-4
BF16_TOL = 5e-2

_PARAMS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(arch):
    """(reference cfg, fam, bf16 params), drawn once per arch."""
    if arch not in _PARAMS:
        cfg, fam = jreg.get(arch, smoke=True)
        _PARAMS[arch] = (cfg, fam, fam["init"](cfg, jax.random.PRNGKey(0)))
    return _PARAMS[arch]


def _both(arch, f32: bool):
    """(jcfg, jfam, jparams, cfg, fam, params): the reference's params
    (cast to f32 when ``f32``) and the port's copy of them."""
    jcfg, jfam, jp = _ref(arch)
    if f32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    cfg, fam = registry.get(arch, smoke=True)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jfam, jp, cfg, fam, params


_JITTED = {}


def _jit(jfam, name):
    """The reference family's function, jitted with its config static
    (compiled once per shape, not traced again at every call)."""
    key = (id(jfam), name)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jfam[name],
                               static_argnums=4 if name == "decode" else 2)
    return _JITTED[key]


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_registry_copy_equals_reference(arch):
    want, got = jreg.ARCHS[arch], registry.ARCHS[arch]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(registry.reduced(got)) == dataclasses.asdict(
        jreg.reduced(want))
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.vocab_pad == want.vocab_pad
    assert [f.name for f in dataclasses.fields(registry.ModelConfig)] == [
        f.name for f in dataclasses.fields(jreg.ModelConfig)]
    assert registry.VOCAB_ALIGN == jreg.VOCAB_ALIGN


@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_every_arch_resolves_to_the_reference_family(arch):
    """``registry.get`` resolves every arch of the pool, full and reduced,
    to the family whose functions carry the reference's names (encdec
    from ``encdec.py``, the others from ``lm.py``)."""
    for smoke in (False, True):
        jcfg, jfam = jreg.get(arch, smoke=smoke)
        cfg, fam = registry.get(arch, smoke=smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert sorted(fam) == sorted(jfam) == [
            "decode", "forward", "init", "init_cache", "prefill"]
        for name in fam:
            assert fam[name].__name__ == jfam[name].__name__, name
            assert fam[name].__module__.startswith("repro_torch.models.")
        assert fam is registry.get_family(cfg)


def test_dense_archs_resolve_to_the_dense_family():
    assert sorted(a for a, c in registry.ARCHS.items()
                  if c.family == "dense") == sorted(DENSE)
    for arch in DENSE:
        cfg, fam = registry.get(arch, smoke=True)
        assert fam is lm.FAMILIES["dense"] and cfg == registry.reduced(
            registry.ARCHS[arch])


# -------------------------------------------------------------------- init
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def params_leaf(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", DENSE)
def test_init_has_the_reference_shapes_dtypes_and_scales(arch):
    """The port's own draw: the reference's keys, shapes and dtypes (bf16
    weights, f32 norms), norms exactly ones and zeros, each weight's
    standard deviation within 10% of the reference's draw."""
    jcfg, jfam, jp = _ref(arch)
    cfg, fam = registry.get(arch, smoke=True)
    params = fam["init"](cfg, torch.Generator().manual_seed(3), "cpu")
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(params))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == w.dtype.name, name
        if "norm" in name:
            assert np.array_equal(g.numpy(), w), name
        else:
            ws, gs = float(np.std(w.astype(np.float32))), float(g.float().std())
            assert abs(gs - ws) <= 0.1 * ws, (name, gs, ws)


def test_init_refuses_a_generator_on_another_device():
    cfg, fam = registry.get("deepseek-7b", smoke=True)
    with pytest.raises(ValueError, match="generator"):
        fam["init"](cfg, torch.Generator(), torch.device("meta"))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = _t(x, getattr(torch, dtype))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = layers.rmsnorm(tx, _t(w))
    assert got.dtype == tx.dtype
    _close(got, jlayers.rmsnorm(jx, jnp.asarray(w)), tol)
    _close(layers.layernorm(tx, _t(w), _t(b)),
           jlayers.layernorm(jx, jnp.asarray(w), jnp.asarray(b)), tol)
    for bias in (False, True):
        p = jlayers.norm_init(48, with_bias=bias)
        tp = layers.norm_init(48, with_bias=bias)
        assert sorted(tp) == sorted(p)
        _close(layers.apply_norm(tp, tx), jlayers.apply_norm(p, jx), tol)


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "no-heads"])
def test_rope_matches_reference(heads):
    rng = np.random.default_rng(1)
    shape = (2, 7, 3, 16) if heads else (2, 7, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    _close(layers.rope_freqs(16, 1e5), jlayers.rope_freqs(16, 1e5), 1e-6)
    _close(layers.apply_rope(_t(x), _t(pos), 1e5),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e5),
           F32_TOL)


@pytest.mark.parametrize("window", [0, 3])
def test_causal_mask_matches_reference(window):
    got = layers.causal_mask(4, 6, 11, window)
    want = jlayers.causal_mask(4, 6, 11, window)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _x(cfg, rng, b=2, s=12, dtype=np.float32):
    return (rng.standard_normal((b, s, cfg.d_model))).astype(dtype)


@pytest.mark.parametrize("q_chunk", [0, 4], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", DENSE)
def test_attention_matches_reference(arch, q_chunk):
    """Prefill attention: plain matmuls and a masked softmax, with the
    reference's query chunking (12 queries in blocks of 4)."""
    jcfg, _, jp, cfg, _, params = _both(arch, f32=True)
    x = _x(cfg, np.random.default_rng(2))
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    jo, (jk, jv) = jlayers.attention(jlp["attn"], jnp.asarray(x), jcfg,
                                     q_chunk=q_chunk)
    to, (tk, tv) = layers.attention(lm.layer(params["layers"], 0)["attn"],
                                    _t(x), cfg, q_chunk=q_chunk)
    _close(to, jo, F32_TOL)
    _close(tk, jk, F32_TOL)
    _close(tv, jv, F32_TOL)


def test_prefill_attention_uses_no_library_attention(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("scaled_dot_product_attention called")
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        refuse)
    _, _, _, cfg, fam, params = _both("starcoder2-3b", f32=True)
    toks = torch.zeros((1, 6), dtype=torch.long)
    fam["forward"](params, dict(tokens=toks), cfg)
    fam["prefill"](params, dict(tokens=toks), cfg)


DECODE_CASES = {            # T, pos, ring
    "inside": (10, 6, False),
    "past-end": (10, 13, False),
    "ring-cold": (8, 3, True),
    "ring-wrapped": (8, 21, True),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("arch", DENSE)
def test_attention_decode_matches_reference(arch, case):
    """One decode step of one layer against a seeded cache: the new slot
    (``min(pos, T-1)``, or ``pos % T`` in a ring) written in place and
    the output, in f32; ``ops.decode_attention`` runs once."""
    t, pos, ring = DECODE_CASES[case]
    jcfg, _, jp, cfg, _, params = _both(arch, f32=True)
    rng = np.random.default_rng(3)
    x = _x(cfg, rng, s=1)
    ck = rng.standard_normal((2, t, cfg.n_kv, cfg.head_dim)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    jo, jc = jlayers.attention_decode(
        jlp["attn"], jnp.asarray(x), dict(k=jnp.asarray(ck), v=jnp.asarray(cv)),
        jnp.int32(pos), jcfg, ring=ring)
    cache = dict(k=_t(ck).transpose(1, 2).contiguous(),
                 v=_t(cv).transpose(1, 2).contiguous())
    calls = []
    real = ops.decode_attention

    def counted(*a, **k):
        calls.append(a[3].tolist())
        return real(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "decode_attention", counted)
        to, tc = layers.attention_decode(
            lm.layer(params["layers"], 0)["attn"], _t(x), cache, pos, cfg,
            ring=ring)
    assert tc is cache
    assert calls == [[t if ring else min(pos + 1, t)] * 2]
    _close(to, jo, F32_TOL)
    _close(tc["k"].transpose(1, 2), jc["k"], F32_TOL)
    _close(tc["v"].transpose(1, 2), jc["v"], F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_mlp_matches_reference(arch, dtype):
    jcfg, _, jp, cfg, _, params = _both(arch, f32=dtype == "float32")
    x = _x(cfg, np.random.default_rng(4))
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    got = layers.mlp(lm.layer(params["layers"], 0)["mlp"],
                     _t(x, getattr(torch, dtype)), cfg)
    want = jlayers.mlp(jlp["mlp"], jnp.asarray(x, dtype), jcfg)
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


# ------------------------------------------------------------------ the LM
def _tokens(cfg, seed, b=2, s=12):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_reference(arch, dtype):
    """Forward logits, prefill logits and cache, then two decode steps
    on the padded cache (logits and cache), against the reference."""
    f32 = dtype == "float32"
    tol = F32_TOL if f32 else BF16_TOL
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=f32)
    toks = _tokens(cfg, 5)
    jl, _ = _jit(jfam, "forward")(jp, dict(tokens=jnp.asarray(toks)), jcfg)
    tl, aux = fam["forward"](params, dict(tokens=_t(toks)), cfg)
    assert aux == 0.0 and tl.dtype == params["lm_head"].dtype
    _close(tl, jl, tol)
    jl, jc = _jit(jfam, "prefill")(jp, dict(tokens=jnp.asarray(toks)), jcfg)
    tl, tc = fam["prefill"](params, dict(tokens=_t(toks)), cfg)
    _close(tl, jl, tol)
    for key in ("k", "v"):
        _close(convert.lm_cache_to_numpy(tc)[key], jc[key], tol)
    jc, tc = jpad_cache(jcfg, jc, 3), pad_cache(cfg, tc, 3)
    for i, pos in enumerate((12, 13)):
        nt = _tokens(cfg, 6 + i, s=1)
        jl, jc = _jit(jfam, "decode")(jp, jc, jnp.asarray(nt),
                                      jnp.int32(pos), jcfg)
        tl, tc = fam["decode"](params, tc, _t(nt), pos, cfg)
        assert tl.shape == (2, cfg.vocab_pad)
        _close(tl, jl, tol)
        back = convert.lm_cache_to_numpy(tc)
        for key in ("k", "v"):
            _close(back[key], jc[key], tol)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Teacher forcing on the port alone (the reference's
    ``test_decode_matches_forward``): prefill on s-1 tokens, one decode
    step of the last reproduces the forward's last logits, and prefill's
    logits its logits one position before; f32 at 1e-4, bf16 at the
    reference test's 5e-2.  A sliding-window arch's padded prefill cache
    does not grow (the reference's rule), so there every token is
    decoded into a window-sized ring instead.  A cold ring's step attends
    to its zero slots too (the reference's mask), so layer l's keys are
    the forward's from position l (W - 1) on, and the logits from
    L (W - 1) on."""
    for f32, tol in ((True, F32_TOL), (False, BF16_TOL)):
        _, _, _, cfg, fam, params = _both(arch, f32=f32)
        warm = cfg.n_layers * (cfg.swa_window - 1)
        s = warm + 4 if cfg.swa_window else 12
        toks = _t(_tokens(cfg, 7, b=1, s=s))
        full, _ = fam["forward"](params, dict(tokens=toks), cfg)
        if cfg.swa_window:
            cache = fam["init_cache"](cfg, 1, s, "cpu")
            cache = {k: v.to(params["lm_head"].dtype) for k, v in
                     cache.items()}
            for pos in range(s):
                lg, cache = fam["decode"](params, cache,
                                          toks[:, pos:pos + 1], pos, cfg)
                if pos >= warm:
                    _close(lg, full[:, pos].float().numpy(), tol)
            continue
        logits_p, cache = fam["prefill"](params, dict(tokens=toks[:, :-1]),
                                         cfg)
        cache = pad_cache(cfg, cache, 1)
        lg, _ = fam["decode"](params, cache, toks[:, -1:], 11, cfg)
        _close(lg, full[:, -1].float().numpy(), tol)
        _close(logits_p[:, 0], full[:, -2].float().numpy(), tol)


def test_ring_cache_decode_matches_reference_past_the_window():
    """h2o-danube's sliding window: a window-sized cache from
    ``init_cache``, 20 decode steps (positions wrap the ring twice), f32
    logits and cache against the reference at every step."""
    jcfg, jfam, jp, cfg, fam, params = _both("h2o-danube-3-4b", f32=True)
    assert cfg.swa_window == 8
    jc = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jfam["init_cache"](jcfg, 2, 32))
    tc = fam["init_cache"](cfg, 2, 32, "cpu")
    assert tc["k"].shape == (cfg.n_layers, 2, cfg.n_kv, 8, cfg.head_dim)
    tc = {k: v.float() for k, v in tc.items()}
    rng = np.random.default_rng(8)
    for pos in range(20):
        nt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = _jit(jfam, "decode")(jp, jc, jnp.asarray(nt),
                                      jnp.int32(pos), jcfg)
        tl, tc = fam["decode"](params, tc, _t(nt), pos, cfg)
        _close(tl, jl, F32_TOL)
    _close(convert.lm_cache_to_numpy(tc)["k"], jc["k"], F32_TOL)


def test_input_embeds_prefill_matches_reference():
    """pixtral's precomputed-embedding input: cast to bf16 as the
    reference does, then the same prefill."""
    jcfg, jfam, jp, cfg, fam, params = _both("pixtral-12b", f32=False)
    emb = np.random.default_rng(9).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    jl, jc = jfam["prefill"](jp, dict(embeds=jnp.asarray(emb)), jcfg)
    tl, tc = fam["prefill"](params, dict(embeds=_t(emb)), cfg)
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, BF16_TOL)
    _close(convert.lm_cache_to_numpy(tc)["v"], jc["v"], BF16_TOL)


# ---------------------------------------------------------------- convert
def _fill(shapes, rng):
    """Seeded values in the shapes and dtypes of a reference tree of
    ``ShapeDtypeStruct`` (``jax.eval_shape``: no compile)."""
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        s.dtype), shapes)


def _old_rule(np_cache):
    """The conversion before the recurrent families: every 5-d leaf of a
    flat dict transposed on axes 2 and 3."""
    return {k: np.swapaxes(v, 2, 3) if v.ndim == 5 else v
            for k, v in np_cache.items()}


def _np_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _np_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _np_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_convert_round_trips_every_family(arch):
    """Every family's parameters and cache through ``convert`` and back,
    bit for bit, from seeded values in the reference's shapes and dtypes:
    the parameters land in the port's own ``init``'s shapes and dtypes,
    the cache in the port's ``init_cache``'s.  Only attention K / V
    leaves swap time and heads: the dense, moe and mla_moe caches cross
    as before the recurrent families (``_old_rule``), and no recurrent
    state (hybrid's ssm / conv, xlstm's tuples) nor whisper's cross
    ``ck`` / ``cv`` is transposed."""
    jcfg, jfam = jreg.get(arch, smoke=True)
    cfg, fam = registry.get(arch, smoke=True)
    rng = np.random.default_rng(21)
    np_params = _fill(jax.eval_shape(lambda: jfam["init"](
        jcfg, jax.random.PRNGKey(0))), rng)
    params = convert.lm_params_from_numpy(np_params, "cpu")
    own = fam["init"](cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted((n, tuple(t.shape), str(t.dtype))
                  for n, t in _leaves(params)) == sorted(
        (n, tuple(t.shape), str(t.dtype)) for n, t in _leaves(own))
    back = dict(_np_leaves(convert.lm_params_to_numpy(params)))
    for n, w in _np_leaves(np_params):
        assert np.array_equal(back[n], w.astype(np.float32)), n
    np_cache = _fill(jax.eval_shape(lambda: jfam["init_cache"](jcfg, 2, 5)),
                     rng)
    cache = convert.lm_cache_from_numpy(np_cache, "cpu")
    mine = fam["init_cache"](cfg, 2, 5, "cpu")
    assert sorted((n, tuple(t.shape), str(t.dtype))
                  for n, t in _np_leaves(cache)) == sorted(
        (n, tuple(t.shape), str(t.dtype)) for n, t in _np_leaves(mine))
    kv = {"/k", "/v", "/shared/k", "/shared/v"}
    for (n, w), (_, t) in zip(_np_leaves(np_cache), _np_leaves(cache)):
        assert t.is_contiguous(), n
        want = np.swapaxes(w, 2, 3) if n in kv else w
        assert np.array_equal(t.float().numpy(), want.astype(np.float32)), n
    if cfg.family in ("dense", "moe", "mla_moe"):
        old = _old_rule(np_cache)
        assert all(np.array_equal(cache[k].float().numpy(),
                                  old[k].astype(np.float32)) for k in old)
    back = convert.lm_cache_to_numpy(cache)
    assert type(back) is type(np_cache)
    back = dict(_np_leaves(back))
    for n, w in _np_leaves(np_cache):
        assert np.array_equal(back[n], w.astype(np.float32)), n


def test_lm_params_and_cache_cross_bit_for_bit():
    """bf16 parameters keep their 16 bits through ``lm_params_from_numpy``
    (and come back as the f32 that holds each exactly); the cache's time
    and head axes swap both ways."""
    jcfg, jfam, jp = _ref("starcoder2-3b")
    npp = jax.tree.map(np.asarray, jp)
    params = convert.lm_params_from_numpy(npp, "cpu")
    back = convert.lm_params_to_numpy(params)
    for (name, w), (name2, g) in zip(sorted(_leaves(npp)),
                                     sorted(_leaves(back))):
        assert name == name2
        assert str(params_leaf(params, name).dtype).endswith(w.dtype.name)
        assert np.array_equal(g, w.astype(np.float32)), name
    _, jc = jfam["prefill"](jp, dict(tokens=jnp.zeros((2, 5), jnp.int32)),
                            jcfg)
    npc = jax.tree.map(np.asarray, jc)
    tc = convert.lm_cache_from_numpy(npc, "cpu")
    assert tc["k"].shape == (jcfg.n_layers, 2, jcfg.n_kv, 5, jcfg.head_dim)
    assert tc["k"].is_contiguous() and tc["k"].dtype == torch.bfloat16
    back = convert.lm_cache_to_numpy(tc)
    assert all(np.array_equal(back[k], npc[k].astype(np.float32))
               for k in ("k", "v"))

