"""The port's MoE families (``moe``: granite-moe; ``mla_moe``:
deepseek-v3) against the JAX reference's, on the CPU: the MoE layer's
routing, drops and aux loss, MLA, each family's forward (with the MTP
logits), prefill and decode, the loss and its gradients, two train
steps, the caches through ``convert`` and ``kvcache``, the optimizers'
per-matrix runs and the entry points (``generate``, ``ServeScheduler``
and the cache plans are in ``tests/test_torch_serving.py``).

Parameters are drawn by the reference's ``fam["init"]`` and carried
across with ``convert.lm_params_from_numpy``; inputs come from a numpy
seed; the reduced configs (``registry.reduced``) run.

Tolerances (``tests/test_torch_models.py``'s and
``tests/test_torch_training.py``'s where they hold):
* routing (experts, capacity positions, drops) exact; greedy tokens
  exact in f32;
* one layer on the same inputs, f32 copies of the parameters: rtol /
  atol 1e-4 (MoE output, aux, MLA, MLA decode), gradients within 1e-4
  of a leaf's max |g|; bf16 parameters: 5e-2;
* whole models in f32: the MoE layer casts to bf16 where the reference
  casts (tokens into the dispatch, the SwiGLU product, the combine
  weights, and in the backward their cotangents), so f32 runs round
  there too.  An f32 value whose last bits differ between the packages
  (another summation order upstream) can round one bf16 step the other
  way, 2^-8 of it; measured here one such token in ~3,000 roundings of
  the forward (3.5e-4 on the logits) and a few cotangents in the
  backward (3.7e-3 of a gradient leaf's max).  So whole-model values
  are held to ``MOE_F32_TOL`` (2e-3), the loss to 1e-5 relative,
  gradients to ``MOE_GRAD_TOL`` (1e-2 of a leaf's max), two train steps'
  loss and grad norm to 1e-3 relative, moments to 1e-2 of a leaf's max
  and parameters to ``2 lr`` (AdamW's first moving step is sign-like: a
  gradient near zero whose sign such a rounding turns moves its element
  by up to 2 lr; measured 1.4e-3 at lr 1e-3).  bf16 models: 5e-2.

Every new module is imported by its own name (the reference's dead-code
gate walks ``src/``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import kvcache as jkvcache  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402

import repro_torch.launch.serve as serve  # noqa: E402
import repro_torch.launch.train as train  # noqa: E402
import repro_torch.training.optimizer as opt_mod  # noqa: E402
import repro_torch.training.train_step as ts_mod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, lm, registry  # noqa: E402
from repro_torch.serving import decode, kvcache  # noqa: E402

MOE = ["granite-moe-1b-a400m", "deepseek-v3-671b"]
F32_TOL = 1e-4
BF16_TOL = 5e-2
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
MOE_F32_TOL = 2e-3
MOE_GRAD_TOL = 1e-2
STEP_RTOL = 1e-3
MOMENT_TOL = 1e-2
# a leaf's update (parameters after the steps less before) against the
# reference's, over the reference's update's norm: 2.1e-3 at most read
# (deepseek-v3's Adafactor), where an update halved reads 0.5 and one
# skipped reads 1
UPDATE_RTOL = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _ref(arch):
    """(reference cfg, fam, bf16 params), drawn once per arch."""
    if arch not in _PARAMS:
        cfg, fam = jreg.get(arch, smoke=True)
        init = jax.jit(fam["init"], static_argnums=0)
        _PARAMS[arch] = (cfg, fam, init(cfg, jax.random.PRNGKey(0)))
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
    key = (id(jfam), name)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jfam[name],
                               static_argnums=4 if name == "decode" else 2)
    return _JITTED[key]


_JMOE = jax.jit(jlayers.moe, static_argnums=(2, 3, 4))
_JMLA = jax.jit(jlayers.mla_attention, static_argnums=(2, 3, 4))
_JMLA_DECODE = jax.jit(jlayers.mla_decode, static_argnums=4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _leaves_close(got, want, tol, what=""):
    """Every leaf of ``got`` within ``tol`` of its ``want`` leaf's max |x|
    (the same keys in both)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _leaves_close(got[k], want[k], tol, f"{what}/{k}")
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} x {scale}"


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _tokens(cfg, seed, b=2, s=12):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _layer0(jp, params, key):
    """Layer 0 of the reference's and the port's stack ``key``."""
    return (jax.tree.map(lambda a: a[0], jp[key]),
            lm.layer(params[key], 0))


def _moe_stack(cfg):
    return "layers" if cfg.family == "moe" else "moe_layers"


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_archs_resolve(arch, smoke):
    cfg, fam = registry.get(arch, smoke=smoke)
    assert fam is lm.FAMILIES[cfg.family]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreg.get(arch, smoke=smoke)[0])


# -------------------------------------------------------------------- init
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", MOE)
def test_init_has_the_reference_shapes_dtypes_and_scales(arch):
    """The port's own draw: the reference's keys, shapes and dtypes (bf16
    weights and experts, f32 router and norms), norms exactly ones and
    zeros, each weight's standard deviation within 10% of the
    reference's draw."""
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
        if "norm/" in name:
            assert np.array_equal(g.numpy(), w), name
        else:
            ws = float(np.std(w.astype(np.float32)))
            gs = float(g.float().std())
            assert abs(gs - ws) <= 0.1 * ws, (name, gs, ws)
    with pytest.raises(ValueError, match="generator"):
        fam["init"](cfg, torch.Generator(), torch.device("meta"))


# ------------------------------------------------------------------ the MoE
def _ref_route(probs, k, cap):
    """The reference's routing (``layers.py:371-386``) on (G, Tg, E)
    probabilities: experts, positions in capacity, keep."""
    e = probs.shape[-1]
    ng, g_sz = probs.shape[:2]
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    flat = onehot.reshape(ng, g_sz * k, e)
    pos = jnp.cumsum(flat, axis=1) - 1.0
    pos = jnp.sum(pos * flat, axis=-1).reshape(ng, g_sz, k)
    return np.asarray(idx), np.asarray(pos).astype(np.int64), \
        np.asarray(pos < cap)


ROUTE_CASES = {            # group_size, capacity_factor: 0 = the default
    "default": (0, 0.0),
    "drops": (8, 0.5),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("arch", MOE)
def test_routing_equals_reference(arch, case):
    """The port's experts, capacity positions and drops equal the
    reference's bit for bit on the layer's own router probabilities; the
    small group and capacity factor drop pairs, the default keeps
    them."""
    group, cf = ROUTE_CASES[case]
    _, _, jp, cfg, _, params = _both(arch, f32=True)
    _, lp = _layer0(jp, params, _moe_stack(cfg))
    x = np.random.default_rng(1).standard_normal((2, 12, cfg.d_model))
    xn = layers.apply_norm(lp["moe"]["norm"], _t(x.astype(np.float32)))
    g_sz = min(group or layers.MOE_GROUP, 24)
    probs = torch.softmax(xn.reshape(24 // g_sz, g_sz, -1)
                          @ lp["moe"]["router"], dim=-1)
    cap = layers.moe_capacity(cfg.top_k, g_sz, cfg.n_experts,
                              cf or layers.MOE_CF)
    assert cap == int(np.ceil(cfg.top_k * g_sz / cfg.n_experts
                              * (cf or jlayers.MOE_CF)))
    gate, idx, pos, keep = layers.moe_route(probs, cfg.top_k, cap)
    widx, wpos, wkeep = _ref_route(jnp.asarray(probs.numpy()), cfg.top_k,
                                   cap)
    assert np.array_equal(idx.numpy(), widx)
    assert np.array_equal(pos.numpy(), wpos)
    assert np.array_equal(keep.numpy(), wkeep)
    assert (not keep.all()) == (case == "drops")
    _close(gate.sum(-1), np.ones(gate.shape[:2]), 1e-6)


def test_routing_ties_take_the_lower_expert_first():
    """Equal probabilities: ``jax.lax.top_k``'s order (lower index first),
    which ``torch.topk`` does not promise."""
    probs = np.full((1, 6, 8), 1 / 8, np.float32)
    probs[0, 1, [2, 5]] = 0.2
    probs[0, 3] = [0.05, 0.2, 0.05, 0.2, 0.2, 0.1, 0.1, 0.1]
    _, idx, pos, keep = layers.moe_route(torch.from_numpy(probs), 3, 2)
    widx, wpos, wkeep = _ref_route(jnp.asarray(probs), 3, 2)
    assert np.array_equal(idx.numpy(), widx)
    assert np.array_equal(pos.numpy(), wpos)
    assert np.array_equal(keep.numpy(), wkeep)
    assert idx[0, 3].tolist() == [1, 3, 4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_reference(arch, case, dtype):
    """The layer's output and aux loss (granite without a shared expert,
    deepseek-v3 with one), with the default group and with one that
    drops pairs."""
    f32 = dtype == "float32"
    group, cf = ROUTE_CASES[case]
    jcfg, _, jp, cfg, _, params = _both(arch, f32=f32)
    jlp, lp = _layer0(jp, params, _moe_stack(cfg))
    x = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jo, jaux = _JMOE(jlp["moe"], jnp.asarray(x, dtype), jcfg, group, cf)
    to, taux = layers.moe(lp["moe"], _t(x, getattr(torch, dtype)), cfg,
                          group, cf)
    assert to.dtype == getattr(torch, dtype)
    tol = F32_TOL if f32 else BF16_TOL
    _close(to, jo, tol)
    assert abs(float(taux) - float(jaux)) <= tol * abs(float(jaux))


def test_moe_layer_gradients_match_reference():
    """Gradients of a scalar of the layer's output and aux (the
    dispatch's gather and the combine's indexed sum against the dense
    one-hot products), f32 parameters, pairs dropped."""
    jcfg, _, jp, cfg, _, params = _both("deepseek-v3-671b", f32=True)
    jlp, lp = _layer0(jp, params, "moe_layers")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        o, aux = jlayers.moe(p, x, jcfg, 8, 0.5)
        return jnp.sum(o * jnp.asarray(w)) + 3.0 * aux
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jlp["moe"],
                                                      jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in convert.lm_params_from_numpy(
                  jax.tree.map(np.asarray, jlp["moe"]), "cpu").items()
              if not isinstance(v, dict)}
    tp = dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jlp["moe"]), "cpu"), **leaves)
    tx = _t(x).requires_grad_()
    o, aux = layers.moe(tp, tx, cfg, 8, 0.5)
    (torch.sum(o * _t(w)) + 3.0 * aux).backward()
    for k, v in leaves.items():
        _leaves_close(v.grad, jg[k], GRAD_TOL, k)
    _leaves_close(tx.grad, jgx, GRAD_TOL, "x")
    del lp


# ---------------------------------------------------------------------- MLA
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_reference(dtype):
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both("deepseek-v3-671b", f32=f32)
    jlp, lp = _layer0(jp, params, "dense_layers")
    x = np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jo, (jc, jkr) = _JMLA(jlp["attn"], jnp.asarray(x, dtype), jcfg)
    to, (tc, tkr) = layers.mla_attention(lp["attn"],
                                         _t(x, getattr(torch, dtype)), cfg)
    tol = F32_TOL if f32 else BF16_TOL
    for got, want in ((to, jo), (tc, jc), (tkr, jkr)):
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, tol)


@pytest.mark.parametrize("q_chunk", [0, 4], ids=["whole", "chunked"])
def test_mla_attention_chunked_matches_reference(q_chunk):
    """12 queries in blocks of 4 (the reference's chunking rule: only
    past twice the block), f32."""
    jcfg, _, jp, cfg, _, params = _both("deepseek-v3-671b", f32=True)
    jlp, lp = _layer0(jp, params, "moe_layers")
    x = np.random.default_rng(5).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32)
    jo, _ = _JMLA(jlp["attn"], jnp.asarray(x), jcfg, None, q_chunk)
    to, _ = layers.mla_attention(lp["attn"], _t(x), cfg, q_chunk=q_chunk)
    _close(to, jo, F32_TOL)


@pytest.mark.parametrize("pos", [6, 13], ids=["inside", "past-end"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype, pos):
    """One decode step against a seeded latent cache of 10 slots: the new
    slot written in place (``min(pos, T - 1)``) and the output."""
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both("deepseek-v3-671b", f32=f32)
    jlp, lp = _layer0(jp, params, "dense_layers")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((2, 10, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, 10, cfg.qk_rope_dim)).astype(np.float32)
    jd = getattr(jnp, dtype)
    jo, jc = _JMLA_DECODE(jlp["attn"], jnp.asarray(x, jd),
                                dict(c=jnp.asarray(c, jd),
                                     kr=jnp.asarray(kr, jd)),
                                jnp.int32(pos), jcfg)
    td = getattr(torch, dtype)
    cache = dict(c=_t(c, td), kr=_t(kr, td))
    to, tc = layers.mla_decode(lp["attn"], _t(x, td), cache, pos, cfg)
    assert tc is cache and to.dtype == td
    tol = F32_TOL if f32 else BF16_TOL
    _close(to, jo, tol)
    _close(tc["c"], jc["c"], tol)
    _close(tc["kr"], jc["kr"], tol)


# ------------------------------------------------------------------ the LMs
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_decode_match_reference(arch, dtype):
    """Forward logits (and deepseek-v3's MTP logits) and aux, prefill
    logits and cache, then two decode steps on the padded cache (logits
    and cache), against the reference."""
    f32 = dtype == "float32"
    tol = MOE_F32_TOL if f32 else BF16_TOL
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=f32)
    toks = _tokens(cfg, 5)
    (jl, jaux) = _jit(jfam, "forward")(jp, dict(tokens=jnp.asarray(toks)),
                                       jcfg)
    tl, taux = fam["forward"](params, dict(tokens=_t(toks)), cfg)
    if cfg.mtp:
        assert isinstance(tl, tuple) and len(tl) == 2
        _close(tl[1], jl[1], tol)
        tl, jl = tl[0], jl[0]
    assert tl.dtype == params["lm_head"].dtype
    _close(tl, jl, tol)
    assert abs(float(taux) - float(jaux)) <= (1e-5 if f32 else BF16_TOL) \
        * abs(float(jaux))
    jl, jc = _jit(jfam, "prefill")(jp, dict(tokens=jnp.asarray(toks)), jcfg)
    tl, tc = fam["prefill"](params, dict(tokens=_t(toks)), cfg)
    _close(tl, jl, tol)
    assert sorted(tc) == sorted(jc)
    for key, leaf in convert.lm_cache_to_numpy(tc).items():
        _close(leaf, jc[key], tol)
    jc, tc = jkvcache.pad_cache(jcfg, jc, 3), kvcache.pad_cache(cfg, tc, 3)
    for i, pos in enumerate((12, 13)):
        nt = _tokens(cfg, 6 + i, s=1)
        jl, jc = _jit(jfam, "decode")(jp, jc, jnp.asarray(nt),
                                      jnp.int32(pos), jcfg)
        tl, tc = fam["decode"](params, tc, _t(nt), pos, cfg)
        assert tl.shape == (2, cfg.vocab_pad)
        _close(tl, jl, tol)
        for key, leaf in convert.lm_cache_to_numpy(tc).items():
            _close(leaf, jc[key], tol)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward(arch, monkeypatch):
    """Teacher forcing on the port alone, f32 at 1e-4 and bf16 at 5e-2.
    The forward routes the sequence's 12 tokens as one group and a
    decode step its one token, so the capacity factor is raised (both
    paths) until no pair is dropped.  granite: prefill on 11 tokens and
    one decode step give the forward's last two logits.  deepseek-v3:
    every token decoded from ``init_cache``, each step's logits the
    forward's at that position (the reference's prefill caches k_rope
    before RoPE and its decode after, so decode after prefill is not the
    forward's there either)."""
    monkeypatch.setattr(layers, "MOE_CF", 8.0)
    for f32, tol in ((True, MOE_F32_TOL), (False, BF16_TOL)):
        _, _, _, cfg, fam, params = _both(arch, f32=f32)
        toks = _t(_tokens(cfg, 7, b=1, s=12))
        full, _ = fam["forward"](params, dict(tokens=toks), cfg)
        full = full[0] if isinstance(full, tuple) else full
        if cfg.family == "mla_moe":
            cache = {k: v.to(params["lm_head"].dtype) for k, v in
                     fam["init_cache"](cfg, 1, 12, "cpu").items()}
            for pos in range(12):
                lg, cache = fam["decode"](params, cache,
                                          toks[:, pos:pos + 1], pos, cfg)
                _close(lg, full[:, pos], tol)
            continue
        logits_p, cache = fam["prefill"](params, dict(tokens=toks[:, :-1]),
                                         cfg)
        cache = kvcache.pad_cache(cfg, cache, 1)
        lg, _ = fam["decode"](params, cache, toks[:, -1:], 11, cfg)
        _close(lg, full[:, -1], tol)
        _close(logits_p[:, 0], full[:, -2], tol)


def test_moe_decode_launches_decode_attention_once_a_layer(monkeypatch):
    """granite's decode step: ``ops.decode_attention`` once a layer, on
    the (B, Hkv, T, D) slice of the cache (its plain version here)."""
    _, _, _, cfg, fam, params = _both("granite-moe-1b-a400m", f32=True)
    shapes = []
    real = ops.decode_attention

    def counted(q, k, v, lengths, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape), lengths.tolist()))
        return real(q, k, v, lengths, **kw)
    monkeypatch.setattr(ops, "decode_attention", counted)
    step = decode.make_serve_step(cfg, fam)
    cache = {k: v.float() for k, v in
             fam["init_cache"](cfg, 3, 16, "cpu").items()}
    for pos in range(3):
        step(params, cache, torch.zeros((3, 1), dtype=torch.int32), pos)
    assert shapes == [((3, cfg.n_heads, cfg.head_dim),
                       (3, cfg.n_kv, 16, cfg.head_dim), [pos + 1] * 3)
                      for pos in range(3) for _ in range(cfg.n_layers)]


def test_mla_decode_launches_no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("decode_attention called on the MLA path")
    monkeypatch.setattr(ops, "decode_attention", refuse)
    _, _, _, cfg, fam, params = _both("deepseek-v3-671b", f32=True)
    out = decode.generate(cfg, fam, params, dict(tokens=_t(_tokens(cfg, 8))),
                          3)
    assert out.shape == (2, 3)


# ------------------------------------------------------------------ caches
@pytest.mark.parametrize("arch", MOE)
def test_cache_crosses_convert_with_its_time_axis(arch):
    """A prefill cache carried both ways through ``convert``: granite's
    k / v swap time and head axes; deepseek-v3's latent (L, B, T, r)
    leaves keep time on axis 2, bit for bit (bf16)."""
    jcfg, jfam, jp = _ref(arch)
    _, jc = jfam["prefill"](jp, dict(tokens=jnp.zeros((2, 5), jnp.int32)),
                            jcfg)
    npc = jax.tree.map(np.asarray, jc)
    tc = convert.lm_cache_from_numpy(npc, "cpu")
    for key, leaf in tc.items():
        assert leaf.is_contiguous() and leaf.dtype == torch.bfloat16
        if key in ("k", "v"):
            assert leaf.shape == (jcfg.n_layers, 2, jcfg.n_kv, 5,
                                  jcfg.head_dim)
        else:
            assert tuple(leaf.shape) == npc[key].shape
            assert leaf.shape[2] == 5
    back = convert.lm_cache_to_numpy(tc)
    assert sorted(back) == sorted(npc)
    assert all(np.array_equal(back[k], npc[k].astype(np.float32))
               for k in npc)


def test_mla_cache_plan_is_the_latent_one():
    """deepseek-v3's cache plan: the latent leaves' bytes, which a
    (T, H, D) cache of the same model would exceed by
    H (dn + dr + dv) / (dc + dr) (about 71x at full width)."""
    cfg, fam = registry.get("deepseek-v3-671b")
    plan = kvcache.plan_cache(cfg, fam, 4, 1024)
    per_pos = cfg.n_layers * 4 * 1024 * 2
    assert plan.bytes_total == per_pos * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    full = per_pos * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim
                                    + cfg.v_head_dim)
    assert 70 < full / plan.bytes_total < 72


# -------------------------------------------------------- loss and training
def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return (dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels)),
            dict(tokens=torch.from_numpy(toks),
                 labels=torch.from_numpy(labels)))


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference(arch):
    """forward + ``lm_loss`` (aux at ``moe_aux_weight``, deepseek-v3's MTP
    head at 0.1) and its gradient on f32 copies against ``jax.grad``."""
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=True)
    jb, tb = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(jts.make_loss_fn(jcfg, jfam)))(jp,
                                                                       jb)
    tl, tg = ts_mod.value_and_grad(ts_mod.make_loss_fn(cfg, fam), params, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _leaves_close(tg, jg, MOE_GRAD_TOL, arch)


@pytest.mark.parametrize("arch", MOE)
def test_two_train_steps_match_reference(arch):
    """Two steps from one f32 state carried by ``convert``: granite with
    AdamW, deepseek-v3 with Adafactor (the launcher's choice for
    ``mla_moe``); loss and grad norm, each leaf's update (within
    ``UPDATE_RTOL`` of the reference's update) and the moments."""
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=True)
    name = "adafactor" if cfg.family == "mla_moe" else "adamw"
    assert train.make_optimizer(cfg, 1e-3, 1).name == name
    jo = getattr(jopt, name)(lr=1e-3, warmup=1)
    to = getattr(opt_mod, name)(lr=1e-3, warmup=1)
    jstate = jts.TrainState.create(jp, jo)
    state = convert.train_state_from_numpy(jax.device_get(jstate), "cpu")
    jstep = jax.jit(jts.make_train_step(jcfg, jfam, jo))
    step = ts_mod.make_train_step(cfg, fam, to)
    for i in range(2):
        jb, tb = _batch(cfg, b=2, s=16, seed=10 + i)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        for k in ("loss", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= STEP_RTOL * abs(
                float(jm[k])), (i, k)
    for got, want, p0 in zip(opt_mod.tree_leaves(state.params),
                             jax.tree.leaves(jstate.params),
                             jax.tree.leaves(jp)):
        moved = np.linalg.norm(_np(want) - _np(p0))
        assert moved > 0
        assert np.linalg.norm(_np(got) - _np(want)) <= UPDATE_RTOL * moved
    _leaves_close(state.opt_state, jstate.opt_state, MOMENT_TOL, "moments")


LEAF = (2, 3, 8, 4)


@pytest.mark.parametrize("elems", [1, 64, 1 << 30],
                         ids=["one-matrix", "two-matrices", "whole"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_matrix_runs_equal_a_whole_leaf_update(name, elems, monkeypatch):
    """A (2, 3, 8, 4) leaf (and a (5, 8) matrix and a vector beside it)
    updated in runs of one matrix, of two, and whole: three steps, each
    against the reference's whole-leaf update, within 1e-6 of a leaf's
    max (AdamW's runs elementwise the same bits as the whole leaf's)."""
    monkeypatch.setattr(opt_mod, "SLICE_ELEMS", elems)
    assert len(opt_mod.matrix_runs(LEAF)) == {1: 6, 64: 3, 1 << 30: 1}[elems]
    rng = np.random.default_rng(11)
    tree = dict(a=rng.standard_normal(LEAF).astype(np.float32),
                b=rng.standard_normal((5, 8)).astype(np.float32),
                c=rng.standard_normal(7).astype(np.float32))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.lm_params_from_numpy(tree, "cpu")
    jo = getattr(jopt, name)(lr=1e-2, warmup=1)
    to = getattr(opt_mod, name)(lr=1e-2, warmup=1)
    js, tstate = jo.init(jp), to.init(tp)
    for step in range(3):
        g = {k: (rng.standard_normal(v.shape) * 1e-1).astype(np.float32)
             for k, v in tree.items()}
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.int32(step))
        to.update(convert.lm_params_from_numpy(g, "cpu"), tstate, tp,
                  torch.tensor(step, dtype=torch.int32))
    _leaves_close(tp, jp, 1e-6, f"{name} params")
    _leaves_close(tstate, js, 1e-6, f"{name} state")


def test_matrix_runs_bound_deepseek_v3_expert_stack():
    """One MoE layer's expert stack at full width, (1, 256, 7168, 2048):
    runs of 4 matrices (58.7 M elements), none past ``SLICE_ELEMS``."""
    shape = (1, 256, 7168, 2048)
    runs = opt_mod.matrix_runs(shape)
    assert len(runs) == 64
    assert all((r.stop - r.start) * 7168 * 2048 <= opt_mod.SLICE_ELEMS
               for r in runs)
    assert runs[-1].stop == 256


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", MOE)
def test_serve_main_on_the_cpu(arch, capsys):
    """``launch.serve.main`` on the reduced MoE archs with ``device="cpu"``:
    every request served, each with the reference main's token count
    (the port draws its own parameters)."""
    argv = ["--arch", arch, "--requests", "4", "--slots", "2",
            "--max-new", "5", "--max-len", "24"]
    got = serve.main(argv, device="cpu")
    want = jserve.main(argv)
    assert [(r.rid, len(r.out)) for r in got] == [
        (r.rid, len(r.out)) for r in want]
    assert "served 4/4 requests, 20 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", MOE)
def test_train_main_on_the_cpu(arch, capsys):
    """``launch.train.main`` on the reduced MoE archs: finite losses that
    fall, the launcher's optimizer (AdamW / Adafactor)."""
    losses = train.main(["--arch", arch, "--smoke", "--steps", "6",
                         "--batch", "2", "--seq", "16", "--lr", "3e-3"],
                        device="cpu")
    out = capsys.readouterr().out
    cfg, _ = registry.get(arch, smoke=True)
    assert f"family={cfg.family}" in out
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < losses[0], losses


def test_scheduler_routes_the_batch_as_one_group():
    """A decode step's B tokens are one routing group: with a capacity of
    one pair an expert (granite reduced, B 3, cf 0.5: C = ceil(2 * 3 / 4
    * 0.5) = 1), the first row's token changes the later rows' outputs
    (capacity goes to the earlier tokens), in the port as in the
    reference."""
    jcfg, jfam, jp, cfg, fam, params = _both("granite-moe-1b-a400m",
                                             f32=True)
    jlp, lp = _layer0(jp, params, "layers")
    x = np.random.default_rng(12).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    y = x.copy()
    y[0] = -y[0]
    outs = []
    for inp in (x, y):
        jo, _ = _JMOE(jlp["moe"], jnp.asarray(inp), jcfg, 0, 0.5)
        to, _ = layers.moe(lp["moe"], _t(inp), cfg, 0, 0.5)
        _close(to, jo, F32_TOL)
        outs.append(to)
    assert not torch.allclose(outs[0][1:], outs[1][1:])
