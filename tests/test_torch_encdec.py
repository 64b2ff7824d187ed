"""The port's encoder-decoder family (``repro_torch.models.encdec``,
whisper-tiny) against the JAX reference's, on the CPU: the sinusoidal
positions, cross-attention, the encoder, forward, prefill, decode, the
loss and its gradients, ``generate``, ``ServeScheduler`` and the
training launcher.

Parameters are drawn by the reference's ``fam["init"]`` and carried
across with ``convert.lm_params_from_numpy``; frames and tokens come
from a numpy seed; the reduced config (``registry.reduced``) runs.  The
audio front end is a stub in both: the batch carries frame embeddings.

Tolerances (``tests/test_torch_recurrent.py``'s):
* f32 (the reference's parameters cast to f32 in the test): rtol / atol
  ``F32_TOL`` 1e-4; the reference's encoder rounds its frames to bf16
  (``astype(DTYPE)``) and its layer scan then refuses f32 weights, so
  the f32 runs set both modules' ``DTYPE`` to f32 (``_both``);
  gradients within ``GRAD_TOL`` 1e-4 of a leaf's max, the loss within
  1e-5 relative; greedy tokens exact;
* bf16: rtol / atol ``BF16_TOL`` 5e-2;
* three launcher steps in f32: each loss within ``STEP_RTOL`` 1e-3.
* ``sinusoidal``: 1e-5 at positions below 64 (f32 sin / cos of
  arguments up to 64, two libraries).

Every new module is imported by its own name (the reference's dead-code
gate walks ``src/``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import train as jtrain  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import decode as jdecode  # noqa: E402
from repro.serving import kvcache as jkvcache  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro.training import train_step as jts  # noqa: E402

import repro_torch.launch.serve as serve  # noqa: E402
import repro_torch.launch.train as train  # noqa: E402
import repro_torch.models.encdec as encdec  # noqa: E402
import repro_torch.training.train_step as ts_mod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, lm, registry  # noqa: E402
from repro_torch.serving import decode, kvcache, scheduler  # noqa: E402

ARCH = "whisper-tiny"
F32_TOL = 1e-4
BF16_TOL = 5e-2
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
STEP_RTOL = 1e-3
S_ENC = 20


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _ref():
    """(reference cfg, fam, bf16 params), drawn once."""
    if not _PARAMS:
        cfg, fam = jreg.get(ARCH, smoke=True)
        init = jax.jit(fam["init"], static_argnums=0)
        _PARAMS[ARCH] = (cfg, fam, init(cfg, jax.random.PRNGKey(0)))
    return _PARAMS[ARCH]


def _both(f32: bool, mp=None):
    """(jcfg, jfam, jparams, cfg, fam, params); with ``f32`` the
    reference's parameters cast to f32 and both encoders' frame dtype
    set to f32 through ``mp`` (a ``monkeypatch``): the reference's
    ``_encode`` rounds its frames to ``DTYPE`` (bf16) and its layer scan
    then refuses f32 weights (the carry turns f32)."""
    jcfg, jfam, jp = _ref()
    if f32:
        mp.setattr(jencdec, "DTYPE", jnp.float32)
        mp.setattr(encdec, "DTYPE", torch.float32)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    cfg, fam = registry.get(ARCH, smoke=True)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jfam, jp, cfg, fam, params


_JITTED = {}


def _jit(jfam, name):
    key = (id(jfam), name)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jfam[name],
                               static_argnums=4 if name == "decode" else 2)
    return _JITTED[key]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _leaves_close(got, want, tol, what=""):
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


def _batch(cfg, seed, b=2, s=8, s_enc=S_ENC, labels=False):
    """(reference batch, port batch): frames (B, S_enc, d) f32, decoder
    tokens (B, S), and labels when asked."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out = dict(embeds=emb, tokens=toks)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _f32_cache(tree):
    return {k: v.float() for k, v in tree.items()}


# -------------------------------------------------------------- the layers
@pytest.mark.parametrize("dim", [64, 384])
def test_sinusoidal_matches_reference(dim):
    pos = np.arange(64)
    want = jencdec.sinusoidal(jnp.asarray(pos), dim)
    got = encdec.sinusoidal(torch.from_numpy(pos), dim)
    assert got.dtype == torch.float32 and got.shape == (64, dim)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype, monkeypatch):
    """Decoder tokens against 20 encoder positions (every one attended),
    layer 0's cross parameters."""
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both(f32, monkeypatch)
    jlp = jax.tree.map(lambda a: a[0], jp["dec_layers"]["cross"])
    lp = lm.layer(params["dec_layers"], 0)["cross"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((2, S_ENC, cfg.n_kv, cfg.head_dim)).astype(
        np.float32)
    v = rng.standard_normal((2, S_ENC, cfg.n_kv, cfg.head_dim)).astype(
        np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.cross_attention(jlp, jnp.asarray(x, jd),
                                   (jnp.asarray(k, jd), jnp.asarray(v, jd)),
                                   jcfg)
    got = layers.cross_attention(lp, _t(x, td), (_t(k, td), _t(v, td)), cfg)
    assert got.dtype == td
    _close(got, want, F32_TOL if f32 else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_cross_kv_match_reference(dtype, monkeypatch):
    """The bidirectional encoder's output and every decoder layer's cross
    (k, v) of it, (L, B, S_enc, Hkv, D)."""
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both(f32, monkeypatch)
    jb, tb = _batch(cfg, 2)
    want = jax.jit(jencdec._encode, static_argnums=2)(jp, jb["embeds"], jcfg)
    got = encdec._encode(params, tb["embeds"], cfg)
    tol = F32_TOL if f32 else BF16_TOL
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol)
    jk, jv = jax.jit(jencdec._cross_kv, static_argnums=2)(jp, want, jcfg)
    tk, tv = encdec._cross_kv(params, _t(_np(want), got.dtype), cfg)
    assert tuple(tk.shape) == (cfg.dec_layers, 2, S_ENC, cfg.n_kv,
                               cfg.head_dim)
    _close(tk, jk, tol)
    _close(tv, jv, tol)


def test_encoder_attention_is_bidirectional(monkeypatch):
    """An encoder position reads the positions after it: changing the last
    frame moves the first position's output (it would not under a
    causal mask)."""
    _, _, _, cfg, _, params = _both(True, monkeypatch)
    _, tb = _batch(cfg, 3)
    a = encdec._encode(params, tb["embeds"], cfg)
    e = tb["embeds"].clone()
    e[:, -1] += 1.0
    b = encdec._encode(params, e, cfg)
    assert not torch.allclose(a[:, 0], b[:, 0])


# ----------------------------------------------------------------- the LM
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_init_has_the_reference_shapes_dtypes_and_scales():
    """The port's own draw: the reference's keys (``enc_layers``,
    ``dec_layers`` with ``self`` / ``cross`` / ``mlp``), shapes and
    dtypes, norms exactly ones and zeros, each drawn weight's standard
    deviation within 10% of the reference's."""
    jcfg, jfam, jp = _ref()
    cfg, fam = registry.get(ARCH, smoke=True)
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
            ws = float(np.std(w.astype(np.float32)))
            gs = float(g.float().std())
            assert abs(gs - ws) <= 0.1 * ws, (name, gs, ws)
    with pytest.raises(ValueError, match="generator"):
        fam["init"](cfg, torch.Generator(), torch.device("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_reference(dtype, monkeypatch):
    """Forward logits; prefill logits and its cache (self k / v swapped
    to (L, B, Hkv, T, D), cross ck / cv as the reference's); then two
    decode steps from the reference's padded cache carried by
    ``convert`` (the port's own padded cache checked equal to it
    first), logits and cache."""
    f32 = dtype == "float32"
    tol = F32_TOL if f32 else BF16_TOL
    jcfg, jfam, jp, cfg, fam, params = _both(f32, monkeypatch)
    jb, tb = _batch(cfg, 4)
    jl, _ = _jit(jfam, "forward")(jp, jb, jcfg)
    tl, aux = fam["forward"](params, tb, cfg)
    assert tl.dtype == params["lm_head"].dtype and aux == 0.0
    _close(tl, jl, tol)
    jl, jc = _jit(jfam, "prefill")(jp, jb, jcfg)
    tl, tc = fam["prefill"](params, tb, cfg)
    _close(tl, jl, tol)
    assert tuple(tc["k"].shape) == (cfg.dec_layers, 2, cfg.n_kv, 8,
                                    cfg.head_dim)
    assert tuple(tc["ck"].shape) == (cfg.dec_layers, 2, S_ENC, cfg.n_kv,
                                     cfg.head_dim)
    jc, tc = jkvcache.pad_cache(jcfg, jc, 3), kvcache.pad_cache(cfg, tc, 3)
    assert tc["k"].shape[3] == 11 and tc["ck"].shape[2] == S_ENC
    back = convert.lm_cache_to_numpy(tc)
    assert sorted(back) == sorted(jc)
    for key in jc:
        _close(back[key], jc[key], tol, key)
    tc = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for i, pos in enumerate((8, 9)):
        nt = np.random.default_rng(5 + i).integers(0, cfg.vocab, (2, 1)
                                                   ).astype(np.int32)
        jl, jc = _jit(jfam, "decode")(jp, jc, jnp.asarray(nt),
                                      jnp.int32(pos), jcfg)
        tl, tc2 = fam["decode"](params, tc, _t(nt), pos, cfg)
        assert tc2 is tc and tl.shape == (2, cfg.vocab_pad)
        _close(tl, jl, tol)
        back = convert.lm_cache_to_numpy(tc)
        for key in jc:
            _close(back[key], jc[key], tol, key)


def test_decode_matches_forward(monkeypatch):
    """Teacher forcing on the port alone, f32 at 1e-4 and bf16 at 5e-2:
    prefill on the frames and the first token, then every later token
    decoded (self-attention through the decode path, cross-attention
    over the prefill's ``ck`` / ``cv``) gives the forward's logits at
    its position."""
    for f32, tol in ((False, BF16_TOL), (True, F32_TOL)):
        _, _, _, cfg, fam, params = _both(f32, monkeypatch)
        _, tb = _batch(cfg, 6, b=1, s=10)
        full, _ = fam["forward"](params, tb, cfg)
        lg, cache = fam["prefill"](params, dict(embeds=tb["embeds"],
                                                tokens=tb["tokens"][:, :1]),
                                   cfg)
        _close(lg[:, 0], full[:, 0], tol)
        cache = kvcache.pad_cache(cfg, cache, 9)
        for pos in range(1, 10):
            lg, cache = fam["decode"](params, cache,
                                      tb["tokens"][:, pos:pos + 1], pos, cfg)
            _close(lg, full[:, pos], tol, f"position {pos}")


def test_decode_launches_decode_attention_once_a_decoder_layer(monkeypatch):
    """whisper's decode step: ``ops.decode_attention`` once a decoder
    layer on its (B, Hkv, T, D) self-attention slice; the
    cross-attention launches none.  Full width: G = 1 at D = 64 over 4
    decoder layers."""
    _, _, _, cfg, fam, params = _both(True, monkeypatch)
    calls = []
    real = ops.decode_attention

    def counted(q, k, v, lengths, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), lengths.tolist()))
        assert k.is_contiguous() and v.is_contiguous()
        return real(q, k, v, lengths, **kw)
    monkeypatch.setattr(ops, "decode_attention", counted)
    cache = _f32_cache(fam["init_cache"](cfg, 3, 16, "cpu"))
    step = decode.make_serve_step(cfg, fam)
    for pos in range(3):
        step(params, cache, torch.zeros((3, 1), dtype=torch.int32), pos)
    assert calls == [((3, cfg.n_heads, cfg.head_dim),
                      (3, cfg.n_kv, 16, cfg.head_dim), [pos + 1] * 3)
                     for pos in range(3) for _ in range(cfg.dec_layers)]
    full = registry.ARCHS[ARCH]
    assert (full.n_heads // full.n_kv, full.head_dim, full.dec_layers) == (
        1, 64, 4)


# -------------------------------------------------------- loss and training
def test_loss_and_grads_match_reference(monkeypatch):
    """forward + ``lm_loss`` and its gradient on f32 copies (the encoder
    unrematted, each decoder block rematted, as in the reference)
    against ``jax.grad``; ``tok_emb`` and the frames' path included."""
    jcfg, jfam, jp, cfg, fam, params = _both(True, monkeypatch)
    jb, tb = _batch(cfg, 7, s=16, labels=True)
    jl, jg = jax.jit(jax.value_and_grad(jts.make_loss_fn(jcfg, jfam)))(jp,
                                                                       jb)
    tl, tg = ts_mod.value_and_grad(ts_mod.make_loss_fn(cfg, fam), params, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _leaves_close(tg, jg, GRAD_TOL, ARCH)


def test_train_main_matches_reference_launcher(monkeypatch, capsys):
    """``launch.train.main --smoke`` and the reference's from the same f32
    parameters on the same synthetic batches (frames and decoder tokens,
    the launcher's encdec batch): 3 AdamW steps (step 0 at lr 0), each
    loss within ``STEP_RTOL``."""
    _, _, jp, cfg, _, params = _both(True, monkeypatch)
    real, jreal = registry.get, jreg.get
    jp = jax.tree.map(lambda a: jnp.array(a, copy=True), jp)  # donated

    def get(a, smoke=False):
        c, fam = real(a, smoke)
        return c, dict(fam, init=lambda c, gen, dev: params)

    def jget(a, smoke=False):
        c, fam = jreal(a, smoke)
        return c, dict(fam, init=lambda c, key: jp)
    monkeypatch.setattr(registry, "get", get)
    monkeypatch.setattr(jreg, "get", jget)
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--lr", "3e-3"]
    got = train.main(argv, device="cpu")
    want = jtrain.main(argv)
    assert len(got) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    assert got[2] != got[1]
    assert "family=encdec" in capsys.readouterr().out


def test_batch_source_caps_the_decoder_at_448_tokens():
    """The launcher's encdec batch: frames of the whole sequence, decoder
    tokens and labels cut to 448 (whisper's decoder positions)."""
    cfg, _ = registry.get(ARCH)
    _, batch_at = train.batch_source(cfg, 1500, 2)
    b = batch_at(0)
    assert b["embeds"].shape == (2, 1500, cfg.d_model)
    assert b["tokens"].shape == b["labels"].shape == (2, 448)


# ----------------------------------------------------------------- serving
def test_generate_matches_reference(monkeypatch):
    """Prefill on the frames and a 4-token prompt, padding, then greedy
    decode steps, f32: the same tokens."""
    jcfg, jfam, jp, cfg, fam, params = _both(True, monkeypatch)
    jb, tb = _batch(cfg, 8, s=4)
    want = np.asarray(jdecode.generate(jcfg, jfam, jp, jb, 6))
    got = decode.generate(cfg, fam, params, tb, 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert np.array_equal(got.numpy(), want)


def test_scheduler_matches_reference(monkeypatch):
    """Three slots over a 20-position cache, f32: the same requests
    complete in the same order with the same tokens.  The scheduler's
    ``init_cache`` holds all-zero ``ck`` / ``cv``, so its
    cross-attention reads zeros (the reference's meaning, kept)."""
    jcfg, jfam, jp, cfg, fam, params = _both(True, monkeypatch)
    jsched = jscheduler.ServeScheduler(jcfg, jfam, jp, batch_slots=3,
                                       max_len=20)
    jsched.cache = jax.tree.map(lambda a: a.astype(jnp.float32),
                                jsched.cache)
    sched = scheduler.ServeScheduler(cfg, fam, params, batch_slots=3,
                                     max_len=20)
    assert not sched.cache["ck"].any()
    sched.cache = _f32_cache(sched.cache)
    rng = np.random.default_rng(3)
    reqs = [(rid, rng.integers(0, cfg.vocab, 20 if rid == 2 else int(
        rng.integers(3, 10))).astype(np.int32), int(rng.integers(4, 17)))
        for rid in range(6)]
    for s in (jsched, sched):
        mod = jscheduler if s is jsched else scheduler
        for rid, prompt, max_new in reqs:
            s.submit(mod.Request(rid=rid, prompt=prompt, max_new=max_new))
    want, got = jsched.run(), sched.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert 2 not in [r.rid for r in got]
    assert [r.out for r in got] == [r.out for r in want]
    assert np.array_equal(sched.lengths, jsched.lengths)


def test_serve_main_on_the_cpu(capsys):
    argv = ["--arch", ARCH, "--requests", "3", "--slots", "2", "--max-new",
            "4", "--max-len", "16"]
    got = serve.main(argv, device="cpu")
    assert [(r.rid, len(r.out)) for r in got] == [(0, 4), (1, 4), (2, 4)]
    assert "served 3/3 requests, 12 tokens" in capsys.readouterr().out
