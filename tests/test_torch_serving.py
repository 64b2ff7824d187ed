"""The port's serving stack (``repro_torch.serving``, ``launch.serve``)
against the JAX reference's, on the CPU.

The reduced configs of the five dense archs and the two MoE ones
(granite-moe, deepseek-v3; the recurrent and encoder-decoder families'
serving is in ``tests/test_torch_recurrent.py`` and
``tests/test_torch_encdec.py``); parameters drawn by the
reference's ``fam["init"]``, cast to f32 in the test and carried across
with ``convert.lm_params_from_numpy``, so that greedy tokens can be
held exactly equal (in bf16 the two round differently: see
``tests/test_torch_models.py``).  The reference's scheduler gets the
f32 copies by assignment (``sched.params``, ``sched.cache``).  Cache
plans are compared in bytes for every arch, full-width configs
included.

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
from repro.models import registry as jreg  # noqa: E402
from repro.serving import decode as jdecode  # noqa: E402
from repro.serving import kvcache as jkvcache  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import decode, kvcache, scheduler  # noqa: E402

DENSE = ["starcoder2-3b", "starcoder2-15b", "deepseek-7b", "h2o-danube-3-4b",
         "pixtral-12b"]
SERVED = DENSE + ["granite-moe-1b-a400m", "deepseek-v3-671b"]
F32_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_pair(arch):
    """(jcfg, jfam, f32 reference params, cfg, fam, the port's copy)."""
    jcfg, jfam = jreg.get(arch, smoke=True)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jfam["init"](jcfg, jax.random.PRNGKey(0)))
    cfg, fam = registry.get(arch, smoke=True)
    return (jcfg, jfam, jp, cfg, fam,
            convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


# ----------------------------------------------------------------- kvcache
@pytest.mark.parametrize("smoke", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_plan_cache_bytes_equal_reference(arch, smoke):
    """Sized from shapes alone (the meta device): no memory, at full
    width too; a ring cache never grows past its window; every leaf of
    a nested cache counted (hybrid's ``shared``, xlstm's tuples)."""
    jcfg, jfam = jreg.get(arch, smoke=smoke)
    cfg, fam = registry.get(arch, smoke=smoke)
    for batch, length, devices in ((4, 128, 4), (8, 32768, 1)):
        want = jkvcache.plan_cache(jcfg, jfam, batch, length, devices)
        got = kvcache.plan_cache(cfg, fam, batch, length, devices)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", SERVED)
def test_pad_cache_matches_reference(arch):
    """The prefill cache grown by 3 zero slots on the time axis (k / v:
    axis 3 of the port's layout, 2 of the reference's; MLA's latent
    leaves: axis 2 in both); a sliding-window arch's stays as it is."""
    jcfg, jfam, jp, cfg, fam, params = _f32_pair(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 5)).astype(
        np.int32)
    _, jc = jfam["prefill"](jp, dict(tokens=jnp.asarray(toks)), jcfg)
    _, tc = fam["prefill"](params, dict(tokens=torch.from_numpy(toks)), cfg)
    jc, got = jkvcache.pad_cache(jcfg, jc, 3), kvcache.pad_cache(cfg, tc, 3)
    t = 5 if cfg.swa_window else 8
    assert sorted(got) == sorted(jc)
    for key, leaf in got.items():
        assert leaf.shape[kvcache.TIME_AXIS[key]] == t, key
    if "k" in got:
        assert got["k"].shape == (cfg.n_layers, 2, cfg.n_kv, t,
                                  cfg.head_dim)
    back = convert.lm_cache_to_numpy(got)
    for key in got:
        np.testing.assert_allclose(back[key], np.asarray(jc[key]),
                                   rtol=F32_TOL, atol=F32_TOL)
        assert not back[key][:, :, 5:].any()


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_logits_greedy_masks_the_vocab_padding(dtype):
    """The padding columns hold the largest logits; greedy still picks
    within the vocabulary, as the reference does, first index on ties;
    temperature sampling from a generator stays inside it too."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 512)).astype(np.float32)
    logits[:, 500:] = 50.0
    logits[3, [7, 9]] = 9.0                       # a tie: index 7 wins
    want = np.asarray(jdecode.sample_logits(
        jnp.asarray(logits, dtype), jax.random.PRNGKey(0), 0.0, 500))
    got = decode.sample_logits(torch.from_numpy(logits).to(
        getattr(torch, dtype)), None, 0.0, 500)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want) and got[3] == 7
    hot = decode.sample_logits(torch.from_numpy(logits), torch.Generator()
                               .manual_seed(0), 0.7, 500)
    assert hot.shape == (6,) and int(hot.max()) < 500


@pytest.mark.parametrize("arch", SERVED)
def test_generate_matches_reference(arch):
    """Prefill, padding, then greedy decode steps: the same tokens."""
    jcfg, jfam, jp, cfg, fam, params = _f32_pair(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)
    want = np.asarray(jdecode.generate(jcfg, jfam, jp,
                                       dict(tokens=jnp.asarray(toks)), 6))
    got = decode.generate(cfg, fam, params, dict(tokens=torch.from_numpy(
        toks)), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert np.array_equal(got.numpy(), want)


def test_serve_step_launches_decode_attention_once_a_layer(monkeypatch):
    """The decode step's attention goes through ``ops.decode_attention``,
    once per layer per step, on a (B, Hkv, T, D) slice of the cache."""
    _, _, _, cfg, fam, params = _f32_pair("deepseek-7b")
    shapes = []
    real = ops.decode_attention

    def counted(q, k, v, lengths, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape), lengths.tolist()))
        assert k.is_contiguous() and v.is_contiguous()
        return real(q, k, v, lengths, **kw)
    monkeypatch.setattr(ops, "decode_attention", counted)
    step = decode.make_serve_step(cfg, fam)
    cache = {k: v.float() for k, v in
             fam["init_cache"](cfg, 3, 16, "cpu").items()}
    for pos in range(4):
        step(params, cache, torch.zeros((3, 1), dtype=torch.int32), pos)
    assert shapes == [((3, cfg.n_heads, cfg.head_dim),
                       (3, cfg.n_kv, 16, cfg.head_dim), [pos + 1] * 3)
                      for pos in range(4) for _ in range(cfg.n_layers)]


# --------------------------------------------------------------- scheduler
def _requests(cfg, max_len):
    """Seeded prompts of 3-9 tokens with max_new 4-16 (some stop at
    ``max_len - 1``), and one prompt of ``max_len`` tokens (dropped)."""
    rng = np.random.default_rng(3)
    reqs = []
    for rid in range(7):
        n = max_len if rid == 2 else int(rng.integers(3, 10))
        reqs.append((rid, rng.integers(0, cfg.vocab, n).astype(np.int32),
                     int(rng.integers(4, 17))))
    return reqs


@pytest.mark.parametrize("arch", SERVED)
def test_scheduler_matches_reference(arch):
    """Three slots over a 20-position cache (h2o-danube's is its
    8-slot ring): the same requests complete in the same order with the
    same tokens, and the slots end at the same lengths."""
    jcfg, jfam, jp, cfg, fam, params = _f32_pair(arch)
    slots, max_len = 3, 20
    jsched = jscheduler.ServeScheduler(jcfg, jfam, jp, batch_slots=slots,
                                       max_len=max_len)
    jsched.cache = jax.tree.map(lambda a: a.astype(jnp.float32),
                                jsched.cache)
    sched = scheduler.ServeScheduler(cfg, fam, params, batch_slots=slots,
                                     max_len=max_len)
    if "k" in sched.cache:
        assert sched.cache["k"].shape[3] == (8 if cfg.swa_window
                                             else max_len)
    sched.cache = {k: v.float() for k, v in sched.cache.items()}
    for s in (jsched, sched):
        mod = jscheduler if s is jsched else scheduler
        for rid, prompt, max_new in _requests(cfg, max_len):
            s.submit(mod.Request(rid=rid, prompt=prompt, max_new=max_new))
    want, got = jsched.run(), sched.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert 2 not in [r.rid for r in got]             # the over-long prompt
    assert any(len(r.out) < r.max_new for r in got)  # the max_len - 1 rule
    assert [r.out for r in got] == [r.out for r in want]
    assert np.array_equal(sched.lengths, jsched.lengths)


def test_serve_main_on_the_cpu(capsys):
    """``launch.serve.main`` with the reference's arguments and
    ``device="cpu"``: every request served, each with the reference
    main's token count (the port draws its own parameters)."""
    argv = ["--arch", "h2o-danube-3-4b", "--requests", "5", "--slots", "2",
            "--max-new", "6", "--max-len", "24"]
    got = serve.main(argv, device="cpu")
    want = jserve.main(argv)
    assert [(r.rid, len(r.out)) for r in got] == [
        (r.rid, len(r.out)) for r in want]
    assert "served 5/5 requests, 30 tokens" in capsys.readouterr().out
    assert all(0 <= t < 512 for r in got for t in r.out)
