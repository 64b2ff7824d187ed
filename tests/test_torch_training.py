"""The port's dense training path (``repro_torch.models.lm.lm_loss``,
``repro_torch.training``, ``repro_torch.launch.train``, the checkpointed
``TrainState``) against the JAX reference's, on the CPU (the
counterpart of ``tests/test_training.py``).

Parameters are drawn by the reference's ``fam["init"]`` and carried
across with ``convert``; inputs come from a numpy seed.  The reduced
configs of the five dense archs run (vocab 128 where the reference's
own training test uses it).

Tolerances:
* ``lm_loss``: f32 within 1e-6 relative (the same logsumexp in another
  summation order); bf16 logits within 5e-2 (``BF16_TOL``);
* loss and gradients of forward + ``lm_loss`` on f32 copies: loss within
  1e-5 relative, each gradient leaf within 1e-4 of its max |g|
  (``GRAD_TOL``; measured ~1.5e-6);
* optimizers: three updates from one carried state in f32, parameters
  and moments within 1e-5 of each leaf's max |x| (``OPT_TOL``; measured
  2e-7); on bf16 parameters within one bf16 rounding (``BF16_TOL``);
* the train step against the reference's on an f32 state, three steps:
  loss and grad norm within 1e-5 relative, parameters and moments within
  ``OPT_TOL`` of each leaf's max |x| (measured 1.8e-6);
* remat, and the ``unbind`` forward against the ``select`` one, change
  no bit.

Every new module is imported by its own name (the reference's dead-code
gate walks ``src/``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.lm import lm_loss as jlm_loss  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402

import repro_torch.launch.train as train  # noqa: E402
import repro_torch.training.optimizer as opt_mod  # noqa: E402
import repro_torch.training.train_step as ts_mod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.runtime.fault import (FaultTolerantLoop,  # noqa: E402
                                       SimulatedFailure)
from repro_torch.training import (TrainState, adafactor, adamw,  # noqa: E402
                                  make_train_step)

DENSE = ["starcoder2-3b", "starcoder2-15b", "deepseek-7b", "h2o-danube-3-4b",
         "pixtral-12b"]
BF16_TOL = 5e-2
GRAD_TOL = 1e-4
OPT_TOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _ref(arch, vocab=None):
    """(reference cfg, fam, bf16 params), drawn once per (arch, vocab)."""
    key = (arch, vocab)
    if key not in _PARAMS:
        cfg, fam = jreg.get(arch, smoke=True)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        _PARAMS[key] = (cfg, fam, fam["init"](cfg, jax.random.PRNGKey(0)))
    return _PARAMS[key]


def _both(arch, f32: bool, vocab=None):
    """(jcfg, jfam, jparams, cfg, fam, params): the reference's params
    (cast to f32 when ``f32``) and the port's copy of them."""
    jcfg, jfam, jp = _ref(arch, vocab)
    if f32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    cfg, fam = registry.get(arch, smoke=True)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jfam, jp, cfg, fam, params


def _np(tree):
    """A tree of tensors or jax arrays as f32 numpy (bf16 exactly)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(jnp.asarray(tree).astype(jnp.float32))


def _leaves_close(got, want, tol, what=""):
    """Every leaf of ``got`` within ``tol`` of its ``want`` leaf's max |x|
    (the same keys in both)."""
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _leaves_close(got[k], want[k], tol, f"{what}/{k}")
        return
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} x {scale}"


def _batch(cfg, b=2, s=16, seed=0, embeds=False):
    """(reference batch, port batch) of tokens (or embeddings) and
    labels from a numpy seed."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if embeds:
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        key = "embeds"
    else:
        x = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        key = "tokens"
    return (dict({key: jnp.asarray(x)}, labels=jnp.asarray(labels)),
            dict({key: torch.from_numpy(x)}, labels=torch.from_numpy(labels)))


# ------------------------------------------------------------------ lm_loss
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_matches_reference(dtype):
    """Padding columns (vocab 500 of 512) hold the largest logits: a loss
    that did not mask them would differ by far more than the tolerance."""
    cfg = dataclasses.replace(registry.reduced(registry.ARCHS["deepseek-7b"]),
                              vocab=500)
    jcfg = dataclasses.replace(jreg.reduced(jreg.ARCHS["deepseek-7b"]),
                               vocab=500)
    assert cfg.vocab_pad == 512
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 8, 512)).astype(np.float32) * 3
    logits[..., 500:] = 40.0
    labels = rng.integers(0, 500, (2, 8)).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = float(jlm_loss(jnp.asarray(logits).astype(jdt),
                          jnp.asarray(labels), jcfg))
    got = lm.lm_loss(torch.from_numpy(logits).to(tdt),
                     torch.from_numpy(labels), cfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    tol = 1e-6 if dtype == "float32" else BF16_TOL
    assert abs(float(got) - want) <= tol * abs(want), (float(got), want)
    # the aux term: cfg.moe_aux_weight * aux
    aux = float(jlm_loss(jnp.asarray(logits), jnp.asarray(labels), jcfg, 2.5))
    got_aux = float(lm.lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels), cfg, 2.5))
    assert abs(got_aux - aux) <= 1e-6 * abs(aux)


def test_lm_loss_grad_zero_on_padding_columns():
    cfg = dataclasses.replace(registry.reduced(registry.ARCHS["deepseek-7b"]),
                              vocab=500)
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((2, 4, 512)).astype(
        np.float32)).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, 500, (2, 4)).astype(np.int32))
    lm.lm_loss(logits, labels, cfg).backward()
    assert torch.equal(logits.grad[..., 500:], torch.zeros(2, 4, 12))
    assert float(logits.grad[..., :500].abs().sum()) > 0


# ------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    """forward + lm_loss and its gradient on f32 copies (tokens in; the
    reference casts an embeddings batch to bf16, which f32 weights
    cannot take)."""
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=True)
    jb, tb = _batch(cfg)
    jl, jg = jax.value_and_grad(jts.make_loss_fn(jcfg, jfam))(jp, jb)
    tl, tg = ts_mod.value_and_grad(ts_mod.make_loss_fn(cfg, fam), params, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _leaves_close(tg, jg, GRAD_TOL, arch)
    for p in opt_mod.tree_leaves(params):
        assert not p.requires_grad and p.grad is None


def test_input_embeds_loss_and_grads_match_reference():
    """pixtral's embeddings batch (bf16, as the reference casts it): the
    loss within the bf16 tolerance, and the token embedding, which the
    loss does not reach, gets a zero gradient in both."""
    jcfg, jfam, jp, cfg, fam, params = _both("pixtral-12b", f32=False)
    jb, tb = _batch(cfg, embeds=True)
    jl, jg = jax.value_and_grad(jts.make_loss_fn(jcfg, jfam))(jp, jb)
    tl, tg = ts_mod.value_and_grad(ts_mod.make_loss_fn(cfg, fam), params, tb)
    assert abs(float(tl) - float(jl)) <= BF16_TOL * abs(float(jl))
    assert not np.asarray(jg["tok_emb"]).any()
    assert tg["tok_emb"].dtype == torch.bfloat16
    assert not tg["tok_emb"].any()
    _leaves_close(tg["lm_head"], jg["lm_head"], BF16_TOL, "lm_head")


@pytest.mark.parametrize("arch", DENSE)
def test_remat_changes_no_bit(arch, monkeypatch):
    """Gradients of the bf16 parameters with every block rematted and
    with every activation kept (``checkpoint`` replaced by a plain
    call): the same bits."""
    _, _, _, cfg, fam, params = _both(arch, f32=False)
    _, tb = _batch(cfg, seed=3)
    loss_fn = ts_mod.make_loss_fn(cfg, fam)
    calls = []

    def counted(fn, *args, **kw):
        calls.append(1)
        return real(fn, *args, **kw)
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", counted)
    la, ga = ts_mod.value_and_grad(loss_fn, params, tb)
    assert len(calls) == cfg.n_layers
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *args, **kw: fn(*args))
    lb, gb = ts_mod.value_and_grad(loss_fn, params, tb)
    assert torch.equal(la, lb)
    for a, b in zip(opt_mod.tree_leaves(ga), opt_mod.tree_leaves(gb)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _select_forward(params, batch, cfg):
    """The forward as it took each layer before: ``lm.layer``'s
    ``v[i]`` of every stacked leaf, once a layer."""
    x = lm._embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1])[None, :]
    for i in range(cfg.n_layers):
        x, _ = lm._dense_block(lm.layer(params["layers"], i), x, cfg,
                               positions)
    return lm._head(params, x, cfg), 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_unbind_forward_equals_select_forward(arch):
    """Logits, loss and gradients: the same bits through ``unstack`` as
    through ``layer``."""
    _, _, _, cfg, fam, params = _both(arch, f32=False)
    _, tb = _batch(cfg, seed=4)
    with torch.no_grad():
        a = lm.dense_forward(params, tb, cfg)[0]
        b = _select_forward(params, tb, cfg)[0]
    assert torch.equal(a, b)
    la, ga = ts_mod.value_and_grad(ts_mod.make_loss_fn(cfg, fam), params, tb)
    lb, gb = ts_mod.value_and_grad(
        ts_mod.make_loss_fn(cfg, dict(fam, forward=_select_forward)),
        params, tb)
    assert torch.equal(la, lb)
    for x, y in zip(opt_mod.tree_leaves(ga), opt_mod.tree_leaves(gb)):
        assert torch.equal(x, y)


def test_unstack_views_every_layer():
    _, _, _, cfg, _, params = _both("starcoder2-3b", f32=False)
    got = lm.unstack(params["layers"], cfg.n_layers)
    assert len(got) == cfg.n_layers
    for i, lp in enumerate(got):
        want = lm.layer(params["layers"], i)
        for a, b in zip(opt_mod.tree_leaves(lp), opt_mod.tree_leaves(want)):
            assert a.data_ptr() == b.data_ptr() and torch.equal(a, b)


# ------------------------------------------------------------- clip / norm
def _grad_tree(rng, dtype=np.float32):
    return dict(a=rng.standard_normal((3, 4, 5)).astype(dtype) * 3,
                b=dict(w=rng.standard_normal((7,)).astype(dtype),
                       s=rng.standard_normal((2, 6)).astype(dtype) * 10))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    rng = np.random.default_rng(5)
    tree = _grad_tree(rng)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = convert.lm_params_from_numpy(tree, "cpu")
    ttree["a"] = ttree["a"].to(torch.bfloat16)
    jtree["a"] = jtree["a"].astype(jnp.bfloat16)
    jn = float(jts.global_norm(jtree))
    tn = float(ts_mod.global_norm(ttree))
    assert abs(tn - jn) <= 1e-6 * jn
    jc, jnorm = jts.clip_by_global_norm(jtree, max_norm)
    tc, tnorm = ts_mod.clip_by_global_norm(ttree, max_norm)
    assert tc is ttree                                  # in place
    assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
    assert tc["a"].dtype == torch.bfloat16
    _leaves_close(tc, jc, 1e-6, "clipped")
    if max_norm == 1.0:
        assert abs(float(ts_mod.global_norm(tc)) - 1.0) < 1e-2


# --------------------------------------------------------------- optimizers
def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])
    return (tuple(tree.shape), str(tree.dtype))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_init_matches_reference(name):
    """The state's leaves, shapes and dtypes equal the reference's,
    Adafactor factoring the stacked (L, d) norm leaves too."""
    jcfg, jfam, jp, cfg, fam, params = _both("starcoder2-3b", f32=False)
    want = _specs(getattr(jopt, name)().init(jp))
    got = _specs(getattr(opt_mod, name)().init(params))
    assert got == want
    if name == "adafactor":
        norm = got["layers"]["attn"]["norm"]["w"]
        assert norm == dict(vr=((cfg.n_layers,), "float32"),
                            vc=((cfg.d_model,), "float32"))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name, f32):
    """Three updates (warmup 2) from one carried state, the same
    gradients in both.  AdamW's step 0 runs at lr 0 (its ramp is
    ``step / warmup``); Adafactor's ramp is ``(step + 1) / warmup``."""
    jcfg, jfam, jp, cfg, fam, params = _both("deepseek-7b", f32=f32,
                                             vocab=128)
    jo = getattr(jopt, name)(lr=1e-2, warmup=2)
    to = getattr(opt_mod, name)(lr=1e-2, warmup=2)
    jstate, tstate = jo.init(jp), to.init(params)
    rng = np.random.default_rng(6)
    first = {k: v.clone() for k, v in
             ckpt.flatten(params).items()}
    for step in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32) * 1e-2).astype(p.dtype), jp)
        tg = convert.lm_params_from_numpy(jax.tree.map(np.asarray, g), "cpu")
        jp, jstate = jax.jit(jo.update)(g, jstate, jp, jnp.int32(step))
        out, tstate2 = to.update(tg, tstate, params,
                                 torch.tensor(step, dtype=torch.int32))
        assert out is params and tstate2 is tstate        # in place
        if step == 0 and name == "adamw":                 # lr 0
            for k, v in ckpt.flatten(params).items():
                assert torch.equal(v, first[k]), k
    tol = OPT_TOL if f32 else BF16_TOL
    _leaves_close(params, jp, tol, f"{name} params")
    _leaves_close(tstate, jstate, OPT_TOL, f"{name} state")
    moved = [k for k, v in ckpt.flatten(params).items()
             if not torch.equal(v, first[k])]
    assert len(moved) == len(first)


def test_adafactor_state_is_factored():
    _, _, _, cfg, fam, params = _both("deepseek-7b", f32=False, vocab=128)
    st = adafactor().init(params)
    p_bytes = sum(x.numel() * x.element_size()
                  for x in opt_mod.tree_leaves(params))
    s_bytes = sum(x.numel() * x.element_size()
                  for x in opt_mod.tree_leaves(st))
    assert s_bytes < 0.35 * p_bytes    # far sub-linear vs adamw's 4x


# --------------------------------------------------------------- train step
def _states(opt_name="adamw", lr=1e-3, warmup=1):
    """(jcfg, jfam, reference state, cfg, fam, port state) from one f32
    state carried by ``convert``."""
    jcfg, jfam, jp, cfg, fam, params = _both("deepseek-7b", f32=True,
                                             vocab=128)
    jo = getattr(jopt, opt_name)(lr=lr, warmup=warmup)
    to = getattr(opt_mod, opt_name)(lr=lr, warmup=warmup)
    jstate = jts.TrainState.create(jp, jo)
    state = convert.train_state_from_numpy(jax.device_get(jstate), "cpu")
    return jcfg, jfam, jo, jstate, cfg, fam, to, state


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jcfg, jfam, jo, jstate, cfg, fam, to, state = _states()
    jstep = jax.jit(jts.make_train_step(jcfg, jfam, jo,
                                        microbatches=microbatches))
    step = make_train_step(cfg, fam, to, microbatches=microbatches)
    src = SyntheticLM(vocab=128, seq_len=64, batch=16, noise=0.0)
    for i in range(3):
        b = src.batch_at(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= LOSS_RTOL * abs(
                float(jm[k])), (i, k)
        assert float(m["step"]) == float(jm["step"]) == i
    assert int(state.step) == 3 and state.step.dtype == torch.int32
    _leaves_close(state.params, jstate.params, OPT_TOL, "params")
    _leaves_close(state.opt_state, jstate.opt_state, OPT_TOL, "moments")


def test_grad_accum_equivalence():
    """microbatches=2 gives (nearly) the same update as one batch, on the
    bf16 parameters (the reference's test, on the port)."""
    _, _, _, cfg, fam, params = _both("deepseek-7b", f32=False, vocab=128)
    src = SyntheticLM(vocab=128, seq_len=64, batch=16, noise=0.0)
    batch = {k: torch.from_numpy(v) for k, v in src.batch_at(0).items()}
    out = []
    for mb in (1, 2):
        opt = adamw(lr=1e-3)
        state = TrainState.create(ckpt.tree_map(torch.clone, params), opt)
        out.append(make_train_step(cfg, fam, opt, microbatches=mb)(
            state, batch))
    (s1, m1), (s2, m2) = out
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-2
    for a, b in zip(opt_mod.tree_leaves(s1.params),
                    opt_mod.tree_leaves(s2.params)):
        assert float((a.float() - b.float()).abs().max()) < 5e-2


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_loss_decreases(opt_name):
    """The reference's 40-step descent on the port."""
    _, _, _, cfg, fam, params = _both("deepseek-7b", f32=False, vocab=128)
    params = ckpt.tree_map(torch.clone, params)
    opt = adamw(lr=1e-2, warmup=3) if opt_name == "adamw" \
        else adafactor(lr=5e-2, warmup=3)
    state = TrainState.create(params, opt)
    step = make_train_step(cfg, fam, opt)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch=16, noise=0.0)
    losses = []
    for i in range(40):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in src.batch_at(i).items()})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


# ---------------------------------------------------------------- MTP branch
def _mtp_stub(xp, take):
    """A family whose forward returns (main, mtp) logits: two embedding
    tables read at the tokens (``take`` gathers rows)."""
    def forward(params, batch, cfg):
        t = batch["tokens"]
        return (take(params["main"], t), take(params["mtp"], t)), 0.0
    return dict(forward=forward)


def test_mtp_tuple_branch_matches_reference():
    cfg = dataclasses.replace(registry.reduced(registry.ARCHS["deepseek-7b"]),
                              vocab=100)
    jcfg = dataclasses.replace(jreg.reduced(jreg.ARCHS["deepseek-7b"]),
                               vocab=100)
    rng = np.random.default_rng(7)
    tables = dict(main=rng.standard_normal((100, 128)).astype(np.float32),
                  mtp=rng.standard_normal((100, 128)).astype(np.float32))
    jb, tb = _batch(cfg, b=3, s=10, seed=8)
    jfam = _mtp_stub(jnp, lambda w, t: jnp.take(w, t, axis=0))
    tfam = _mtp_stub(torch, lambda w, t: w[t.long()])
    jl, jg = jax.value_and_grad(jts.make_loss_fn(jcfg, jfam, 0.3))(
        jax.tree.map(jnp.asarray, tables), jb)
    tl, tg = ts_mod.value_and_grad(ts_mod.make_loss_fn(cfg, tfam, 0.3),
                                   convert.lm_params_from_numpy(tables, "cpu"),
                                   tb)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    _leaves_close(tg, jg, 1e-6, "mtp")
    # the MTP term counts: without it the loss differs
    only_main = float(lm.lm_loss(tfam["forward"](
        convert.lm_params_from_numpy(tables, "cpu"), tb, cfg)[0][0],
        tb["labels"], cfg))
    assert abs(only_main - float(tl)) > 1e-3


# ------------------------------------------------------ fault-tolerant loop
def _loop_run(tmp_path, name, steps=6, ckpt_every=2, hook=None,
              forward_fails_at=None):
    """(final state, losses) of a FaultTolerantLoop over a TrainState;
    ``forward_fails_at`` raises a RuntimeError inside the forward at
    that (0-based) forward call, after the first block ran."""
    _, _, _, cfg, fam, params = _both("deepseek-7b", f32=False, vocab=128)
    params = ckpt.tree_map(torch.clone, params)
    opt = adamw(lr=1e-2, warmup=1)
    calls = [0]

    def forward(p, b, c):
        if calls[0] == forward_fails_at:
            calls[0] += 1
            lm._dense_block(lm.layer(p["layers"], 0),
                            lm._embed_in(p, b, c), c,
                            torch.arange(b["tokens"].shape[1])[None])
            raise RuntimeError("simulated device fault in the forward")
        calls[0] += 1
        return lm.dense_forward(p, b, c)

    step = make_train_step(cfg, dict(fam, forward=forward), opt)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, noise=0.0)
    loop = FaultTolerantLoop(
        step, lambda i: {k: torch.from_numpy(v)
                         for k, v in src.batch_at(i).items()},
        str(tmp_path / name), ckpt_every=ckpt_every, failure_hook=hook)
    state, history = loop.run(TrainState.create(params, opt), steps)
    return state, [float(h["loss"]) for h in history]


def _same_state(a, b):
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_loop_over_train_state_survives_failures(tmp_path):
    """A failure hook at step 3 (after the step-2 checkpoint: a rollback)
    and a RuntimeError inside the forward of step 1 (before any
    checkpoint: a retry with the state the step was given) each give the
    history and final state of the unfailed run, bit for bit."""
    base, base_losses = _loop_run(tmp_path, "base")
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise SimulatedFailure("node lost")

    hooked, hooked_losses = _loop_run(tmp_path, "hook", hook=hook)
    assert fired == [3]
    # forward calls: step 0 is call 0, step 1 call 1
    faulted, faulted_losses = _loop_run(tmp_path, "forward",
                                        forward_fails_at=1)
    assert len(base_losses) == 6
    assert hooked_losses == base_losses
    assert faulted_losses == base_losses
    _same_state(hooked, base)
    _same_state(faulted, base)
    assert int(base.step) == 6


def test_checkpointed_train_state_restores_bitwise(tmp_path):
    """save / restore of a bf16 TrainState (AdamW, moved two steps): every
    leaf and the step the same bits, the keys the reference's
    (``jax``'s keystr: ``.params['layers']...``); a checkpoint the
    reference writes is read by the port."""
    jcfg, jfam, jp, cfg, fam, params = _both("deepseek-7b", f32=False,
                                             vocab=128)
    opt = adamw(lr=1e-2, warmup=1)
    state = TrainState.create(ckpt.tree_map(torch.clone, params), opt)
    step = make_train_step(cfg, fam, opt)
    src = SyntheticLM(vocab=128, seq_len=32, batch=4)
    for i in range(2):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in src.batch_at(i).items()})
    ckpt.save_checkpoint(str(tmp_path / "port"), 2, state)
    template = ckpt.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    assert isinstance(template, TrainState)
    back = ckpt.restore_checkpoint(str(tmp_path / "port"), template)
    assert isinstance(back, TrainState)
    _same_state(back, state)
    jstate = jts.TrainState.create(jp, jopt.adamw())
    assert list(ckpt.flatten(state)) == list(jckpt._flatten(jstate)[0])
    jckpt.save_checkpoint(str(tmp_path / "ref"), 0, jstate)
    got = ckpt.restore_checkpoint(str(tmp_path / "ref"),
                                  convert.train_state_from_numpy(
                                      jax.device_get(jstate), "cpu"))
    _same_state(got, convert.train_state_from_numpy(jax.device_get(jstate),
                                                    "cpu"))


# ------------------------------------------------------------------ convert
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_state_round_trip(name):
    jcfg, jfam, jp, *_ = _both("starcoder2-3b", f32=False)
    jstate = jts.TrainState.create(jp, getattr(jopt, name)())
    jstate = dataclasses.replace(jstate, step=jnp.int32(7))
    state = convert.train_state_from_numpy(jax.device_get(jstate), "cpu")
    assert int(state.step) == 7 and state.step.dtype == torch.int32
    assert _specs(state.params) == _specs(jp)
    assert _specs(state.opt_state) == _specs(jstate.opt_state)
    back = convert.train_state_to_numpy(state)
    assert back["step"] == 7 and back["step"].dtype == np.int32
    again = convert.train_state_from_numpy(back, "cpu")
    # bf16 leaves came back as f32 (exactly): cast them back
    again.params = opt_mod.tree_map(lambda t, want: t.to(want.dtype),
                                    again.params, state.params)
    _same_state(again, state)


# ------------------------------------------------------------------- launch
def test_scale_config_matches_reference():
    for arch in ("starcoder2-3b", "deepseek-7b"):
        for kw in (dict(d_model=256), dict(n_layers=3, vocab=1000),
                   dict(d_model=128, n_layers=2, vocab=300)):
            got = train.scale_config(registry.ARCHS[arch], **kw)
            want = jtrain.scale_config(jreg.ARCHS[arch], **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_batch_source_matches_reference():
    """The step's host batch: the reference loop's keys and bytes, tokens
    for the text archs and embeddings for pixtral."""
    for arch in ("deepseek-7b", "pixtral-12b"):
        cfg, _ = registry.get(arch, smoke=True)
        _, batch_at = train.batch_source(cfg, 16, 3)
        ref = JSyntheticLM(vocab=cfg.vocab, seq_len=16, batch=3,
                           d_model=cfg.d_model if cfg.input_embeds else 0)
        want = ref.batch_at(5)
        got = batch_at(5)
        keys = ["embeds", "labels"] if cfg.input_embeds \
            else ["labels", "tokens"]
        assert sorted(got) == keys
        for k in keys:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


def test_train_main_smoke_on_cpu(capsys):
    losses = train.main(["--arch", "deepseek-7b", "--smoke", "--steps", "8",
                         "--batch", "4", "--seq", "32", "--lr", "3e-3",
                         "--log-every", "4"], device="cpu")
    out = capsys.readouterr().out
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0], losses
    assert "arch=deepseek-7b family=dense" in out and "1 device(s)" in out
    assert "first loss" in out and "gnorm=" in out


def test_train_main_with_checkpoints_equals_without(tmp_path, capsys):
    argv = ["--arch", "starcoder2-3b", "--smoke", "--steps", "5", "--batch",
            "2", "--seq", "16", "--lr", "3e-3"]
    plain = train.main(argv, device="cpu")
    looped = train.main(argv + ["--ckpt-dir", str(tmp_path / "c"),
                                "--ckpt-every", "2"], device="cpu")
    assert looped == plain
    assert ckpt.latest_step(str(tmp_path / "c")) == 4


def test_train_entry_points_refuse():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--smoke", "--steps", "1"])
