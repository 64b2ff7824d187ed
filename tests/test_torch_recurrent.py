"""The port's recurrent families against the JAX reference's, on the CPU:
Mamba2's SSD (``repro_torch.models.ssm``), the xLSTM cells
(``repro_torch.models.xlstm``), and the ``hybrid`` (zamba2-1.2b) and
``xlstm`` (xlstm-1.3b) families of ``lm.py`` through forward, prefill,
decode, the loss and its gradients, ``generate``, ``ServeScheduler`` and
the training launcher.

Parameters are drawn by the reference's ``fam["init"]`` and carried
across with ``convert.lm_params_from_numpy``; inputs come from a numpy
seed; the reduced configs (``registry.reduced``) run.  The chunked forms
run with their default chunk and with ``CHUNK`` / ``MCHUNK`` patched to
4 (as ``tests/test_recurrence.py`` patches them), so that padding and
the cross-chunk carry are exercised.  The reference's module functions
run eagerly (so that a patched chunk is read), its families jitted.

Tolerances:
* f32 (the reference's parameters cast to f32 in the test): rtol / atol
  ``F32_TOL`` 1e-4 on values, states and logits (the two packages sum
  in other orders; the chunked forms re-associate the recurrence);
  gradients within ``GRAD_TOL`` 1e-4 of a leaf's max |g|, the loss
  within 1e-5 relative; greedy tokens exact;
* bf16 (the parameters as drawn): rtol / atol ``BF16_TOL`` 5e-2, a few
  bf16 roundings apart (``tests/test_torch_models.py``'s): an f32 value
  whose last bits differ can round one bf16 step the other way.  Whole
  bf16 models carry such a step through their recurrences: there a
  value may also stand as far from the reference's bf16 run as
  ``NOISE`` (1.5) x the reference's own f32 run of the same inputs
  does (``_noisy_close``).
* three launcher steps in f32: loss within ``STEP_RTOL`` 1e-3 relative
  (``tests/test_torch_moe.py``'s).

Every new module is imported by its own name (the reference's dead-code
gate walks ``src/``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import train as jtrain  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.serving import decode as jdecode  # noqa: E402
from repro.serving import kvcache as jkvcache  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro.training import train_step as jts  # noqa: E402

import repro_torch.launch.serve as serve  # noqa: E402
import repro_torch.launch.train as train  # noqa: E402
import repro_torch.models.ssm as ssm  # noqa: E402
import repro_torch.models.xlstm as xlstm  # noqa: E402
import repro_torch.training.train_step as ts_mod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.serving import decode, kvcache, scheduler  # noqa: E402

ARCHS = ["zamba2-1.2b", "xlstm-1.3b"]
F32_TOL = 1e-4
BF16_TOL = 5e-2
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
STEP_RTOL = 1e-3
NOISE = 1.5
HYBRID_PREFILL_TOL = 2e-3
SMALL_CHUNK = 4


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _trees_close(got, want, tol, what=""):
    """Two caches (numpy or tensors) of the same tree, leaf by leaf; a
    leaf the reference keeps in bf16 whatever the parameters' dtype
    (hybrid's ``shared`` k / v, rounded by ``astype(DTYPE)``) at
    ``BF16_TOL``: an f32 value whose last bits differ rounds one bf16
    step the other way."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _trees_close(got[k], want[k], tol, f"{what}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _trees_close(g, w, tol, f"{what}/{i}")
    else:
        assert tuple(_np(got).shape) == tuple(np.shape(want)), what
        if getattr(want, "dtype", None) == jnp.bfloat16:
            tol = max(tol, BF16_TOL)
        _close(got, want, tol, what)


def _leaves_close(got, want, tol, what=""):
    """Every leaf of ``got`` within ``tol`` of its ``want`` leaf's max
    |x| (the same keys in both)."""
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


def _cast(tree, dtype):
    """A port cache (dicts and tuples of tensors) with every leaf in
    ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_cast(v, dtype) for v in tree)
    return tree.to(dtype)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _x(cfg, seed, s=10, b=2, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, dtype), _t(x, getattr(torch, dtype))


def _tokens(cfg, seed, b=2, s=12):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _layer0(jp, params, key):
    """Layer 0 of the reference's and the port's stack ``key``."""
    return jax.tree.map(lambda a: a[0], jp[key]), lm.layer(params[key], 0)


def _mlstm0(jp, params):
    """The first mLSTM of the first group (leaves (G, M, ...))."""
    return (jax.tree.map(lambda a: a[0, 0], jp["groups"]["mlstm"]),
            lm.layer(lm.layer(params["groups"], 0)["mlstm"], 0))


def _slstm0(jp, params):
    return (jax.tree.map(lambda a: a[0], jp["groups"]["slstm"]),
            lm.layer(params["groups"], 0)["slstm"])


# ------------------------------------------------------------------ the SSD
def test_split_proj_takes_the_reference_pieces():
    """``torch.split``'s sizes give ``jnp.split``'s index cuts: z, xc, B,
    C and dt of widths di, di, N, N, H."""
    jcfg, _, jp, cfg, _, params = _both("zamba2-1.2b", f32=True)
    jlp, lp = _layer0(jp, params, "mamba")
    jx, tx = _x(cfg, 0)
    want = jssm._split_proj(jlp, jx, jcfg)
    got = ssm._split_proj(lp, tx, cfg)
    di = cfg.ssm_expand * cfg.d_model
    assert [g.shape[-1] for g in got] == [di, di, cfg.ssm_state,
                                          cfg.ssm_state, cfg.ssm_heads]
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["sequence", "step"])
def test_conv_matches_reference(with_state, dtype):
    """The causal depthwise conv over a sequence (its last CONV_W - 1
    inputs the decode state) and the one-step update from a state (in
    f32, rounded back)."""
    rng = np.random.default_rng(1)
    di = 24
    w = (rng.standard_normal((ssm.CONV_W, di)) * 0.2).astype(np.float32)
    xc = rng.standard_normal((2, 1 if with_state else 9, di)).astype(
        np.float32)
    st = rng.standard_normal((2, ssm.CONV_W - 1, di)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jst = jssm._conv(jnp.asarray(xc, jd), jnp.asarray(w, jd),
                           jnp.asarray(st, jd) if with_state else None)
    tout, tst = ssm._conv(_t(xc, td), _t(w, td),
                          _t(st, td) if with_state else None)
    assert tout.dtype == td and tst.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(tout, jout, tol)
    _close(tst, jst, 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [0, SMALL_CHUNK], ids=["whole", "chunked"])
def test_ssd_forward_matches_reference(chunk, dtype, monkeypatch):
    """One Mamba2 layer over 10 positions, from the zero state and from a
    seeded one: its output and the carried (ssm, conv) state.  With
    chunks of 4 the last chunk is padded by 2 and the state crosses two
    chunk boundaries."""
    if chunk:
        monkeypatch.setattr(ssm, "CHUNK", chunk)
        monkeypatch.setattr(jssm, "CHUNK", chunk)
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both("zamba2-1.2b", f32=f32)
    jlp, lp = _layer0(jp, params, "mamba")
    jx, tx = _x(cfg, 2, dtype=dtype)
    s0 = np.random.default_rng(3).standard_normal(
        (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)).astype(
            np.float32)
    tol = F32_TOL if f32 else BF16_TOL
    for state in (None, s0):
        jy, (js, jc) = jssm.ssd_forward(
            jlp, jx, jcfg, None if state is None else (jnp.asarray(state),
                                                       None))
        ty, (ts, tc) = ssm.ssd_forward(
            lp, tx, cfg, None if state is None else (_t(state), None))
        assert ty.dtype == tx.dtype and ts.dtype == torch.float32
        _close(ty, jy, tol)
        _close(ts, js, tol)
        _close(tc, jc, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_matches_reference(dtype):
    """One SSD step from a seeded state."""
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both("zamba2-1.2b", f32=f32)
    jlp, lp = _layer0(jp, params, "mamba")
    rng = np.random.default_rng(3)
    di = cfg.ssm_expand * cfg.d_model
    st = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state)).astype(np.float32)
    cv = rng.standard_normal((2, ssm.CONV_W - 1, di)).astype(np.float32)
    jx, tx = _x(cfg, 4, s=1, dtype=dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, (js, jc) = jssm.ssd_decode(jlp, jx, (jnp.asarray(st),
                                             jnp.asarray(cv, jd)), jcfg)
    ty, (ts, tc) = ssm.ssd_decode(lp, tx, (_t(st), _t(cv, td)), cfg)
    tol = F32_TOL if f32 else BF16_TOL
    _close(ty, jy, tol)
    _close(ts, js, tol)
    _close(tc, jc, tol)


@pytest.mark.parametrize("seq", [5, 13])
def test_ssd_chunked_equals_its_decode_recurrence(seq, monkeypatch):
    """The port alone, f32: the chunked forward (chunks of 4) against its
    O(1) decode step run position by position from the zero state, the
    outputs and the final states at 1e-4."""
    monkeypatch.setattr(ssm, "CHUNK", SMALL_CHUNK)
    _, _, _, cfg, _, params = _both("zamba2-1.2b", f32=True)
    lp = lm.layer(params["mamba"], 1)
    _, tx = _x(cfg, 5, s=seq)
    y, (s_fin, c_fin) = ssm.ssd_forward(lp, tx, cfg)
    di = cfg.ssm_expand * cfg.d_model
    st = (torch.zeros((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)),
          torch.zeros((2, ssm.CONV_W - 1, di)))
    ys = []
    for t in range(seq):
        yt, st = ssm.ssd_decode(lp, tx[:, t:t + 1], st, cfg)
        ys.append(yt)
    _close(torch.cat(ys, 1), y, F32_TOL)
    _close(st[0], s_fin, F32_TOL)
    _close(st[1], c_fin, F32_TOL)


# ---------------------------------------------------------------- the mLSTM
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [0, SMALL_CHUNK], ids=["whole", "chunked"])
def test_mlstm_forward_matches_reference(chunk, dtype, monkeypatch):
    """One mLSTM over 10 positions from a seeded (C, n, m) state: its
    output and the state it carries out (chunks of 4: the last padded by
    2, with li = -1e30 there)."""
    if chunk:
        monkeypatch.setattr(xlstm, "MCHUNK", chunk)
        monkeypatch.setattr(jxl, "MCHUNK", chunk)
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both("xlstm-1.3b", f32=f32)
    jlp, lp = _mlstm0(jp, params)
    jx, tx = _x(cfg, 6, dtype=dtype)
    h = cfg.n_heads
    pp = cfg.xlstm_proj * cfg.d_model // h
    rng = np.random.default_rng(7)
    st = (rng.standard_normal((2, h, pp, pp)).astype(np.float32),
          rng.standard_normal((2, h, pp)).astype(np.float32),
          rng.standard_normal((2, h)).astype(np.float32))
    for state in (None, st):
        jy, jst = jxl.mlstm_forward(jlp, jx, jcfg, state=None if state is
                                    None else tuple(map(jnp.asarray, state)))
        ty, tst = xlstm.mlstm_forward(lp, tx, cfg, state=None if state is
                                      None else tuple(map(_t, state)))
        tol = F32_TOL if f32 else BF16_TOL
        assert ty.dtype == tx.dtype
        _close(ty, jy, tol)
        _trees_close(tst, jst, tol, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_matches_reference(dtype):
    """One step from a seeded state, the state written in place."""
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both("xlstm-1.3b", f32=f32)
    jlp, lp = _mlstm0(jp, params)
    jx, tx = _x(cfg, 8, s=1, dtype=dtype)
    h = cfg.n_heads
    pp = cfg.xlstm_proj * cfg.d_model // h
    rng = np.random.default_rng(9)
    st = (rng.standard_normal((2, h, pp, pp)).astype(np.float32),
          rng.standard_normal((2, h, pp)).astype(np.float32),
          rng.standard_normal((2, h)).astype(np.float32))
    jy, jst = jxl.mlstm_decode(jlp, jx, tuple(map(jnp.asarray, st)), jcfg)
    state = tuple(map(_t, st))
    ty, tst = xlstm.mlstm_decode(lp, tx, state, cfg)
    assert all(a is b for a, b in zip(tst, state))
    tol = F32_TOL if f32 else BF16_TOL
    _close(ty, jy, tol)
    _trees_close(tst, jst, tol, "state")


@pytest.mark.parametrize("seq", [5, 13])
def test_mlstm_chunked_equals_its_decode_recurrence(seq, monkeypatch):
    """The port alone, f32: the chunkwise form (chunks of 4) against its
    stabilised recurrence step by step from the zero state (m = -1e30),
    outputs and (C, n) at 1e-4; the stabiliser m at 1e-4 too (both take
    the same max)."""
    monkeypatch.setattr(xlstm, "MCHUNK", SMALL_CHUNK)
    _, _, _, cfg, _, params = _both("xlstm-1.3b", f32=True)
    lp = lm.layer(lm.layer(params["groups"], 1)["mlstm"], 0)
    _, tx = _x(cfg, 10, s=seq)
    y, st_fin = xlstm.mlstm_forward(lp, tx, cfg)
    h = cfg.n_heads
    pp = cfg.xlstm_proj * cfg.d_model // h
    st = (torch.zeros((2, h, pp, pp)), torch.zeros((2, h, pp)),
          torch.full((2, h), xlstm.NEG))
    ys = []
    for t in range(seq):
        yt, st = xlstm.mlstm_decode(lp, tx[:, t:t + 1], st, cfg)
        ys.append(yt)
    _close(torch.cat(ys, 1), y, F32_TOL)
    for a, b in zip(st, st_fin):
        _close(a, b, F32_TOL)


@pytest.mark.parametrize("module", ["ssd", "mlstm"])
def test_chunked_gradients_match_reference(module, monkeypatch):
    """Gradients of a scalar of one chunked layer's output (chunks of 4,
    10 positions: the masked exponents and the padded tail) against
    ``jax.grad``, f32, every leaf and the input within ``GRAD_TOL`` of
    its max; all finite (an unmasked exp would give inf x 0 = NaN)."""
    monkeypatch.setattr(ssm, "CHUNK", SMALL_CHUNK)
    monkeypatch.setattr(jssm, "CHUNK", SMALL_CHUNK)
    monkeypatch.setattr(xlstm, "MCHUNK", SMALL_CHUNK)
    monkeypatch.setattr(jxl, "MCHUNK", SMALL_CHUNK)
    arch = "zamba2-1.2b" if module == "ssd" else "xlstm-1.3b"
    jcfg, _, jp, cfg, _, params = _both(arch, f32=True)
    if module == "ssd":
        jlp, lp = _layer0(jp, params, "mamba")
        jfn, tfn = jssm.ssd_forward, ssm.ssd_forward
    else:
        jlp, lp = _mlstm0(jp, params)
        jfn, tfn = jxl.mlstm_forward, xlstm.mlstm_forward
    jx, tx = _x(cfg, 11)
    w = np.random.default_rng(12).standard_normal(tx.shape).astype(
        np.float32)

    def jloss(p, x):
        return jnp.sum(jfn(p, x, jcfg)[0] * jnp.asarray(w))
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jlp, jx)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in lp.items()
              if not isinstance(v, dict)}
    tp = dict(lp, **leaves)
    tx = tx.requires_grad_()
    torch.sum(tfn(tp, tx, cfg)[0] * _t(w)).backward()
    for k, v in leaves.items():
        assert bool(torch.isfinite(v.grad).all()), k
        _leaves_close(v.grad, jg[k], GRAD_TOL, k)
    _leaves_close(tx.grad, jgx, GRAD_TOL, "x")


# ---------------------------------------------------------------- the sLSTM
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_matches_reference(dtype):
    """One sLSTM (and its gated FFN) over 7 positions from the zero state,
    then 3 more carrying the state it returned."""
    f32 = dtype == "float32"
    jcfg, _, jp, cfg, _, params = _both("xlstm-1.3b", f32=f32)
    jlp, lp = _slstm0(jp, params)
    jx, tx = _x(cfg, 13, dtype=dtype)
    tol = F32_TOL if f32 else BF16_TOL
    jy, jst = jxl.slstm_forward(jlp, jx[:, :7], jcfg)
    ty, tst = xlstm.slstm_forward(lp, tx[:, :7], cfg)
    _close(ty, jy, tol)
    _trees_close(tst, jst, tol, "state")
    jy, jst = jxl.slstm_forward(jlp, jx[:, 7:], jcfg, state=jst)
    ty, tst = xlstm.slstm_forward(lp, tx[:, 7:], cfg, state=tst)
    _close(ty, jy, tol)
    _trees_close(tst, jst, tol, "state")


def test_slstm_decode_matches_reference():
    """One step from a seeded (h, c, n, m), f32."""
    jcfg, _, jp, cfg, _, params = _both("xlstm-1.3b", f32=True)
    jlp, lp = _slstm0(jp, params)
    h = cfg.n_heads
    sp = cfg.d_model // h
    rng = np.random.default_rng(14)
    st = [rng.standard_normal((2, h, sp)).astype(np.float32)
          for _ in range(3)] + [rng.standard_normal((2, h)).astype(
              np.float32)]
    st[2] = np.abs(st[2])                          # n, a normaliser
    jx, tx = _x(cfg, 15, s=1)
    jy, jst = jxl.slstm_decode(jlp, jx, tuple(map(jnp.asarray, st)), jcfg)
    ty, tst = xlstm.slstm_decode(lp, tx, tuple(map(_t, st)), cfg)
    _close(ty, jy, F32_TOL)
    _trees_close(tst, jst, F32_TOL, "state")


# ------------------------------------------------------------------ the LMs
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_shapes_dtypes_and_scales(arch):
    """The port's own draw: the reference's keys, shapes (xlstm's
    two-level (G, M, ...) mLSTM stacks) and dtypes, norms exactly ones
    and zeros, the fixed leaves (a_log, dt_bias, d_skip) equal, each
    drawn weight's standard deviation within 10% of the reference's."""
    jcfg, jfam, jp = _ref(arch)
    cfg, fam = registry.get(arch, smoke=True)
    params = fam["init"](cfg, torch.Generator().manual_seed(3), "cpu")
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(params))
    assert sorted(got) == sorted(want)
    fixed = ("norm/", "a_log", "dt_bias", "d_skip")
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == w.dtype.name, name
        if any(f in name for f in fixed):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, err_msg=name)
        else:
            ws = float(np.std(w.astype(np.float32)))
            gs = float(g.float().std())
            assert abs(gs - ws) <= 0.1 * ws, (name, gs, ws)
    with pytest.raises(ValueError, match="generator"):
        fam["init"](cfg, torch.Generator(), torch.device("meta"))


def _noisy_close(got, want, want32, what=""):
    """A bf16 whole-model value: within ``BF16_TOL``, or, where the
    model's own bf16 rounding moves it further, no farther from the
    reference's bf16 run than ``NOISE`` x the reference's f32 run on the
    same inputs is (an f32 value whose last bits differ rounds one bf16
    step the other way, and the recurrences carry the step on; zamba2's
    forward logits read 0.107 against 0.126)."""
    if isinstance(want, dict):
        for k in want:
            _noisy_close(got[k], want[k], want32[k], f"{what}/{k}")
        return
    if isinstance(want, (tuple, list)):
        for i, (g, w, w32) in enumerate(zip(got, want, want32)):
            _noisy_close(g, w, w32, f"{what}/{i}")
        return
    g, w, w32 = _np(got), _np(want), _np(want32)
    assert g.shape == w.shape, what
    err = np.abs(g - w)
    if (err <= BF16_TOL * (1 + np.abs(w))).all():
        return
    noise = float(np.abs(w32 - w).max())
    assert float(err.max()) <= NOISE * noise, (what, float(err.max()), noise)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, dtype):
    """Forward logits, prefill logits and the cache converted back, then
    two decode steps (logits and cache), each from the reference's
    padded cache carried by ``convert`` (the port's padded prefill cache
    checked equal to it first).  f32 at ``F32_TOL`` (the caches cast to
    f32: hybrid's ``shared`` and ``conv`` leaves are bf16 as made);
    bf16 forward and prefill at ``_noisy_close``, the decode steps (one
    step from the same inputs) at ``BF16_TOL``."""
    f32 = dtype == "float32"
    tol = F32_TOL if f32 else BF16_TOL
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=f32)
    jp32 = _both(arch, f32=True)[2]
    toks = dict(tokens=jnp.asarray(_tokens(cfg, 16)))
    tt = dict(tokens=_t(_tokens(cfg, 16)))
    jl, _ = _jit(jfam, "forward")(jp, toks, jcfg)
    tl, aux = fam["forward"](params, tt, cfg)
    assert tl.dtype == params["lm_head"].dtype and aux == 0.0
    jl2, jc = _jit(jfam, "prefill")(jp, toks, jcfg)
    tl2, tc = fam["prefill"](params, tt, cfg)
    got = (tl, tl2, convert.lm_cache_to_numpy(tc))
    if f32:
        _close(tl, jl, tol)
        _close(tl2, jl2, tol)
        _trees_close(got[2], jc, tol, "prefill cache")
    else:
        jl32, _ = _jit(jfam, "forward")(jp32, toks, jcfg)
        jl32b, jc32 = _jit(jfam, "prefill")(jp32, toks, jcfg)
        _noisy_close(got, (jl, jl2, jc), (jl32, jl32b, jc32), "prefill")
    jc, tc = jkvcache.pad_cache(jcfg, jc, 3), kvcache.pad_cache(cfg, tc, 3)
    if f32:
        _trees_close(convert.lm_cache_to_numpy(tc), jc, tol, "padded cache")
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
    tc = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for i, pos in enumerate((12, 13)):
        nt = _tokens(cfg, 17 + i, s=1)
        jl, jc = _jit(jfam, "decode")(jp, jc, jnp.asarray(nt),
                                      jnp.int32(pos), jcfg)
        tl, tc2 = fam["decode"](params, tc, _t(nt), pos, cfg)
        assert tc2 is tc
        assert tl.shape == (2, cfg.vocab_pad)
        _close(tl, jl, tol)
        _trees_close(convert.lm_cache_to_numpy(tc), jc, tol, "decode cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher forcing on the port alone, f32 at 1e-4 and bf16 at 5e-2:
    prefill on 11 tokens and one decode step give the forward's last two
    logits; then every token decoded from ``init_cache`` gives the
    forward's logits at its position (the chunked forms against the
    recurrences, a zero state as the forward's start).  hybrid's prefill
    rounds the shared block's K / V to bf16 whatever the parameters'
    dtype (the reference's ``astype(DTYPE)``), so in f32 its decode step
    after prefill holds to ``HYBRID_PREFILL_TOL`` (2e-3; read 5.2e-4)."""
    for f32, tol in ((True, F32_TOL), (False, BF16_TOL)):
        _, _, _, cfg, fam, params = _both(arch, f32=f32)
        toks = _t(_tokens(cfg, 18, b=1, s=12))
        full, _ = fam["forward"](params, dict(tokens=toks), cfg)
        logits_p, cache = fam["prefill"](params, dict(tokens=toks[:, :-1]),
                                         cfg)
        cache = kvcache.pad_cache(cfg, cache, 1)
        if f32:
            cache = _cast(cache, torch.float32)
        lg, _ = fam["decode"](params, cache, toks[:, -1:], 11, cfg)
        _close(lg, full[:, -1], HYBRID_PREFILL_TOL if f32 and
               cfg.family == "hybrid" else tol)
        _close(logits_p[:, 0], full[:, -2], tol)
        cache = fam["init_cache"](cfg, 1, 12, "cpu")
        if f32:
            cache = _cast(cache, torch.float32)
        for pos in range(12):
            lg, cache = fam["decode"](params, cache, toks[:, pos:pos + 1],
                                      pos, cfg)
            _close(lg, full[:, pos], tol, f"position {pos}")


def test_hybrid_decode_launches_decode_attention_once_a_shared_block(
        monkeypatch):
    """zamba2's decode step: ``ops.decode_attention`` once for each
    application of the shared block (n_layers // hybrid_every), on its
    (B, Hkv, T, D) slice of ``shared``; the full-width geometry is G = 1
    at D = 64 and six applications, after layers 5, 11, ..., 35."""
    _, _, _, cfg, fam, params = _both("zamba2-1.2b", f32=True)
    calls = []
    real = ops.decode_attention

    def counted(q, k, v, lengths, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), lengths.tolist(),
                      k.data_ptr()))
        assert k.is_contiguous() and v.is_contiguous()
        return real(q, k, v, lengths, **kw)
    monkeypatch.setattr(ops, "decode_attention", counted)
    cache = _cast(fam["init_cache"](cfg, 3, 16, "cpu"), torch.float32)
    step = decode.make_serve_step(cfg, fam)
    for pos in range(3):
        step(params, cache, torch.zeros((3, 1), dtype=torch.int32), pos)
    n_sh = cfg.n_layers // cfg.hybrid_every
    slab = cache["shared"]["k"][0].numel() * 4
    assert [c[:3] for c in calls] == [
        ((3, cfg.n_heads, cfg.head_dim), (3, cfg.n_kv, 16, cfg.head_dim),
         [pos + 1] * 3) for pos in range(3) for _ in range(n_sh)]
    base = cache["shared"]["k"].data_ptr()
    assert [(c[3] - base) // slab for c in calls[:n_sh]] == list(range(n_sh))
    full = registry.ARCHS["zamba2-1.2b"]
    assert [i for i in range(full.n_layers)
            if lm._applies_shared(full, i)] == [5, 11, 17, 23, 29, 35]
    assert full.n_heads // full.n_kv == 1 and full.head_dim == 64


def test_xlstm_decode_launches_no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("decode_attention called on the xlstm path")
    monkeypatch.setattr(ops, "decode_attention", refuse)
    _, _, _, cfg, fam, params = _both("xlstm-1.3b", f32=True)
    out = decode.generate(cfg, fam, params,
                          dict(tokens=_t(_tokens(cfg, 19))), 3)
    assert out.shape == (2, 3)


def test_xlstm_full_width_state_and_head():
    """At full width the mLSTM head is xlstm_proj * d / H = 1024 (not the
    config's head_dim 512), so a slot's C is 4 x 1024 x 1024 f32 a
    layer: 5.6 GB of state over 8 slots and 42 mLSTMs, sized on the
    meta device."""
    cfg, fam = registry.get("xlstm-1.3b")
    (c, n, m), (h, cs, ns, ms) = fam["init_cache"](cfg, 8, 256, "meta")
    assert tuple(c.shape) == (6, 7, 8, 4, 1024, 1024)
    assert tuple(h.shape) == (6, 8, 4, 512)
    plan = kvcache.plan_cache(cfg, fam, 8, 256)
    assert plan.bytes_total == jkvcache.plan_cache(
        jreg.ARCHS["xlstm-1.3b"], jreg.get_family(jreg.ARCHS["xlstm-1.3b"]),
        8, 256).bytes_total
    assert 5.6e9 < plan.bytes_total < 5.7e9


# -------------------------------------------------------- loss and training
def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return (dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels)),
            dict(tokens=torch.from_numpy(toks),
                 labels=torch.from_numpy(labels)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """forward + ``lm_loss`` and its gradient (through each block's
    remat) on f32 copies against ``jax.grad``: the loss within 1e-5
    relative, every leaf within ``GRAD_TOL`` of its max."""
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=True)
    jb, tb = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(jts.make_loss_fn(jcfg, jfam)))(jp,
                                                                       jb)
    tl, tg = ts_mod.value_and_grad(ts_mod.make_loss_fn(cfg, fam), params, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _leaves_close(tg, jg, GRAD_TOL, arch)


def _same_params(monkeypatch, arch, jp, params):
    """Both launchers' ``registry.get`` give the family with ``init``
    returning the same f32 parameters (the port draws its own
    otherwise)."""
    real, jreal = registry.get, jreg.get
    # the reference's step donates its state: hand it copies
    jp = jax.tree.map(lambda a: jnp.array(a, copy=True), jp)

    def get(a, smoke=False):
        cfg, fam = real(a, smoke)
        return cfg, dict(fam, init=lambda cfg, gen, dev: params)

    def jget(a, smoke=False):
        cfg, fam = jreal(a, smoke)
        return cfg, dict(fam, init=lambda cfg, key: jp)
    monkeypatch.setattr(registry, "get", get)
    monkeypatch.setattr(jreg, "get", jget)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_matches_reference_launcher(arch, monkeypatch, capsys):
    """``launch.train.main --smoke`` and the reference's, from the same
    f32 parameters on the same synthetic batches: 3 AdamW steps (step 0
    runs at lr 0 under the automatic warmup of 1, so the third loss is
    the first after a moving update), each loss within ``STEP_RTOL``."""
    _, _, jp, cfg, _, params = _both(arch, f32=True)
    _same_params(monkeypatch, arch, jp, params)
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--lr", "3e-3"]
    got = train.main(argv, device="cpu")
    want = jtrain.main(argv)
    assert len(got) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    assert got[2] != got[1]
    assert f"family={cfg.family}" in capsys.readouterr().out


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """Prefill, padding, then greedy decode steps, f32: the same
    tokens."""
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=True)
    toks = _tokens(cfg, 20, s=8)
    want = np.asarray(jdecode.generate(jcfg, jfam, jp,
                                       dict(tokens=jnp.asarray(toks)), 6))
    got = decode.generate(cfg, fam, params, dict(tokens=_t(toks)), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert np.array_equal(got.numpy(), want)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_matches_reference(arch):
    """Three slots over a 20-position cache, f32: the same requests
    complete in the same order with the same tokens.  A slot's prompt is
    fed through the whole batch's step, so the other slots' recurrent
    states advance too (the reference's meaning, kept)."""
    jcfg, jfam, jp, cfg, fam, params = _both(arch, f32=True)
    slots, max_len = 3, 20
    jsched = jscheduler.ServeScheduler(jcfg, jfam, jp, batch_slots=slots,
                                       max_len=max_len)
    jsched.cache = jax.tree.map(lambda a: a.astype(jnp.float32),
                                jsched.cache)
    sched = scheduler.ServeScheduler(cfg, fam, params, batch_slots=slots,
                                     max_len=max_len)
    sched.cache = _cast(sched.cache, torch.float32)
    for s in (jsched, sched):
        mod = jscheduler if s is jsched else scheduler
        for rid, prompt, max_new in _requests(cfg, max_len):
            s.submit(mod.Request(rid=rid, prompt=prompt, max_new=max_new))
    want, got = jsched.run(), sched.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert 2 not in [r.rid for r in got]
    assert [r.out for r in got] == [r.out for r in want]
    assert np.array_equal(sched.lengths, jsched.lengths)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_the_cpu(arch, capsys):
    """``launch.serve.main`` with ``device="cpu"``: every request served
    with its ``max_new`` tokens, all inside the vocabulary (the port
    draws its own parameters; ``test_scheduler_matches_reference`` holds
    the scheduler to the reference's tokens)."""
    argv = ["--arch", arch, "--requests", "3", "--slots", "2",
            "--max-new", "4", "--max-len", "16"]
    got = serve.main(argv, device="cpu")
    assert [(r.rid, len(r.out)) for r in got] == [(0, 4), (1, 4), (2, 4)]
    assert all(0 <= t < 512 for r in got for t in r.out)
    assert "served 3/3 requests, 12 tokens" in capsys.readouterr().out
