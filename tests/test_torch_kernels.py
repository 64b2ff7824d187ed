"""The port's kernels: plain versions against the JAX package's Pallas
kernels, and what the Hopper wrappers refuse.

On the CPU the plain versions (``repro_torch.kernels.ref``, the path
``kernels.ops`` takes for a CPU tensor) run against the Pallas kernels in
interpret mode, on the same inputs made with numpy from a seed, at sizes
that cross the Pallas block boundaries, with -1 padding and +inf
mailbox entries.  min must match bitwise and counts exactly; add agrees
to f32 re-association, rtol 1e-5 / atol 1e-6 (the two sum the same
values in different orders).

The Hopper kernels cannot run here (no card, no nvcc); the ``gpu``
tests in ``tests/test_torch_gpu.py`` hold them against these plain
versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import deliver_fused as jdf
from repro.kernels import relax_min as jrx
from repro.kernels import segment_combine as jsc

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import deliver_fused as df
from repro_torch.kernels import histogram_bin as hb
from repro_torch.kernels import ops, ref
from repro_torch.kernels import relax_min as rx
from repro_torch.kernels import segment_combine as sc
from repro_torch.kernels import spmv_csr as sp

ADD_RTOL, ADD_ATOL = 1e-5, 1e-6
COMBINES = ("min", "add")


def _with_inf(rng, x, p):
    return np.where(rng.random(x.shape[0]) < p, np.inf, x).astype(np.float32)


def _segments(rng, n, num_segments, pad=0.25):
    seg = rng.integers(0, num_segments, n).astype(np.int32)
    return np.where(rng.random(n) < pad, -1, seg).astype(np.int32)


def _agree(combine, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if combine == "min":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=ADD_RTOL, atol=ADD_ATOL)


# ------------------------------------------------- plain vs Pallas (CPU)
@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("n", [17, 2048, 5000])
def test_relax_plain_matches_pallas(combine, n):
    rng = np.random.default_rng(n)
    v = _with_inf(rng, rng.random(n).astype(np.float32) * 9, 0.4)
    m = _with_inf(rng, rng.random(n).astype(np.float32) * 9, 0.3)
    f = rng.random(n) < 0.5
    jv, ji = jrx.relax(jnp.asarray(v), jnp.asarray(m), jnp.asarray(f),
                       combine, interpret=True)
    tv, ti = ops.relax(torch.from_numpy(v), torch.from_numpy(m),
                       torch.from_numpy(f), combine)
    # elementwise, no re-association: bitwise for both combines
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert ti.dtype == torch.int8
    assert np.array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("n,segs", [(100, 7), (4000, 700), (2048, 513),
                                    (1500, 1500)])
def test_segment_combine_plain_matches_pallas(combine, n, segs):
    rng = np.random.default_rng(n + segs)
    seg = _segments(rng, n, segs)
    val = rng.random(n).astype(np.float32) * 9
    want = jsc.segment_combine(jnp.asarray(seg), jnp.asarray(val), segs,
                               combine, interpret=True)
    got = ops.segment_combine(torch.from_numpy(seg), torch.from_numpy(val),
                              segs, combine)
    _agree(combine, got.numpy(), want)
    if combine == "min":        # untouched segments: the true +inf
        untouched = ~np.isin(np.arange(segs), seg)
        assert np.all(np.isposinf(got.numpy()[untouched]))


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("n,nd", [(100, 37), (3000, 1100), (1024, 512),
                                  (600, 2048)])
def test_deliver_fused_plain_matches_pallas(combine, n, nd):
    rng = np.random.default_rng(n * 7 + nd)
    seg = _segments(rng, n, nd, pad=0.4)
    val = rng.random(n).astype(np.float32) * 9
    mail = (np.zeros(nd, np.float32) if combine == "add"
            else _with_inf(rng, rng.random(nd).astype(np.float32) * 9, 0.5))
    jmail, jcnt = jdf.deliver_fused(jnp.asarray(seg), jnp.asarray(val),
                                    jnp.asarray(mail), combine,
                                    interpret=True)
    tmail, tcnt = ops.deliver_fused(torch.from_numpy(seg),
                                    torch.from_numpy(val),
                                    torch.from_numpy(mail), combine)
    _agree(combine, tmail.numpy(), jmail)
    assert tcnt.dtype == torch.float32
    assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))


def test_plain_versions_are_the_reference_oracles():
    """ref.py mirrors the JAX package's ref.py oracles too."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(9)
    seg = _segments(rng, 900, 300)
    val = rng.random(900).astype(np.float32)
    for combine in COMBINES:
        want = jref.segment_combine_ref(seg, val, 300, combine)
        got = ref.segment_combine_ref(torch.from_numpy(seg),
                                      torch.from_numpy(val), 300, combine)
        _agree(combine, got.numpy(), want)


def test_big_stand_in_difference_is_pinned():
    """The one documented difference: the Pallas kernels use the finite
    stand-in _BIG = 3.4e38 for +inf.  A record value in [3.4e38,
    FLT_MAX] therefore comes back as +inf from segment_combine and as
    3.4e38 from deliver_fused's min, while the port (true +inf identity,
    plain and Hopper alike) keeps the value itself."""
    big = np.float32(3.40e38)
    assert big >= np.float32(jsc._BIG)
    seg = np.array([0, 1, -1], np.int32)
    val = np.array([big, 5.0, 1.0], np.float32)
    jout = np.asarray(jsc.segment_combine(jnp.asarray(seg), jnp.asarray(val),
                                          2, "min", interpret=True))
    tout = ops.segment_combine(torch.from_numpy(seg), torch.from_numpy(val),
                               2, "min").numpy()
    assert jout[0] == np.inf and tout[0] == big
    assert jout[1] == tout[1] == 5.0

    mail = np.full(2, np.inf, np.float32)
    jmail, _ = jdf.deliver_fused(jnp.asarray(seg), jnp.asarray(val),
                                 jnp.asarray(mail), "min", interpret=True)
    tmail, _ = ops.deliver_fused(torch.from_numpy(seg), torch.from_numpy(val),
                                 torch.from_numpy(mail), "min")
    assert np.asarray(jmail)[0] == np.float32(jdf._BIG)
    assert tmail.numpy()[0] == big


@pytest.mark.parametrize("n,path", [(0, "f32"), (1, "f32"),
                                    ((1 << 24) - 1, "f32"), (1 << 24, "i32"),
                                    ((1 << 24) + 5, "i32")])
def test_deliver_fused_counting_path(n, path):
    """f32 count atomics while every count is an integer below 2^24 (then
    exact in any order), int32 atomics converted in place from 2^24
    records on."""
    assert df.counting_path(n) == path


@pytest.mark.parametrize("kernel", [rx.relax, sc.segment_combine,
                                    df.deliver_fused, hb.histogram_bin,
                                    sp.spmv_bcsr, da.decode_attention])
def test_hopper_wrappers_refuse_cpu_tensors(kernel):
    """A wrapper launches its kernel or raises: it never takes the plain
    version itself, and a refused call counts no launch."""
    x = torch.zeros(4)
    seg = torch.zeros(4, dtype=torch.int32)
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        if kernel is rx.relax:
            kernel(x, x, x > 0)
        elif kernel is sc.segment_combine:
            kernel(seg, x, 4)
        elif kernel is hb.histogram_bin:
            kernel(seg, 4)
        elif kernel is sp.spmv_bcsr:
            kernel(torch.zeros((1, 1, 4, 4)),
                   torch.zeros((1, 1), dtype=torch.int32), x, 4)
        elif kernel is da.decode_attention:
            kv = torch.zeros((1, 1, 4, 8))
            kernel(torch.zeros((1, 2, 8)), kv, kv, seg[:1])
        else:
            kernel(seg, x, x)
    assert kernel.launches == before


def test_unknown_combine_raises():
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="combine"):
        ops.relax(x, x, x > 0, combine="max")
