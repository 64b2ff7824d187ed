"""``ops.decode_attention``: the port's entry point against the JAX
package's Pallas kernel.

On the CPU the entry point takes its plain version
(``repro_torch.kernels.ref.decode_attention_ref``); the same numpy
inputs from a seed go through ``repro.kernels.ops.decode_attention`` in
interpret mode.  Tolerances are those of ``tests/test_kernels.py``'s
decode test: rtol/atol 1e-4 in f32 (the two sum in other orders), 2e-2
in bf16 (one bf16 rounding of the output).  Lengths include 0, 1, S and
one past S inside a ragged last block, where the Pallas function is not
the reference's ``decode_attention_ref``: a pinned test records how.

The Hopper kernel cannot run here; ``tests/test_torch_gpu.py`` holds it
against this plain version on the card.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return rng, q, k, v


def _both(q, k, v, lens, block, dtype, scale=None):
    """(Pallas in interpret mode, port) outputs as f32 numpy arrays."""
    jout = jops.decode_attention(
        *(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)), jnp.asarray(lens),
        scale=scale, block_s=block, interpret=True)
    tout = ops.decode_attention(
        *(torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v)),
        torch.from_numpy(lens), scale=scale, block_s=block)
    assert tout.dtype == TDT[dtype]
    return np.asarray(jout, np.float32), tout.float().numpy()


# the JAX package's decode shapes (tests/test_kernels.py), D = 120
# (h2o-danube-3-4b's head width) and G = 12 (starcoder2-3b's grouping);
# each keeps the interpret grid B * H * ceil(S / block_s) under 100
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,s,d,block", [
    (2, 8, 2, 300, 64, 128), (1, 4, 4, 64, 32, 64), (3, 6, 3, 1000, 128, 256),
    (4, 4, 2, 200, 120, 128), (2, 12, 1, 150, 32, 64)])
def test_decode_attention_matches_pallas(dtype, b, h, hkv, s, d, block):
    rng, q, k, v = _inputs(b * 1000 + s, b, h, hkv, s, d)
    s_pad = -(-s // block) * block
    # 0, 1, S and a length past S inside the padded last block (S itself
    # when S is a multiple of block_s), as many as the batch holds
    past = s + max(1, (s_pad - s) // 2) if s_pad > s else s
    lens = rng.permutation(np.array([0, 1, s, past], np.int32))[:b]
    jout, tout = _both(q, k, v, lens, block, dtype)
    np.testing.assert_allclose(tout, jout, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ragged_lengths(dtype):
    """Every special length in one batch, plus lengths from the seed."""
    b, h, hkv, s, d, block = 8, 4, 2, 200, 120, 128
    rng, q, k, v = _inputs(7, b, h, hkv, s, d)
    lens = np.concatenate([[0, 1, s, s + 30, -3],
                           rng.integers(2, s, 3)]).astype(np.int32)
    jout, tout = _both(q, k, v, lens, block, dtype)
    np.testing.assert_allclose(tout, jout, rtol=TOL[dtype], atol=TOL[dtype])


def test_pallas_edge_semantics_are_pinned():
    """Where the Pallas function (and so the port) is not the reference's
    ``decode_attention_ref``: a length of 0 gives the mean of V over the
    padded length s_pad (the ref gives NaN), and a length past S counts
    the zero-padded positions below it with score 0, which changes the
    softmax's denominator."""
    b, h, hkv, s, d, block = 2, 4, 2, 300, 32, 128
    s_pad = 384
    _, q, k, v = _inputs(3, b, h, hkv, s, d)
    lens = np.array([0, 350], np.int32)
    jout, tout = _both(q, k, v, lens, block, "float32")
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-4)
    want = ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                torch.from_numpy(lens), block_s=block)
    ref = np.asarray(jref.decode_attention_ref(q, k, v, lens))
    group = h // hkv
    mean = np.repeat(v[0].sum(axis=1) / s_pad, group, axis=0)   # (H, D)
    np.testing.assert_allclose(want[0].numpy(), mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jout[0], mean, rtol=1e-5, atol=1e-6)
    assert np.isnan(ref[0]).all()
    # length 350 > S = 300: 50 padded positions of score 0 and value 0
    scores = np.einsum("hd,hsd->hs", q[1],
                       np.repeat(k[1], group, axis=0)) / math.sqrt(d)
    p = np.exp(scores - scores.max(axis=1, keepdims=True))
    pad = 50 * np.exp(-scores.max(axis=1, keepdims=True))
    want_past = (np.einsum("hs,hsd->hd", p, np.repeat(v[1], group, axis=0))
                 / (p.sum(axis=1, keepdims=True) + pad))
    np.testing.assert_allclose(tout[1], want_past, rtol=1e-4, atol=1e-5)
    assert np.abs(tout[1] - ref[1]).max() > 1e-3


def test_entry_point_contract():
    """Output in q's dtype, default scale 1/sqrt(D), and a ValueError when
    the query heads are not a multiple of the KV heads."""
    _, q, k, v = _inputs(5, 2, 4, 2, 50, 16)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    lens = torch.tensor([50, 20], dtype=torch.int32)
    out = ops.decode_attention(q, k, v, lens)
    assert out.dtype == torch.float32 and out.shape == (2, 4, 16)
    assert torch.equal(out, ops.decode_attention(q, k, v, lens,
                                                 scale=1 / math.sqrt(16)))
    assert not torch.allclose(out, ops.decode_attention(q, k, v, lens,
                                                        scale=1.0))
    bf = ops.decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), lens)
    assert bf.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiple"):
        ops.decode_attention(q[:, :3].contiguous(), k, v, lens)


@pytest.mark.parametrize("pairs,s", [(256, 32768), (2, 32768), (1024, 32768),
                                     (1, 1), (3, 1000), (70_000, 65),
                                     (300, 32768), (1, 524_288)])
def test_split_plan_covers_every_position(pairs, s):
    splits, chunk = da.split_plan(pairs, s)
    tiles = -(-s // da.TILE)
    most = min(-(-tiles // da.MIN_TILES), da.MAX_SPLITS)
    assert chunk % da.TILE == 0 and 1 <= splits <= da.MAX_SPLITS
    assert (splits - 1) * chunk < s <= splits * chunk
    assert chunk >= min(tiles, da.MIN_TILES) * da.TILE
    # every wave of blocks filled, or as many splits as allowed
    blocks = pairs * splits
    waves = -(-blocks // da.WAVE)
    assert (blocks >= da.WAVE_FILL * da.WAVE * waves
            or chunk == -(-tiles // most) * da.TILE)


@pytest.mark.parametrize("sms", [78, 114, da.WAVE])
@pytest.mark.parametrize("pairs", [2, 48, 256])
def test_split_plan_follows_the_sm_count(pairs, sms):
    """The wrapper passes the card's SM count as the wave: every wave of
    that many blocks filled, or as many splits as allowed; the default
    wave is 132."""
    s = 32768
    splits, chunk = da.split_plan(pairs, s, sms)
    tiles = -(-s // da.TILE)
    most = min(-(-tiles // da.MIN_TILES), da.MAX_SPLITS)
    assert (splits - 1) * chunk < s <= splits * chunk
    blocks = pairs * splits
    assert (blocks >= da.WAVE_FILL * sms * -(-blocks // sms)
            or chunk == -(-tiles // most) * da.TILE)
    if sms == da.WAVE:
        assert (splits, chunk) == da.split_plan(pairs, s)


# decode_32k (S = 32,768): one request of starcoder2-3b (2 KV heads) gets
# 64 splits of 8 tiles, 128 blocks for the 132 SMs; at batch 128
# (starcoder2-3b's 256 pairs, h2o-danube-3-4b's and deepseek-7b-at-32's
# 1024) one split a pair fills the waves
@pytest.mark.parametrize("pairs,plan", [(2, (64, 512)), (256, (1, 32768)),
                                        (1024, (1, 32768))])
def test_split_plan_at_decode_32k(pairs, plan):
    assert da.split_plan(pairs, 32768) == plan
