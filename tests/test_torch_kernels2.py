"""The port's histogram and block-sparse SpMV kernels: the plain versions
against the JAX package's Pallas kernels, and the BCSR conversion.

On the CPU ``kernels.ops.histogram`` / ``ops.spmv`` take the plain
versions (``kernels.ref.histogram_ref`` / ``spmv_ref``); they run here
against ``repro.kernels.ops`` in interpret mode on the same inputs, made
with numpy from a seed, at sizes that leave a ragged last block (and,
for the histogram, negative padding ids).  Counts must match bitwise;
SpMV within rtol 1e-4 / atol 1e-4 (``tests/test_kernels.py``).  The
port's own ``bcsr_from_csr`` must give the reference's arrays byte for
byte.  ``histogram_bin.plan`` (where the kernel keeps the bins) is held
at its boundaries.  The Hopper kernels themselves run in
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops

from repro_torch.graph import rmat_edges
from repro_torch.kernels import histogram_bin as hb
from repro_torch.kernels import ops, ref
from repro_torch.kernels import spmv_csr as sp


@pytest.mark.parametrize("n,bins", [(1, 3), (3000, 700), (5000, 1025)])
def test_histogram_plain_matches_pallas(n, bins):
    rng = np.random.default_rng(n + bins)
    idx = rng.integers(-4, bins, n).astype(np.int32)
    want = np.asarray(jops.histogram(jnp.asarray(idx), bins,
                                     interpret=True))
    got = ops.histogram(torch.from_numpy(idx), bins)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.bincount(
        idx[idx >= 0], minlength=bins).astype(np.float32))


H100_SMS, H100_SMEM = 132, 232_448     # SMs; opt-in shared memory a block


@pytest.mark.parametrize("bins,path,slices,per_block", [
    (0, "private", 1, 0),
    (12_288, "private", 1, 12_288),        # the old 48 KB limit
    (58_112, "private", 1, 58_112),        # 232,448 B: one block's most
    (58_113, "sliced", 2, 29_060),
    (100_003, "sliced", 2, 50_004),        # not divisible by the slices
    (524_288, "sliced", 16, 32_768),       # the Histogram app's bins
    (524_289, "sliced", 16, 32_772),
    (929_792, "sliced", 16, 58_112),       # 16 blocks' most
    (929_793, "sliced", 32, 29_060),
    (7_438_336, "sliced", 128, 58_112),    # 128 slices on 132 SMs
    (7_438_337, "global", 0, 0),           # 256 slices: past the SMs
])
def test_histogram_plan_at_its_boundaries(bins, path, slices, per_block):
    p = hb.plan(bins, H100_SMS, H100_SMEM)
    assert (p.path, p.slices, p.per_block) == (path, slices, per_block)
    assert p.smem_bytes == 4 * per_block <= H100_SMEM
    if path == "sliced":
        # whole int4s a chunk; the fewest power-of-two slices that fit
        assert per_block % 4 == 0 and slices * per_block >= bins
        assert slices & (slices - 1) == 0
        assert 4 * -(-bins // (slices // 2)) > H100_SMEM


@pytest.mark.parametrize("bins,sms,smem", [
    (524_288, 0, H100_SMEM),       # no SM
    (100, 132, 12),                # a block holds 3 bins: no slice fits
])
def test_histogram_plan_raises_without_a_resident_block(bins, sms, smem):
    with pytest.raises(ValueError, match="no resident block"):
        hb.plan(bins, sms, smem)


def test_histogram_plan_depends_on_the_card_only():
    """The same bins on other cards' numbers: fewer SMs move the global
    boundary; less shared memory moves the private one and the slices."""
    assert hb.plan(524_288, 16, H100_SMEM).path == "sliced"
    assert hb.plan(524_288, 15, H100_SMEM).path == "global"   # 16 > 15
    assert hb.plan(12_288, 132, 48 * 1024).path == "private"
    assert hb.plan(12_289, 132, 48 * 1024) == hb.Plan("sliced", 2, 6_148,
                                                      24_592)


def test_histogram_wrapper_refuses_2_31_ids():
    """int32 counters could wrap at 2^31 ids: refused before any launch
    (a meta tensor: no memory behind it)."""
    before = hb.histogram_bin.launches
    with pytest.raises(ValueError, match="2\\^31"):
        hb.histogram_bin(torch.empty(2**31, dtype=torch.int32,
                                     device="meta"), 8)
    assert hb.histogram_bin.launches == before


def _matrix(scale, bm, bk):
    g = rmat_edges(scale, edge_factor=4, seed=scale)
    shape = (g.n_rows, g.n_cols)
    return (g, jops.bcsr_from_csr(g.row_ptr, g.col_idx, g.weights, shape,
                                  bm=bm, bk=bk),
            ops.bcsr_from_csr(g.row_ptr, g.col_idx, g.weights, shape, bm=bm,
                              bk=bk))


@pytest.mark.parametrize("scale,bm,bk", [(6, 16, 24), (7, 32, 48),
                                         (8, 128, 128)])
def test_bcsr_from_csr_is_the_reference_bytewise(scale, bm, bk):
    _, jm, m = _matrix(scale, bm, bk)
    assert m.blocks.dtype == jm.blocks.dtype and m.cols.dtype == jm.cols.dtype
    assert m.blocks.tobytes() == jm.blocks.tobytes()
    assert m.cols.tobytes() == jm.cols.tobytes()
    assert (m.shape, m.bm, m.bk, m.mb, m.kmax) == (jm.shape, jm.bm, jm.bk,
                                                    jm.mb, jm.kmax)


@pytest.mark.parametrize("scale,bm,bk", [(6, 16, 24), (7, 32, 48)])
def test_spmv_plain_matches_pallas(scale, bm, bk):
    g, jm, m = _matrix(scale, bm, bk)
    x = np.random.default_rng(scale).random(g.n_cols).astype(np.float32)
    want = np.asarray(jops.spmv(jm, jnp.asarray(x), interpret=True))
    got = ops.spmv(m, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # a matrix moved once with BCSR.to gives the same product
    dm = m.to("cpu")
    assert isinstance(dm.blocks, torch.Tensor) and dm.cols.dtype == torch.int32
    assert torch.equal(ops.spmv(dm, torch.from_numpy(x)), got)
    np.testing.assert_allclose(got.numpy(), ref.spmv_ref(
        torch.from_numpy(m.blocks), torch.from_numpy(m.cols),
        torch.from_numpy(x), g.n_rows).numpy(), rtol=0, atol=0)


def test_spmv_refuses_a_mismatched_x():
    _, _, m = _matrix(6, 16, 24)
    with pytest.raises(ValueError, match="shape"):
        ops.spmv(m, torch.zeros(m.shape[1] + 1))


def test_new_kernels_are_counted():
    """Both wrappers sit in ops.KERNELS, so a main-path run counts and
    resets their launches with the engine's three."""
    from repro_torch.kernels import histogram_bin as hb
    assert hb.histogram_bin in ops.KERNELS and sp.spmv_bcsr in ops.KERNELS
    hb.histogram_bin.launches = sp.spmv_bcsr.launches = 3
    ops.reset_launches()
    assert all(k.launches == 0 for k in ops.KERNELS)
