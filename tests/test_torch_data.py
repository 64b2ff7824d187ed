"""The port's data path (``repro_torch.data``): ``zipf_tokens`` and
``SyntheticLM`` byte-equal to the reference's (``repro.data``), and
``DataPipeline``'s order and device placement; ``shard_batch`` and
``DataPipeline(mesh=)`` give each grid position its row-major block
(on ranks: ``tests/test_torch_sharded.py``).  Every new module is
imported by its own name (the reference's dead-code gate walks
``src/``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import DataPipeline as JDataPipeline  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data.synthetic import zipf_tokens as jzipf_tokens  # noqa: E402

import repro_torch.data as data  # noqa: E402
import repro_torch.data.pipeline as pipeline  # noqa: E402
import repro_torch.data.synthetic as synthetic  # noqa: E402


@pytest.mark.parametrize("vocab,alpha", [(128, 1.2), (49152, 1.2),
                                         (1000, 0.8)])
def test_zipf_tokens_byte_equal(vocab, alpha):
    for seed in (0, 1, 7):
        got = synthetic.zipf_tokens(np.random.default_rng(seed), vocab,
                                    (3, 5), alpha)
        want = jzipf_tokens(np.random.default_rng(seed), vocab, (3, 5),
                            alpha)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kw", [dict(vocab=128, seq_len=64, batch=16),
                                dict(vocab=512, seq_len=17, batch=3, seed=5,
                                     noise=0.3),
                                dict(vocab=300, seq_len=8, batch=2,
                                     d_model=16)])
def test_synthetic_lm_byte_equal(kw):
    got, want = synthetic.SyntheticLM(**kw), JSyntheticLM(**kw)
    for step in (0, 1, 9):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (step, k)


def test_exports_match_reference():
    from repro import data as jdata
    assert data.__all__ == jdata.__all__


def test_pipeline_order_and_placement():
    """From ``start_step`` on, in order, each batch the source's on the
    requested device, the same order as the reference's pipeline."""
    src = synthetic.SyntheticLM(vocab=128, seq_len=8, batch=2)
    pipe = data.DataPipeline(src, device="cpu", prefetch=2, start_step=3)
    ref = JDataPipeline(JSyntheticLM(vocab=128, seq_len=8, batch=2),
                        prefetch=2, start_step=3)
    try:
        for i in range(3, 8):
            got, want = next(pipe), next(ref)
            assert pipe.step == ref.step == i + 1
            assert sorted(got) == ["labels", "tokens"]
            for k, v in got.items():
                assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
                assert v.dtype == torch.int32
                assert np.array_equal(v.numpy(), want[k])
                assert np.array_equal(v.numpy(), src.batch_at(i)[k])
    finally:
        pipe.close()
        ref.close()


def test_to_device_keeps_dtypes():
    b = synthetic.SyntheticLM(vocab=64, seq_len=4, batch=2,
                              d_model=8).batch_at(0)
    got = pipeline.to_device(b, "cpu")
    assert {k: v.dtype for k, v in got.items()} == dict(
        tokens=torch.int32, labels=torch.int32, embeds=torch.float32)
    assert np.array_equal(got["embeds"].numpy(), b["embeds"])


GRIDS = [((2, 2), ("data", "model"), ("data",)),
         ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
         ((4, 1), ("data", "model"), ("pod", "data"))]


@pytest.mark.parametrize("shape,names,axes", GRIDS)
def test_shard_batch_gives_each_position_its_block(shape, names, axes):
    """Every grid position's block is rows ``r * B / n`` on, ``r`` its
    row-major index along the batch axes the grid has; the blocks of
    the positions that differ there tile the batch; a 0-d leaf stays
    whole."""
    from repro_torch.launch.shardings import MeshShape
    src = synthetic.SyntheticLM(vocab=128, seq_len=6, batch=8)
    host = dict(src.batch_at(1), scale=np.float32(2.0))
    sizes = dict(zip(names, shape))
    have = [a for a in axes if a in names]
    n = int(np.prod([sizes[a] for a in have]))
    for coords in np.ndindex(*shape):
        at = dict(zip(names, coords))
        r = 0
        for a in have:
            r = r * sizes[a] + at[a]
        got = data.shard_batch(host, MeshShape(names, shape, coords), axes,
                               device="cpu")
        rows = slice(r * 8 // n, (r + 1) * 8 // n)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.from_numpy(host[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), host[k][rows])
        assert float(got["scale"]) == 2.0


def test_shard_batch_refuses_an_undividing_batch():
    from repro_torch.launch.shardings import MeshShape
    grid = MeshShape(("data", "model"), (2, 2), (1, 0))
    with pytest.raises(ValueError, match="do not divide"):
        data.shard_batch(dict(tokens=np.zeros((3, 4), np.int32)), grid,
                         device="cpu")


def test_pipeline_with_a_mesh_yields_the_blocks():
    from repro_torch.launch.shardings import MeshShape
    grid = MeshShape(("data", "model"), (2, 2), (1, 1))
    src = synthetic.SyntheticLM(vocab=64, seq_len=4, batch=4)
    pipe = data.DataPipeline(src, device="cpu", mesh=grid, start_step=5)
    try:
        for step in (5, 6):
            got = next(pipe)
            want = data.shard_batch(src.batch_at(step), grid, device="cpu")
            assert sorted(got) == sorted(want)
            for k in want:
                assert torch.equal(got[k], want[k])
    finally:
        pipe.close()


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    src = synthetic.SyntheticLM(vocab=64, seq_len=4, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.DataPipeline(src)
