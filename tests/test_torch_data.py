"""The port's data path (``repro_torch.data``): ``zipf_tokens`` and
``SyntheticLM`` byte-equal to the reference's (``repro.data``), and
``DataPipeline``'s order and device placement; a mesh raises (ROADMAP
A.10d).  Every new module is imported by its own name (the reference's
dead-code gate walks ``src/``)."""
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


def test_mesh_and_shard_batch_raise():
    src = synthetic.SyntheticLM(vocab=64, seq_len=4, batch=2)
    with pytest.raises(NotImplementedError, match="A.10d"):
        data.DataPipeline(src, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="A.10d"):
        data.shard_batch(src.batch_at(0), object())


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    src = synthetic.SyntheticLM(vocab=64, seq_len=4, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.DataPipeline(src)
