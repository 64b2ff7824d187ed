"""The port's dry run (``repro_torch.launch.dryrun``) and its op counter
(``repro_torch.launch.opanalysis``), the counterparts of the reference's
``launch/dryrun.py`` and ``launch/hloanalysis.py``.

* The counter against closed forms: a chain of n 128^3 products (n = 2,
  8) counts n times one product's FLOPs and bytes; an all-reduce in a
  Python loop of 8 on a 4-rank ``fake`` group counts 8 all-reduces of
  their operand's bytes (the reference's test multiplies a scan's
  collectives by its trip count); a write into a slice counts the slice
  (the reference's dynamic-update-slice rule); ``ops.decode_attention``
  on fake tensors is one op of 4 B H S D FLOPs that launches nothing.
* Reduced cells of a dense, a MoE and the encoder-decoder arch on a 2 x 2
  ``fake`` grid, train / prefill / decode: ``model_flops_global`` is the
  reference's formula over the reference's registry, ``long_500k`` is
  skipped exactly where the reference skips it, the dense arch's
  per-rank train FLOPs stand within 5% of a closed form written out
  here (every block's products 4 times under remat, the head's 3, each
  a rank's half of the tensor-parallel step's but for the K / V
  projection, whose block splits a head), and the overrides the port
  has not ported raise.
* The same reduced step on real CPU tensors over a one-rank gloo group
  counts the same FLOPs, bytes, collectives and ops as its dry run on a
  1 x 1 ``fake`` grid, and its peak within 0.8-1.25x (the card's gate):
  gloo releases a collective's operand on its own thread, so a real
  step's peak now and then holds one gathered block more (64 KiB at
  these sizes; the decode cell's 1,024 positions keep that small).  (This build of PyTorch has no CUDA:
  its autograd and its views of a CUDA tensor need the device's guard,
  fake tensors included, so fake ``cuda`` runs of these steps are held
  against fake ``cpu`` ones in ``tests/test_torch_gpu.py``.)
* One full-width cell through ``python -m repro_torch.launch.dryrun`` in
  a subprocess, as ``tests/test_system.py``'s dry-run test: whisper-tiny
  decode_32k on the 16 x 16 grid.
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import registry as jreg  # noqa: E402

import repro_torch.launch.dryrun as dryrun  # noqa: E402
import repro_torch.launch.opanalysis as opanalysis  # noqa: E402
from repro_torch.core.collectives import make_grid  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving.decode import make_prefill, make_serve_step  # noqa: E402,E501
from repro_torch.training import Shardings, TrainState, adamw  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
GRID = ((2, 2), ("data", "model"))
ONE = ((1, 1), ("data", "model"))
ARCHS = ("starcoder2-3b", "granite-moe-1b-a400m", "whisper-tiny")
TINY = {"train": shapes.ShapeCell("tiny_train", "train", 64, 4),
        "prefill": shapes.ShapeCell("tiny_prefill", "prefill", 64, 4),
        "decode": shapes.ShapeCell("tiny_decode", "decode", 1024, 4)}
# the predicted peak over the real step's, held (chip_smoke.py's DRY_PEAK)
PEAK = (0.8, 1.25)


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _fake_group(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


# ------------------------------------------------------------- the counter
@pytest.mark.parametrize("n", [2, 8])
def test_product_chain_scales_with_its_length(n):
    x = torch.randn(128, 128)
    w = torch.randn(128, 128)

    def chain():
        y = x
        for _ in range(n):
            y = y @ w
        return y
    got = opanalysis.analyze_step(chain)
    assert got["flops"] == n * 2 * 128 ** 3
    assert got["hbm_bytes"] == n * 3 * 128 * 128 * 4
    assert got["ops"] == n
    assert got["peak_bytes"] == 2 * 128 * 128 * 4     # two links live
    assert got["collective_total_bytes"] == 0


def test_all_reduce_in_a_loop_counts_every_call(no_group):
    _fake_group(8)
    try:
        quad = dist.new_group([0, 1, 2, 3])
        x = torch.ones(64, 32)

        def loop():
            for _ in range(8):
                dist.all_reduce(x, group=quad)
        got = opanalysis.analyze_step(loop)
    finally:
        dist.destroy_process_group()
    assert got["collective_counts"]["all-reduce"] == 8
    assert got["collective_bytes"]["all-reduce"] == 8 * 64 * 32 * 4
    assert sum(got["collective_counts"].values()) == 8
    assert got["collective_link_bytes"] == dict(within_node=8 * 64 * 32 * 4,
                                                across_nodes=0)
    assert got["ops"] == 8


def test_a_group_across_nodes_is_charged_to_the_network(no_group):
    _fake_group(16)
    try:
        pair = dist.new_group([0, 8])
        got = opanalysis.analyze_step(
            lambda: dist.all_reduce(torch.ones(10), group=pair))
    finally:
        dist.destroy_process_group()
    assert got["collective_link_bytes"] == dict(within_node=0,
                                                across_nodes=40)


def test_a_slice_write_counts_the_slice():
    buf = torch.zeros(64, 64)
    upd = torch.ones(8, 64)

    def write():
        buf[8:16] = upd
    got = opanalysis.analyze_step(write)
    assert got["hbm_bytes"] == 2 * 8 * 64 * 4          # read, written once
    assert got["hbm_bytes"] < buf.numel() * 4
    assert got["peak_bytes"] == 0
    rows, vals = torch.tensor([1, 5]), torch.ones(2, 64)
    got = opanalysis.analyze_step(lambda: buf.index_put_((rows,), vals))
    # the index, the values read and the values written
    assert got["hbm_bytes"] == 2 * 8 + 2 * (2 * 64 * 4)


def test_decode_attention_is_one_custom_op_on_fake_tensors():
    b, h, hkv, s, d = 8, 24, 2, 4096, 128
    da.decode_attention.launches = 0
    for dev in ("cuda", "cpu"):
        with FakeTensorMode():
            q = torch.empty(b, h, d, dtype=torch.bfloat16, device=dev)
            k = torch.empty(b, hkv, s, d, dtype=torch.bfloat16, device=dev)
            lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
            with opanalysis.StepCount() as count:
                out, lse = ops.decode_attention(q, k, k, lengths)
        assert (tuple(out.shape), out.dtype) == ((b, h, d), torch.bfloat16)
        assert (tuple(lse.shape), lse.dtype) == ((b, h), torch.float32)
        got = count.summary()
        assert got["ops"] == 1
        assert got["flops"] == 4 * b * h * s * d
        assert got["hbm_bytes"] == ((2 * q.numel() + 2 * k.numel()) * 2
                                    + 4 * b + 4 * b * h)
    assert da.decode_attention.launches == 0


# -------------------------------------------------------- reduced cells
def _closed_form_train_flops(cfg, tokens: int, seq: int, m: int) -> int:
    """Per-rank FLOPs of the dense family's train step, tensor-parallel
    over ``m`` ranks of ``model``: every block's products (q, k, v, o,
    Q K^T and P V over all ``seq`` keys, the MLP) forward, again under
    remat and twice backward; the head's forward and twice backward.
    Each product is a rank's 1/m, but for a projection whose block
    splits a head, computed whole (``layers.attention``)."""
    d, h, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                         cfg.d_ff)

    def share(n):                 # the part of n heads' work a rank does
        return n / m if (n * hd // m) % hd == 0 else n
    mlp = (3 if cfg.mlp_act == "swiglu" else 2) * 2 * d * ff / m
    block = (2 * d * hd * (share(h) + h / m + 2 * share(hkv))
             + 2 * 2 * seq * share(h) * hd + mlp)
    head = 2 * d * cfg.vocab_pad / m
    return tokens * (4 * cfg.n_layers * block + 3 * head)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cells_on_a_2x2_grid(arch, tmp_path, no_group):
    cfg, _ = registry.get(arch, smoke=True)
    jcfg = jreg.reduced(jreg.ARCHS[arch])
    for name, cell in shapes.SHAPES.items():
        r = dryrun.run_cell(arch, name, "single", str(tmp_path),
                            device="cpu", smoke=True, grid=GRID)
        if not jshapes.applicable(jcfg, name):
            assert r["status"] == "skipped"
            continue
        assert r["status"] == "ok", r
        assert r["n_devices"] == 4 and r["grid"] == [2, 2]
        tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
        want = (6 if cell.kind == "train" else 2) \
            * jcfg.active_param_count() * tokens
        assert r["model_flops_global"] == want
        assert r["counted_flops_global"] == 4 * r["cost"]["flops_per_device"]
        assert r["cost"]["flops_per_device"] > 0
        assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert r["memory"]["argument_size_in_bytes"] > 0
        # parameters gathered over 'data' under fsdp, the non-dense
        # families' over 'model' too
        assert r["collectives"]["counts"]["all-gather"] > 0
        if cell.kind == "train":
            assert r["collectives"]["counts"]["all-reduce"] > 0
        on_disk = json.load(open(tmp_path / f"{arch}_{name}_single.json"))
        assert on_disk == json.loads(json.dumps(r))
        if arch == "starcoder2-3b" and cell.kind == "train":
            closed = _closed_form_train_flops(cfg, tokens // 2, cell.seq, 2)
            got = r["cost"]["flops_per_device"]
            assert abs(got - closed) <= 0.05 * closed, (got, closed)


@pytest.mark.parametrize("opt,err", [
    ({"microbatches": 2}, NotImplementedError),
    ({"seq_parallel": True}, NotImplementedError),
    ({"two_hop_dispatch": True}, NotImplementedError),
    ({"ep_axes": ["data", "model"]}, NotImplementedError),
    ({"carry_cache": False}, ValueError),
    ({"no_such_knob": 1}, ValueError)])
def test_overrides_not_ported_raise(opt, err, tmp_path, no_group):
    with pytest.raises(err):
        dryrun.run_cell("granite-moe-1b-a400m", "train_4k", "single",
                        str(tmp_path), opt, device="cpu", smoke=True,
                        grid=GRID)
    assert not dist.is_initialized()


def test_overrides_set_the_knobs_for_the_cell_only(tmp_path, no_group):
    from repro_torch.models import layers
    before = layers.DEFAULT_Q_CHUNK, layers.MOE_GROUP, layers.MOE_CF
    r = {}
    for q in (0, 512):
        r[q] = dryrun.run_cell("starcoder2-3b", "prefill_32k", "single",
                               str(tmp_path), {"q_chunk": q} if q else None,
                               device="cpu", smoke=True, grid=GRID,
                               tag=str(q))
    assert (layers.DEFAULT_Q_CHUNK, layers.MOE_GROUP,
            layers.MOE_CF) == before
    # the same work in twice as many query blocks, a quarter the scores
    assert r[512]["cost"]["flops_per_device"] == \
        r[0]["cost"]["flops_per_device"]
    assert r[512]["ops"] > r[0]["ops"]
    assert r[512]["memory"]["temp_size_in_bytes"] < \
        r[0]["memory"]["temp_size_in_bytes"]
    ok = dryrun.run_cell("starcoder2-3b", "decode_32k", "single",
                         str(tmp_path), {"carry_cache": True}, device="cpu",
                         smoke=True, grid=GRID)
    assert ok["status"] == "ok"


# --------------------------------------------------- real against fake
def _real_inputs(arch, cell, grid, gen):
    """The reduced cell's step and real CPU inputs, placed as
    ``dryrun.build_cell`` places its fake ones."""
    cfg, fam = registry.get(arch, smoke=True)
    fsdp = arch in dryrun.FSDP_ARCHS
    params = fam["init"](cfg, gen, "cpu")
    b, s = cell.batch, cell.seq

    def ids(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             dtype=torch.int32)
    if cell.kind == "train":
        opt = adamw()
        state = TrainState.create(params, opt)
        specs = sh.train_state_specs(state, grid, fsdp=fsdp)
        batch = dict(tokens=ids(b, s), labels=ids(b, s))
        step = make_train_step(cfg, fam, opt,
                               shardings=Shardings(grid, specs))
        return step, (sh.place(state, specs, grid), batch)
    if cell.kind == "prefill":
        batch = dict(tokens=ids(b, s))
        specs = sh.serve_specs(params, grid, batch=batch, fsdp=fsdp)
        fn = make_prefill(cfg, fam, shardings=Shardings(grid, specs))
        return fn, (sh.place(params, _param_specs(specs), grid), batch)
    cache = fam["init_cache"](cfg, b, s, device="cpu")
    tokens = ids(b, 1)
    specs = sh.serve_specs(params, grid, batch=dict(tokens=tokens),
                           cache=cache, fsdp=fsdp)
    fn = make_serve_step(cfg, fam, shardings=Shardings(grid, specs))
    return fn, (sh.place(params, _param_specs(specs), grid), cache, tokens,
                s - 1, None)


def _param_specs(specs):
    return {k[len(".params"):]: v for k, v in specs.items()
            if k.startswith(".params")}


KEYS = ("flops", "collective_counts", "collective_bytes", "ops",
        "hbm_bytes")


@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_real_and_fake_runs_count_the_same(arch, kind, tmp_path, no_group):
    cell = TINY[kind]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=60))
        try:
            grid = make_grid(*ONE)
            fn, args = _real_inputs(arch, cell, grid,
                                    torch.Generator().manual_seed(0))
            with opanalysis.StepCount() as count:
                fn(*args)
        finally:
            dist.destroy_process_group()
    real = count.summary()
    fake = dryrun.run_cell(arch, cell, "one", str(tmp_path), device="cpu",
                           smoke=True, grid=ONE)
    got = dict(flops=fake["cost"]["flops_per_device"],
               collective_counts=fake["collectives"]["counts"],
               collective_bytes=fake["collectives"]["bytes"],
               ops=fake["ops"],
               peak_bytes=fake["memory"]["temp_size_in_bytes"],
               hbm_bytes=fake["cost"]["bytes_per_device"])
    assert {k: got[k] for k in KEYS} == {k: real[k] for k in KEYS}
    assert real["ops"] > 100 and real["flops"] > 0
    assert PEAK[0] <= got["peak_bytes"] / real["peak_bytes"] <= PEAK[1]


def test_run_cell_refuses_an_existing_group(tmp_path, no_group):
    _fake_group(4)
    try:
        with pytest.raises(RuntimeError, match="default group"):
            dryrun.run_cell("whisper-tiny", "decode_32k", "single",
                            str(tmp_path), device="cpu", smoke=True,
                            grid=GRID)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the CLI
def test_cli_full_width_cell(tmp_path):
    """One full-width cell end to end in a subprocess: the 256-rank fake
    group, the rules, the step on fake tensors, the artifact."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[ OK ] whisper-tiny_decode_32k_single" in proc.stdout
    art = json.load(open(tmp_path / "whisper-tiny_decode_32k_single.json"))
    assert art["status"] == "ok"
    assert art["n_devices"] == 256
    assert art["cost"]["flops_per_device"] > 0
    assert art["dominant"] in ("compute_s", "memory_s", "collective_s")
    # 128 requests over 16 data ranks: 8 a rank
    assert art["collectives"]["counts"]["all-gather"] > 0
    assert np.isclose(art["useful_flops_ratio"],
                      art["model_flops_global"]
                      / art["counted_flops_global"])
