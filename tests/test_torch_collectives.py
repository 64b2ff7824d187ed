"""The port's proxy-region collectives (``repro_torch.core.collectives``)
on ranks of a gloo process group against the JAX reference's
``repro.core.collectives`` on fake XLA devices (the counterpart of
``tests/test_collectives.py`` and the compressed psum of
``tests/test_pipeline_compression.py``).

The same seeded inputs (numpy, written once to an ``.npz``) go through
the reference, in one subprocess with 8 fake devices (meshes (pod 2,
data 4), (2, 2) and the flat (1, 2) with ``cross=None``), and through the
port, one spawn of ranks per grid (8, 4 and 2 gloo ranks), each rank
handing its own block to every function and writing what it got back.
Each rank's result is held against its device's:

  * ``proxy_psum`` / ``flat_psum`` / ``hierarchical_psum`` /
    ``proxy_psum_tree`` within 1e-5 of the reference and of the exact
    sum, the fallback (a leading dim the region does not divide)
    included, and proxy within 1e-5 of flat;
  * ``two_hop_all_to_all`` / ``one_hop_all_to_all`` and
    ``gather_records`` bitwise (pure data movement), the all-to-alls
    also bitwise equal to the manual transpose;
  * ``proxy_embedding_grad`` within 1e-5 of the reference and of a dense
    ``np.add.at``;
  * ``compressed_proxy_psum`` within the reference's own bound (2
    scales, 2% of max |x|) and within one block scale of the reference's
    output per element (the regional reduce-scatter sums in another f32
    order, so a value on a rounding edge may land one step away);
  * no function writes into its input.

``_quantize_int8`` / ``_dequantize_int8`` are held bitwise in-process,
and the byte models equal over a table of (bytes, region, cross).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _subproc import run_devices
from _torch_ranks import run_ranks

from repro.core import collectives as J

from repro_torch.core import collectives as C

# tag -> (grid shape (pod, data), cross axis)
GRIDS = {"2x4": ((2, 4), "pod"), "2x2": ((2, 2), "pod"),
         "1x2": ((1, 2), None)}
PSUM_SHAPES = ((16, 4), (5, 3), (64,))        # (5, 3): the fallback
COMP_SHAPES = ((16, 8), (40, 33), (5, 3))      # (40, 33): shards of 2-3 blocks
V, D, NID = 32, 4, 6
TOL = 1e-5


def _inputs() -> dict:
    out = {}
    for g, (tag, (shape, _)) in enumerate(GRIDS.items()):
        n = shape[0] * shape[1]
        rng = np.random.default_rng(g)
        for i, s in enumerate(PSUM_SHAPES):
            out[f"{tag}__psum{i}"] = rng.standard_normal((n,) + s).astype(
                np.float32)
        for i, s in enumerate(COMP_SHAPES):
            out[f"{tag}__comp{i}"] = rng.standard_normal((n,) + s).astype(
                np.float32)
        out[f"{tag}__a2a"] = rng.standard_normal(
            (n, shape[0], shape[1], 3, 5)).astype(np.float32)
        out[f"{tag}__ids"] = rng.integers(0, V, (n, NID)).astype(np.int32)
        out[f"{tag}__gv"] = rng.standard_normal((n, NID, D)).astype(
            np.float32)
        out[f"{tag}__rec_idx"] = (
            np.arange(5, dtype=np.int32)[None]
            + 100 * np.arange(n, dtype=np.int32)[:, None])
        out[f"{tag}__rec_val"] = rng.standard_normal((n, 5)).astype(
            np.float32)
    return out


_REFERENCE = """
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import collectives as C
GRIDS = {grids}
V = {V}
inp = np.load({inputs!r})
out = {{}}
for tag, (shape, cross) in GRIDS.items():
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("pod", "data"))
    spec = P(("pod", "data"))

    def run(fn, *args):
        f = jax.shard_map(lambda *a: fn(*[x[0] for x in a])[None],
                          mesh=mesh, in_specs=(spec,) * len(args),
                          out_specs=spec, check_vma=False)
        return np.asarray(jax.jit(f)(*args))

    def get(k):
        return inp[tag + "__" + k]
    for i in range({n_psum}):
        x = get(f"psum{{i}}")
        out[f"{{tag}}__psum{{i}}"] = run(
            lambda v: C.proxy_psum(v, "data", cross), x)
        out[f"{{tag}}__flat{{i}}"] = run(
            lambda v: C.flat_psum(v, ("pod", "data")), x)
        out[f"{{tag}}__hier{{i}}"] = np.asarray(
            C.hierarchical_psum(x, mesh, "data", cross))
    for i in range({n_comp}):
        out[f"{{tag}}__comp{{i}}"] = run(
            lambda v: C.compressed_proxy_psum(v, "data", cross),
            get(f"comp{{i}}"))
    out[tag + "__two"] = run(lambda b: C.two_hop_all_to_all(b, "data", cross),
                             get("a2a"))
    out[tag + "__one"] = run(lambda b: C.one_hop_all_to_all(b, "data", cross),
                             get("a2a"))
    out[tag + "__emb"] = run(
        lambda i, g: C.proxy_embedding_grad(i, g, V, "data", cross),
        get("ids"), get("gv"))
    for k in (0, 1):
        out[f"{{tag}}__rec{{k}}"] = run(
            lambda a, b: C.gather_records((a, b), "data")[k],
            get("rec_idx"), get("rec_val"))
np.savez({dest!r}, **out)
print("OK")
"""

_PORT = """
import numpy as np
from repro_torch.core import collectives as C
tag, shape, cross = {tag!r}, {shape!r}, {cross!r}
grid = C.make_grid(shape, ("pod", "data"))
inp = np.load({inputs!r})
V = {V}
out, unchanged = {{}}, []


def mine(k):
    return torch.from_numpy(inp[tag + "__" + k][RANK].copy())


def call(key, fn, *args):
    before = [a.clone() for a in args]
    got = fn(*args)
    unchanged.append(all(torch.equal(a, b) for a, b in zip(args, before)))
    if isinstance(got, tuple):
        for k, g in enumerate(got):
            out[f"{{key}}{{k}}"] = g.numpy()
    else:
        out[key] = got.numpy()


for i in range({n_psum}):
    x = mine(f"psum{{i}}")
    call(f"psum{{i}}", lambda v: C.proxy_psum(v, "data", cross, grid=grid), x)
    call(f"flat{{i}}", lambda v: C.flat_psum(v, ("pod", "data"), grid=grid),
         x)
    call(f"hier{{i}}", lambda v: C.hierarchical_psum(v, grid, "data", cross),
         x)
for i in range({n_comp}):
    call(f"comp{{i}}", lambda v: C.compressed_proxy_psum(v, "data", cross,
                                                         grid=grid),
         mine(f"comp{{i}}"))
call("two", lambda b: C.two_hop_all_to_all(b, "data", cross, grid=grid),
     mine("a2a"))
call("one", lambda b: C.one_hop_all_to_all(b, "data", cross, grid=grid),
     mine("a2a"))
call("emb", lambda i, g: C.proxy_embedding_grad(i, g, V, "data", cross,
                                                grid=grid),
     mine("ids"), mine("gv"))
call("rec", lambda a, b: C.gather_records((a, b), "data", grid=grid),
     mine("rec_idx"), mine("rec_val"))
tree = dict(b=(mine("psum2"), [mine("psum1")]), a=mine("psum0"))
leaves = (tree["a"], tree["b"][0], tree["b"][1][0])
before = [t.clone() for t in leaves]
got = C.proxy_psum_tree(tree, "data", cross, grid=grid)
assert list(got) == ["a", "b"] and isinstance(got["b"], tuple) \\
    and isinstance(got["b"][1], list)
out["tree0"], out["tree1"], out["tree2"] = (
    got["a"].numpy(), got["b"][1][0].numpy(), got["b"][0].numpy())
unchanged.append(all(torch.equal(a, b) for a, b in zip(leaves, before)))
layout = dict(coords=list(grid.coords))
for key, axes in (("pod", "pod"), ("data", "data"),
                  ("pod,data", ("pod", "data"))):
    layout[key] = [dist.get_process_group_ranks(grid.group(axes)),
                   grid.size(axes)]
np.savez({outdir!r} + f"/rank{{RANK}}.npz", unchanged=np.array(unchanged),
         **out)
print("LAYOUT", json.dumps(layout))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"inputs", "ref", tag: (every rank's outputs stacked, layouts)}."""
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    fmt = dict(V=V, inputs=str(tmp / "inputs.npz"), n_psum=len(PSUM_SHAPES),
               n_comp=len(COMP_SHAPES))
    out = run_devices(_REFERENCE.format(grids=repr(GRIDS),
                                        dest=str(tmp / "ref.npz"), **fmt),
                      n=8)
    assert "OK" in out
    got = dict(inputs=inputs, ref=dict(np.load(tmp / "ref.npz")))
    for tag, (shape, cross) in GRIDS.items():
        outdir = tmp / tag
        outdir.mkdir()
        n = shape[0] * shape[1]
        texts = run_ranks("import json\n" + _PORT.format(
            tag=tag, shape=shape, cross=cross, outdir=str(outdir), **fmt), n)
        ranks = [dict(np.load(outdir / f"rank{r}.npz")) for r in range(n)]
        stacked = {k: np.stack([r[k] for r in ranks]) for k in ranks[0]}
        layouts = [json.loads(t.split("LAYOUT ", 1)[1].splitlines()[0])
                   for t in texts]
        got[tag] = (stacked, layouts)
    return got


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


CASES = [(tag, i) for tag in GRIDS for i in range(len(PSUM_SHAPES))]


@pytest.mark.parametrize("tag,i", CASES)
def test_proxy_psum_matches_reference_and_flat(runs, tag, i):
    port, _ = runs[tag]
    ref = runs["ref"]
    x = runs["inputs"][f"{tag}__psum{i}"]
    exact = x.astype(np.float64).sum(0)
    for key in ("psum", "flat", "hier"):
        got = port[f"{key}{i}"]
        assert got.shape == x.shape and got.dtype == np.float32
        _close(got, np.broadcast_to(exact, x.shape))
        want = ref[f"{tag}__{key}{i}"]
        _close(got, np.broadcast_to(want, x.shape))
    _close(port[f"psum{i}"], port[f"flat{i}"])


@pytest.mark.parametrize("tag", GRIDS)
def test_proxy_psum_tree_maps_every_leaf(runs, tag):
    port, _ = runs[tag]
    for k in range(len(PSUM_SHAPES)):
        _close(port[f"tree{k}"], runs["ref"][f"{tag}__psum{k}"])
        np.testing.assert_array_equal(port[f"tree{k}"], port[f"psum{k}"])


@pytest.mark.parametrize("tag", GRIDS)
def test_all_to_all_bitwise(runs, tag):
    port, _ = runs[tag]
    ref = runs["ref"]
    (c, r), _ = GRIDS[tag]
    buf = runs["inputs"][f"{tag}__a2a"]
    manual = np.transpose(buf.reshape(c, r, c, r, 3, 5),
                          (2, 3, 0, 1, 4, 5)).reshape(buf.shape)
    for key in ("two", "one"):
        np.testing.assert_array_equal(port[key], ref[f"{tag}__{key}"])
        np.testing.assert_array_equal(port[key], manual)


@pytest.mark.parametrize("tag", GRIDS)
def test_proxy_embedding_grad(runs, tag):
    port, _ = runs[tag]
    (c, r), cross = GRIDS[tag]
    ids = runs["inputs"][f"{tag}__ids"]
    gv = runs["inputs"][f"{tag}__gv"]
    got = port["emb"]
    assert got.shape == (c * r, V // r, D)
    _close(got, runs["ref"][f"{tag}__emb"])
    # rank (p, q) owns rows q*V/r.. of the sum over its pod (flat) or
    # over the whole grid
    for p in range(c):
        scope = slice(p * r, p * r + r) if cross is None else slice(0, c * r)
        dense = np.zeros((V, D), np.float64)
        np.add.at(dense, ids[scope].reshape(-1), gv[scope].reshape(-1, D))
        _close(got[p * r:(p + 1) * r].reshape(V, D), dense)


def _block_scales(x, region, cross, block=256):
    """Each output element's shared block scale: the max over regions of
    its block's max |regional sum| / 127, laid out as the output."""
    n = x.shape[0]
    c = n // region
    sums = x.astype(np.float32).reshape((c, region) + x.shape[1:]).sum(1)
    k = x.shape[1] // region
    scales = np.zeros((c,) + x.shape[1:], np.float32)
    for q in range(region):
        shard = sums[:, q * k:(q + 1) * k].reshape(c, -1)
        pad = (-shard.shape[1]) % block
        blocks = np.pad(shard, ((0, 0), (0, pad))).reshape(c, -1, block)
        s = np.abs(blocks).max(-1).max(0) / 127.0
        per = np.repeat(s, block)[:shard.shape[1]]
        scales[:, q * k:(q + 1) * k] = per.reshape((k,) + x.shape[2:])
    return scales.max(0)


@pytest.mark.parametrize("tag,i", [(t, i) for t in GRIDS
                                   for i in range(len(COMP_SHAPES))])
def test_compressed_proxy_psum_bounded_and_near_reference(runs, tag, i):
    port, _ = runs[tag]
    (c, r), cross = GRIDS[tag]
    x = runs["inputs"][f"{tag}__comp{i}"]
    got = port[f"comp{i}"]
    want = runs["ref"][f"{tag}__comp{i}"]
    assert got.shape == x.shape and got.dtype == np.float32
    exact = x.astype(np.float64).sum(0)
    if cross is None or COMP_SHAPES[i][0] % r:
        # flat branch or fallback: an exact f32 sum, no quantization
        _close(got, np.broadcast_to(exact, x.shape))
        _close(got, want)
        return
    # the reference's own bound (tests/test_pipeline_compression.py)
    err = np.abs(got - exact)
    scale = np.abs(exact).max() / 127.0
    assert err.max() <= 2 * scale + 1e-5, (err.max(), scale)
    assert err.max() / np.abs(exact).max() < 0.02
    # within one block scale of the reference's output, element by element
    per = _block_scales(x, r, cross)
    assert (np.abs(got - want) <= per[None] * (1 + 1e-6) + 1e-7).all()
    # every rank holds the same result
    assert (got == got[:1]).all()


@pytest.mark.parametrize("tag", GRIDS)
def test_gather_records_bitwise(runs, tag):
    port, _ = runs[tag]
    for k in (0, 1):
        assert port[f"rec{k}"].dtype == runs["ref"][f"{tag}__rec{k}"].dtype
        np.testing.assert_array_equal(port[f"rec{k}"],
                                      runs["ref"][f"{tag}__rec{k}"])


@pytest.mark.parametrize("tag", GRIDS)
def test_inputs_unchanged(runs, tag):
    port, _ = runs[tag]
    assert port["unchanged"].all(), port["unchanged"]


@pytest.mark.parametrize("tag", GRIDS)
def test_grid_is_row_major_like_make_mesh(runs, tag):
    (c, r), _ = GRIDS[tag]
    _, layouts = runs[tag]
    for rank, lay in enumerate(layouts):
        p, q = divmod(rank, r)
        assert lay["coords"] == [p, q]
        assert lay["pod"] == [[q + r * k for k in range(c)], c]
        assert lay["data"] == [[p * r + k for k in range(r)], r]
        assert lay["pod,data"] == [list(range(c * r)), c * r]


# ------------------------------------------------------ in-process parts
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 255, 256, 300, 1024])
def test_quantizer_bitwise(dtype, n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10).astype(np.float32)
    x[: min(n, 4)] = [127.0, 2.5, -3.5, 0.5][: min(n, 4)]   # halves: to even
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy(), dtype)
    q, s = C._quantize_int8(tx)
    jq, js = J._quantize_int8(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    d = C._dequantize_int8(q, s, (n,))
    jd = J._dequantize_int8(jq, js, (n,))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_byte_models_equal():
    for nbytes in (1, 1e6, 2.5e9):
        for n_dev in (1, 2, 8, 512):
            assert C.allreduce_bytes(nbytes, n_dev) == \
                J.allreduce_bytes(nbytes, n_dev)
        for region in (1, 2, 4, 16):
            for cross in (1, 2, 8):
                assert C.proxy_sync_bytes(nbytes, region, cross) == \
                    J.proxy_sync_bytes(nbytes, region, cross)


def test_group_that_cannot_carry_the_tensor_raises(monkeypatch):
    monkeypatch.setattr(C.dist, "get_backend", lambda group: "nccl")
    with pytest.raises(ValueError, match="nccl process group cannot carry "
                                         "cpu"):
        C.check_carrier(None, "cpu")
    monkeypatch.setattr(C.dist, "get_backend",
                        lambda group: "cpu:gloo,cuda:nccl")
    C.check_carrier(None, "cpu")
    C.check_carrier(None, None)
