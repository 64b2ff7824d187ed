"""The PyTorch port's framework-free base against the JAX reference.

Data is made with numpy from a seed and handed to both packages: the
copied numpy modules (csr, rmat, oracles, costmodel, metrics) must
behave exactly like the originals, and the torch renderings of the
geometry, P$ index maps and traffic charges must give the reference's
values bit for bit.  Also: the port imports nothing of JAX or of the
JAX package.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import costmodel as jcost
from repro.core import netstats as jnet
from repro.core import proxy as jproxy
from repro.core import tilegrid as jtg
from repro.graph import csr as jcsr
from repro.graph import oracles as joracles
from repro.graph import rmat as jrmat

from repro_torch import convert, device
from repro_torch.core import costmodel, netstats, proxy, tilegrid
from repro_torch.graph import csr, oracles, rmat
from repro_torch.obs import metrics

REPO = Path(__file__).resolve().parent.parent

GRIDS = {
    "8x8": dict(ny=8, nx=8),
    "16x16-dies4-pkg8": dict(ny=16, nx=16, die_ny=4, die_nx=4, pkg_ny=8,
                             pkg_nx=8),
    "16x16-mesh": dict(ny=16, nx=16, die_ny=4, die_nx=4, pkg_ny=8, pkg_nx=8,
                       torus=False),
    "12x20-dies4-pkg8": dict(ny=12, nx=20, die_ny=4, die_nx=4, pkg_ny=8,
                             pkg_nx=8),
}


def _grids(name):
    return jtg.TileGrid(**GRIDS[name]), tilegrid.TileGrid(**GRIDS[name])


def _tiles(grid, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, grid.num_tiles, n).astype(np.int32)
    dst = rng.integers(0, grid.num_tiles, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    return src, dst, mask


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------- datasets
@pytest.mark.parametrize("scale,ef,seed", [(6, 4, 0), (8, 8, 1), (9, 16, 42)])
def test_rmat_and_csr_copies_equal(scale, ef, seed):
    a = rmat.rmat_edges(scale, edge_factor=ef, seed=seed)
    b = jrmat.rmat_edges(scale, edge_factor=ef, seed=seed)
    for k in ("row_ptr", "col_idx", "weights"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.n_cols == b.n_cols
    at, bt = csr.transpose_csr(a), jcsr.transpose_csr(b)
    for k in ("row_ptr", "col_idx", "weights"):
        assert np.array_equal(getattr(at, k), getattr(bt, k)), k
    hv_a = rmat.histogram_input(a, 64)
    assert np.array_equal(hv_a, jrmat.histogram_input(b, 64))


def test_csr_from_edges_dedup_equal():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    w = rng.random(400).astype(np.float32)
    a = csr.csr_from_edges(src, dst, 50, weights=w, dedup=True)
    b = jcsr.csr_from_edges(src, dst, 50, weights=w, dedup=True)
    for k in ("row_ptr", "col_idx", "weights"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_oracles_equal():
    g = rmat.rmat_edges(8, edge_factor=6, seed=2)
    root = int(np.argmax(g.out_degree()))
    assert np.array_equal(oracles.bfs_oracle(g, root),
                          joracles.bfs_oracle(g, root))
    assert np.array_equal(oracles.sssp_oracle(g, root),
                          joracles.sssp_oracle(g, root))
    assert np.array_equal(oracles.wcc_oracle(g), joracles.wcc_oracle(g))


def test_csr_to_device():
    g = rmat.rmat_edges(7, edge_factor=4, seed=5)
    d = convert.csr_to_device(g, "cpu")
    assert np.array_equal(d["row_lo"].numpy(), g.row_lo)
    assert np.array_equal(d["row_hi"].numpy(), g.row_hi)
    assert d["col_idx"].dtype == torch.int32
    assert np.array_equal(d["col_idx"].numpy(), g.col_idx)
    assert np.array_equal(d["weights"].numpy(), g.weights)


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_routing_helpers_equal(name):
    jg, tg = _grids(name)
    src, dst, _ = _tiles(jg, 3000, seed=len(name))
    s, d = _t(src), _t(dst)
    assert np.array_equal(np.asarray(jg.hops(src, dst)),
                          tg.hops(s, d).numpy())
    for a, b in zip(jg.link_levels(src, dst), tg.link_levels(s, d)):
        assert np.array_equal(np.asarray(a), b.numpy())
    for rny, rnx in ((2, 2), (4, 2), (3, 5)):
        assert np.array_equal(
            np.asarray(jg.region_crossings(src, dst, rny, rnx)),
            tg.region_crossings(s, d, rny, rnx).numpy())
        assert np.array_equal(np.asarray(jg.region_id(src, rny, rnx)),
                              tg.region_id(s, rny, rnx).numpy())
    idx = np.random.default_rng(1).integers(0, 5000, 2000).astype(np.int32)
    assert np.array_equal(np.asarray(jg.owner(idx, 5000)),
                          tg.owner(_t(idx), 5000).numpy())


@pytest.mark.parametrize("chips", [(1, 1), (2, 2), (1, 4)])
def test_chip_partition_maps_equal(chips):
    jg, tg = _grids("16x16-dies4-pkg8")
    jp = jtg.ChipPartition(jg, *chips)
    tp = tilegrid.ChipPartition(tg, *chips)
    tid = np.arange(jg.num_tiles, dtype=np.int32)
    assert np.array_equal(np.asarray(jp.local_tile(tid)),
                          tp.local_tile(_t(tid)).numpy())
    assert np.array_equal(np.asarray(jp.chip_of_tile(tid)),
                          tp.chip_of_tile(_t(tid)).numpy())
    ltid = np.arange(jp.tiles_per_chip, dtype=np.int32)
    for chip in range(jp.num_chips):
        assert np.array_equal(np.asarray(jp.global_tile(chip, ltid)),
                              tp.global_tile(chip, _t(ltid)).numpy())
    assert (tilegrid.partition_grid(tg, 4).chips_y
            == jtg.partition_grid(jg, 4).chips_y)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_proxy_maps_and_pcache_equal(name):
    jg, tg = _grids(name)
    owner, src, _ = _tiles(jg, 3000, seed=7)
    for rny, rnx, slots in ((2, 2, 64), (4, 4, 512), (3, 5, 100)):
        jc = jproxy.ProxyConfig(region_ny=rny, region_nx=rnx, slots=slots)
        tc = proxy.ProxyConfig(region_ny=rny, region_nx=rnx, slots=slots)
        assert np.array_equal(np.asarray(jproxy.proxy_tile(jg, jc, owner,
                                                           src)),
                              proxy.proxy_tile(tg, tc, _t(owner),
                                               _t(src)).numpy())
        idx = np.random.default_rng(slots).integers(
            0, 10**6, 2000).astype(np.int32)
        a = np.asarray(jproxy.pcache_slot(jc, idx))
        b = proxy.pcache_slot(tc, _t(idx))
        assert b.dtype == torch.int32 and np.array_equal(a, b.numpy())
        jt, jv = jproxy.make_pcache(jg, jc, float("inf"))
        tt, tv = proxy.make_pcache(tg, tc, float("inf"), "cpu")
        assert np.array_equal(np.asarray(jt), tt.numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())


def test_proxy_config_validation_copied():
    grid = tilegrid.TileGrid(16, 16)
    casc = proxy.CascadeConfig(levels=3, group_ny=2, group_nx=2)
    with pytest.raises(ValueError, match="cascade level"):
        proxy.ProxyConfig(region_ny=4, region_nx=4,
                          cascade=casc).validate(grid)
    with pytest.raises(ValueError):
        proxy.CascadeConfig(levels=0)
    proxy.ProxyConfig(region_ny=4, region_nx=4,
                      cascade=proxy.CascadeConfig(levels=1)).validate(grid)


# ------------------------------------------------------------- traffic
@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("regions", [None, (2, 2), (4, 3)])
def test_charge_equal(name, regions):
    jg, tg = _grids(name)
    src, dst, mask = _tiles(jg, 4000, seed=11)
    a = jnet.charge(jg, src, dst, mask, region_dims=regions)
    b = netstats.charge(tg, _t(src), _t(dst), _t(mask), region_dims=regions)
    assert set(a) == set(b)
    for k in a:
        assert b[k].dtype == torch.float32
        assert float(np.asarray(a[k])) == float(b[k]), k
    ma = jnet.merge_charges(a, a)
    mb = netstats.merge_charges(b, b)
    assert {k: float(np.asarray(v)) for k, v in ma.items()} == \
        {k: float(v) for k, v in mb.items()}


@pytest.mark.parametrize("chips", [(2, 2), (1, 4)])
def test_charge_off_chip_equal(chips):
    jg, tg = _grids("16x16-dies4-pkg8")
    src, dst, mask = _tiles(jg, 3000, seed=13)
    a = jnet.charge_off_chip(jtg.ChipPartition(jg, *chips), src, dst, mask)
    b = netstats.charge_off_chip(tilegrid.ChipPartition(tg, *chips),
                                 _t(src), _t(dst), _t(mask))
    assert {k: float(np.asarray(v)) for k, v in a.items()} == \
        {k: float(v) for k, v in b.items()}


def test_trace_and_counters_copied():
    rng = np.random.default_rng(4)
    keys = ("compute_per_tile_max", "intra_die_hops", "inter_die_crossings",
            "inter_pkg_crossings", "delivered_max_per_tile",
            "edges_processed", "records_consumed", "pending")
    stacked = {k: rng.integers(0, 1000, 9).astype(np.float32) for k in keys}
    ta, tb = jnet.SuperstepTrace(), netstats.SuperstepTrace()
    ta.append_chunk(stacked, 7)
    tb.append_chunk(stacked, 7)
    assert ta.to_dict() == tb.to_dict()
    assert netstats.SuperstepTrace.from_dict(ta.to_dict()).to_dict() == \
        ta.to_dict()
    ca = jnet.TrafficCounters(messages=3.0, hop_msgs=9.0)
    cb = netstats.TrafficCounters(messages=3.0, hop_msgs=9.0)
    assert ca.add(ca).as_dict() == cb.add(cb).as_dict()
    assert netstats.MSG_BITS == jnet.MSG_BITS


# ------------------------------------------------------------- cost model
@pytest.mark.parametrize("pkg", ["DCRA_SRAM", "DCRA_HBM_HORIZ", "DALOREX"])
@pytest.mark.parametrize("tiles", [64, 1024, 16384])
def test_step_cycles_and_price_equal(pkg, tiles):
    jg, tg = jtg.square_grid(tiles), tilegrid.square_grid(tiles)
    jp, tp = getattr(jcost, pkg), getattr(costmodel, pkg)
    assert jcost.link_provisioning(jg, jp) == costmodel.link_provisioning(tg,
                                                                          tp)
    links = costmodel.link_provisioning(tg, tp)
    rng = np.random.default_rng(tiles)
    vec = {k: rng.integers(0, 10**6, 32).astype(np.float64)
           for k in ("compute_ops", "intra_bits", "die_bits", "pkg_bits",
                     "endpoint_bits")}
    a = jcost.step_cycles(jp, links, **vec)
    b = costmodel.step_cycles(tp, links, **vec)
    assert np.array_equal(a, b)
    trace = dict(vec, touched_bits=vec["intra_bits"], pending=vec["die_bits"])
    ca = jnet.TrafficCounters(messages=1e6, intra_die_hops=3e6,
                              records_consumed=5e5, edges_processed=7e5)
    cb = netstats.TrafficCounters(**ca.as_dict())
    ra = jcost.price(jp, jg, ca, mem_bits_hbm=1e9, per_superstep_peak=trace)
    rb = costmodel.price(tp, tg, cb, mem_bits_hbm=1e9,
                         per_superstep_peak=trace)
    assert (ra.time_s, ra.energy_j, ra.cost_usd) == \
        (rb.time_s, rb.energy_j, rb.cost_usd)


def test_metrics_registry_copied():
    reg = metrics.MetricsRegistry()
    reg.counter("engine.host_syncs").inc()
    reg.counter("engine.host_syncs").inc(2)
    reg.histogram("h").observe(3.0)
    assert reg.snapshot()["counters"] == {"engine.host_syncs": 3.0}
    assert reg.snapshot()["histograms"]["h"]["max"] == 3.0


# ------------------------------------------------------------- device
def test_device_default_is_the_card():
    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device.resolve(None)
    assert device.resolve("cpu") == torch.device("cpu")


def test_engine_state_round_trip():
    rng = np.random.default_rng(0)
    np_state = dict(values=rng.random(8).astype(np.float32),
                    mail_val=np.full(8, np.inf, np.float32),
                    mail_flag=rng.random(8) < 0.5,
                    cur_lo=np.arange(8, dtype=np.int32),
                    cur_hi=np.arange(8, dtype=np.int32) + 2,
                    cur_val=np.zeros(8, np.float32),
                    p_tag=np.full((4, 2), -1, np.int32),
                    p_val=np.full((4, 2), np.inf, np.float32))
    st = convert.engine_state_from_numpy(np_state, "cpu")
    assert all(st[k].dtype == convert.STATE_DTYPES[k] for k in st)
    back = convert.engine_state_to_numpy(st)
    for k, v in np_state.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    with pytest.raises(ValueError, match="unknown"):
        convert.engine_state_from_numpy(dict(bogus=np.zeros(2)), "cpu")


# ------------------------------------------------------------- hygiene
def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "decode_variants.py",
        REPO / "scripts" / "engine_kernel_variants.py",
        REPO / "scripts" / "hooks_overhead.py",
        REPO / "scripts" / "lint_engine_torch.py"]


def test_port_sources_import_no_jax_or_reference():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_importing_the_port_loads_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "n = sum(m.startswith('repro_torch') for m in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 20 else 0)\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
