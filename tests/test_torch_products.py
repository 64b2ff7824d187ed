"""``repro_torch.products``: the package-time product search measured
through the port's engine, on the CPU (``device="cpu"``).

The reference's cases (``tests/test_products.py``) on the port, then
parity with ``repro.products`` with no tolerance: measurement payloads,
every priced row, Pareto fronts and selections at 1, 4 and 16 chips; the
design space and the chip counts; a cache entry written by the reference
read and priced by the port, while the two packages' keys differ; one
RMAT graph per sweep; no silent CPU fallback.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.products as ref_products  # noqa: E402
from repro.graph import apps as ref_apps  # noqa: E402
# the reference's modules by their own names too, as the port's below:
# the dead-code gate's walk may mark a package seen without reading its
# ``__init__`` when a submodule is reached first
from repro.products import cache as ref_cache  # noqa: E402
from repro.products import search as ref_search_mod  # noqa: E402
from repro.products import space as ref_space  # noqa: E402
from repro_torch.core.costmodel import DCRA_SRAM, price  # noqa: E402
from repro_torch.core.netstats import SuperstepTrace  # noqa: E402
from repro_torch.core.proxy import max_cascade_levels  # noqa: E402
from repro_torch.graph import apps  # noqa: E402
from repro_torch.products import cache as port_cache  # noqa: E402
from repro_torch.products import search as port_search  # noqa: E402
from repro_torch.products import space as port_space  # noqa: E402
from repro_torch.products.search import (  # noqa: E402
    Measurement, MeasureSpec, ProductSearch, pareto_front, select_products)
from repro_torch.products.space import product_space  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:          # property tests below degrade to skips
    given = None

SSSP = MeasureSpec(app="sssp", scale=8, tiles=64)
HISTO = MeasureSpec(app="histo", scale=8, tiles=64, cascade_levels=1)
PARITY = {"sssp": SSSP, "histo casc1": HISTO,
          "sssp 4 chips": dataclasses.replace(SSSP, chips=4),
          "sssp 16 chips": dataclasses.replace(SSSP, chips=16)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _search(path) -> ProductSearch:
    return ProductSearch(cache_dir=str(path), device="cpu")


@pytest.fixture(scope="module")
def search(tmp_path_factory):
    return _search(tmp_path_factory.mktemp("products"))


@pytest.fixture(scope="module")
def rows(search):
    return search.sweep([SSSP, HISTO], product_space())


# ------------------------------------------- the reference's cases, ported
def test_sweep_measures_once_prices_many(search, rows):
    """2 specs x 12 configs -> 24 priced rows from exactly 2 engine runs."""
    assert len(rows) == 2 * 12
    assert search.engine_runs == 2
    assert len({r["product"] for r in rows}) == 12


def test_cache_round_trip_identical_pricing(search, rows):
    """Reloading a measurement from its JSON cache entry reproduces the
    live measurement's pricing bit-for-bit, without an engine run."""
    runs_before = search.engine_runs
    rows2 = search.sweep([SSSP, HISTO], product_space())
    assert search.engine_runs == runs_before
    assert all(r["from_cache"] for r in rows2)
    for r1, r2 in zip(rows, rows2):
        assert {**r1, "from_cache": True} == r2


def test_trace_json_round_trip(search):
    m = search.measure(SSSP)
    t2 = SuperstepTrace.from_dict(m.trace.to_dict())
    assert len(t2) == len(m.trace) == m.supersteps
    assert t2.to_dict() == m.trace.to_dict()


@pytest.mark.parametrize("chips", [0, 4])
def test_reprice_under_own_config_matches_measured_time(search, chips):
    """Pricing a run's trace under the config it was measured with
    reproduces the run loop's own BSP time (monolithic and
    distributed)."""
    m = search.measure(dataclasses.replace(SSSP, chips=chips))
    if chips:
        assert m.trace.board_links > 1
        assert m.counters.off_chip_msgs > 0
    rep = price(DCRA_SRAM, m.grid, m.counters, per_superstep_peak=m.trace)
    assert rep.time_s == pytest.approx(m.time_s, rel=1e-9)


def test_pareto_front_no_selected_product_dominated(rows):
    for meas in {r["measurement"] for r in rows}:
        group = [r for r in rows if r["measurement"] == meas]
        front = pareto_front(group)
        assert front
        for f in front:
            for r in group:
                dominates = (r["thr_per_usd"] >= f["thr_per_usd"]
                             and r["eff_per_usd"] >= f["eff_per_usd"]
                             and (r["thr_per_usd"] > f["thr_per_usd"]
                                  or r["eff_per_usd"] > f["eff_per_usd"]))
                assert not dominates, (f, r)


def test_select_products_optimal_per_objective(rows):
    group = [r for r in rows if r["measurement"] == SSSP.label]
    sel = select_products(group)
    assert sel["time"]["time_s"] == min(r["time_s"] for r in group)
    assert sel["energy"]["energy_j"] == min(r["energy_j"] for r in group)
    assert sel["cost"]["cost_usd"] == min(r["cost_usd"] for r in group)
    assert sel["throughput_per_dollar"]["thr_per_usd"] == \
        max(r["thr_per_usd"] for r in group)
    assert sel["efficiency_per_dollar"]["eff_per_usd"] == \
        max(r["eff_per_usd"] for r in group)


def test_cascade_legs_priced_into_products(search, rows):
    casc = [r for r in rows if r["measurement"] == HISTO.label]
    assert all(r["cascade_combined"] > 0 for r in casc)
    m = search.measure(HISTO)
    no_casc = search.measure(dataclasses.replace(HISTO, cascade_levels=0))
    assert m.counters.cascade_combined > 0
    assert no_casc.counters.cascade_combined == 0


def test_corrupt_cache_entry_is_a_miss(tmp_path):
    ps = _search(tmp_path)
    spec = MeasureSpec(app="histo", scale=7, tiles=16)
    assert not ps.measure(spec).from_cache
    with open(ps.cache.path(spec.key()), "w") as f:
        f.write("{not json")
    assert not ps.measure(spec).from_cache      # re-measured, not crashed
    assert ps.engine_runs == 2
    assert ps.measure(spec).from_cache


def test_sweep_chips_axis_measures_per_chip_count(tmp_path):
    """Configs with chips=N re-base the measurement onto the distributed
    engine at N chips: one engine run per chip count, every same-count
    config re-priced from the one cached board-level trace."""
    ps = _search(tmp_path)
    cfgs = product_space(memory=("sram",), network=("d_32+64_od64",),
                         chips=(1, 4), board_links=(1, 2))
    rows = ps.sweep([SSSP], cfgs)
    assert ps.engine_runs == 2                  # once per chip count
    assert sorted({r["chips"] for r in rows}) == [1, 4]
    four = {r["product"]: r for r in rows if r["chips"] == 4}
    assert all(k.startswith("sram/net-d/sram1.5/c4") for k in four)
    assert all(r["measurement"].endswith("4chips") for r in four.values())
    # fewer board links are never faster, and cost less
    bl1, bl2 = four["sram/net-d/sram1.5/c4/bl1"], four["sram/net-d/sram1.5/c4"]
    assert bl1["time_s"] >= bl2["time_s"]
    assert bl1["cost_usd"] < bl2["cost_usd"]


def test_reprice_cached_4chip_trace_exact(tmp_path):
    """Re-pricing a cached 4-chip trace under its measured PackageConfig
    reproduces the directly measured run.time_s."""
    ps = _search(tmp_path)
    spec = dataclasses.replace(SSSP, chips=4)
    live = ps.measure(spec)
    cached = ps.measure(spec)
    assert cached.from_cache and not live.from_cache
    assert cached.trace.chips_y * cached.trace.chips_x == 4
    for m in (live, cached):
        rep = ps.price_product(m, dataclasses.replace(DCRA_SRAM, chips=4))
        assert rep.time_s == m.time_s == live.time_s


def test_price_product_rejects_chip_count_mismatch(search):
    m = search.measure(SSSP)
    with pytest.raises(ValueError, match="chips=4"):
        search.price_product(m, dataclasses.replace(DCRA_SRAM, chips=4))


def test_measure_validates_spec(tmp_path):
    ps = _search(tmp_path / "never-written")
    with pytest.raises(ValueError, match="unknown app"):
        ps.measure(MeasureSpec(app="bfsx", scale=8, tiles=64))
    with pytest.raises(ValueError, match="cannot block-partition"):
        ps.measure(MeasureSpec(app="sssp", scale=8, tiles=64, chips=5))
    assert ps.engine_runs == 0                  # rejected before running
    assert not (tmp_path / "never-written").exists()


def test_spec_hash_sensitive_to_every_field():
    base = MeasureSpec(app="sssp", scale=8, tiles=64)
    perturbed = dict(app="histo", scale=9, tiles=256, edge_factor=16,
                     seed=2, oq_cap=16, slots=256, region_div=2,
                     cascade_levels=1, cascade_group=4, selective=False,
                     chips=4, epochs=5)
    assert set(perturbed) == {f.name for f in dataclasses.fields(base)}
    keys = {base.key()}
    for field, value in perturbed.items():
        assert getattr(base, field) != value, field
        k = dataclasses.replace(base, **{field: value}).key()
        assert k not in keys, f"key collision perturbing {field!r}"
        keys.add(k)


def test_stale_schema_cache_entry_rejected(tmp_path):
    ps = _search(tmp_path)
    spec = MeasureSpec(app="histo", scale=7, tiles=16)
    ps.measure(spec)
    path = ps.cache.path(spec.key())
    with open(path) as f:
        payload = json.load(f)
    payload["schema"] = 1                       # pre-chips-axis schema
    with open(path, "w") as f:
        json.dump(payload, f)
    m = ps.measure(spec)
    assert not m.from_cache and ps.engine_runs == 2
    assert ps.measure(spec).from_cache          # rewritten at current schema


def test_concurrent_writer_round_trip(tmp_path):
    """Two searches sharing one cache dir: whoever measures first
    publishes atomically; a torn write is a miss, not a crash."""
    spec = MeasureSpec(app="histo", scale=7, tiles=16)
    a, b = _search(tmp_path), _search(tmp_path)
    ma = a.measure(spec)
    mb = b.measure(spec)
    assert a.engine_runs == 1 and b.engine_runs == 0
    assert mb.from_cache
    assert mb.trace.to_dict() == ma.trace.to_dict()
    assert mb.counters.as_dict() == ma.counters.as_dict()
    (tmp_path / "junk.tmp").write_text('{"schema": 2, "trunc')
    assert b.measure(spec).from_cache
    with open(a.cache.path(spec.key()), "w") as f:
        f.write('{"schema": 2, "spec": {"app": "hist')   # torn mid-write
    m = b.measure(spec)
    assert not m.from_cache and b.engine_runs == 1       # re-measured
    assert b.measure(spec).from_cache                    # healed


@pytest.mark.property
@pytest.mark.slow
@pytest.mark.skipif(given is None, reason="hypothesis not installed")
def test_pricing_contract_random_configs(tmp_path_factory):
    """Property: for random cascade/chunk/chip measurement configs, the
    measured trace priced under its own PackageConfig reproduces the run
    loop's time."""
    ps = _search(tmp_path_factory.mktemp("contract"))

    @settings(max_examples=6, deadline=None)
    @given(app=st.sampled_from(("sssp", "histo")),
           cascade_levels=st.integers(0, 1),
           chips=st.sampled_from((0, 4)),
           run_chunk=st.sampled_from((0, 3)),
           seed=st.integers(1, 2))
    def check(app, cascade_levels, chips, run_chunk, seed):
        spec = MeasureSpec(app=app, scale=7, tiles=64, seed=seed,
                           cascade_levels=cascade_levels, chips=chips)
        m = ps.measure(spec, run_chunk=run_chunk)
        cfg = dataclasses.replace(DCRA_SRAM, chips=max(chips, 1))
        rep = ps.price_product(m, cfg)
        assert rep.time_s == pytest.approx(m.time_s, rel=1e-9)
        assert ps.price_product(m, DCRA_SRAM).time_s == rep.time_s

    check()


def test_max_cascade_levels():
    assert max_cascade_levels(8, 8, 2, 2) == 1
    assert max_cascade_levels(16, 16, 2, 2) == 2
    assert max_cascade_levels(16, 16, 2, 2, 4, 4) == 1
    assert max_cascade_levels(8, 8, 3, 3) == 0
    assert max_cascade_levels(8, 8, 2, 2, 8, 8) == 0


def test_histogram_measurement_values_sane(search):
    m = search.measure(HISTO)
    assert m.supersteps == len(m.trace)
    assert m.counters.edges_processed > 0
    assert m.touched_bits > 0 and m.dataset_bits > 0
    assert np.isfinite(m.time_s) and m.time_s > 0


# ------------------------------------------------ parity with the reference
@pytest.fixture(scope="module")
def ref_search(tmp_path_factory):
    return ref_products.ProductSearch(
        cache_dir=str(tmp_path_factory.mktemp("ref_products")))


def _ref(spec: MeasureSpec) -> ref_search_mod.MeasureSpec:
    return ref_search_mod.MeasureSpec(**dataclasses.asdict(spec))


@pytest.fixture(scope="module")
def both(search, ref_search):
    """{label: (port rows, reference rows)} of each parity spec's sweep
    over the default space, and its measurements."""
    out = {}
    for label, spec in PARITY.items():
        out[label] = dict(
            rows=(search.sweep([spec], product_space()),
                  ref_search.sweep([_ref(spec)],
                                   ref_space.product_space())),
            measured=(search.measure(spec),
                      ref_search.measure(_ref(spec))))
    return out


@pytest.mark.parametrize("label", list(PARITY))
def test_measurement_payload_equals_reference(both, label):
    port, ref = both[label]["measured"]
    assert json.dumps(port.to_payload()) == json.dumps(ref.to_payload())


@pytest.mark.parametrize("label", list(PARITY))
def test_priced_rows_equal_reference(both, label):
    port, ref = both[label]["rows"]
    assert len(port) == len(ref) == 12
    for p, r in zip(port, ref):
        assert p.keys() == r.keys()
        for k in p:
            if k != "from_cache":
                assert p[k] == r[k], (label, p["product"], k)


@pytest.mark.parametrize("label", list(PARITY))
def test_pareto_and_selection_equal_reference(both, label):
    port, ref = both[label]["rows"]
    names = lambda rows: [r["product"] for r in rows]  # noqa: E731
    assert names(pareto_front(port)) == names(ref_products.pareto_front(ref))
    for metrics in (("time", "energy"), ("cost", "efficiency_per_dollar")):
        assert names(pareto_front(port, metrics)) == \
            names(ref_products.pareto_front(ref, metrics))
    sel, ref_sel = select_products(port), ref_products.select_products(ref)
    assert {k: v["product"] for k, v in sel.items()} == \
        {k: v["product"] for k, v in ref_sel.items()}


@pytest.mark.parametrize("space", [
    {}, dict(sram_mib=port_space.FULL_SRAM_MIB),
    dict(chips=port_space.CHIP_COUNTS, board_links=(1, 2, 4))])
def test_product_space_equals_reference(space):
    port = [dataclasses.asdict(c) for c in product_space(**space)]
    ref = [dataclasses.asdict(c)
           for c in ref_space.product_space(**space)]
    assert port == ref
    assert len({c["name"] for c in port}) == len(port)


def test_space_constants_equal_reference():
    for name in ("MEMORY_STYLES", "DEFAULT_SRAM_MIB", "FULL_SRAM_MIB",
                 "CHIP_COUNTS", "DEFAULT_BOARD_LINKS"):
        assert getattr(port_space, name) == getattr(ref_space, name)
    assert port_search.OBJECTIVES == ref_products.OBJECTIVES
    assert port_cache.SCHEMA_VERSION == ref_cache.SCHEMA_VERSION
    assert apps.DISTRIBUTED_APPS == frozenset(apps.APPS) == \
        ref_apps.DISTRIBUTED_APPS


@pytest.mark.parametrize("tiles", [64, 256, 1024, 4096])
def test_chip_counts_for_equals_reference(tiles):
    assert port_space.chip_counts_for(tiles) == \
        ref_space.chip_counts_for(tiles)
    assert port_space.chip_counts_for(tiles, (0, 1, 2, 9, 16)) == \
        ref_space.chip_counts_for(tiles, (0, 1, 2, 9, 16))


def test_reference_cache_entry_read_and_priced_by_the_port(both, ref_search):
    """A file the reference's ``CounterCache`` wrote is read by the port's
    cache and prices to the reference's rows; the two packages' keys for
    one spec differ, so the port's search never takes it as a hit."""
    spec = PARITY["sssp 4 chips"]
    ref_key = _ref(spec).key()
    assert spec.key() != ref_key
    payload = port_cache.CounterCache(ref_search.cache.root).get(ref_key)
    assert payload is not None and payload["schema"] == 2
    m = Measurement.from_payload(spec, payload)
    ref_rows = both["sssp 4 chips"]["rows"][1]
    ps = _search(ref_search.cache.root)
    for cfg, want in zip(product_space(), ref_rows):
        got = port_search.product_row(m, cfg, ps.price_product(m, cfg))
        assert got == dict(want, from_cache=True)
    assert not ps.measure(spec).from_cache and ps.engine_runs == 1


def test_stable_hash_equals_reference():
    obj = dict(a=1, b=[2.5, "x"], c=None)
    assert port_cache.stable_hash(obj) == ref_products.stable_hash(obj)


# ----------------------------------------------------- the port's own rules
def test_chips_sweep_makes_the_graph_once(tmp_path, monkeypatch):
    from repro_torch.graph import rmat
    calls = []
    made = rmat.rmat_edges

    def counting(*args, **kw):
        calls.append((args, kw))
        return made(*args, **kw)
    monkeypatch.setattr(rmat, "rmat_edges", counting)
    ps = _search(tmp_path)
    rows = ps.sweep([dataclasses.replace(SSSP, app="bfs")],
                    product_space(chips=(1, 4)))
    assert ps.engine_runs == 2 and len(rows) == 24
    assert calls == [((8,), dict(edge_factor=8, seed=1))]
    ps.measure(dataclasses.replace(SSSP, app="bfs", seed=2))
    assert len(calls) == 2                      # another dataset, made


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        assert ProductSearch(cache_dir=str(tmp_path)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ProductSearch(cache_dir=str(tmp_path))


def test_cache_dir_and_metrics_are_the_ports(tmp_path):
    from repro_torch.obs.metrics import default_registry
    assert port_search.DEFAULT_CACHE_DIR == ".repro_cache/products_torch"
    assert port_search.DEFAULT_CACHE_DIR != ref_search_mod.DEFAULT_CACHE_DIR
    reg = default_registry()
    hits = reg.counter("products.measure.cache_hits")
    misses = reg.counter("products.measure.cache_misses")
    h0, m0 = hits.value, misses.value
    ps = _search(tmp_path)
    spec = MeasureSpec(app="histo", scale=7, tiles=16)
    ps.measure(spec)
    ps.measure(spec)
    assert (hits.value - h0, misses.value - m0) == (1, 1)
