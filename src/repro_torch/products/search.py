"""Package-time product search: measure once, price many (paper §IV).

The port of ``repro.products.search``, measuring through the port's
engine: on the card by default (every measurement runs the engine's
``relax``, ``segment_combine`` and ``deliver_fused`` kernels), on the CPU
only when ``ProductSearch(device="cpu")`` asks for it.  Its cache keys
name the package (``MeasureSpec.key``) and its default directory is its
own, so a reference entry is never a hit for the port; the entries'
payloads keep the reference's layout.  A search keeps the RMAT graphs it
makes for its lifetime, so a sweep over chip counts makes each dataset
once; no result depends on it.

The engine run is the expensive part (a 16384-tile run takes minutes);
pricing is purely analytic over the measured traffic.  ``ProductSearch``
therefore splits the design-space exploration loop into:

  1. **measure** — run each (app, dataset, cascade level/grouping)
     combination through the engine exactly once and cache the counter
     vectors (whole-run :class:`TrafficCounters` + the per-superstep
     :class:`SuperstepTrace`) as JSON on disk, keyed by a stable hash of
     the spec;
  2. **sweep** — re-price the cached traffic across an arbitrary set of
     :class:`PackageConfig` products (``costmodel.price`` recomputes the
     BSP time superstep-wise under each config's link widths/counts, NoC
     count and HBM channels);
  3. **select** — Pareto-filter the swept rows per target metric pair
     and pick the best product per objective (time-to-solution, energy,
     $, throughput/$, efficiency/$) — the paper's claim that one silicon
     design yields differently-optimal chip products post-silicon.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.costmodel import (PackageConfig, SystemReport,
                              dcache_memory_bits, price)
from ..core.netstats import MSG_BITS, SuperstepTrace, TrafficCounters
from ..core.tilegrid import TileGrid, partition_grid, square_grid
from ..device import resolve
from ..graph.csr import CSR
from .cache import CounterCache, stable_hash

DEFAULT_CACHE_DIR = ".repro_cache/products_torch"

# Objectives a product can be selected for: (row key, maximize?)
OBJECTIVES: Dict[str, Tuple[str, bool]] = {
    "time": ("time_s", False),
    "energy": ("energy_j", False),
    "cost": ("cost_usd", False),
    "throughput_per_dollar": ("thr_per_usd", True),
    "efficiency_per_dollar": ("eff_per_usd", True),
}


@dataclasses.dataclass(frozen=True)
class MeasureSpec:
    """One engine measurement: app + dataset + grid + cascade policy.

    Everything that changes the measured traffic belongs here (it is the
    cache key); everything that only changes pricing belongs in the
    :class:`PackageConfig` sweep instead.
    """

    app: str                  # bfs | sssp | wcc | pagerank | spmv | histo
    scale: int                # RMAT scale (log2 vertices) / log2 elements
    tiles: int                # square tile grid size
    edge_factor: int = 8
    seed: int = 1
    oq_cap: int = 32
    slots: int = 512
    region_div: int = 4
    cascade_levels: int = 0
    cascade_group: int = 2
    selective: bool = True
    chips: int = 0            # >1: measure on the distributed runtime
    epochs: int = 3           # pagerank only

    def key(self) -> str:
        # the package's name in the key: the reference hashes its specs
        # without it, so the two packages' entries never alias
        return stable_hash(dict(dataclasses.asdict(self), v=1,
                                impl="repro_torch"))

    @property
    def label(self) -> str:
        casc = (f"/casc{self.cascade_levels}x{self.cascade_group}"
                if self.cascade_levels else "")
        chips = f"/{self.chips}chips" if self.chips > 1 else ""
        return f"{self.app}/s{self.scale}/{self.tiles}t{casc}{chips}"


@dataclasses.dataclass
class Measurement:
    """Cached engine output: everything pricing needs, nothing more."""

    spec: MeasureSpec
    counters: TrafficCounters
    trace: SuperstepTrace
    touched_bits: float       # dataset bits touched (drives the D$ model)
    dataset_bits: float       # resident dataset footprint
    teps_edges: float
    time_s: float             # measured under the spec's own run config
    supersteps: int
    from_cache: bool = False

    @property
    def grid(self) -> TileGrid:
        return square_grid(self.spec.tiles)

    def to_payload(self) -> Dict:
        return dict(spec=dataclasses.asdict(self.spec),
                    counters=self.counters.as_dict(),
                    trace=self.trace.to_dict(),
                    touched_bits=self.touched_bits,
                    dataset_bits=self.dataset_bits,
                    teps_edges=self.teps_edges,
                    time_s=self.time_s, supersteps=self.supersteps)

    @classmethod
    def from_payload(cls, spec: MeasureSpec, payload: Dict) -> "Measurement":
        c = TrafficCounters()
        for k, v in payload["counters"].items():
            if hasattr(c, k):
                setattr(c, k, v)
        return cls(spec=spec, counters=c,
                   trace=SuperstepTrace.from_dict(payload["trace"]),
                   touched_bits=float(payload["touched_bits"]),
                   dataset_bits=float(payload["dataset_bits"]),
                   teps_edges=float(payload.get("teps_edges", 0.0)),
                   time_s=float(payload["time_s"]),
                   supersteps=int(payload["supersteps"]),
                   from_cache=True)


class ProductSearch:
    """Measure-once / price-many sweep over the package design space.

    ``device=None`` measures on the CUDA card and raises without one
    (``device.resolve``); ``device="cpu"`` runs the kernels' plain
    versions.  The device is resolved once, here.
    """

    def __init__(self, cache_dir: str = DEFAULT_CACHE_DIR, device=None):
        self.cache = CounterCache(cache_dir)
        self.device = resolve(device)
        self.engine_runs = 0     # measurements that actually ran the engine
        self._graphs: Dict[Tuple[int, int, int], CSR] = {}

    def _graph(self, spec: MeasureSpec) -> CSR:
        """The spec's RMAT graph, made once per (scale, edge_factor, seed)
        in this search's lifetime (the same graph a fresh one would be)."""
        from ..graph import rmat
        key = (spec.scale, spec.edge_factor, spec.seed)
        if key not in self._graphs:
            self._graphs[key] = rmat.rmat_edges(
                spec.scale, edge_factor=spec.edge_factor, seed=spec.seed)
        return self._graphs[key]

    # ------------------------------------------------------------- measure
    @staticmethod
    def validate(spec: MeasureSpec) -> None:
        """Reject unmeasurable specs up front with actionable errors —
        before dataset generation, and instead of silently passing a
        ``chips`` the app layer cannot honour."""
        from ..graph import apps
        if spec.app not in apps.APPS:
            raise ValueError(
                f"unknown app {spec.app!r}; measurable apps: "
                f"{sorted(apps.APPS)}")
        if spec.chips > 1:
            if spec.app not in apps.DISTRIBUTED_APPS:
                raise ValueError(
                    f"app {spec.app!r} does not support distributed "
                    f"measurement (chips={spec.chips}); distributed apps: "
                    f"{sorted(apps.DISTRIBUTED_APPS)}")
            try:
                partition_grid(square_grid(spec.tiles), spec.chips)
            except ValueError as e:
                raise ValueError(
                    f"spec {spec.label!r}: chips={spec.chips} cannot "
                    f"block-partition the {spec.tiles}-tile grid ({e})"
                ) from None

    def measure(self, spec: MeasureSpec,
                run_chunk: Optional[int] = None) -> Measurement:
        """Cached engine measurement of ``spec``.

        ``run_chunk`` only selects the run loop's supersteps-per-dispatch
        (chunked execution is bit-identical to per-step — see
        tests/test_chunked.py), so it is *not* part of the cache key.
        """
        self.validate(spec)
        from ..obs.metrics import default_registry
        reg = default_registry()
        key = spec.key()
        payload = self.cache.get(key)
        if payload is not None:
            reg.counter("products.measure.cache_hits").inc()
            return Measurement.from_payload(spec, payload)
        reg.counter("products.measure.cache_misses").inc()
        m = self._run_engine(spec, run_chunk=run_chunk)
        self.cache.put(key, m.to_payload())
        return m

    def _run_engine(self, spec: MeasureSpec,
                    run_chunk: Optional[int] = None) -> Measurement:
        from ..graph import apps

        self.engine_runs += 1
        grid = square_grid(spec.tiles)
        proxy = apps.table2_proxy(
            grid, spec.app, slots=spec.slots, region_div=spec.region_div,
            cascade_levels=spec.cascade_levels,
            cascade_group=spec.cascade_group, selective=spec.selective)
        kw = dict(proxy=proxy, oq_cap=spec.oq_cap, device=self.device)
        if spec.chips > 1:
            kw["chips"] = spec.chips
        if run_chunk is not None:
            kw["run_chunk"] = run_chunk
        if spec.app == "histo":
            rng = np.random.default_rng(spec.seed)
            n = spec.edge_factor << spec.scale
            bins = max(grid.num_tiles, 1 << spec.scale >> 3)
            values = rng.integers(0, bins, size=n, dtype=np.int32)
            r = apps.histogram(values, bins, grid, **kw)
            dataset_bits = float(values.nbytes * 8)
        else:
            g = self._graph(spec)
            dataset_bits = float(g.footprint_bytes() * 8)
            if spec.app in ("bfs", "sssp"):
                root = int(np.argmax(g.out_degree()))
                r = getattr(apps, spec.app)(g, root, grid, **kw)
            elif spec.app == "wcc":
                r = apps.wcc(g, grid, **kw)
            elif spec.app == "pagerank":
                r = apps.pagerank(g, grid, epochs=spec.epochs, **kw)
            elif spec.app == "spmv":
                rng = np.random.default_rng(spec.seed)
                x = rng.random(g.n_cols).astype(np.float32)
                r = apps.spmv(g, x, grid, **kw)
            else:
                raise ValueError(f"unknown app {spec.app!r}")
        # normalize device scalars (np.float32) to Python floats so a
        # live measurement prices bit-identically to its cached JSON form
        c = TrafficCounters()
        for k, v in r.run.counters.as_dict().items():
            setattr(c, k, v)
        touched = (c.edges_processed + c.records_consumed) * MSG_BITS
        return Measurement(spec=spec, counters=c, trace=r.run.trace,
                           touched_bits=float(touched),
                           dataset_bits=dataset_bits,
                           teps_edges=float(r.teps_edges),
                           time_s=float(r.run.time_s),
                           supersteps=r.run.supersteps)

    # --------------------------------------------------------------- price
    def price_product(self, m: Measurement,
                      cfg: PackageConfig) -> SystemReport:
        """Analytic re-pricing of one measurement under one product,
        using the shared D$ memory policy (``dcache_memory_bits``).

        A config that names a chip count must be priced on a measurement
        taken at that chip count — the trace's off-chip traffic is a
        property of the measured partition (``sweep`` re-measures per
        chip count; ``price`` enforces the same rule on the trace).
        """
        if cfg.chips >= 1 and cfg.chips != max(m.spec.chips, 1):
            raise ValueError(
                f"product {cfg.name!r} is a {cfg.chips}-chip packaging "
                f"but measurement {m.spec.label!r} ran on "
                f"{max(m.spec.chips, 1)} chip(s); measure at "
                f"chips={cfg.chips} (sweep() does this per chip count)")
        sram, hbm = dcache_memory_bits(cfg, m.touched_bits)
        return price(cfg, m.grid, m.counters, mem_bits_sram=sram,
                     mem_bits_hbm=hbm, per_superstep_peak=m.trace)

    # --------------------------------------------------------------- sweep
    @staticmethod
    def spec_for_product(spec: MeasureSpec,
                         cfg: PackageConfig) -> MeasureSpec:
        """The measurement a product config must be priced on: the spec
        re-based to the config's chip count (chips<=1 products price the
        monolithic measurement; chips=0 configs inherit the spec's own
        partition)."""
        if cfg.chips == 0:
            return spec
        chips = cfg.chips if cfg.chips > 1 else 0
        if chips == spec.chips:
            return spec
        return dataclasses.replace(spec, chips=chips)

    def sweep(self, specs: Iterable[MeasureSpec],
              configs: Sequence[PackageConfig]) -> List[Dict]:
        """Measure each spec once *per chip count*, price it under every
        config of that chip count.

        Configs with ``chips >= 1`` re-base the spec onto the distributed
        runtime at that partition (measured once and cached like any
        other spec); all same-chip-count configs re-price the one cached
        board-level trace analytically.  Returns flat rows (one per spec
        x config) carrying the metric columns the paper's Fig. 9/10
        curves plot.
        """
        rows = []
        for spec in specs:
            measured: Dict[str, Measurement] = {}
            for cfg in configs:
                s = self.spec_for_product(spec, cfg)
                m = measured.get(s.key())
                if m is None:
                    m = measured[s.key()] = self.measure(s)
                rep = self.price_product(m, cfg)
                rows.append(product_row(m, cfg, rep))
        return rows


def product_row(m: Measurement, cfg: PackageConfig,
                rep: SystemReport) -> Dict:
    gteps = m.teps_edges / max(rep.time_s, 1e-12) / 1e9
    return dict(
        measurement=m.spec.label, product=cfg.name,
        app=m.spec.app, tiles=m.spec.tiles,
        chips=max(m.spec.chips, 1),
        cascade_levels=m.spec.cascade_levels,
        cascade_group=m.spec.cascade_group,
        time_s=rep.time_s, energy_j=rep.energy_j, cost_usd=rep.cost_usd,
        power_w=rep.power_w, gteps=gteps,
        thr_per_usd=rep.throughput_per_dollar,
        eff_per_usd=rep.efficiency_per_dollar,
        cascade_combined=m.counters.cascade_combined,
        cross_region_msgs=m.counters.cross_region_msgs,
        from_cache=m.from_cache,
    )


# --------------------------------------------------------------------------
# Pareto selection
# --------------------------------------------------------------------------
def _objective_value(row: Dict, metric: str) -> float:
    key, maximize = OBJECTIVES[metric]
    v = float(row[key])
    return v if maximize else -v


def pareto_front(rows: Sequence[Dict],
                 metrics: Tuple[str, str] = ("throughput_per_dollar",
                                             "efficiency_per_dollar"),
                 ) -> List[Dict]:
    """Non-dominated rows on a metric pair (both oriented to maximize).

    A row is dominated when another row is >= on both objectives and
    strictly > on at least one.
    """
    vals = [(_objective_value(r, metrics[0]),
             _objective_value(r, metrics[1])) for r in rows]
    front = []
    for i, (a0, a1) in enumerate(vals):
        dominated = any(
            (b0 >= a0 and b1 >= a1) and (b0 > a0 or b1 > a1)
            for j, (b0, b1) in enumerate(vals) if j != i)
        if not dominated:
            front.append(rows[i])
    return front


def select_products(rows: Sequence[Dict],
                    objectives: Optional[Sequence[str]] = None,
                    ) -> Dict[str, Dict]:
    """Best product per objective over the given rows.

    Pass one measurement's rows to pick its per-objective winners — the
    package-time reconfiguration story in one table: the same measured
    run selects *different* products depending on what the customer
    optimizes for.
    """
    objectives = list(objectives or OBJECTIVES)
    out = {}
    for metric in objectives:
        out[metric] = max(rows, key=lambda r: _objective_value(r, metric))
    return out
