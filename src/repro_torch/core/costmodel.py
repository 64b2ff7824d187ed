"""Cost / energy / time model for DCRA packages (paper Table III + §IV-B).

A verbatim copy of ``repro.core.costmodel`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in. ``tests/test_torch_base.py``
holds the copy against the original.

Everything here is analytic and deterministic: given the traffic counters
measured by the engine (exact message/hop/crossing counts) and a package
configuration, we price time, energy and dollars exactly the way the
paper does — Murphy-model die yield on a $6,047 7nm wafer, interposer /
substrate / bonding overheads, $7.5/GB HBM, and the per-level pJ/bit and
latency constants of Table III.

The BSP time model: each superstep costs
    max(compute_time, network_time_per_level..., memory_time)
where compute is PU-ops at 1 GHz, network time is level traffic divided by
provisioned level bandwidth (link width x links at that level), and memory
time covers D$ miss traffic to HBM.  This reproduces the paper's
observable effects (Fig. 6 link-width scaling, Fig. 9/10/11 tradeoffs)
from measured traffic rather than per-cycle router simulation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Union

import numpy as np

from .netstats import MSG_BITS, SuperstepTrace, TrafficCounters
from .tilegrid import TileGrid

# --------------------------------------------------------------------------
# Table III constants
# --------------------------------------------------------------------------
SRAM_DENSITY_MIB_MM2 = 3.5
SRAM_RW_LAT_NS = 0.82
SRAM_READ_PJ_BIT = 0.18
SRAM_WRITE_PJ_BIT = 0.28
CACHE_TAG_PJ = 6.3

HBM_DENSITY_GIB_MM2 = 8.0 / 110.0
HBM_CHANNELS = 8
HBM_CHANNEL_GBS = 64.0
HBM_RW_LAT_NS = 50.0
HBM_RW_PJ_BIT = 3.7
HBM_REFRESH_PJ_BIT = 0.22
HBM_REFRESH_PERIOD_MS = 32.0

MCM_PHY_AREAL_GBIT_MM2 = 690.0
MCM_PHY_BEACH_GBIT_MM = 880.0
INTERPOSER_PHY_AREAL_GBIT_MM2 = 1070.0
INTERPOSER_PHY_BEACH_GBIT_MM = 1780.0
D2D_LINK_LAT_NS = 4.0
D2D_LINK_PJ_BIT = 0.55
NOC_WIRE_LAT_PS_MM = 50.0
NOC_WIRE_PJ_BIT_MM = 0.15
NOC_ROUTER_LAT_PS = 500.0
NOC_ROUTER_PJ_BIT = 0.10
IO_DIE_RXTX_LAT_NS = 20.0
OFF_PKG_PJ_BIT = 1.17

CLOCK_GHZ = 1.0
TILE_WIRE_MM = 0.8          # wire length of one tile-to-tile NoC hop

# Modeled D$ hit rate on touched dataset memory (paper: "high enough");
# the canonical value — benchmarks and the product search import it from
# here so the modeled rate cannot drift between figures.
D_CACHE_HIT = 0.85
HBM_LINE_BITS = 512         # D$ line fill per miss


def dcache_memory_bits(cfg: "PackageConfig", touched_bits: float,
                       hit_rate: float = D_CACHE_HIT):
    """Split touched dataset bits into (sram_bits, hbm_bits) under the
    modeled D$: hits are SRAM accesses; on HBM products each missed
    record additionally fetches a full HBM line.  The single memory
    policy every pricing site shares (Fig. 9, Fig. 10, product search).
    """
    if cfg.has_hbm:
        return (touched_bits * hit_rate,
                (1.0 - hit_rate) * touched_bits * (HBM_LINE_BITS / MSG_BITS))
    return touched_bits, 0.0

# Fabrication economics (§IV-B)
WAFER_COST_USD = 6047.0     # 300mm, 7nm
WAFER_DIAMETER_MM = 300.0
WAFER_EDGE_LOSS_MM = 4.0
SCRIBE_MM = 0.2
# Paper text says "0.07 defects per mm^2" — that must be per cm^2 (the
# isine yield calculator it cites uses defects/cm^2; 0.07/mm^2 would give
# ~1% yield on a 130mm^2 die).  We use the physically sane unit.
DEFECT_DENSITY_MM2 = 0.07 / 100.0
HBM_USD_PER_GB = 7.5
INTERPOSER_COST_FRAC_OF_DIE = 0.20   # HBM<->DCRA silicon interposer
SUBSTRATE_COST_FRAC_OF_DIE = 0.10    # organic substrate, per equal area
BONDING_COST_FRAC = 0.05

# Board-level packaging economics (the chip-partitioning axis): a chip
# product built as N separately packaged chips pays per-chip IO dies,
# board sockets/traces per chip site, a per-link SERDES+trace cost, and
# a known-good-assembly yield per bonded die (more dies in one package
# -> lower assembly yield; splitting into more chips trades that against
# extra IO dies and board links).
BOARD_LINK_USD = 3.0                 # SERDES lanes + board traces per link
BOARD_USD_PER_CHIP = 25.0            # socket/site + assembly per chip
CHIP_ASSEMBLY_YIELD_PER_DIE = 0.995  # multi-die package assembly yield/die

# PU model: simple in-order core, ~instructions per task-record / per edge.
PU_PJ_PER_OP = 2.0          # 7nm in-order RISC-V class energy/op (refs [90],[93])
PU_OPS_PER_RECORD = 8.0     # drain+compare+update per mailbox record
PU_OPS_PER_EDGE = 6.0       # stream one CSR edge and emit


# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PackageConfig:
    """Packaging-time design decisions for a DCRA chip product (Table II)."""

    name: str = "dcra-sram"
    sram_per_tile_mib: float = 1.5
    hbm_gb_per_die: float = 0.0            # 0 => SRAM-only product
    hbm_vertical: bool = False             # Fig. 5 3D option vs interposer
    intra_die_link_bits: int = 64          # NoC link width inside a die
    inter_die_link_bits: int = 64          # substrate links between dies
    inter_die_links: int = 2               # paper's option (c): 2x32-bit
    # I/O-die budget per border die.  The BSP time model serializes each
    # off-package/board link at this value in *bits per tile-clock cycle*
    # (at 1 GHz: numerically Gbit/s per link; 512 = 64 GB/s).
    off_pkg_gbs_per_die_edge: float = 512.0
    noc_count: int = 2                     # physical NoCs
    # Chip partitioning as a packaging decision (paper's multi-node
    # regime): ``chips`` is how many separately packaged chips the tile
    # grid is split into at board level (0 = unpartitioned / inherit the
    # measurement's partition), and ``board_links_y`` / ``board_links_x``
    # are the per-axis board-link provisioning — links laid between each
    # adjacent chip pair along that axis of the chip grid (the default 2
    # reproduces the distributed runtime's historical provisioning).
    chips: int = 0
    board_links_y: int = 2
    board_links_x: int = 2

    @property
    def has_hbm(self) -> bool:
        return self.hbm_gb_per_die > 0


# Paper's evaluated configurations.
DCRA_SRAM = PackageConfig(name="dcra-sram")
DCRA_HBM_HORIZ = PackageConfig(name="dcra-hbm-horiz", hbm_gb_per_die=8.0)
DCRA_HBM_VERT = PackageConfig(name="dcra-hbm-vert", hbm_gb_per_die=8.0,
                              hbm_vertical=True)
# Dalorex baseline: same chiplet integration (paper §V-C), no proxies, and
# the network option (a): single shared 32-bit crossing between dies.
DALOREX = PackageConfig(name="dalorex", intra_die_link_bits=32,
                        inter_die_link_bits=32, inter_die_links=1)

NETWORK_OPTIONS = {
    # Fig. 6 characterization: (intra_die_bits, inter_die_bits, inter_die_links)
    "a_2x32_od32": PackageConfig(name="a", intra_die_link_bits=32,
                                 inter_die_link_bits=32, inter_die_links=1),
    "b_32+64_od32": PackageConfig(name="b", intra_die_link_bits=64,
                                  inter_die_link_bits=32, inter_die_links=1),
    "c_32+64_od2x32": PackageConfig(name="c", intra_die_link_bits=64,
                                    inter_die_link_bits=32, inter_die_links=2),
    "d_32+64_od64": PackageConfig(name="d", intra_die_link_bits=64,
                                  inter_die_link_bits=64, inter_die_links=1),
}


# --------------------------------------------------------------------------
# Silicon cost (Murphy yield)
# --------------------------------------------------------------------------
def murphy_yield(area_mm2: float, d0: float = DEFECT_DENSITY_MM2) -> float:
    ad = area_mm2 * d0
    if ad == 0:
        return 1.0
    return ((1.0 - math.exp(-ad)) / ad) ** 2


def dies_per_wafer(area_mm2: float) -> float:
    r = WAFER_DIAMETER_MM / 2.0 - WAFER_EDGE_LOSS_MM
    side = math.sqrt(area_mm2) + SCRIBE_MM
    eff = side * side
    return max(1.0, math.pi * r * r / eff - math.pi * 2 * r / math.sqrt(2 * eff))


def die_cost(area_mm2: float) -> float:
    good = dies_per_wafer(area_mm2) * murphy_yield(area_mm2)
    return WAFER_COST_USD / good


def tile_area_mm2(sram_mib: float) -> float:
    """SRAM area + logic (PU+router+TSU = 1/7th of SRAM area at 1.5MiB, §V-A)."""
    sram = sram_mib / SRAM_DENSITY_MIB_MM2
    logic = (1.5 / SRAM_DENSITY_MIB_MM2) / 7.0
    return sram + logic


def dcra_die_area_mm2(cfg: PackageConfig, grid: TileGrid) -> float:
    tiles = grid.die_ny * grid.die_nx
    base = tiles * tile_area_mm2(cfg.sram_per_tile_mib)
    # PHY beachfront for inter-die links + I/O edge (adds ~4.5% for option c,
    # matching the paper's reported area growth).
    phy_frac = 0.02 + 0.0125 * cfg.inter_die_links
    if cfg.hbm_vertical:
        phy_frac += 0.05   # active-interposer pads/power for the 3D stack
    return base * (1.0 + phy_frac)


# --------------------------------------------------------------------------
@dataclasses.dataclass
class SystemReport:
    """Priced execution: produced by ``price()`` from measured counters."""

    time_s: float
    energy_j: float
    cost_usd: float
    power_w: float
    breakdown: Dict[str, float]

    @property
    def throughput_per_dollar(self) -> float:
        return 1.0 / (self.time_s * self.cost_usd)

    @property
    def efficiency_per_dollar(self) -> float:
        return 1.0 / (self.energy_j * self.cost_usd)


def system_cost_usd(cfg: PackageConfig, grid: TileGrid) -> float:
    """Dollar cost of the grid: DCRA dies + HBM + interposer/substrate/bonding.

    When ``cfg.chips >= 1`` the grid is priced as a *board-level product*
    of that many separately packaged chips: the same silicon, but each
    chip pays its own IO dies and board site, the board pays per-link
    provisioning (``board_link_provisioning``), and package assembly
    yield degrades with the number of dies bonded into one chip
    (``CHIP_ASSEMBLY_YIELD_PER_DIE``).  ``cfg.chips == 0`` keeps the
    legacy monolithic-assembly model (one IO-die pair per package, no
    board terms) so unpartitioned pricing is unchanged.
    """
    die_a = dcra_die_area_mm2(cfg, grid)
    dcra_unit = die_cost(die_a)
    dy, dx = grid.dies
    n_dies = dy * dx
    cost = n_dies * dcra_unit
    if cfg.has_hbm:
        cost += n_dies * cfg.hbm_gb_per_die * HBM_USD_PER_GB
        ip = INTERPOSER_COST_FRAC_OF_DIE * dcra_unit
        if cfg.hbm_vertical:
            ip *= 1.05  # paper: vertical costs ~5% more than horizontal
        cost += n_dies * ip
    # organic substrate (10% of equal-area die cost) + bonding 5%/die
    cost += n_dies * SUBSTRATE_COST_FRAC_OF_DIE * dcra_unit
    cost *= (1.0 + BONDING_COST_FRAC)
    if cfg.chips >= 1:
        cy, cx = chip_partition_dims(cfg, grid)
        n_chips = cy * cx
        # known-good-die assembly: every die bonded into a chip must
        # survive assembly for the chip to ship
        assembly_yield = CHIP_ASSEMBLY_YIELD_PER_DIE ** (n_dies / n_chips)
        cost /= assembly_yield
        # IO dies per chip (board-network ingress/egress) + board terms
        cost += n_chips * 2 * die_cost(30.0)
        cost += n_chips * BOARD_USD_PER_CHIP
        if n_chips > 1:
            cost += board_link_provisioning(cfg, cy, cx) * BOARD_LINK_USD
    else:
        # I/O dies: one per package edge, small 16-tile-edge die, cheap node
        cost += grid.num_packages * 2 * die_cost(30.0)
    return cost


# --------------------------------------------------------------------------
# BSP time model (shared by the engine run loops and analytic re-pricing)
# --------------------------------------------------------------------------
def link_provisioning(grid: TileGrid, pkg: PackageConfig) -> dict:
    """Per-level link counts + grid diameter for the BSP time model.

    Intra-die capacity scales with the number of physical NoCs (the
    paper's dual-NoC tile: ``noc_count=2`` is the default provisioning of
    4 links/tile, so existing configs are unchanged).
    """
    dy, dx = grid.dies
    n_die_links = (dy * (dx - 1) + dx * (dy - 1)) * 2 * pkg.inter_die_links \
        if dy * dx > 1 else 1
    py, px = grid.packages
    n_pkg_links = max(1, (py * (px - 1) + px * (py - 1)) * 2)
    return dict(intra=grid.num_tiles * 2 * pkg.noc_count, die=n_die_links,
                pkg=n_pkg_links,
                diameter=(grid.ny + grid.nx) / (2 if grid.torus else 1))


def board_link_provisioning(cfg: PackageConfig, chips_y: int,
                            chips_x: int) -> int:
    """Total board links provisioned for a (chips_y x chips_x) chip grid
    under ``cfg``'s per-axis knobs: ``board_links_x`` links between each
    horizontally adjacent chip pair, ``board_links_y`` vertically.  The
    single formula the distributed run loop and analytic re-pricing share
    — re-pricing a measured trace under its own config must reproduce the
    run loop's board serialization exactly."""
    return max(1, chips_y * (chips_x - 1) * cfg.board_links_x
               + chips_x * (chips_y - 1) * cfg.board_links_y)


def chip_partition_dims(cfg: PackageConfig, grid: TileGrid):
    """(chips_y, chips_x) of the board partition ``cfg.chips`` selects on
    ``grid`` (the most square dividing chip grid, same rule as
    ``tilegrid.partition_grid``).  Returns (1, 1) for unpartitioned
    products; raises ValueError when the count cannot partition the grid."""
    if cfg.chips <= 1:
        return 1, 1
    from .tilegrid import partition_grid
    part = partition_grid(grid, cfg.chips)
    return part.chips_y, part.chips_x


def _off_pkg_bits_per_cycle(cfg: PackageConfig) -> float:
    # The BSP model serializes off-package/board links at the IO-die
    # budget expressed in bits/cycle at the 1 GHz tile clock (default 512).
    return float(cfg.off_pkg_gbs_per_die_edge)


# BSP level names, in the order step_cycles maxes them (the exporter's
# simulated-time track order)
STEP_CYCLE_LEVELS = ("compute", "intra", "die", "pkg", "endpoint", "board",
                     "hbm")


def step_cycle_terms(cfg: PackageConfig, links: dict, *, compute_ops,
                     intra_bits, die_bits, pkg_bits, endpoint_bits=0.0,
                     hbm_bits=0.0, off_chip_bits=0.0, board_links=1,
                     n_dies=1) -> Dict[str, np.ndarray]:
    """Named per-level BSP cycle terms of superstep(s) — the
    decomposition behind :func:`step_cycles`' max.  Keys are
    :data:`STEP_CYCLE_LEVELS` (``hbm`` only on HBM products with miss
    traffic).  Works elementwise on scalars or per-superstep vectors.
    The telemetry exporter (``obs.export``) renders these as the
    per-level simulated-time tracks; ``step_cycles`` maxes them, so the
    timeline and the priced time cannot drift."""
    terms = dict(
        compute=np.asarray(compute_ops, dtype=np.float64),
        intra=(np.asarray(intra_bits, np.float64)
               / (links["intra"] * cfg.intra_die_link_bits)),
        die=(np.asarray(die_bits, np.float64)
             / (links["die"] * cfg.inter_die_link_bits)),
        pkg=(np.asarray(pkg_bits, np.float64)
             / (links["pkg"] * _off_pkg_bits_per_cycle(cfg))),
        endpoint=(np.asarray(endpoint_bits, np.float64)
                  / cfg.intra_die_link_bits),
        board=(np.asarray(off_chip_bits, np.float64)
               / (max(board_links, 1) * _off_pkg_bits_per_cycle(cfg))),
    )
    # HBM drain: miss traffic served by the package's HBM channels,
    # converted to tile-clock cycles.
    hbm = np.asarray(hbm_bits, np.float64)
    if cfg.has_hbm and np.any(hbm > 0):
        hbm_bytes_per_cycle = (n_dies * HBM_CHANNELS * HBM_CHANNEL_GBS * 1e9
                               / (CLOCK_GHZ * 1e9))
        terms["hbm"] = hbm / 8.0 / hbm_bytes_per_cycle
    return terms


def step_cycles(cfg: PackageConfig, links: dict, *, compute_ops,
                intra_bits, die_bits, pkg_bits, endpoint_bits=0.0,
                hbm_bits=0.0, off_chip_bits=0.0, board_links=1,
                n_dies=1):
    """BSP cycles of superstep(s): max over (tile compute, per-level
    network serialization, endpoint contention, HBM drain, board leg).
    Works elementwise on scalars or per-superstep numpy vectors."""
    terms = step_cycle_terms(
        cfg, links, compute_ops=compute_ops, intra_bits=intra_bits,
        die_bits=die_bits, pkg_bits=pkg_bits, endpoint_bits=endpoint_bits,
        hbm_bits=hbm_bits, off_chip_bits=off_chip_bits,
        board_links=board_links, n_dies=n_dies)
    t = terms["compute"]
    for name in STEP_CYCLE_LEVELS[1:]:
        if name in terms:
            t = np.maximum(t, terms[name])
    return t


# ``per_superstep_peak`` keys understood by :func:`price` (beyond the
# legacy whole-run {'time_s': ...} shortcut).
TRACE_KEYS = ("compute_ops", "intra_bits", "die_bits", "pkg_bits",
              "hbm_bits")


def _trace_from_peak(peak) -> tuple:
    """Normalize price()'s per_superstep_peak argument.

    Returns (trace_dict, hbm_bits_or_None) where trace_dict maps vector
    names to numpy arrays, or (None, None) when the argument is the
    legacy {'time_s': t} form (or None).
    """
    if peak is None:
        return None, None
    if isinstance(peak, SuperstepTrace):
        d = peak.to_dict()
    else:
        d = dict(peak)
        if not any(k in d for k in TRACE_KEYS):
            return None, None       # legacy {'time_s': ...}
    n = max((len(np.atleast_1d(d[k])) for k in d
             if k in SuperstepTrace._VECTOR_FIELDS + ("hbm_bits",)),
            default=0)
    if n == 0:
        return None, None

    def vec(key, default=0.0):
        v = np.atleast_1d(np.asarray(d.get(key, default), np.float64))
        return np.broadcast_to(v, (n,)) if v.shape[0] != n else v

    trace = {k: vec(k) for k in SuperstepTrace._VECTOR_FIELDS}
    trace["board_links"] = int(d.get("board_links", 1))
    trace["chips_y"] = int(d.get("chips_y", 1))
    trace["chips_x"] = int(d.get("chips_x", 1))
    trace["double_buffer"] = bool(d.get("double_buffer", False))
    trace["recovery_events"] = [dict(ev)
                                for ev in d.get("recovery_events", ())]
    hbm = vec("hbm_bits") if "hbm_bits" in d else None
    return trace, hbm


def trace_time_s(cfg: PackageConfig, grid: TileGrid, trace,
                 mem_bits_hbm: float = 0.0) -> float:
    """Recompute BSP time superstep-wise from recorded level traffic.

    ``trace`` is a :class:`~repro.core.netstats.SuperstepTrace` or a dict
    of per-superstep vectors (scalars broadcast).  This replays the run
    loop's time accounting exactly — per-step level maxima, pipeline-fill
    per active step, IO-die latency per off-chip step — but under an
    arbitrary :class:`PackageConfig`, which is what makes a measured run
    re-priceable across a package design space.
    """
    td, hbm_bits = _trace_from_peak(trace)
    if td is None:
        raise ValueError("trace has no per-superstep level-traffic keys")
    return _trace_time_s_parsed(cfg, grid, td, hbm_bits, mem_bits_hbm)


def _board_links_for(cfg: PackageConfig, td) -> int:
    """Board-link count the BSP board leg serializes over.

    A trace that recorded its chip-partition geometry is re-provisioned
    under *this* config's per-axis board-link knobs — the rescaling that
    makes board-link provisioning a packaging axis.  Traces without
    geometry (legacy dicts, monolithic runs) keep their recorded count.
    A config that names a chip count different from the measured
    partition is rejected: the off-chip traffic in the trace is a
    property of the partition it ran on, so cross-chip-count re-pricing
    needs a new measurement, not a rescale (``ProductSearch.sweep``
    re-measures per chip count).
    """
    cy, cx = int(td["chips_y"]), int(td["chips_x"])
    measured = cy * cx
    if cfg.chips >= 1 and cfg.chips != max(measured, 1):
        raise ValueError(
            f"config prices a {cfg.chips}-chip product but the trace was "
            f"measured on a {cy}x{cx} chip partition ({max(measured, 1)} "
            f"chips); re-measure at chips={cfg.chips} instead of "
            f"re-pricing across chip counts")
    if measured > 1:
        return board_link_provisioning(cfg, cy, cx)
    return int(td["board_links"])


def _parsed_terms(cfg: PackageConfig, grid: TileGrid, td, hbm_bits,
                  mem_bits_hbm: float):
    """Per-superstep level terms + accounting constants of a parsed trace
    dict — the shared front half of the full replay and the
    recovery-window replay (so a faulted run's discarded-work pricing
    cannot drift from its base replay)."""
    if hbm_bits is None:
        # Apportion the run's total HBM miss traffic across supersteps
        # proportionally to touched dataset bits.
        hbm_bits = np.zeros(len(td["compute_ops"]))
        if cfg.has_hbm and mem_bits_hbm > 0:
            touched = td["touched_bits"]
            tot = float(np.sum(touched))
            if tot > 0:
                hbm_bits = mem_bits_hbm * touched / tot
            else:
                hbm_bits = np.full_like(touched,
                                        mem_bits_hbm / max(len(touched), 1))
    links = link_provisioning(grid, cfg)
    dy, dx = grid.dies
    blinks = _board_links_for(cfg, td)
    terms = step_cycle_terms(
        cfg, links, compute_ops=td["compute_ops"],
        intra_bits=td["intra_bits"], die_bits=td["die_bits"],
        pkg_bits=td["pkg_bits"], endpoint_bits=td["endpoint_bits"],
        hbm_bits=hbm_bits, off_chip_bits=td["off_chip_bits"],
        board_links=blinks, n_dies=dy * dx)
    io_lat = 2.0 * IO_DIE_RXTX_LAT_NS * CLOCK_GHZ
    fill = links["diameter"] * 0.5
    return terms, io_lat, fill, blinks


def _window_cycles(td, terms, io_lat: float, fill: float,
                   lo: int, hi: int) -> float:
    """Replay cycles of supersteps ``[lo, hi)`` only — the discarded-work
    window of a rollback event.  Uses the exact per-step rule of the full
    replay below (sync or double-buffered), restricted to the window; in
    double-buffer mode the window's first charged step pays the exchange
    of the last charged step *before* the window, which is precisely the
    ``prev_exch`` the run loop restores from its checkpoint snapshot."""
    if td.get("double_buffer"):
        core = terms["compute"]
        for name in STEP_CYCLE_LEVELS[1:]:
            if name != "board" and name in terms:
                core = np.maximum(core, terms[name])
        board = terms["board"]
        exch = board + io_lat * (td["off_chip_msgs"] > 0)
        charged = (core > 0) | (board > 0) | (td["pending"] > 0)
        ce, ee = core[charged], exch[charged]
        prev = np.concatenate(([0.0], ee[:-1]))
        pos = np.flatnonzero(charged)
        sel = (pos >= lo) & (pos < hi)
        return (float(np.sum(np.maximum(ce, prev)[sel]))
                + float(np.sum(sel)) * fill)
    t = terms["compute"]
    for name in STEP_CYCLE_LEVELS[1:]:
        if name in terms:
            t = np.maximum(t, terms[name])
    charged = (t > 0) | (td["pending"] > 0)
    idx = np.arange(t.shape[0])
    w = charged & (idx >= lo) & (idx < hi)
    cycles = float(np.sum(t[w]))
    cycles += float(np.sum(w)) * fill
    cycles += float(np.sum(w & (td["off_chip_msgs"] > 0))) * io_lat
    return cycles


def checkpoint_leg_cycles(cfg: PackageConfig, bits: float,
                          board_links: int) -> float:
    """Cycles to stream a ``bits``-sized checkpoint image over the
    provisioned board links (checkpoint write, restore and
    re-shard-onto-survivors all move the same image; the serialization
    matches the BSP board leg).  The single formula the distributed run
    loop's fault-tolerance accounting and the trace replay share — so
    re-pricing a faulted run under its own config reproduces its
    measured time exactly."""
    return float(bits) / (max(int(board_links), 1)
                          * _off_pkg_bits_per_cycle(cfg))


def recovery_waste_cycles(cfg: PackageConfig, grid: TileGrid, trace,
                          lo: int, hi: int) -> float:
    """Cycles the run loop spent executing supersteps ``[lo, hi)`` — the
    work a rollback to checkpoint ``lo`` after failing at ``hi``
    discards.  The run loop calls this at rollback time (its trace then
    holds rows ``[0, hi)``); the replay recomputes it from the final
    trace, whose ``[lo, hi)`` rows are bit-identical because the resumed
    run re-records them — both sides therefore add the exact same
    float."""
    td, hbm_bits = _trace_from_peak(trace)
    if td is None:
        return 0.0
    terms, io_lat, fill, _ = _parsed_terms(cfg, grid, td, hbm_bits, 0.0)
    return _window_cycles(td, terms, io_lat, fill, int(lo), int(hi))


def _recovery_overhead_cycles(cfg: PackageConfig, td, terms, io_lat: float,
                              fill: float, blinks: int) -> float:
    """Replay the fault-tolerance event log: checkpoint/restore board
    legs plus each rollback's discarded-work window, accumulated in
    execution order (the run loop adds the identical floats in the
    identical order into its separate overhead accumulator)."""
    oh = 0.0
    for ev in td.get("recovery_events") or ():
        kind = ev.get("kind")
        if kind in ("checkpoint", "reshard"):
            oh += checkpoint_leg_cycles(cfg, float(ev.get("bits", 0.0)),
                                        blinks)
        elif kind == "rollback":
            oh += _window_cycles(td, terms, io_lat, fill,
                                 int(ev["from_step"]), int(ev["at_step"]))
    return oh


def _trace_time_s_parsed(cfg: PackageConfig, grid: TileGrid, td, hbm_bits,
                         mem_bits_hbm: float) -> float:
    terms, io_lat, fill, blinks = _parsed_terms(cfg, grid, td, hbm_bits,
                                                mem_bits_hbm)
    if td.get("double_buffer"):
        # Overlap-aware accumulation (double-buffered boundary exchange):
        # superstep k's board leg + IO-die latency overlap superstep
        # k+1's chip-local BSP work, so each charged step pays
        # max(core_k, exchange_{k-1}) and the final exchange drains in
        # the open.  Mirrors the run loop's double_buffer accounting —
        # a trace with no board traffic degenerates to the sync rule.
        core = terms["compute"]
        for name in STEP_CYCLE_LEVELS[1:]:
            if name != "board" and name in terms:
                core = np.maximum(core, terms[name])
        board = terms["board"]
        exch = board + io_lat * (td["off_chip_msgs"] > 0)
        charged = (core > 0) | (board > 0) | (td["pending"] > 0)
        ce, ee = core[charged], exch[charged]
        cycles = float(np.sum(np.maximum(
            ce, np.concatenate(([0.0], ee[:-1])))))
        cycles += ce.shape[0] * fill
        cycles += float(ee[-1]) if ee.shape[0] else 0.0
    else:
        t = terms["compute"]
        for name in STEP_CYCLE_LEVELS[1:]:
            if name in terms:
                t = np.maximum(t, terms[name])
        charged = (t > 0) | (td["pending"] > 0)
        cycles = float(np.sum(t[charged]))
        cycles += float(np.sum(charged)) * fill
        io_steps = charged & (td["off_chip_msgs"] > 0)
        cycles += float(np.sum(io_steps)) * io_lat
    # fault-tolerance overhead: checkpoint legs, rollback waste, re-shard
    # legs — the run loop keeps these in a separate accumulator added
    # once at the end, so one final addition here matches it bit-exactly
    cycles += _recovery_overhead_cycles(cfg, td, terms, io_lat, fill,
                                        blinks)
    return cycles / (CLOCK_GHZ * 1e9)


def price(cfg: PackageConfig, grid: TileGrid, counters: TrafficCounters,
          mem_bits_sram: float = 0.0, mem_bits_hbm: float = 0.0,
          per_superstep_peak: Union[SuperstepTrace, Dict[str, float],
                                    None] = None) -> SystemReport:
    """Convert measured traffic into (time, energy, $) under a package config.

    Args:
      counters: whole-run accumulated counters from the engine.
      mem_bits_sram / mem_bits_hbm: dataset bits read+written locally.
      per_superstep_peak: optional per-superstep level traffic — a
        :class:`~repro.core.netstats.SuperstepTrace` (what
        ``RunResult.trace`` carries) or a dict with vectors/scalars for
        {'compute_ops', 'intra_bits', 'die_bits', 'pkg_bits',
        'hbm_bits'} (plus the optional trace extras: 'endpoint_bits',
        'off_chip_bits', 'off_chip_msgs', 'touched_bits', 'pending',
        'board_links').  When provided, time is recomputed superstep-wise
        under *this* config — the BSP max per superstep with this
        config's link widths/counts, NoC count and HBM channels — so the
        same measured run can be re-priced across package configs.  When
        'hbm_bits' is absent it is derived from ``mem_bits_hbm``
        apportioned over 'touched_bits'.  The legacy ``{'time_s': t}``
        form is still accepted and uses ``t`` unchanged.
    """
    bits = MSG_BITS
    # ------------------------------------------------------------- energy
    e_wire = (counters.intra_die_hops * bits
              * (NOC_WIRE_PJ_BIT_MM * TILE_WIRE_MM + NOC_ROUTER_PJ_BIT))
    e_d2d = counters.inter_die_crossings * bits * (D2D_LINK_PJ_BIT + NOC_ROUTER_PJ_BIT)
    e_pkg = counters.inter_pkg_crossings * bits * OFF_PKG_PJ_BIT
    # board-level legs of the distributed runtime: each chip-grid hop is
    # one IO-die SERDES Tx + board trace + Rx (charged like an off-package
    # link crossing; the IO-die latency enters the BSP time model instead)
    e_off_chip = counters.off_chip_hop_msgs * bits * OFF_PKG_PJ_BIT
    if cfg.has_hbm and cfg.hbm_vertical:
        # 3D stacking saves the interposer wire energy on HBM accesses.
        hbm_pj = HBM_RW_PJ_BIT * 0.72
    else:
        hbm_pj = HBM_RW_PJ_BIT
    e_sram = mem_bits_sram * (SRAM_READ_PJ_BIT + SRAM_WRITE_PJ_BIT) / 2.0
    e_hbm = mem_bits_hbm * hbm_pj
    ops = (counters.records_consumed * PU_OPS_PER_RECORD
           + counters.edges_processed * PU_OPS_PER_EDGE)
    e_pu = ops * PU_PJ_PER_OP
    # P$ tag checks — including the combine events at intermediate proxies
    # of the cascade reduction tree (each merge is one tag check + combine)
    e_tags = (counters.filtered_at_proxy + counters.coalesced_at_proxy
              + counters.cascade_combined) * CACHE_TAG_PJ
    energy_pj = (e_wire + e_d2d + e_pkg + e_off_chip + e_sram + e_hbm
                 + e_pu + e_tags)

    # --------------------------------------------------------------- time
    trace_dict, hbm_vec = _trace_from_peak(per_superstep_peak)
    time_s = None
    if trace_dict is not None:
        # the documented contract: recompute the BSP time superstep-wise
        # from recorded level traffic under *this* package config
        time_s = _trace_time_s_parsed(cfg, grid, trace_dict, hbm_vec,
                                      mem_bits_hbm)
    elif (per_superstep_peak is not None
          and not isinstance(per_superstep_peak, SuperstepTrace)
          and "time_s" in per_superstep_peak):
        time_s = per_superstep_peak["time_s"]
    if time_s is None:
        # fall back: aggregate roofline over the whole run (also the
        # path for an empty trace — a run that recorded no supersteps)
        n_tiles = grid.num_tiles
        compute_s = ops / n_tiles / (CLOCK_GHZ * 1e9)
        dy, dx = grid.dies
        intra_bw = cfg.intra_die_link_bits * CLOCK_GHZ * 1e9  # bit/s per link
        # bisection-style serialization: level traffic / (links at level * bw)
        intra_links = n_tiles * 2
        die_links = (dy * dx) * 2 * cfg.inter_die_links
        die_bw = cfg.inter_die_link_bits * CLOCK_GHZ * 1e9
        pkg_links = max(1, grid.num_packages) * 4
        pkg_bw = _off_pkg_bits_per_cycle(cfg) * CLOCK_GHZ * 1e9  # bit/s
        t_intra = counters.intra_die_hops * bits / (intra_links * intra_bw)
        t_die = counters.inter_die_crossings * bits / (max(die_links, 1) * die_bw)
        t_pkg = counters.inter_pkg_crossings * bits / (max(pkg_links, 1) * pkg_bw)
        t_hbm = 0.0
        if cfg.has_hbm and mem_bits_hbm:
            t_hbm = (mem_bits_hbm / 8.0) / (dy * dx * HBM_CHANNELS * HBM_CHANNEL_GBS * 1e9)
        time_s = max(compute_s, t_intra, t_die, t_pkg, t_hbm)

    # refresh energy for HBM over the runtime
    if cfg.has_hbm:
        dy, dx = grid.dies
        stored_bits = dy * dx * cfg.hbm_gb_per_die * 8e9
        energy_pj += stored_bits * HBM_REFRESH_PJ_BIT * (time_s * 1e3 / HBM_REFRESH_PERIOD_MS)

    energy_j = energy_pj * 1e-12
    cost = system_cost_usd(cfg, grid)
    return SystemReport(
        time_s=time_s, energy_j=energy_j, cost_usd=cost,
        power_w=energy_j / max(time_s, 1e-12),
        breakdown=dict(
            wire_j=(e_wire + e_d2d + e_pkg) * 1e-12,
            off_chip_j=e_off_chip * 1e-12,
            mem_j=(e_sram + e_hbm) * 1e-12,
            pu_j=e_pu * 1e-12,
            tags_j=e_tags * 1e-12,
            ops=ops,
        ),
    )
