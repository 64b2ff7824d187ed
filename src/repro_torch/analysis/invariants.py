"""Counter-conservation checker + the runtime sanitizer's error type.

A copy of ``repro.analysis.invariants`` (numpy only): the port imports nothing of
the JAX package, whose package ``__init__`` pulls JAX in.
``tests/test_torch_obs.py`` holds the copy against the original.

Every message the engine emits is conserved: an emitted edge record is
either merged with a sibling (batch coalescing, P$ combine, cascade-tree
merge), absorbed (P$ filter), or delivered to its owner — and every
network hop it takes decomposes into exactly one level (intra-die,
inter-die, off-package).  These are the properties that make the traffic
counters a *measurement* rather than an estimate, and the measured
:class:`~repro.core.netstats.SuperstepTrace` re-priceable
(measure-once / price-many).  The checks:

``counter-negative`` / ``counter-nonint``
    Every :class:`TrafficCounters` field is a count (or a hop-weighted
    sum of counts): nonnegative and integer-valued.  f32 device sums
    keep integer values exactly below 2**24 and round to *integers*
    above it, so a fractional counter is a model bug, not rounding.

``hop-decomposition``
    ``hop_msgs == intra_die_hops + inter_die_crossings +
    inter_pkg_crossings`` — every on-silicon hop is charged at exactly
    one network level (the board-level legs are counted separately in
    ``off_chip_hop_msgs``).

``owner-conservation``
    Write-through / no-proxy: ``owner_msgs == edges_processed -
    filtered_at_proxy - coalesced_at_proxy - cascade_combined`` exactly
    (batch leaders = emitted - coalesced; survivors = leaders -
    filtered; tree merges subtract one message each).  Write-back P$
    absorbs improving hits without a counter, so only ``<=`` holds
    there (with equality impossible to restore without counting
    ``upd_hit`` — which is P$-internal, not traffic).

``consumed-bound``
    ``records_consumed <= owner_msgs + seeds``: mailbox slots combine on
    arrival, so each drain needs at least one owner-leg delivery (or an
    initial seed) behind it.

``owner-subset``
    ``owner_msgs <= messages`` and ``owner_hop_msgs <= hop_msgs``: the
    owner-bound leg is a subset of all charged legs.

``trace-*``
    The per-superstep trace: equal-length vectors, nonnegative entries,
    wire-bit vectors quantized to ``MSG_BITS``, and a drained final
    superstep (``pending[-1] == 0`` — the run loop only stops early on
    an explicit budget).

``monotone-frontier``
    Min-combine apps only relax: no value may increase between
    snapshots (:func:`check_values`).  ``EngineConfig.sanitize=True``
    additionally proves this per superstep on device.

``reprice-ratio``
    ``costmodel.trace_time_s`` under the run's own
    :class:`PackageConfig` must reproduce ``RunResult.time_s`` (ratio
    == 1 up to f64 summation order) — the measure-once / price-many
    contract.

:func:`check_run` composes all of the above on a
:class:`~repro.core.engine.RunResult`; ``assert_clean`` turns findings
into a :class:`SanitizerError` (what ``EngineConfig.sanitize=True``
raises).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from ..core import costmodel
from ..core.netstats import MSG_BITS, SuperstepTrace, TrafficCounters
from .findings import Finding, summarize

# f32 device accumulation: integer counts stay exact below 2**24 and
# integral above; equality checks allow relative f32 slack.
_RTOL = 1e-6


class SanitizerError(AssertionError):
    """A conservation/sanity invariant failed at runtime."""


def _isint(v: float) -> bool:
    return math.isfinite(v) and abs(v - round(v)) <= _RTOL * max(1.0, abs(v))


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= _RTOL * max(1.0, abs(a), abs(b))


# ------------------------------------------------------------------ counters
def check_counters(c: TrafficCounters, *, where: str,
                   write_back: bool = False,
                   seeds: int = 0) -> List[Finding]:
    """Conservation + sanity of a run's accumulated traffic counters."""
    findings = []

    def bad(rule, msg):
        findings.append(Finding("invariants", rule, where, msg))

    for f in dataclasses.fields(c):
        v = float(getattr(c, f.name))
        if not math.isfinite(v) or v < 0:
            bad("counter-negative",
                f"counter '{f.name}' = {v!r}: counts cannot go negative "
                f"or non-finite")
        elif not _isint(v):
            bad("counter-nonint",
                f"counter '{f.name}' = {v!r} is fractional: every field "
                f"is a message/hop count")

    lvl = c.intra_die_hops + c.inter_die_crossings + c.inter_pkg_crossings
    if not _close(c.hop_msgs, lvl):
        bad("hop-decomposition",
            f"hop_msgs={c.hop_msgs} != intra+die+pkg={lvl}: some hop was "
            f"charged at zero or two network levels")

    rhs = (c.edges_processed - c.filtered_at_proxy - c.coalesced_at_proxy
           - c.cascade_combined)
    if write_back:
        # improving P$ hits absorb records without a counter: only <=
        if c.owner_msgs > rhs * (1 + _RTOL) + _RTOL:
            bad("owner-conservation",
                f"owner_msgs={c.owner_msgs} > emitted-merged-filtered="
                f"{rhs}: the owner leg delivered records that were never "
                f"emitted")
    elif not _close(c.owner_msgs, rhs):
        bad("owner-conservation",
            f"owner_msgs={c.owner_msgs} != edges_processed - filtered - "
            f"coalesced - cascade_combined = {rhs}: an emitted record "
            f"was neither merged, filtered nor delivered")

    if c.records_consumed > c.owner_msgs + seeds + _RTOL * c.owner_msgs:
        bad("consumed-bound",
            f"records_consumed={c.records_consumed} > owner_msgs+seeds="
            f"{c.owner_msgs + seeds}: mailbox drains outnumber "
            f"deliveries")

    if c.owner_msgs > c.messages * (1 + _RTOL):
        bad("owner-subset",
            f"owner_msgs={c.owner_msgs} > messages={c.messages}")
    if c.owner_hop_msgs > c.hop_msgs * (1 + _RTOL):
        bad("owner-subset",
            f"owner_hop_msgs={c.owner_hop_msgs} > hop_msgs={c.hop_msgs}")
    return findings


# --------------------------------------------------------------------- trace
def check_trace(trace: SuperstepTrace, *, where: str,
                drained: bool = True) -> List[Finding]:
    """Structural sanity of the per-superstep level-traffic record."""
    findings = []

    def bad(rule, msg):
        findings.append(Finding("invariants", rule, where, msg))

    n = len(trace)
    for f in trace._VECTOR_FIELDS:
        vec = np.asarray(getattr(trace, f), dtype=np.float64)
        if vec.shape[0] != n:
            bad("trace-length",
                f"trace field '{f}' has {vec.shape[0]} entries but "
                f"compute_ops has {n}: a superstep was dropped from one "
                f"vector")
            continue
        if vec.size and (not np.all(np.isfinite(vec)) or vec.min() < 0):
            bad("trace-negative",
                f"trace field '{f}' has negative/non-finite entries "
                f"(min={vec.min() if np.all(np.isfinite(vec)) else 'nan'})")
        if f.endswith("_bits") and f != "touched_bits" and vec.size:
            q = vec / MSG_BITS
            if not np.allclose(q, np.round(q), rtol=_RTOL, atol=_RTOL):
                bad("trace-bit-quantum",
                    f"trace field '{f}' is not a multiple of MSG_BITS="
                    f"{MSG_BITS}: level traffic is charged per message")
    if drained and n and trace.pending[-1] != 0:
        bad("trace-not-drained",
            f"final superstep left pending={trace.pending[-1]}: the run "
            f"stopped before draining (budget hit without being declared)")
    return findings


# -------------------------------------------------------------------- values
def check_values(before, after, combine: str, *, where: str) -> List[Finding]:
    """Monotone frontier for min-combine apps: relaxation never regresses."""
    if combine != "min":
        return []
    b = np.asarray(before, dtype=np.float64)
    a = np.asarray(after, dtype=np.float64)
    worse = int(np.sum(a > b))
    if worse:
        return [Finding(
            "invariants", "monotone-frontier", where,
            f"{worse} value(s) increased across the run of a min-combine "
            f"app: relaxation must be monotone")]
    return []


# ------------------------------------------------------------------- reprice
def check_reprice(result, pkg, grid, *, where: str,
                  mem_bits_hbm: float = 0.0,
                  rtol: float = 1e-9) -> List[Finding]:
    """Measure-once / price-many: re-pricing the measured trace under the
    run's own package must reproduce the run's BSP time.  ``rtol`` covers
    f64 summation-order drift only (np.sum pairwise vs the run loop's
    sequential accumulation), not model slack."""
    trace = getattr(result, "trace", None)
    if trace is None or len(trace) == 0:
        return []
    repriced = costmodel.trace_time_s(pkg, grid, trace,
                                      mem_bits_hbm=mem_bits_hbm)
    t = float(result.time_s)
    if t == 0.0 and repriced == 0.0:
        return []
    if t == 0.0 or abs(repriced - t) > rtol * max(abs(t), abs(repriced)):
        ratio = repriced / t if t else float("inf")
        return [Finding(
            "invariants", "reprice-ratio", where,
            f"trace_time_s={repriced!r} vs run time_s={t!r} "
            f"(ratio {ratio!r}): the measured trace no longer reproduces "
            f"the run's BSP time under its own PackageConfig")]
    return []


# ----------------------------------------------------------------- composite
def check_run(result, *, pkg, grid, where: str = "run",
              write_back: bool = False, seeds: int = 0,
              combine: Optional[str] = None,
              values_before=None, values_after=None,
              drained: bool = True,
              mem_bits_hbm: float = 0.0) -> List[Finding]:
    """All post-run invariants of one ``RunResult``.

    ``pkg``/``grid`` are the run's own :class:`PackageConfig` /
    :class:`TileGrid` (the reprice contract is against the measured
    config, not an arbitrary one).  ``values_before``/``values_after``
    enable the monotone-frontier check when ``combine == 'min'``.
    Returns findings; use :func:`assert_clean` to raise instead.
    """
    findings = []
    findings += check_counters(result.counters, where=where,
                               write_back=write_back, seeds=seeds)
    if result.trace is not None:
        findings += check_trace(result.trace, where=where, drained=drained)
        findings += check_reprice(result, pkg, grid, where=where,
                                  mem_bits_hbm=mem_bits_hbm)
    if combine is not None and values_before is not None \
            and values_after is not None:
        findings += check_values(values_before, values_after, combine,
                                 where=where)
    return findings


def assert_clean(findings: Sequence[Finding], context: str = "") -> None:
    """Raise :class:`SanitizerError` if any invariant failed."""
    if findings:
        head = f"sanitizer: {len(findings)} invariant violation(s)"
        if context:
            head += f" in {context}"
        raise SanitizerError(head + "\n" + summarize(findings))
