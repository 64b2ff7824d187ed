"""Load-balance metrics over telemetry load matrices.

A copy of ``repro.obs.imbalance`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in.
``tests/test_torch_obs.py`` holds the copy against the original.

The paper's cascading argument ("proxy regions + selective cascading …
improve load balancing") is a measurable claim: take the per-worker load
each superstep — delivered records per chip (``pc_delivered`` +
``pc_recv``) distributed, per tile (``tv_delivered``) monolithic — and
ask how unequal it is.  This module turns a telemetry run's
``(supersteps, workers)`` load matrix into those numbers:

  * :func:`gini` — Gini coefficient of a load vector (0 = perfectly
    balanced, → 1 = one worker holds everything);
  * :func:`max_over_mean` — the bottleneck ratio the BSP time model
    actually pays (a superstep costs its *max* worker, so max/mean is
    the slowdown vs perfect balance);
  * :func:`summarize` — whole-run report: totals-based and per-step
    Gini/max-over-mean plus the top imbalanced supersteps;
  * :func:`cascade_efficacy` — owner-message reduction vs a baseline
    run (the Tascade comparison: how much owner-bound traffic the
    proxy/cascade tree absorbed).

Everything here is plain NumPy over host-side matrices — nothing touches
the engine or devices (see the layering note in ``obs/__init__``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def gini(x) -> float:
    """Gini coefficient of a nonnegative load vector.

    0 = perfectly balanced; (n-1)/n = one worker holds all the load.
    Zero-total or empty vectors read as perfectly balanced (0.0).
    """
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    if n == 0:
        return 0.0
    total = float(x.sum())
    if total <= 0.0:
        return 0.0
    xs = np.sort(x)
    i = np.arange(1, n + 1, dtype=np.float64)
    # sorted-prefix identity of the mean-absolute-difference definition
    return float((2.0 * np.sum(i * xs) - (n + 1) * total) / (n * total))


def max_over_mean(x) -> float:
    """Bottleneck ratio of a load vector: max / mean (1 = perfect
    balance; the factor by which the slowest worker stretches a BSP
    superstep).  Zero-total or empty vectors read as 0.0."""
    x = np.asarray(x, np.float64).ravel()
    if x.size == 0:
        return 0.0
    m = float(x.mean())
    return float(x.max() / m) if m > 0 else 0.0


def step_metrics(load) -> Dict[str, np.ndarray]:
    """Per-superstep balance metrics of a ``(supersteps, workers)`` load
    matrix: ``gini`` and ``max_over_mean`` vectors of length
    supersteps."""
    load = np.atleast_2d(np.asarray(load, np.float64))
    return dict(
        gini=np.array([gini(r) for r in load]),
        max_over_mean=np.array([max_over_mean(r) for r in load]),
    )


def summarize(load, top: int = 5) -> Dict[str, object]:
    """Whole-run imbalance summary of a ``(supersteps, workers)`` load
    matrix.

    ``total_*`` metrics look at each worker's load summed over the run
    (does anyone do more work overall?); ``mean_step_*`` average the
    per-superstep metrics over steps that moved any load (is any single
    barrier stretched?).  ``top_steps`` lists the most imbalanced
    supersteps by per-step Gini — the ones to inspect in the trace.
    """
    load = np.atleast_2d(np.asarray(load, np.float64))
    if load.size == 0:
        return dict(supersteps=0, workers=0, total_gini=0.0,
                    total_max_over_mean=0.0, mean_step_gini=0.0,
                    max_step_gini=0.0, mean_step_max_over_mean=0.0,
                    top_steps=[])
    per = step_metrics(load)
    totals = load.sum(axis=0)
    active = load.sum(axis=1) > 0
    order = np.argsort(-per["gini"], kind="stable")
    top_steps = [
        dict(step=int(s), gini=float(per["gini"][s]),
             max_over_mean=float(per["max_over_mean"][s]),
             load=float(load[s].sum()))
        for s in order[:top] if load[s].sum() > 0
    ]
    return dict(
        supersteps=int(load.shape[0]),
        workers=int(load.shape[1]),
        total_gini=gini(totals),
        total_max_over_mean=max_over_mean(totals),
        mean_step_gini=(float(per["gini"][active].mean())
                        if active.any() else 0.0),
        max_step_gini=float(per["gini"].max()) if per["gini"].size else 0.0,
        mean_step_max_over_mean=(float(per["max_over_mean"][active].mean())
                                 if active.any() else 0.0),
        top_steps=top_steps,
    )


def run_load_matrix(recorder) -> np.ndarray:
    """Per-worker per-superstep load of a recorded telemetry run.

    Distributed runs: delivered + exchange-received records per chip
    (``pc_delivered + pc_recv``) — the endpoint work each chip's barrier
    waits on.  Monolithic runs: delivered records per tile
    (``tv_delivered``).  Returns ``(supersteps, workers)``; empty when
    the run recorded no telemetry vectors.
    """
    avail = recorder.vec_keys()
    if "pc_delivered" in avail:
        m = recorder.vec_matrix("pc_delivered")
        if "pc_recv" in avail:
            m = m + recorder.vec_matrix("pc_recv")
        return m
    if "tv_delivered" in avail:
        return recorder.vec_matrix("tv_delivered")
    return np.zeros((0, 0))


def cascade_efficacy(owner_msgs: float, baseline_owner_msgs: float) -> float:
    """Owner-message reduction vs a baseline run: ``1 - with/without``
    (1 = every owner-bound message absorbed before the owner leg; 0 = no
    effect; negative = the tree added traffic).  The baseline is a run
    of the same app/graph without the proxy (or without the cascade),
    whose ``counters.owner_msgs`` the caller passes in."""
    if baseline_owner_msgs <= 0:
        return 0.0
    return float(1.0 - owner_msgs / baseline_owner_msgs)


def imbalance_report(recorder, baseline_counters=None,
                     top: int = 5) -> Dict[str, object]:
    """Full imbalance report for a recorded telemetry run: the
    :func:`summarize` metrics over :func:`run_load_matrix`, plus the
    run's owner-message totals and — when ``baseline_counters`` (a
    :class:`~repro.core.netstats.TrafficCounters` of a no-proxy or
    no-cascade run) is given — the :func:`cascade_efficacy`."""
    rep = summarize(run_load_matrix(recorder), top=top)
    result = recorder.result
    if result is not None:
        rep["owner_msgs"] = float(result.counters.owner_msgs)
        rep["messages"] = float(result.counters.messages)
        rep["supersteps_run"] = int(result.supersteps)
    if baseline_counters is not None and result is not None:
        rep["baseline_owner_msgs"] = float(baseline_counters.owner_msgs)
        rep["cascade_efficacy"] = cascade_efficacy(
            rep["owner_msgs"], rep["baseline_owner_msgs"])
    return rep
