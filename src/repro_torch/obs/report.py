"""Markdown + JSON run reports from a recorded telemetry run.

A copy of ``repro.obs.report`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in.
``tests/test_torch_obs.py`` holds the copy against the original.

:func:`run_report` folds everything the observability stack measured —
wall-clock breakdown, simulated BSP time, GTEPS, a per-superstep message
histogram, the load-imbalance summary (``obs.imbalance``), sanitizer
status and the metrics-registry snapshot — into one plain dict;
:func:`to_markdown` renders it human-readable and :func:`write_report`
writes both forms next to each other (``<stem>.json`` / ``<stem>.md``).

The report is the artifact CI uploads per run (see tier1.yml) and the
standard shape later perf/fault/serving work reports through.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from .imbalance import imbalance_report
from .metrics import default_registry

_HIST_BINS = 8


def _superstep_histogram(rec) -> Dict[str, list]:
    """Histogram of per-superstep injected messages (how bursty the run
    is): log-spaced bins over the observed range."""
    msgs = rec.stat_matrix("messages")
    if msgs.size == 0:
        return dict(edges=[], counts=[])
    top = float(msgs.max())
    if top <= 0:
        return dict(edges=[0.0, 1.0], counts=[int(msgs.size)])
    edges = np.unique(np.concatenate(
        [[0.0], np.geomspace(1.0, max(top, 1.0), _HIST_BINS)]))
    counts, edges = np.histogram(msgs, bins=edges)
    return dict(edges=[float(e) for e in edges],
                counts=[int(c) for c in counts])


def run_report(rec, *, teps_edges: Optional[float] = None,
               baseline_counters=None, registry=None,
               top: int = 5) -> Dict[str, object]:
    """Build the run-report dict for a recorded telemetry run.

    ``teps_edges`` (the app's Graph500-style edge count, e.g.
    ``AppResult.teps_edges``) enables the GTEPS line; ``baseline_counters``
    (a no-proxy/no-cascade run's TrafficCounters) enables cascade
    efficacy; ``registry`` defaults to the process-wide metrics registry.
    """
    meta, result = rec.meta, rec.result
    reg = registry if registry is not None else default_registry()
    rep: Dict[str, object] = dict(
        app=meta.app if meta is not None else "?",
        grid=(f"{meta.grid_ny}x{meta.grid_nx}" if meta is not None else "?"),
        n_chips=meta.n_chips if meta is not None else 1,
        chunk=meta.chunk if meta is not None else 0,
        backend=meta.backend if meta is not None else "?",
        supersteps=rec.supersteps,
        wall=rec.wall_breakdown(),
    )
    if result is not None:
        rep["sim_time_s"] = float(result.time_s)
        rep["sim_cycles"] = float(result.cycles)
        rep["counters"] = result.counters.as_dict()
        if teps_edges is not None:
            rep["teps_edges"] = float(teps_edges)
            rep["gteps"] = float(teps_edges) / max(result.time_s,
                                                   1e-12) / 1e9
    rep["superstep_histogram"] = _superstep_histogram(rec)
    rep["imbalance"] = imbalance_report(rec, baseline_counters, top=top)
    sanitize_on = bool(meta.sanitize) if meta is not None else False
    rep["sanitizer"] = dict(
        enabled=sanitize_on,
        # a sanitize run that produced a result raised on any violation,
        # so reaching the report means clean
        status=("clean" if sanitize_on and result is not None
                else ("off" if not sanitize_on else "unknown")))
    rep["metrics"] = reg.snapshot()
    return rep


def _fmt(v: float) -> str:
    return f"{v:,.4g}" if isinstance(v, float) else str(v)


def to_markdown(rep: Dict[str, object]) -> str:
    """Render a :func:`run_report` dict as markdown."""
    lines = [f"# Run report: {rep['app']} "
             f"({rep['grid']} tiles, {rep['n_chips']} chip(s), "
             f"chunk={rep['chunk']}, backend={rep['backend']})", ""]
    lines.append(f"- supersteps: **{rep['supersteps']}**")
    if "sim_time_s" in rep:
        lines.append(f"- simulated time: **{_fmt(rep['sim_time_s'])} s** "
                     f"({_fmt(rep['sim_cycles'])} cycles)")
    if "gteps" in rep:
        lines.append(f"- GTEPS: **{_fmt(rep['gteps'])}** "
                     f"({_fmt(rep['teps_edges'])} edges)")
    w = rep["wall"]
    lines.append(f"- wall: {_fmt(w['total_s'])} s over {w['chunks']} "
                 f"chunk(s) — dispatch {_fmt(w['dispatch_s'])} s, "
                 f"fetch {_fmt(w['fetch_s'])} s, "
                 f"account {_fmt(w['account_s'])} s")
    san = rep["sanitizer"]
    lines.append(f"- sanitizer: {san['status']}"
                 + ("" if san["enabled"] else " (disabled)"))
    hist = rep["superstep_histogram"]
    if hist["counts"]:
        lines += ["", "## Superstep message histogram", "",
                  "| messages ≤ | supersteps |", "|---:|---:|"]
        for hi, c in zip(hist["edges"][1:], hist["counts"]):
            lines.append(f"| {_fmt(float(hi))} | {c} |")
    imb = rep["imbalance"]
    lines += ["", "## Load imbalance", ""]
    if imb["supersteps"]:
        lines.append(f"- workers: {imb['workers']} — total Gini "
                     f"**{_fmt(imb['total_gini'])}**, total max/mean "
                     f"{_fmt(imb['total_max_over_mean'])}")
        lines.append(f"- per-step: mean Gini {_fmt(imb['mean_step_gini'])}, "
                     f"max Gini {_fmt(imb['max_step_gini'])}, mean max/mean "
                     f"{_fmt(imb['mean_step_max_over_mean'])}")
        if "cascade_efficacy" in imb:
            lines.append(f"- cascade efficacy: "
                         f"**{_fmt(imb['cascade_efficacy'])}** "
                         f"(owner msgs {_fmt(imb['owner_msgs'])} vs "
                         f"baseline {_fmt(imb['baseline_owner_msgs'])})")
        if imb["top_steps"]:
            lines += ["", "| top imbalanced superstep | Gini | max/mean "
                      "| load |", "|---:|---:|---:|---:|"]
            for t in imb["top_steps"]:
                lines.append(f"| {t['step']} | {_fmt(t['gini'])} | "
                             f"{_fmt(t['max_over_mean'])} | "
                             f"{_fmt(t['load'])} |")
    else:
        lines.append("- no telemetry load vectors recorded "
                     "(run with `EngineConfig.telemetry=True`)")
    return "\n".join(lines) + "\n"


def write_report(rep: Dict[str, object], stem: str) -> Dict[str, str]:
    """Write ``<stem>.json`` and ``<stem>.md``; returns their paths."""
    os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)
    jpath, mpath = stem + ".json", stem + ".md"
    with open(jpath, "w") as f:
        json.dump(rep, f, indent=2)
    with open(mpath, "w") as f:
        f.write(to_markdown(rep))
    return dict(json=jpath, markdown=mpath)
