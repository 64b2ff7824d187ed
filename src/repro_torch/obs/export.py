"""Chrome trace-event / Perfetto JSON export of a recorded telemetry run.

A copy of ``repro.obs.export`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in.
``tests/test_torch_obs.py`` holds the copy against the original.

Feed the output of :func:`write_trace` to ``chrome://tracing`` or
https://ui.perfetto.dev.  The trace has three process groups:

  * **host wall-clock** (pid 0) — one track per phase of the chunked run
    loop (``dispatch`` / ``fetch`` / ``account``), one complete-span
    ("X") event per chunk per phase, in real microseconds since the run
    started.  This is where host time goes.
  * **BSP timeline (simulated)** (pid 1) — one track per network level
    of the BSP time model (:data:`~repro.core.costmodel.STEP_CYCLE_LEVELS`:
    compute, intra-NoC, inter-die, off-package, endpoint, board, HBM),
    one span per superstep per level whose duration is that level's
    serialization term in simulated microseconds (cycles / 1000 at the
    1 GHz tile clock).  The superstep's cost is the *max* across tracks
    (``costmodel.step_cycles``), so the widest track per superstep is
    the binding level.  This is where simulated time goes.  When the run
    was double-buffered (``SuperstepTrace.double_buffer``) the board
    track instead shows ``exchange k (overlap)`` spans drawn over the
    *next* superstep's compute window — the overlap the accumulation
    rule credits.  Compacted runs (``EngineConfig.compaction > 1``)
    add an ``active-set compaction`` counter track here: per-superstep
    ``active_fraction`` (active tiles / grid tiles) and ``bucket_cap``
    (the selected capacity-ladder rung) sampled from the chunk stat
    rows — no extra host syncs.  Fault-tolerant runs add a ``fault
    tolerance`` track: checkpoint / re-shard spans sized by the image's
    board-leg serialization and rollback spans covering the discarded
    replay window (``SuperstepTrace.recovery_events``).
  * **chip c (sim load)** (pids 10+c) — per-chip counter ("C") tracks of
    the telemetry load vectors (delivered / recv / edges / …) sampled at
    each superstep's simulated start time; monolithic runs group tiles
    by grid row instead.  Only present when the run had
    ``EngineConfig.telemetry=True``.

All events follow the Chrome trace-event format (``ph``/``pid``/``tid``/
``ts``/``dur`` in µs); the top-level object is
``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.costmodel import (CLOCK_GHZ, IO_DIE_RXTX_LAT_NS, PackageConfig,
                              STEP_CYCLE_LEVELS, checkpoint_leg_cycles,
                              link_provisioning, step_cycle_terms)

PID_HOST = 0
PID_SIM = 1
PID_CHIP0 = 10            # chip c -> pid PID_CHIP0 + c

_US_PER_CYCLE = 1.0 / (CLOCK_GHZ * 1e3)       # 1 GHz: 1000 cycles per µs

_LEVEL_LABELS = dict(compute="compute (PU ops)", intra="intra-die NoC",
                     die="inter-die links", pkg="off-package links",
                     endpoint="endpoint contention", board="board links",
                     hbm="HBM drain")

_WALL_TRACKS = (("dispatch", 1), ("fetch", 2), ("account", 3))


def _meta_event(pid: int, name: str, tid: Optional[int] = None,
                thread: Optional[str] = None) -> dict:
    if thread is not None:
        return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": thread}}
    return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name}}


def _wall_events(rec) -> List[dict]:
    """Host wall-clock spans: one X event per chunk per loop phase."""
    evs = [_meta_event(PID_HOST, "host wall-clock")]
    for name, tid in _WALL_TRACKS:
        evs.append(_meta_event(PID_HOST, "", tid=tid, thread=name))
    t0 = rec.t0
    for s in rec.spans:
        label = f"chunk {s.index} [{s.step_lo}:{s.step_hi})"
        for (a, b), (_, tid) in zip(
                (s.t_dispatch, s.t_fetch, s.t_account), _WALL_TRACKS):
            evs.append({"ph": "X", "name": label, "pid": PID_HOST,
                        "tid": tid, "ts": (a - t0) * 1e6,
                        "dur": max(b - a, 0.0) * 1e6,
                        "args": {"steps": s.n_steps}})
    return evs


def _sim_terms(rec):
    """Per-superstep BSP level terms (cycles) from the run's
    SuperstepTrace, or None when the recorder has no priced result."""
    result, meta = rec.result, rec.meta
    if (result is None or result.trace is None or meta is None
            or meta.grid is None or len(result.trace) == 0):
        return None
    trace = result.trace
    pkg = meta.pkg if meta.pkg is not None else PackageConfig()
    links = link_provisioning(meta.grid, pkg)
    terms = step_cycle_terms(
        pkg, links,
        compute_ops=np.asarray(trace.compute_ops, np.float64),
        intra_bits=np.asarray(trace.intra_bits, np.float64),
        die_bits=np.asarray(trace.die_bits, np.float64),
        pkg_bits=np.asarray(trace.pkg_bits, np.float64),
        endpoint_bits=np.asarray(trace.endpoint_bits, np.float64),
        off_chip_bits=np.asarray(trace.off_chip_bits, np.float64),
        board_links=trace.board_links)
    return (terms, links, np.asarray(trace.pending, np.float64),
            np.asarray(trace.off_chip_msgs, np.float64),
            bool(getattr(trace, "double_buffer", False)))


def _sim_events(rec) -> Tuple[List[dict], List[float]]:
    """Simulated-time spans per superstep per BSP level; returns the
    events plus each superstep's simulated start time (µs) so the load
    counters can sample on the same clock."""
    out = _sim_terms(rec)
    if out is None:
        return [], []
    terms, links, pending, off_msgs, double_buffer = out
    evs = [_meta_event(PID_SIM, "BSP timeline (simulated)")]
    levels = [lv for lv in STEP_CYCLE_LEVELS if lv in terms]
    for i, lv in enumerate(levels):
        evs.append(_meta_event(PID_SIM, "", tid=i + 1,
                               thread=_LEVEL_LABELS.get(lv, lv)))
    fill_us = links["diameter"] * 0.5 * _US_PER_CYCLE
    io_us = 2.0 * IO_DIE_RXTX_LAT_NS * CLOCK_GHZ * _US_PER_CYCLE
    n = len(pending)
    starts: List[float] = []
    cur = 0.0
    if double_buffer:
        # double-buffered accumulation rule: a charged step pays
        # max(core, previous step's in-flight exchange) + fill, and its
        # own boundary exchange (board + IO-die latency) overlaps the
        # *next* step's compute — so the exchange span is drawn starting
        # where the next compute window opens (see the distributed
        # runtime's run loop).
        prev_exch = 0.0
        board_i = levels.index("board") + 1 if "board" in levels else None
        for s in range(n):
            starts.append(cur)
            core = 0.0
            for i, lv in enumerate(levels):
                if lv == "board":
                    continue
                t_us = float(terms[lv][s]) * _US_PER_CYCLE
                core = max(core, t_us)
                if t_us > 0.0:
                    evs.append({"ph": "X", "name": f"superstep {s}",
                                "pid": PID_SIM, "tid": i + 1, "ts": cur,
                                "dur": t_us, "args": {"level": lv}})
            board_us = float(terms["board"][s]) * _US_PER_CYCLE \
                if board_i is not None else 0.0
            if core > 0.0 or board_us > 0.0 or pending[s] > 0.0:
                cur += max(core, prev_exch) + fill_us
                prev_exch = board_us + (io_us if off_msgs[s] > 0.0 else 0.0)
                if prev_exch > 0.0 and board_i is not None:
                    evs.append({"ph": "X", "name": f"exchange {s} (overlap)",
                                "pid": PID_SIM, "tid": board_i, "ts": cur,
                                "dur": prev_exch, "args": {"level": "board"}})
        return evs, starts
    for s in range(n):
        starts.append(cur)
        step = 0.0
        for i, lv in enumerate(levels):
            t_us = float(terms[lv][s]) * _US_PER_CYCLE
            step = max(step, t_us)
            if t_us > 0.0:
                evs.append({"ph": "X", "name": f"superstep {s}",
                            "pid": PID_SIM, "tid": i + 1, "ts": cur,
                            "dur": t_us, "args": {"level": lv}})
        # the run loop's accumulation rule: charged steps pay the level
        # max plus pipeline fill, plus IO-die latency when records
        # crossed chips (see engine.run and the distributed runtime's)
        if step > 0.0 or pending[s] > 0.0:
            cur += step + fill_us
            if off_msgs[s] > 0.0:
                cur += io_us
    return evs, starts


def _load_events(rec, starts: List[float]) -> List[dict]:
    """Per-chip (or per-tile-row) load counter tracks on the simulated
    clock, from the run's telemetry vectors."""
    keys = rec.vec_keys()
    if not keys or not starts:
        return []
    evs: List[dict] = []
    pc = sorted(k for k in keys if k.startswith("pc_"))
    if pc:
        mats = {k: rec.vec_matrix(k) for k in pc}
        n_chips = next(iter(mats.values())).shape[1]
        ndev = getattr(rec.meta, "n_devices", 1) if rec.meta else 1
        per = n_chips // ndev if ndev and n_chips % ndev == 0 else n_chips
        for c in range(n_chips):
            name = f"chip {c} (sim load)" if ndev <= 1 else \
                f"chip {c} / dev {c // per} (sim load)"
            evs.append(_meta_event(PID_CHIP0 + c, name))
        for k, m in mats.items():
            name = k[3:]
            s_max = min(len(starts), m.shape[0])
            for c in range(n_chips):
                for s in range(s_max):
                    evs.append({"ph": "C", "name": name,
                                "pid": PID_CHIP0 + c, "tid": 0,
                                "ts": starts[s],
                                "args": {name: float(m[s, c])}})
        return evs
    # monolithic: group the per-tile vectors by grid row (tile groups)
    meta = rec.meta
    evs.append(_meta_event(PID_CHIP0, "chip 0 (sim load)"))
    for k in ("tv_delivered", "tv_edges"):
        if k not in keys:
            continue
        m = rec.vec_matrix(k)
        ny = meta.grid_ny if meta is not None and meta.grid_ny else 1
        if ny and m.shape[1] % ny == 0:
            m = m.reshape(m.shape[0], ny, -1).sum(axis=2)
        name = k[3:]
        s_max = min(len(starts), m.shape[0])
        for r in range(m.shape[1]):
            for s in range(s_max):
                evs.append({"ph": "C", "name": f"{name} row{r}",
                            "pid": PID_CHIP0, "tid": 0, "ts": starts[s],
                            "args": {name: float(m[s, r])}})
    return evs


_TID_COMPACTION = 90      # counter track on the sim process


def _compaction_events(rec, starts: List[float]) -> List[dict]:
    """Active-set compaction counter ("C") tracks on the simulated
    clock: ``active_fraction`` (active tiles / grid tiles) and
    ``bucket_cap`` (the capacity-ladder rung the superstep ran in),
    one sample per superstep.  Both come from the telemetry stats the
    engine's bucket switch emits into the packed chunk stat row — they
    ride the existing chunk fetch, so rendering them adds no host
    syncs.  Empty (and absent from the trace) on dense runs."""
    act = rec.stat_matrix("active_tiles")
    if act.size == 0 or not starts:
        return []
    cap = rec.stat_matrix("bucket_cap")
    tiles = rec.meta.tiles if rec.meta is not None else 0
    frac = act / tiles if tiles else act
    evs = [_meta_event(PID_SIM, "", tid=_TID_COMPACTION,
                       thread="active-set compaction")]
    s_max = min(len(starts), act.shape[0])
    for s in range(s_max):
        evs.append({"ph": "C", "name": "active_fraction", "pid": PID_SIM,
                    "tid": _TID_COMPACTION, "ts": starts[s],
                    "args": {"active_fraction": float(frac[s])}})
        if s < cap.shape[0]:
            evs.append({"ph": "C", "name": "bucket_cap", "pid": PID_SIM,
                        "tid": _TID_COMPACTION, "ts": starts[s],
                        "args": {"bucket_cap": float(cap[s])}})
    return evs


_TID_RECOVERY = 91        # fault-tolerance track on the sim process


def _recovery_events(rec, starts: List[float]) -> List[dict]:
    """Fault-tolerance spans ("X") on the simulated clock, from the
    run's ``SuperstepTrace.recovery_events`` log: ``checkpoint`` and
    ``re-shard`` spans sized by the image's board-leg serialization
    (``costmodel.checkpoint_leg_cycles`` — the same pricing the run's
    separate overhead accumulator uses) and ``rollback`` spans covering
    the discarded ``[from_step, at_step)`` replay window.  Empty (and
    absent) on unfailed runs without a checkpoint cadence."""
    result, meta = rec.result, rec.meta
    if result is None or result.trace is None or not starts:
        return []
    events = getattr(result.trace, "recovery_events", None)
    if not events:
        return []
    pkg = meta.pkg if meta is not None and meta.pkg is not None \
        else PackageConfig()
    blinks = int(getattr(result.trace, "board_links", 1))
    end = starts[-1]

    def at(step):
        s = int(step)
        return starts[s] if s < len(starts) else end

    evs = [_meta_event(PID_SIM, "", tid=_TID_RECOVERY,
                       thread="fault tolerance")]
    for ev in events:
        kind = ev.get("kind")
        if kind in ("checkpoint", "reshard"):
            dur = checkpoint_leg_cycles(pkg, float(ev.get("bits", 0.0)),
                                        blinks) * _US_PER_CYCLE
            name = ("checkpoint" if kind == "checkpoint"
                    else f"re-shard (chip {ev.get('chip', '?')} lost)")
            evs.append({"ph": "X", "name": f"{name} @ step {ev['step']}",
                        "pid": PID_SIM, "tid": _TID_RECOVERY,
                        "ts": at(ev["step"]), "dur": dur,
                        "args": dict(ev)})
        elif kind == "rollback":
            lo, hi = int(ev["from_step"]), int(ev["at_step"])
            evs.append({"ph": "X",
                        "name": f"rollback [{lo}:{hi}) "
                                f"(chip {ev.get('chip', '?')})",
                        "pid": PID_SIM, "tid": _TID_RECOVERY,
                        "ts": at(lo), "dur": max(at(hi) - at(lo), 0.0),
                        "args": dict(ev)})
    return evs


def to_trace_events(rec) -> List[dict]:
    """All trace events of a recorded run (see module docstring)."""
    evs = _wall_events(rec)
    sim_evs, starts = _sim_events(rec)
    evs.extend(sim_evs)
    evs.extend(_load_events(rec, starts))
    evs.extend(_compaction_events(rec, starts))
    evs.extend(_recovery_events(rec, starts))
    return evs


def trace_dict(rec) -> Dict[str, object]:
    """The complete Chrome trace-event JSON object for ``rec``."""
    meta = rec.meta
    other: Dict[str, object] = dict(wall_s=rec.wall_s,
                                    supersteps=rec.supersteps)
    if meta is not None:
        other.update(app=meta.app, grid=f"{meta.grid_ny}x{meta.grid_nx}",
                     n_chips=meta.n_chips, chunk=meta.chunk,
                     backend=meta.backend, telemetry=meta.telemetry,
                     n_devices=getattr(meta, "n_devices", 1))
    return {"traceEvents": to_trace_events(rec),
            "displayTimeUnit": "ms", "otherData": other}


def write_trace(rec, path: str) -> str:
    """Write ``rec`` as Chrome trace-event JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(trace_dict(rec), f)
    return path
