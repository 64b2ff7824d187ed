"""Straggler mitigation = the paper's work-imbalance story, reused.

The engine records per-tile load (edges processed / records consumed).
A straggler is a tile whose load is far above the mean — exactly the
paper's "hot data owner".  Two mitigations, both from the paper:

  1. proxy regions (spread the hot tile's combine work regionally) —
     already in the execution path;
  2. re-chunking: skew the ownership map so hot index ranges are split
     across more tiles (the paper's data-placement/partitioning knob).

For LM training the same logic applies to expert imbalance: the MoE
router's aux loss is the *preventive* fix; rebalance_experts() is the
corrective one (capacity re-assignment from observed expert load).
"""
from __future__ import annotations

import numpy as np


def detect_stragglers(load: np.ndarray, threshold: float = 2.0):
    """Tiles with load > threshold * mean.  Returns (mask, ratio)."""
    load = np.asarray(load, np.float64)
    mean = max(load.mean(), 1e-9)
    return load > threshold * mean, load.max() / mean


def rebalance_chunks(load: np.ndarray, n_items: int,
                     max_ratio: float = 1.5) -> np.ndarray:
    """Compute new chunk boundaries from per-tile load.

    Input: per-tile load under equal chunks; output: (T+1,) int64 offsets
    assigning index ranges to tiles such that estimated per-tile load is
    balanced (inverse-load-proportional chunk sizes, clamped to
    max_ratio x equal size to bound churn).
    Returns boundaries; tile t owns [b[t], b[t+1]).
    """
    t = load.shape[0]
    load = np.maximum(np.asarray(load, np.float64), 1e-9)
    eq = n_items / t
    # per-item density within old chunk ~ load/chunk; target boundaries
    # equalize cumulative load.
    density = load / eq                             # per old chunk
    cum = np.concatenate([[0.0], np.cumsum(density)])
    targets = np.linspace(0, cum[-1], t + 1)
    # invert the cumulative-load curve at old-chunk granularity
    pos = np.interp(targets, cum, np.arange(t + 1) * eq)
    pos[0], pos[-1] = 0, n_items
    pos = np.round(pos).astype(np.int64)
    # clamp chunk sizes to [eq/max_ratio, eq*max_ratio] to bound movement
    sizes = np.diff(pos)
    lo_sz = min(int(eq / max_ratio), n_items // t)
    hi_sz = max(int(np.ceil(eq * max_ratio)), int(np.ceil(eq)))
    sizes = np.clip(sizes, lo_sz, hi_sz)
    # repair the post-clip drift fully: the clip can move the total by
    # up to t * (hi_sz - lo_sz), so one +-1 pass over at most t chunks
    # is not enough — keep spreading +-1 corrections (largest chunks
    # shrink first, smallest grow first) until the sizes sum exactly,
    # never leaving the clip window, so the cumulative boundaries are
    # monotone by construction and no final-chunk overwrite is needed.
    # (termination: t*lo_sz <= n_items <= t*hi_sz, so whenever the sum is
    # off there is room in the needed direction, and every pass moves the
    # sum at least 1 toward n_items)
    while True:
        diff = int(n_items - sizes.sum())
        if diff == 0:
            break
        if diff > 0:
            room = sizes < hi_sz
            order = np.argsort(sizes[room], kind="stable")
            sizes[np.flatnonzero(room)[order][:diff]] += 1
        else:
            room = sizes > lo_sz
            order = np.argsort(-sizes[room], kind="stable")
            sizes[np.flatnonzero(room)[order][:-diff]] -= 1
    return np.concatenate([[0], np.cumsum(sizes)])


def rebalance_experts(expert_load: np.ndarray, capacity: int):
    """Corrective expert capacity assignment: experts get capacity
    proportional to observed load (sum preserved)."""
    load = np.maximum(np.asarray(expert_load, np.float64), 1e-9)
    total = capacity * load.shape[0]
    cap = np.maximum(1, np.round(total * load / load.sum())).astype(int)
    # fix rounding drift
    drift = total - cap.sum()
    cap[np.argsort(-cap)[: abs(int(drift))]] += np.sign(drift)
    return cap
