"""Pipeline parallelism (GPipe-style) over the ranks of a
``torch.distributed`` group.

The port of ``repro/core/pipeline.py``.  L layers split into S contiguous
stages, one a rank of ``group``; microbatches stream through; each stage
boundary is one neighbour hop (a send to the next stage, a receive from
the previous: across regions it crosses the boundary exactly once per
microbatch, the proxy-region discipline again).

    run_pipeline(stage_fn, params_stage, x_mb, group, n_stages)

where ``stage_fn(params_stage, x)`` applies this rank's layer block.  The
schedule is the standard GPipe fill-drain: T = M + S - 1 ticks for M
microbatches; bubble fraction (S-1)/(M+S-1).  Every stage runs at every
tick, bubbles included, as the reference's scan does.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .collectives import check_carrier


def stage_index(group) -> int:
    return dist.get_rank(group)


def run_pipeline(stage_fn: Callable, params_stage, x_mb, group,
                 n_stages: int):
    """Run microbatches through the pipeline stages on ``group``'s ranks
    (stage s is group rank s).

    stage_fn: (params_stage, x) -> x, this rank's contiguous layer block
        (same shape in and out -- a residual-stream transformer block).
    params_stage: this rank's stage parameters.
    x_mb: (M, mb, ...) microbatched input; only stage 0 reads it, but
        every rank passes the same shape.
    Returns (M, mb, ...): the outputs the LAST stage produced (every other
    rank returns the zeros it started with; the caller selects stage
    S-1's copy).
    """
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"{n_stages} stages on a group of "
                         f"{dist.get_world_size(group)} ranks")
    check_carrier(group, x_mb.device)
    m = x_mb.shape[0]
    sidx = dist.get_rank(group)
    last = n_stages - 1
    nxt = dist.get_global_rank(group, (sidx + 1) % n_stages)
    prev = dist.get_global_rank(group, (sidx - 1) % n_stages)
    buf = torch.zeros_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    for t in range(m + n_stages - 1):
        # stage 0 injects microbatch t (the last one again past M);
        # the others take what the previous stage sent
        x_in = x_mb[min(t, m - 1)] if sidx == 0 else buf
        y = stage_fn(params_stage, x_in)
        # the last stage banks its result for microbatch t - S + 1
        if sidx == last and t - last >= 0:
            outs[t - last] = y
        # boundary hop: stage s -> s+1, circular as the reference's
        # ppermute (one rank sends nothing: its buffer is y)
        if n_stages == 1:
            buf = y
            continue
        y = y.contiguous()
        buf = torch.empty_like(y)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y, nxt, group),
            dist.P2POp(dist.irecv, buf, prev, group)])
        for r in reqs:
            r.wait()
    return outs


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
