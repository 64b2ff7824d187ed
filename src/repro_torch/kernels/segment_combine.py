"""Segment combine kernel -- the proxy (P$) coalescing operation itself.

Replaces ``repro/kernels/segment_combine.py`` ``segment_combine``: a
dense segment min/add over (segment id, value) records.  The TPU kernel
compared every record with every segment of a block (one-hot); this one
(``csrc/engine_kernels.cu``) is one cooperative launch: the identity
fill, a grid barrier, then one scatter pass of float atomics.  Where a
thread of the resident grid takes more than one batch of records (the
write-back flush wave, where the atomics set the pace), each run of
equal ids in neighbouring lanes of a warp is folded first, so a run (the
engine hands over sorted ids) costs one atomic per warp; a smaller job
(a P$ call) goes straight to the atomics, its pace set by the launch.
Ids need not be sorted.  min is bitwise order-free; add re-associates
from run to run.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import Case, check_combine, segment_combine_ref as plain


def segment_combine(seg, val, num_segments: int, combine: str = "min"):
    """Hopper kernel.  seg: (N,) int32 CUDA tensor, < 0 = padding; val:
    (N,) f32.  Returns (num_segments,) f32; untouched segments hold the
    identity (+inf for min, 0 for add)."""
    check_combine(combine)
    n = seg.numel()
    dev = seg.device
    _build.check("segment_combine seg", seg, (torch.int32,))
    _build.check("segment_combine val", val, (torch.float32,), n, dev)
    out = torch.empty((num_segments,), dtype=torch.float32, device=dev)
    fn = _build.bind("engine_kernels", "segment_combine_launch", 3, 2, 1)
    with torch.cuda.device(dev):
        _build.launch("segment_combine", fn, seg.data_ptr(), val.data_ptr(),
                      out.data_ptr(), n, num_segments, int(combine == "min"),
                      torch.cuda.current_stream(dev).cuda_stream)
    segment_combine.launches += 1
    return out


def analysis_cases():
    """``analysis.kernel_races`` cases: the reference's
    (``segment_combine.py`` ``analysis_cases``: six records into eight
    segments, and a compacted window's stream with padding between)
    and 4,096 records into 64 segments (many writers a segment), each
    in both combines."""
    from . import ops
    gen = torch.Generator().manual_seed(12)
    sets = (("", torch.tensor([0, 3, 3, 7, 1, 0], dtype=torch.int32),
             torch.arange(6.0), 8),
            ("compact:", torch.tensor([4, -1, 0, 4, -1, 6],
                                      dtype=torch.int32),
             torch.arange(6.0) + 0.5, 8),
            ("dense:", torch.randint(-1, 64, (4096,), generator=gen,
                                     dtype=torch.int32),
             torch.rand(4096, generator=gen), 64))
    return [Case(f"segment_combine:{label}{c}", ops.segment_combine, plain,
                 (seg, val, n, c), (0, 1), (c,))
            for label, seg, val, n in sets for c in ("min", "add")]


segment_combine.launches = 0
__all__ = ["segment_combine", "plain"]
