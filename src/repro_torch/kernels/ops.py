"""Entry points for the engine's kernels, dispatched on the tensor's device.

A CUDA tensor goes to the Hopper kernel (built on first use; a failed
build or launch raises); a CPU tensor goes to the kernel's plain version.
Nothing else decides the route, and nothing falls back.
"""
from __future__ import annotations

from . import deliver_fused as _df
from . import relax_min as _rx
from . import segment_combine as _sc


def relax(values, mail_val, mail_flag, combine: str = "min"):
    if values.is_cuda:
        return _rx.relax(values, mail_val, mail_flag, combine)
    return _rx.plain(values, mail_val, mail_flag, combine)


def segment_combine(seg, val, num_segments: int, combine: str = "min"):
    if seg.is_cuda:
        return _sc.segment_combine(seg, val, num_segments, combine)
    return _sc.plain(seg, val, num_segments, combine)


def deliver_fused(seg, val, mail_val, combine: str = "min"):
    if seg.is_cuda:
        return _df.deliver_fused(seg, val, mail_val, combine)
    return _df.plain(seg, val, mail_val, combine)


KERNELS = (_rx.relax, _sc.segment_combine, _df.deliver_fused)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
