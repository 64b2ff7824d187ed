"""Histogram binning kernel (the Histo app's hot loop, standalone).

Replaces ``repro/kernels/histogram_bin.py`` ``histogram_bin``.  The TPU
kernel summed a one-hot (records x bins) block per grid step because
the TPU's vector unit has no scatter; this one is one pass of integer
atomics (``csrc/histogram_bin.cu``: privatized shared-memory bins when
they fit in 48 KB, global atomics otherwise), then an int32 -> f32
conversion.  Bound by device-memory bytes (each id read once, each count
written once).  Counts are integers, so the result is bitwise the plain
version's in any order.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import histogram_ref as plain


def histogram_bin(idx, num_bins: int):
    """Hopper kernel.  idx: (N,) int32 CUDA tensor of bin ids, < 0 =
    padding (ids >= num_bins are skipped too).  Returns (num_bins,) f32
    counts."""
    dev = idx.device
    _build.check("histogram_bin idx", idx, (torch.int32,))
    cnt_i = torch.empty((num_bins,), dtype=torch.int32, device=dev)
    out = torch.empty((num_bins,), dtype=torch.float32, device=dev)
    fn = _build.bind("histogram_bin", "histogram_bin_launch", 3, 2, 0)
    with torch.cuda.device(dev):
        _build.launch("histogram_bin", fn, idx.data_ptr(), cnt_i.data_ptr(),
                      out.data_ptr(), idx.numel(), num_bins,
                      torch.cuda.current_stream(dev).cuda_stream)
    histogram_bin.launches += 1
    return out


histogram_bin.launches = 0
__all__ = ["histogram_bin", "plain"]
