"""Entry points for the port's kernels, dispatched on the tensor's device.

A CUDA tensor goes to the Hopper kernel (built on first use; a failed
build or launch raises); a CPU tensor goes to the kernel's plain version.
Nothing else decides the route, and nothing falls back.
"""
from __future__ import annotations

import torch

from . import deliver_fused as _df
from . import histogram_bin as _hb
from . import relax_min as _rx
from . import segment_combine as _sc
from . import spmv_csr as _sp

bcsr_from_csr = _sp.bcsr_from_csr
BCSR = _sp.BCSR


def histogram(idx, num_bins: int):
    """Counts of each bin id in ``idx`` (int32; < 0 = padding), (num_bins,)
    f32."""
    if idx.is_cuda:
        return _hb.histogram_bin(idx, num_bins)
    return _hb.plain(idx, num_bins)


def spmv(mat: BCSR, x):
    """y = A @ x for a BCSR matrix (numpy arrays, or tensors from
    ``BCSR.to``, which saves the copy per call) and x, (K,) f32.  Returns
    (M,) f32 on x's device."""
    m, k = mat.shape
    if x.shape != (k,):
        raise ValueError(f"spmv: x has shape {tuple(x.shape)}, the matrix "
                         f"{mat.shape}")
    blocks = torch.as_tensor(mat.blocks, device=x.device)
    cols = torch.as_tensor(mat.cols, device=x.device)
    if x.is_cuda:
        return _sp.spmv_bcsr(blocks, cols, x, m)
    return _sp.plain(blocks, cols, x, m)


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


KERNELS = (_rx.relax, _sc.segment_combine, _df.deliver_fused,
           _hb.histogram_bin, _sp.spmv_bcsr)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
