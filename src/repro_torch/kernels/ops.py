"""Entry points for the port's kernels, dispatched on the tensor's device.

A CUDA tensor goes to the Hopper kernel (built on first use; a failed
build or launch raises); a CPU tensor goes to the kernel's plain version.
Nothing else decides the route, and nothing falls back.

Each kernel wrapper counts its launches (``launches``); a CUDA graph's
replays are added by the graph's owner (``add_launches``).
"""
from __future__ import annotations

import torch

from . import decode_attention as _da
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


def decode_attention(q, k, v, lengths, scale=None, block_s: int = 512):
    """One query token per (batch, head) against a KV cache: q (B, H, D),
    k and v (B, Hkv, S, D), lengths (B,) int32; each group of H / Hkv
    query heads shares a KV head; ``scale`` defaults to 1/sqrt(D).  The
    Pallas kernel's function: positions past a length are masked, and K
    and V count as zero-padded to a multiple of ``block_s`` (so a length
    <= 0 gives the mean of V over the padded length).  f32 inside;
    returns (B, H, D) in q's dtype."""
    if q.is_cuda:
        return _da.decode_attention(q, k, v, lengths, scale, block_s)
    return _da.plain(q, k, v, lengths, scale, block_s)


def analysis_cases():
    """Every kernel's ``analysis.kernel_races`` cases (``ref.Case``),
    from each kernel module's ``analysis_cases``: the counterpart of the
    reference's kernel suite (``ops.py``, ``relax_min.py``,
    ``segment_combine.py``, ``deliver_fused.py``, ``histogram_bin.py``
    ``analysis_cases``), with spmv_bcsr and decode_attention among them."""
    cases = []
    for mod in (_sc, _rx, _hb, _df, _sp, _da):
        cases.extend(mod.analysis_cases())
    return cases


KERNELS = (_rx.relax, _sc.segment_combine, _df.deliver_fused,
           _hb.histogram_bin, _sp.spmv_bcsr, _da.decode_attention)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    """Every kernel's launch count, by kernel name."""
    return {k.__name__: k.launches for k in KERNELS}


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (by kernel name) to the launch counts.
    A CUDA graph's replay runs the kernels captured in it without calling
    their wrappers, so the graph's owner counts them here, once per
    replay (and takes back what the capture counted, ``times=-1``)."""
    for k in KERNELS:
        k.launches += times * counts.get(k.__name__, 0)
