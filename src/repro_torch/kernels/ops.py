"""Entry points for the port's kernels, dispatched on the tensor's device.

A CUDA tensor goes to the Hopper kernel (built on first use; a failed
build or launch raises); a CPU tensor goes to the kernel's plain version.
Nothing else decides the route, and nothing falls back.

Each kernel wrapper counts its launches (``launches``); a CUDA graph's
replays are added by the graph's owner (``add_launches``).

``decode_attention``, the one kernel on the LM paths, is a custom op of
the dispatcher (``repro_torch::decode_attention``): its CUDA and CPU
bodies take the same route, and a fake tensor (``FakeTensorMode``, the
dry run's) reaches its fake body, which computes nothing and launches
nothing; its FLOPs are registered with ``torch.utils.flop_counter``.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from . import decode_attention as _da
from . import deliver_fused as _df
from . import histogram_bin as _hb
from . import relax_min as _rx
from . import segment_combine as _sc
from . import spmv_csr as _sp
from .ref import decode_geometry

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


# the custom op: declared once, its body by device (the dispatcher picks
# the kernel for a CUDA tensor, the plain version for a CPU one), a fake
# body for FakeTensorMode.  Declared with ``torch.library.Library``
# rather than ``torch.library.custom_op``, whose Python autograd layer
# cost ~45 us more a call than the wrapper on the card's host (PERF.md)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor lengths, "
            "float? scale, int block_s) -> (Tensor, Tensor)")
_LIB.impl("decode_attention",
          lambda *args: _da.decode_attention(*args), "CUDA")
_LIB.impl("decode_attention", lambda *args: _da.plain(*args), "CPU")


@torch.library.register_fake("repro_torch::decode_attention", lib=_LIB)
def _(q, k, v, lengths, scale, block_s):
    b, h, _, _, d, _ = decode_geometry(q, k, v)
    return q.new_empty((b, h, d)), q.new_empty((b, h), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def decode_attention_flops(q_shape, k_shape, *args, out_shape=None,
                           **kwargs) -> int:
    """4 B H S D: Q.K^T and P.V over the whole (B, Hkv, S, D) cache (the
    lse adds B H, nothing beside it)."""
    b, h, d = q_shape
    return 4 * b * h * k_shape[2] * d


_DECODE_ATTENTION = torch.ops.repro_torch.decode_attention.default


def decode_attention(q, k, v, lengths, scale=None, block_s: int = 512):
    """One query token per (batch, head) against a KV cache: q (B, H, D),
    k and v (B, Hkv, S, D), lengths (B,) int32; each group of H / Hkv
    query heads shares a KV head; ``scale`` defaults to 1/sqrt(D).  The
    Pallas kernel's function: positions past a length are masked, and K
    and V count as zero-padded to a multiple of ``block_s`` (so a length
    <= 0 gives the mean of V over the padded length).  f32 inside;
    returns (out, lse): out (B, H, D) in q's dtype, lse (B, H) f32 each
    row's log-sum-exp over the positions it attends, -inf at a length
    <= 0 (``ref.decode_attention_ref``), by which blocks of a cache's
    positions merge.  One call of the custom op
    ``repro_torch::decode_attention``."""
    return _DECODE_ATTENTION(q, k, v, lengths, scale, block_s)


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
