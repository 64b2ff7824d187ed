"""Plain PyTorch versions of the engine's kernels.

They are the kernels' yardsticks: the CPU path of ``kernels.ops`` (the
tests run them against the JAX package's Pallas kernels in interpret
mode) and, on the card, what ``chip_smoke.py`` holds each Hopper kernel
against.  Each computes exactly its kernel's function with plain tensor
operations: ``histogram_ref``, ``relax_ref`` and ``segment_combine_ref``
are the JAX package's ``kernels/ref.py`` oracles; ``deliver_fused_ref``
is the jnp branch of the reference engine's owner delivery
(``core/engine.py`` ``_deliver``), which has no standalone oracle there;
``spmv_ref`` computes the BCSR product block by block, as the Pallas
kernel does (the reference's oracle ``spmv_ref_csr`` works on the CSR).
"""
from __future__ import annotations

import torch

INF = float("inf")


def check_combine(combine: str) -> None:
    if combine not in ("min", "add"):
        raise ValueError(f"combine must be 'min' or 'add', got {combine!r}")


def histogram_ref(idx, num_bins: int):
    """Count bin ids; ids < 0 (padding) and >= num_bins are ignored.
    Returns (num_bins,) f32."""
    ok = (idx >= 0) & (idx < num_bins)
    safe = torch.where(ok, idx, num_bins).to(torch.int64)
    return torch.bincount(safe, minlength=num_bins + 1)[:num_bins].to(
        torch.float32)


def spmv_ref(blocks, cols, x, m: int):
    """y = A @ x over ELL-padded BCSR: blocks (Mb, kmax, bm, bk) f32,
    cols (Mb, kmax) block-column ids, x (K,).  Each block times the x
    block its ``cols`` entry picks, summed over the block-row's kmax
    blocks.  Returns (m,) f32."""
    bk = blocks.shape[3]
    kb = -(-x.shape[0] // bk)
    xp = torch.zeros((max(kb, 1) * bk,), dtype=torch.float32,
                     device=x.device)
    xp[: x.shape[0]] = x
    xb = xp.reshape(-1, bk)[cols.to(torch.int64)]          # (Mb, kmax, bk)
    y = torch.matmul(blocks, xb.unsqueeze(-1)).sum(dim=1)  # (Mb, bm, 1)
    return y.reshape(-1)[:m]


def relax_ref(values, mail_val, mail_flag, combine: str = "min"):
    """IQ-drain fold.  Returns (new_values f32, improved int8)."""
    check_combine(combine)
    v = values.to(torch.float32)
    m = mail_val.to(torch.float32)
    f = mail_flag != 0
    if combine == "min":
        imp = f & (m < v)
        return torch.where(imp, m, v), imp.to(torch.int8)
    return torch.where(f, v + m, v), f.to(torch.int8)


def segment_combine_ref(seg, val, num_segments: int, combine: str = "min"):
    """Dense segment min/add over (seg, val); seg < 0 is padding and
    untouched segments hold the identity (+inf for min, 0 for add)."""
    check_combine(combine)
    ok = seg >= 0
    safe = torch.where(ok, seg, num_segments).to(torch.int64)
    val = val.to(torch.float32)
    if combine == "min":
        out = torch.full((num_segments + 1,), INF, dtype=torch.float32,
                         device=val.device)
        out.scatter_reduce_(0, safe, torch.where(ok, val, INF), "amin",
                            include_self=True)
    else:
        out = torch.zeros((num_segments + 1,), dtype=torch.float32,
                          device=val.device)
        out.index_add_(0, safe, torch.where(ok, val, 0.0))
    return out[:num_segments]


def deliver_fused_ref(seg, val, mail_val, combine: str = "min"):
    """Owner delivery: fold every record with seg >= 0 into
    ``mail_val[seg]`` (min touches only hit indices; add accumulates) and
    count the arrivals per index.  Returns (new_mail f32, counts f32)."""
    check_combine(combine)
    nd = mail_val.shape[0]
    ok = seg >= 0
    safe = torch.where(ok, seg, nd).to(torch.int64)
    val = val.to(torch.float32)
    cnt = torch.zeros((nd + 1,), dtype=torch.int32, device=val.device)
    cnt.index_add_(0, safe, ok.to(torch.int32))
    if combine == "min":
        inc = torch.full((nd + 1,), INF, dtype=torch.float32,
                         device=val.device)
        inc.scatter_reduce_(0, safe, torch.where(ok, val, INF), "amin",
                            include_self=True)
        out = torch.minimum(mail_val, inc[:nd])
    else:
        inc = torch.zeros((nd + 1,), dtype=torch.float32, device=val.device)
        inc.index_add_(0, safe, torch.where(ok, val, 0.0))
        out = mail_val + inc[:nd]
    return out, cnt[:nd].to(torch.float32)
