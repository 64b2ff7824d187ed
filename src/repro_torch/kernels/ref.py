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
kernel does (the reference's oracle ``spmv_ref_csr`` works on the CSR);
``decode_attention_ref`` is the Pallas decode kernel's function, padding
and finite mask included, which the reference's ``decode_attention_ref``
is not at the edges (``length <= 0``, ``length > S``).

``Case`` is one set of inputs on which a kernel is held against its
plain version with its records in other orders (each kernel module's
``analysis_cases``, run by ``analysis.kernel_races``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

INF = float("inf")


class Case(NamedTuple):
    """A kernel call whose result must not depend on the order of its
    records.  ``fn(*args)`` is the entry point (``kernels.ops``: the
    kernel for CUDA tensors, the plain version for CPU ones) and
    ``plain(*args)`` the plain version; ``records`` are the positions in
    ``args`` of the tensors whose ``axis`` is permuted together.  ``outs``
    says how each output combines its records: ``"min"``, ``"count"``
    and ``"overwrite"`` must agree bit for bit in every order, ``"add"``
    within ``tol`` (rtol, atol: f32 re-association).  ``positional``
    outputs follow their records' order (an elementwise kernel) and are
    put back in the first order before they are compared."""
    name: str
    fn: Callable
    plain: Callable
    args: tuple
    records: Tuple[int, ...]
    outs: Tuple[str, ...]
    axis: int = 0
    positional: bool = False
    tol: Tuple[float, float] = (1e-5, 1e-6)


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


MASKED_SCORE = -1e30     # the Pallas kernel's finite mask (_NEG)


def decode_geometry(q, k, v):
    """(B, H, Hkv, S, D, G) of a decode-attention call; raises ValueError
    unless q is (B, H, D), k and v are (B, Hkv, S, D) with S >= 1, and
    H is a multiple of Hkv (G = H / Hkv query heads share a KV head)."""
    if q.dim() != 3 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B, H, D) and (B, Hkv, S, D)")
    b, h, d = q.shape
    _, hkv, s, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or s < 1 or hkv < 1:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if h % hkv:
        raise ValueError(f"decode_attention: {h} query heads are not a "
                         f"multiple of {hkv} KV heads")
    return b, h, hkv, s, d, h // hkv


def decode_attention_ref(q, k, v, lengths, scale=None, block_s: int = 512):
    """One query token per (batch, head) against a KV cache, as the Pallas
    kernel computes it: K and V zero-padded to a multiple of ``block_s``
    positions, positions ``>= lengths[b]`` scored ``MASKED_SCORE``, an
    f32 softmax over the padded positions, the weighted sum of V.  So
    ``length <= 0`` gives the mean of V over the padded length, and
    ``length > S`` counts the padded positions below it with score 0.
    q: (B, H, D); k, v: (B, Hkv, S, D); lengths: (B,) int.  Each group
    of H / Hkv query heads shares one KV head (no copy of K or V per
    head).  Returns (out, lse): out (B, H, D) in q's dtype; lse (B, H)
    f32, each row's log-sum-exp of its scores over the positions below
    its length (the zero-padded ones among them with score 0), -inf
    where the length is <= 0.  Blocks of a cache's positions, each
    called with its own lengths, merge into the call on the whole cache
    by these weights; a block of no position weighs 0, whatever the
    Pallas function's mean of V gives it as output."""
    b, h, hkv, s, d, g = decode_geometry(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s_pad = -(-s // block_s) * block_s
    qf = q.to(torch.float32).reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qf, k.to(torch.float32)) * scale
    scores = torch.cat([scores, scores.new_zeros((b, hkv, g, s_pad - s))], -1)
    pos = torch.arange(s_pad, device=q.device)
    keep = pos[None, :] < lengths.to(q.device)[:, None]
    p = torch.softmax(torch.where(keep[:, None, None, :], scores,
                                  MASKED_SCORE), dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p[..., :s], v.to(torch.float32))
    out = out.reshape(b, h, d).to(q.dtype)
    rows = torch.logsumexp(torch.where(keep[:, None, None, :], scores,
                                       -torch.inf), dim=-1)
    return out, rows.reshape(b, h)
