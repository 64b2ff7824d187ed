"""Shared model building blocks of the dense family (pure functions over
parameter dicts), the port of ``repro/models/layers.py``'s dense subset.

Conventions (the reference's)
-----------------------------
* Params are nested dicts of tensors; layer stacks carry a leading L
  axis (``lm.py`` indexes one layer at a time).
* Weights and activations are bf16; norms, RoPE, softmax and the MLP's
  activation run in f32 and cast back, and every residual add is in the
  activation dtype.  The activation dtype is the embedding's, so f32
  copies of the parameters run the same code in f32.
* Initialisation draws from an explicit ``torch.Generator`` on the
  tensors' device: the reference's shapes, dtypes and scales, not its
  values.

Decode attention is the hand-written kernel: ``attention_decode`` calls
``ops.decode_attention`` (the ``sm_90a`` kernel on a CUDA tensor, its
plain version on a CPU one) on one layer's (B, Hkv, T, D) slice of the
cache, which is laid out (L, B, Hkv, T, D) so that the slice is the
contiguous block the kernel reads.  Prefill and forward attention are
plain matmuls and a masked softmax, as the reference computes them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops

DTYPE = torch.bfloat16
MASKED = -1e30            # the reference's finite mask score


# --------------------------------------------------------------------- init
def dense_init(gen, in_dim: int, out_dim: int, dtype=DTYPE,
               scale: float | None = None):
    scale = scale if scale is not None else (1.0 / in_dim) ** 0.5
    return (torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
            * scale).to(dtype)


def embed_init(gen, vocab: int, dim: int, dtype=DTYPE):
    return (torch.randn((vocab, dim), generator=gen, device=gen.device)
            * 0.02).to(dtype)


# -------------------------------------------------------------------- norms
def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def norm_init(dim: int, with_bias: bool = False, device=None):
    p = {"w": torch.ones((dim,), dtype=torch.float32, device=device)}
    if with_bias:
        p["b"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, x):
    if "b" in p:
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    ang = positions[..., None].float() * freqs             # (..., S, d/2)
    if x.dim() == ang.dim() + 1:                           # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
DEFAULT_Q_CHUNK = 1024   # query-block size for chunked attention: smaller
                         # blocks cap the (B, H, q, T) score transient


def attn_init(gen, cfg) -> Dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    return dict(
        wq=dense_init(gen, d, h * hd),
        wk=dense_init(gen, d, hkv * hd),
        wv=dense_init(gen, d, hkv * hd),
        wo=dense_init(gen, h * hd, d),
        norm=norm_init(d, with_bias=cfg.norm_bias, device=gen.device),
    )


def _attention_scores(q, k, v, mask, q_chunk: int = 0):
    """softmax(q kᵀ / sqrt(d)) v, GQA-aware.

    q: (B, S, H, D); k, v: (B, T, Hkv, D); mask: (B?, S, T) bool or a
    callable giving the (Sq_chunk, T) mask for a query offset (used when
    chunking, so the full S x T mask is never made).
    Returns (B, S, H, D).
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    group = h // hkv
    scale = d ** -0.5
    qg = q.reshape(b, s, hkv, group, d)
    kf = k.float()

    def block(q_blk, mask_blk):
        # q_blk: (B, Sb, Hkv, G, D); mask_blk: (Sb, T) or (B, Sb, T)
        scores = torch.einsum("bskgd,btkd->bkgst", q_blk.float(), kf) * scale
        m = mask_blk if mask_blk.dim() == 3 else mask_blk[None]
        scores = torch.where(m[:, None, None], scores, MASKED)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bkgst,btkd->bskgd", p, v)

    if q_chunk and s > q_chunk:
        out = torch.cat([block(qg[:, i:i + q_chunk], mask(i, min(q_chunk,
                                                                 s - i)))
                         for i in range(0, s, q_chunk)], dim=1)
    else:
        out = block(qg, mask(0, s) if callable(mask) else mask)
    return out.reshape(b, s, h, dv)


def causal_mask(q_off: int, s_q: int, t: int, window: int = 0, device=None):
    """(s_q, t) bool mask; query i at absolute position q_off + i."""
    qpos = q_off + torch.arange(s_q, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def attention(p, x, cfg, positions=None, q_chunk: int = 0,
              bidirectional: bool = False):
    """Self-attention over a full sequence (training / prefill).

    Returns (out, kv) where kv = (k, v), each (B, S, Hkv, D).
    """
    b, s, _ = x.shape
    q_chunk = q_chunk or DEFAULT_Q_CHUNK
    h, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    xn = apply_norm(p["norm"], x)
    q = (xn @ p["wq"]).reshape(b, s, h, hd)
    k = (xn @ p["wk"]).reshape(b, s, hkv, hd)
    v = (xn @ p["wv"]).reshape(b, s, hkv, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if bidirectional:
        def mask_fn(off, sq):
            return torch.ones((sq, s), dtype=torch.bool, device=x.device)
    else:
        def mask_fn(off, sq):
            return causal_mask(off, sq, s, cfg.swa_window, x.device)
    chunk = q_chunk if s > (q_chunk * 2) else 0
    out = _attention_scores(q, k, v, mask_fn, q_chunk=chunk)
    out = out.reshape(b, s, h * hd) @ p["wo"]
    return x + out, (k, v)


def decode_lengths(pos: int, t: int, ring: bool) -> int:
    """Cache positions one decode step attends to, in every row: the
    reference's mask (``layers.py:286-288``) is ``kpos <= pos`` on a
    plain cache (positions past T stay in its last slot) and the whole
    ring buffer on a ring cache (``kpos <= max(pos, T - 1)``), slots not
    yet written included.  Attention does not depend on the slots'
    order, so a length is all the kernel needs."""
    return t if ring else min(pos + 1, t)


def attention_decode(p, x, cache, pos: int, cfg, ring: bool = False):
    """One-token decode.  x: (B, 1, d); cache: dict(k=(B, Hkv, T, D),
    v=...), one layer's contiguous slices of the (L, B, Hkv, T, D) cache;
    pos: the absolute position (an int, shared by every row).  With
    ``ring`` (sliding-window archs) the cache is a ring buffer of size
    window and positions wrap.  Writes the new K/V slot into ``cache``
    in place and returns (out, cache)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    t = cache["k"].shape[2]
    xn = apply_norm(p["norm"], x)
    q = (xn @ p["wq"]).reshape(b, 1, h, hd)
    k = (xn @ p["wk"]).reshape(b, 1, hkv, hd)
    v = (xn @ p["wv"]).reshape(b, 1, hkv, hd)
    if cfg.rope:
        pp = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, pp, cfg.rope_theta)
        k = apply_rope(k, pp, cfg.rope_theta)
    slot = pos % t if ring else min(pos, t - 1)
    cache["k"][:, :, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, :, slot] = v[:, 0].to(cache["v"].dtype)
    lengths = torch.full((b,), decode_lengths(pos, t, ring),
                         dtype=torch.int32, device=x.device)
    out = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                               lengths, scale=hd ** -0.5)
    return x + out.reshape(b, 1, h * hd) @ p["wo"], cache


# ---------------------------------------------------------------------- mlp
def mlp_init(gen, cfg, d_ff: Optional[int] = None) -> Dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p = dict(w_in=dense_init(gen, d, ff), w_out=dense_init(gen, ff, d),
             norm=norm_init(d, with_bias=cfg.norm_bias, device=gen.device))
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = dense_init(gen, d, ff)
    return p


def mlp(p, x, cfg):
    xn = apply_norm(p["norm"], x)
    hmid = xn @ p["w_in"]
    if cfg.mlp_act == "swiglu":
        hmid = F.silu((xn @ p["w_gate"]).float()).to(hmid.dtype) * hmid
    else:
        hmid = F.gelu(hmid.float(), approximate="tanh").to(hmid.dtype)
    return x + hmid @ p["w_out"]
