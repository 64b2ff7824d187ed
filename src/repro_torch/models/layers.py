"""Shared model building blocks (pure functions over parameter dicts), the
port of ``repro/models/layers.py``: the dense family's attention and MLP,
whisper's cross-attention, the routed MoE layer and DeepSeek's
multi-head latent attention (MLA).

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
MLA's decode has no TPU kernel: it stays the reference's f32 einsums
with ``wk_b`` absorbed into the query (its 512 + 64 key width and 128
heads on one latent lie outside ``decode_attention``'s range anyway).

The MoE layer casts where the reference casts, whatever the
activations' dtype: tokens into the dispatch, the SwiGLU product and
the combine weights are bf16 (``layers.py:399``, ``:410``, ``:415``).
Its dense (G, Tg, E, C) dispatch and combine tensors are replaced by
the slot each (token, k) pair lands in: the dispatch copies each kept
pair's token into its slot and the combine gathers each pair's expert
output back.  A token's k experts are distinct and each (expert, slot)
holds at most one token, so every value is the same and only the
combine's sum over k is re-associated.  The sharding hints
(``constrain``, ``wload``, ``TWO_HOP_DISPATCH``) are no-ops without a
mesh and are left out.

The MoE layer is the one place where the batch couples: its dispatch
groups are cut from the tokens of the *global* batch, and its aux loss
is a product of means over all of them.  A sharded train step
(``training/train_step.py``) sets the batch grid for its duration
(``batch_grid``, the counterpart of the reference's launcher-set
``BATCH_AXES``); each rank then routes its own tokens with the global
group's size and capacity, starts each expert's capacity count where
the earlier ranks of its group left off, and sums the aux loss's
statistics over the batch ranks.  Without a grid nothing changes.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.collectives import all_gather
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


def _mm(a, w):
    """``a @ w`` in the two operands' promoted dtype: whisper's encoder
    takes bf16 frames (``encdec._encode``), which jnp's matmul promotes
    against f32 copies of the weights."""
    if a.dtype != w.dtype:
        dt = torch.promote_types(a.dtype, w.dtype)
        a, w = a.to(dt), w.to(dt)
    return a @ w


def attention(p, x, cfg, positions=None, q_chunk: int = 0,
              bidirectional: bool = False):
    """Self-attention over a full sequence (training / prefill).

    Returns (out, kv) where kv = (k, v), each (B, S, Hkv, D).
    """
    b, s, _ = x.shape
    q_chunk = q_chunk or DEFAULT_Q_CHUNK
    h, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    xn = apply_norm(p["norm"], x)
    q = _mm(xn, p["wq"]).reshape(b, s, h, hd)
    k = _mm(xn, p["wk"]).reshape(b, s, hkv, hd)
    v = _mm(xn, p["wv"]).reshape(b, s, hkv, hd)
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


def cross_attention(p, x, enc_kv, cfg):
    """Decoder cross-attention to precomputed encoder (k, v), each (B, T,
    Hkv, D): the query and output projections around the reference's
    plain full-mask attention (no kernel)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    k, v = enc_kv
    xn = apply_norm(p["norm"], x)
    q = _mm(xn, p["wq"]).reshape(b, s, h, hd)
    t = k.shape[1]

    def mask_fn(off, sq):
        return torch.ones((sq, t), dtype=torch.bool, device=x.device)
    out = _attention_scores(q, k, v, mask_fn, q_chunk=0)
    return x + _mm(out.reshape(b, s, h * hd), p["wo"])


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


# ---------------------------------------------------------------------- moe
MOE_GROUP = 2048             # GShard dispatch group size (the reference's)
MOE_CF = 1.25                # expert capacity factor
# (grid, batch axes) of the sharded train step running, else None
BATCH_GRID = None


@contextlib.contextmanager
def batch_grid(grid, axes):
    """The MoE layer's batch grid for the ``with`` block: this rank holds
    its row-major block along ``axes`` of every batch the layer sees."""
    global BATCH_GRID
    prev, BATCH_GRID = BATCH_GRID, (grid, tuple(axes))
    try:
        yield
    finally:
        BATCH_GRID = prev


def _batch_block():
    """(grid, axes, n, r) of the batch grid: ``n`` blocks along the batch
    axes, this rank's ``r`` (grid None, 1, 0 without one)."""
    if BATCH_GRID is None:
        return None, (), 1, 0
    grid, axes = BATCH_GRID
    sizes = dict(zip(grid.names, grid.shape))
    at = dict(zip(grid.names, grid.coords))
    r, n = 0, 1
    for a in axes:
        r, n = r * sizes[a] + at[a], n * sizes[a]
    return grid, axes, n, r


class _BatchSum(torch.autograd.Function):
    """A sum over the batch ranks whose backward is the same sum of their
    cotangents.  Every rank's loss holds the summed statistic, and the
    step averages the ranks' gradients, so each rank's own terms must
    carry the n ranks' cotangents: the mean of the ranks' gradients is
    then the single-device one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _expert_stack(gen, e: int, rows: int, cols: int, scale: float):
    """(e, rows, cols) bf16 drawn one expert at a time, so no more than one
    expert's f32 draw is held (deepseek-v3's stack is 15 GB in f32)."""
    w = torch.empty((e, rows, cols), dtype=DTYPE, device=gen.device)
    for i in range(e):
        w[i] = (torch.randn((rows, cols), generator=gen, device=gen.device)
                * scale).to(DTYPE)
    return w


def moe_init(gen, cfg) -> Dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = dict(router=dense_init(gen, d, e, dtype=torch.float32, scale=0.02),
             w_in=_expert_stack(gen, e, d, ff, (1 / d) ** 0.5),
             w_gate=_expert_stack(gen, e, d, ff, (1 / d) ** 0.5),
             w_out=_expert_stack(gen, e, ff, d, (1 / ff) ** 0.5),
             norm=norm_init(d, with_bias=cfg.norm_bias, device=gen.device))
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg,
                               d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def moe_capacity(k: int, group: int, e: int, capacity_factor: float) -> int:
    """C = ceil(k * group / E * cf), in the reference's float order."""
    return int(math.ceil(k * group / e * capacity_factor))


def moe_route(probs, k: int, cap: int):
    """Top-k routing of (G, Tg, E) router probabilities.

    Returns (gate (G, Tg, k) renormalised, idx (G, Tg, k) the experts,
    pos (G, Tg, k) each pair's place in its expert's capacity, keep).
    ``jax.lax.top_k`` puts the lower index first on a tie; a stable
    descending sort does the same.  ``pos`` counts the earlier pairs
    sent to the same expert in token-major, k-minor order (the
    reference's cumsum); a pair at or past ``cap`` is dropped."""
    e = probs.shape[-1]
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    gate = torch.gather(probs, -1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    with torch.no_grad():
        ng, g_sz = idx.shape[:2]
        flat = idx.reshape(ng, 1, g_sz * k)
        # (G, E, Tg*k): the scan runs along the contiguous last axis
        hot = (flat == torch.arange(e, device=idx.device)[:, None])
        before = torch.cumsum(hot.to(torch.int32), dim=-1) - 1
        pos = torch.gather(before, 1, flat).reshape(ng, g_sz, k).long()
    return gate, idx, pos, pos < cap


def _emm(a, w):
    """(E, N, i) @ (E, i, o) in the two operands' promoted dtype (jnp's
    einsum promotes a bf16 and an f32 operand to f32)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.bmm(a.to(dt), w.to(dt))


def moe(p, x, cfg, group_size: int = 0, capacity_factor: float = 0.0):
    """Top-k routed MoE, GShard-style grouped capacity dispatch: tokens in
    groups of ``group_size``; in each group every expert takes at most
    C = ceil(k * group / E * cf) (token, k) pairs, the rest dropped.
    Returns (out, aux_loss), aux the switch-style load-balance loss."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    group_size = group_size or MOE_GROUP
    capacity_factor = capacity_factor or MOE_CF
    xn = apply_norm(p["norm"], x)
    # under a batch grid, this rank's tokens are block r of n of the
    # global batch's; groups are cut from the global batch
    grid, axes, n, r = _batch_block()
    t_loc = b * s
    t_total = n * t_loc
    g_sz = min(group_size, t_total)
    # this rank's tokens in pieces of one group each: whole groups, or
    # its whole block as a part of one group
    piece = min(g_sz, t_loc)
    if t_loc % piece or g_sz % piece:
        raise ValueError(f"MoE groups of {g_sz} tokens straddle a rank's "
                         f"{t_loc}: neither divides the other")
    ng = t_loc // piece
    xg = xn.reshape(ng, piece, d)

    logits = xg.float() @ p["router"].float()                 # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    cap = moe_capacity(k, g_sz, e, capacity_factor)
    gate, idx, pos, keep = moe_route(probs, k, cap)

    # aux load-balance loss (switch-style): E * sum(density * mean prob),
    # both means over every token of the global batch
    # the one-hot by comparison: ``F.one_hot``'s range check is a host
    # sync on the card
    onehot = idx[..., None] == torch.arange(e, device=x.device)
    counts = onehot.sum(dim=(0, 1, 2))                 # (E,) pairs each
    prob_sum = probs.sum(dim=(0, 1))
    if grid is not None:
        every = all_gather(counts[None], axes, grid=grid)    # (n, E)
        counts = every.sum(0)
        prob_sum = _BatchSum.apply(prob_sum, grid.group(axes))
        if piece < g_sz:
            # the group's earlier ranks fill each expert's capacity
            # first: this rank's positions start past their pairs
            first = r - r % (g_sz // piece)
            offset = every[first:r].sum(0)
            keep = (pos + offset[idx]) < cap
    aux = torch.sum(counts.float() / t_total * (prob_sum / t_total)) * e

    # slots laid out (E, G, C): expert e's capacity buffers of every group
    # are one (G * C, d) operand of its matmuls; a dropped pair goes to
    # the spare row past the end, which is cut off
    n_slots = e * ng * cap
    with torch.no_grad():
        gi = torch.arange(ng, device=x.device)[:, None, None]
        slot = torch.where(keep, (idx * ng + gi) * cap + pos,
                           n_slots).reshape(-1)
    # dispatch: each (token, k) pair's token rounded to bf16
    # (``xg.astype(DTYPE)``) and copied into its slot.  The copies run in
    # f32, so that the backward sums a token's k slots in f32 (the sum
    # over k of ``expand``'s backward) and rounds once, as the
    # reference's bf16 dispatch product does
    xb = xg.reshape(t_loc, 1, d).to(DTYPE).float()
    pairs = xb.expand(t_loc, k, d).reshape(t_loc * k, d)
    xe = pairs.new_zeros((n_slots + 1, d)).index_copy(0, slot, pairs)
    xe = xe[:n_slots].to(DTYPE).reshape(e, ng * cap, d)
    hin = _emm(xe, p["w_in"])
    hg = _emm(xe, p["w_gate"])
    hmid = F.silu(hg.float()).to(DTYPE) * hin
    oe = _emm(hmid, p["w_out"])                               # (E, G*C, d)
    # combine: the kept pairs' outputs weighted by their bf16 gates (a
    # dropped pair reads the zero row past the end)
    ob = torch.cat([oe.reshape(n_slots, d), oe.new_zeros((1, d))])
    w = gate.to(DTYPE)
    w = w.to(torch.promote_types(w.dtype, oe.dtype))
    picked = ob.index_select(0, slot).reshape(ng, piece, k, d)
    out = torch.einsum("gtk,gtkd->gtd", w, picked)
    out = out.reshape(b, s, d)
    if "shared" in p:
        out = out + (mlp(p["shared"], x, cfg) - x)
    return x + out, aux


# ---------------------------------------------------------------------- mla
def mla_init(gen, cfg) -> Dict:
    """DeepSeek-V3 multi-head latent attention."""
    d, h = cfg.d_model, cfg.n_heads
    dq, dc = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = gen.device
    return dict(
        wq_a=dense_init(gen, d, dq),
        q_norm=norm_init(dq, device=dev),
        wq_b=dense_init(gen, dq, h * (dn + dr)),
        wkv_a=dense_init(gen, d, dc + dr),
        kv_norm=norm_init(dc, device=dev),
        wk_b=dense_init(gen, dc, h * dn),
        wv_b=dense_init(gen, dc, h * dv),
        wo=dense_init(gen, h * dv, d),
        norm=norm_init(d, with_bias=cfg.norm_bias, device=dev),
    )


def mla_attention(p, x, cfg, positions=None, q_chunk: int = 0):
    """MLA over a full sequence.  Returns (out, (c_kv (B, S, dc), k_rope
    (B, S, dr))): the latent cache.  As in the reference, the cached
    k_rope is the projection before RoPE, where decode caches it after."""
    b, s, _ = x.shape
    q_chunk = q_chunk or DEFAULT_Q_CHUNK
    h = cfg.n_heads
    dn, dr, dv, dc = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                      cfg.kv_lora_rank)
    xn = apply_norm(p["norm"], x)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = apply_norm(p["q_norm"], xn @ p["wq_a"]) @ p["wq_b"]
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = xn @ p["wkv_a"]                                  # (B, S, dc+dr)
    c_kv = apply_norm(p["kv_norm"], kv[..., :dc])
    k_rope = apply_rope(kv[..., dc:], positions, cfg.rope_theta)
    k_nope = (c_kv @ p["wk_b"]).reshape(b, s, h, dn)
    v = (c_kv @ p["wv_b"]).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)

    def mask_fn(off, sq):
        return causal_mask(off, sq, s, cfg.swa_window, x.device)
    chunk = q_chunk if s > (q_chunk * 2) else 0
    out = _attention_scores(qq, k, v, mask_fn, q_chunk=chunk)
    out = out.reshape(b, s, h * dv) @ p["wo"]
    return x + out, (c_kv, kv[..., dc:])


def mla_decode(p, x, cache, pos: int, cfg):
    """One-token MLA decode against the latent cache, dict(c=(B, T, dc),
    kr=(B, T, dr)): one layer's slices of the (L, B, T, r) cache, written
    in place at slot ``min(pos, T - 1)``.  ``wk_b`` is absorbed into the
    query (scores against the latent itself) and ``wv_b`` applied after
    the context, all in f32.  Returns (out, cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv, dc = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                      cfg.kv_lora_rank)
    t = cache["c"].shape[1]
    xn = apply_norm(p["norm"], x)
    q = apply_norm(p["q_norm"], xn @ p["wq_a"]) @ p["wq_b"]
    q = q.reshape(b, 1, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    pp = torch.full((b, 1), pos, device=x.device)
    q_rope = apply_rope(q_rope, pp, cfg.rope_theta)

    kv = xn @ p["wkv_a"]
    c_new = apply_norm(p["kv_norm"], kv[..., :dc])
    kr_new = apply_rope(kv[..., dc:], pp, cfg.rope_theta)
    slot = min(pos, t - 1)
    cache["c"][:, slot] = c_new[:, 0].to(cache["c"].dtype)
    cache["kr"][:, slot] = kr_new[:, 0].to(cache["kr"].dtype)
    cc, ckr = cache["c"].float(), cache["kr"].float()
    wkb = p["wk_b"].reshape(dc, h, dn).float()
    q_eff = torch.einsum("bhn,chn->bhc", q_nope[:, 0].float(), wkb)
    scale = (dn + dr) ** -0.5
    scores = (torch.einsum("bhc,btc->bht", q_eff, cc)
              + torch.einsum("bhr,btr->bht", q_rope[:, 0].float(), ckr)) \
        * scale
    valid = torch.arange(t, device=x.device)[None, None, :] <= pos
    scores = torch.where(valid, scores, MASKED)
    pr = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,btc->bhc", pr, cc)                # (B, h, dc)
    wvb = p["wv_b"].reshape(dc, h, dv).float()
    out = torch.einsum("bhc,chv->bhv", ctx, wvb)
    out = out.reshape(b, 1, h * dv).to(x.dtype) @ p["wo"]
    return x + out, cache
