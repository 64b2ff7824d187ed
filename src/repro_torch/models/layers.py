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

Tensor-parallel compute over ``model`` (the dense family under a sharded
step, ``model_grid``): ``attention``, ``attention_decode`` and ``mlp``
take this rank's ``model`` blocks of their weights, as the rules cut them
(the reference's ``wload`` keeps that cut at use).  Megatron's pattern:
the normed input enters the region (*f*, ``core.collectives.
copy_to_region``: identity forward, all-reduce backward), a column
weight gives the rank's output columns, a row weight takes the rank's
slice of its input, and the partial products are summed over ``model``
(*g*, ``reduce_from_region``) before the residual add.  The rules cut
columns, not heads: where a rank's block of ``wq`` (or ``wk`` / ``wv``)
is not whole heads, the training and prefill attention all-gathers the
weight over ``model`` (``gather_from_region``, a reduce-scatter
backward) and computes every query head (or the KV heads its query
heads read).  Decode runs the kernel on the rank's block of the cache:
its KV heads, or (its projections' output columns gathered) its block
of positions for every head, the blocks' outputs merged by the
log-sum-exp ``ops.decode_attention`` returns beside them.  Without a
grid (``LOCAL``, one device) every such collective is the identity and
the same bodies compute on whole weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.collectives import (all_gather, copy_to_region,
                                gather_from_region, max_over,
                                reduce_from_region)
from ..kernels import ops

DTYPE = torch.bfloat16
MASKED = -1e30            # the reference's finite mask score


# ------------------------------------------- tensor-parallel compute grid
KV_CUTS = ("heads", "positions", "whole")


@dataclasses.dataclass(frozen=True)
class ModelBlock:
    """Tensor-parallel compute over a grid's ``model`` axis: ``m`` ranks,
    this one ``r``; ``kv_cut`` what a rank holds of a decode cache: its
    1/m of the KV heads (``heads``, all of them at m 1), its 1/m of the
    positions for every head (``positions``), or the whole cache
    (``whole``).  ``LOCAL`` (no grid) is one device."""

    grid: Any
    m: int
    r: int
    kv_cut: str = "heads"

    def t_global(self, t: int) -> int:
        """The positions of a decode cache whose block here holds ``t``."""
        return t * self.m if self.kv_cut == "positions" else t


LOCAL = ModelBlock(None, 1, 0)
# the ModelBlock of the sharded step running, else LOCAL
MODEL_GRID: ModelBlock = LOCAL


@contextlib.contextmanager
def model_grid(grid, kv_cut: str = "heads"):
    """The dense layers compute on this rank's ``model`` blocks of their
    weights for the ``with`` block (``attention``, ``attention_decode``,
    ``mlp``; ``lm.py``'s embedding, head and loss): a column weight
    (``wq``, ``wk``, ``wv``, ``w_in``, ``w_gate``) is this rank's output
    columns, a row weight (``wo``, ``w_out``) its input rows, and
    ``tok_emb`` / ``lm_head`` its vocab rows, as ``launch/shardings.py``
    cuts them; the activations between blocks stay whole on every rank.
    ``kv_cut`` is the decode cache's cut (``launch.shardings.kv_cut``).
    Independent of ``batch_grid``."""
    global MODEL_GRID
    if kv_cut not in KV_CUTS:
        raise ValueError(f"kv_cut {kv_cut!r}: one of {KV_CUTS}")
    sizes = dict(zip(grid.names, grid.shape))
    at = dict(zip(grid.names, grid.coords or (0,) * len(grid.names)))
    prev = MODEL_GRID
    MODEL_GRID = ModelBlock(grid, int(sizes["model"]), int(at["model"]),
                            kv_cut)
    try:
        yield
    finally:
        MODEL_GRID = prev


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


# ------------------------------------------- a layer's model blocks
def _block_of(w, dim: int, full: int, tp: ModelBlock, what: str) -> None:
    """Raise unless ``w``'s ``dim`` is this rank's 1/m of ``full``."""
    if w.shape[dim] * tp.m != full:
        raise ValueError(f"{what}: dim {dim} of {tuple(w.shape)} is not a "
                         f"1/{tp.m} block of {full} (the rules must cut it "
                         f"over 'model')")


def _whole_heads(w, n: int, hd: int, tp: ModelBlock):
    """The first head of this rank's output columns of a (d, n * hd)
    column weight where they are whole heads of a cut, else None (a
    block that splits a head, or a weight the rules left whole)."""
    cols = w.shape[-1]
    if cols == n * hd and tp.m > 1:
        return None
    _block_of(w, -1, n * hd, tp, "a column weight")
    return tp.r * (cols // hd) if cols % hd == 0 else None


def _every_column(w, n_cols: int, tp: ModelBlock):
    """A column weight with all its columns, its gradient summed over
    ``model``: the all-gather of this rank's block (its backward a
    reduce-scatter), or a weight the rules left whole entering the
    region (Megatron's *f*: each rank's share of the work gives it a
    part of the gradient)."""
    if w.shape[-1] == n_cols:
        return copy_to_region(w, "model", grid=tp.grid)
    return gather_from_region(w, w.dim() - 1, "model", grid=tp.grid)


def _kv_for(k, v, h0: int, hl: int, kv0: int, group: int):
    """The K / V heads query heads [h0, h0 + hl) read (head h reads KV
    head h // group; ``k`` holds KV heads from ``kv0``), as (k, v) whose
    heads group the local query heads in order: the KV heads' range
    where it does, else one KV head a query head."""
    lo, hi = h0 // group - kv0, (h0 + hl - 1) // group + 1 - kv0
    k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    want = [(h0 + j) // group - (kv0 + lo) for j in range(hl)]
    n = hi - lo
    if hl % n == 0 and want == [j // (hl // n) for j in range(hl)]:
        return k, v
    idx = torch.tensor(want, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _own_rows(out, h0: int, hd: int, rows: int, tp: ModelBlock):
    """This rank's rows of the row weight ``wo`` of an attention output
    whose columns are heads from ``h0``: columns [r * rows, (r + 1) *
    rows) of the whole output."""
    lo = tp.r * rows - h0 * hd
    return out if lo == 0 and out.shape[-1] == rows else \
        out[..., lo:lo + rows]


def _every_output(x, w, n_cols: int, tp: ModelBlock):
    """``x @ w`` with all ``n_cols`` output columns of a column weight:
    this rank's columns of it gathered over ``model`` (every rank's
    block of the output in order, exact whether or not a block splits a
    head), or the product itself where the rules left ``w`` whole."""
    y = x @ w
    if w.shape[-1] == n_cols:
        return y
    return gather_from_region(y, y.dim() - 1, "model", grid=tp.grid)


def _merge_positions(out, lse, tp: ModelBlock):
    """The decode attention of the whole cache from each rank's over its
    block of positions: the partial outputs weighted by exp(lse - max)
    over ``model``, in f32 (a block of no position has lse -inf and
    weighs 0).  One all-reduce of the max, one of the weighted sums and
    the weights."""
    mx = max_over(lse, "model", grid=tp.grid)
    w = torch.exp(lse - mx)                                  # (B, H)
    b, h, d = out.shape
    both = torch.cat([(out.float() * w[..., None]).reshape(b, h * d), w],
                     dim=-1)
    both = reduce_from_region(both, "model", grid=tp.grid)
    num, den = both[:, :h * d].reshape(b, h, d), both[:, h * d:]
    return (num / den[..., None]).to(out.dtype)


def attention(p, x, cfg, positions=None, q_chunk: int = 0,
              bidirectional: bool = False):
    """Self-attention over a full sequence (training / prefill).

    On this rank's ``model`` blocks (``MODEL_GRID``): the normed input
    enters the region once (*f*); the query heads are this rank's column
    block of ``wq`` where it holds whole heads, else all of them from
    ``wq`` gathered over ``model`` (starcoder2-3b's 24 heads over 16);
    the K / V heads those read are this rank's block of ``wk`` / ``wv``
    where it is exactly them (the heads-cut case, deepseek-7b), else
    every KV head from ``wk`` / ``wv`` gathered over ``model``.  The
    rank's rows of the output meet its row block of ``wo`` and the
    partial products are summed over ``model`` (*g*) before the residual
    add.

    Returns (out, kv) where kv = (k, v), each (B, S, Hkv', D): the rank's
    KV heads where they are its ``wk`` block, else every KV head.
    """
    tp = MODEL_GRID
    b, s, _ = x.shape
    q_chunk = q_chunk or DEFAULT_Q_CHUNK
    h, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    group = h // hkv
    _block_of(p["wo"], 0, h * hd, tp, "wo")
    xn = apply_norm(p["norm"], x)
    xi = copy_to_region(xn, "model", grid=tp.grid)
    h0 = _whole_heads(p["wq"], h, hd, tp)
    if h0 is None:                    # a block that splits a head
        h0, wq = 0, _every_column(p["wq"], h * hd, tp)
    else:
        wq = p["wq"]
    q = _mm(xi, wq).reshape(b, s, -1, hd)
    hl = q.shape[2]
    kv0 = _whole_heads(p["wk"], hkv, hd, tp)
    if kv0 is not None and kv0 == h0 // group \
            and p["wk"].shape[-1] == hl // group * hd:
        wk, wv = p["wk"], p["wv"]
    else:                             # every KV head, gathered
        kv0 = 0
        wk = _every_column(p["wk"], hkv * hd, tp)
        wv = _every_column(p["wv"], hkv * hd, tp)
    k = _mm(xi, wk).reshape(b, s, -1, hd)
    v = _mm(xi, wv).reshape(b, s, -1, hd)
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
    kq, vq = _kv_for(k, v, h0, hl, kv0, group)
    chunk = q_chunk if s > (q_chunk * 2) else 0
    out = _attention_scores(q, kq, vq, mask_fn, q_chunk=chunk)
    out = _own_rows(out.reshape(b, s, hl * hd), h0, hd, p["wo"].shape[0],
                    tp)
    out = reduce_from_region(out @ p["wo"], "model", grid=tp.grid)
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
    """One-token decode.  x: (B, 1, d); cache: dict(k=(B, Hkv', T', D),
    v=...), one layer's contiguous slices of the (L, B, Hkv', T', D)
    cache, this rank's block of it as ``MODEL_GRID.kv_cut`` says; pos:
    the absolute position (an int, shared by every row).  With ``ring``
    (sliding-window archs) the cache is a ring buffer of size window and
    positions wrap.  Writes the new K/V slot into ``cache`` in place and
    returns (out, cache).  On this rank's ``model`` blocks:
      * ``heads`` (the rank holds (B, Hkv / m, T, D), the reference's
        placement where m divides Hkv; one device's whole cache): its
        query heads, its ``wk`` / ``wv`` block's new K / V written into
        its heads, the kernel on that contiguous slice.
      * ``positions`` (every KV head of its T / m positions) or
        ``whole``: each projection's output columns gathered over
        ``model`` (B x H x D, a few KB; exact where a block splits a
        head), the new K / V of every head written only by the rank
        whose block holds the slot, the kernel on the block with its
        local lengths (the plain cache's clamp(pos + 1 - r T / m, 0,
        T / m), a ring's whole block) and, cut on positions, the blocks'
        results merged over ``model`` by their log-sum-exp.
    Either way the rank's rows of the output meet its row block of
    ``wo`` and are summed over ``model``."""
    tp = MODEL_GRID
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    rows = p["wo"].shape[0]
    _block_of(p["wo"], 0, h * hd, tp, "wo")
    t_loc = cache["k"].shape[2]
    xn = apply_norm(p["norm"], x)
    if tp.kv_cut == "heads":
        _block_of(cache["k"], 1, hkv, tp, "the heads-cut cache")
        if _whole_heads(p["wk"], hkv, hd, tp) is None:
            raise ValueError("a heads-cut cache needs wk cut on whole "
                             "heads")
        q = (xn @ p["wq"]).reshape(b, 1, -1, hd)
        k = (xn @ p["wk"]).reshape(b, 1, -1, hd)
        v = (xn @ p["wv"]).reshape(b, 1, -1, hd)
        h0, t0 = tp.r * q.shape[2], 0
    else:                             # every head's columns, gathered
        q = _every_output(xn, p["wq"], h * hd, tp).reshape(b, 1, h, hd)
        k = _every_output(xn, p["wk"], hkv * hd, tp).reshape(b, 1, hkv, hd)
        v = _every_output(xn, p["wv"], hkv * hd, tp).reshape(b, 1, hkv, hd)
        h0 = 0
        t0 = tp.r * t_loc if tp.kv_cut == "positions" else 0
    if cfg.rope:
        pp = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, pp, cfg.rope_theta)
        k = apply_rope(k, pp, cfg.rope_theta)
    t = tp.t_global(t_loc)
    slot = (pos % t if ring else min(pos, t - 1)) - t0
    if 0 <= slot < t_loc:
        cache["k"][:, :, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, :, slot] = v[:, 0].to(cache["v"].dtype)
    n = min(max(decode_lengths(pos, t, ring) - t0, 0), t_loc)
    lengths = torch.full((b,), n, dtype=torch.int32, device=x.device)
    out, lse = ops.decode_attention(q[:, 0].contiguous(), cache["k"],
                                    cache["v"], lengths, scale=hd ** -0.5)
    if tp.kv_cut == "positions":
        out = _merge_positions(out, lse, tp)
    out = _own_rows(out.reshape(b, 1, -1), h0, hd, rows, tp)
    out = reduce_from_region(out @ p["wo"], "model", grid=tp.grid)
    return x + out, cache


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
    """The MLP; on this rank's column blocks of ``w_in`` / ``w_gate`` and
    row block of ``w_out`` (``MODEL_GRID``): the normed input enters the
    region (*f*), the partial products are summed over ``model`` (*g*)."""
    tp = MODEL_GRID
    _block_of(p["w_out"], 0, p["w_in"].shape[-1] * tp.m, tp, "w_out")
    xn = apply_norm(p["norm"], x)
    xi = copy_to_region(xn, "model", grid=tp.grid)
    hmid = xi @ p["w_in"]
    if cfg.mlp_act == "swiglu":
        hmid = F.silu((xi @ p["w_gate"]).float()).to(hmid.dtype) * hmid
    else:
        hmid = F.gelu(hmid.float(), approximate="tanh").to(hmid.dtype)
    return x + reduce_from_region(hmid @ p["w_out"], "model", grid=tp.grid)


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
