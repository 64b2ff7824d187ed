"""Decoder-only LM assembly: the port of ``repro/models/lm.py``.

  dense   - GQA/SWA attention + MLP      (starcoder2, deepseek-7b,
                                          h2o-danube, the pixtral backbone)
  moe     - attention + top-k routed MoE (granite-moe)
  mla_moe - MLA attention, leading dense layers, MoE with a shared
            expert, and the MTP head     (deepseek-v3)
  xlstm   - groups of mLSTMs and one sLSTM (xlstm-1.3b)
  hybrid  - Mamba2 + one shared attention block every k layers
                                         (zamba2-1.2b)

(whisper's encoder-decoder family is ``encdec.py``.)

The family protocol (the reference's, with the port's generator and
device):
  init(cfg, gen, device=None) -> params
  forward(params, batch, cfg) -> (logits, aux_loss)
  prefill(params, batch, cfg) -> (logits, cache)
  decode(params, cache, tokens, pos, cfg) -> (logits, cache)
  init_cache(cfg, batch, cache_len, device=None) -> cache (zeros)

Parameters carry the reference's keys, with the layers stacked on a
leading L axis, so that ``convert.lm_params_from_numpy`` carries them
across without a rename; the layers run one at a time in a Python loop.
The dense and moe caches are dict(k, v), each (L, B, Hkv, T, D): one
layer's slice is the contiguous (B, Hkv, T, D) block
``ops.decode_attention`` reads (the reference keeps (L, B, T, Hkv, D);
``convert.lm_cache_from_numpy`` transposes).  The mla_moe cache is the
reference's latent one, dict(dc, dkr, mc, mkr) of (L, B, T, r) (no
kernel reads it).  The hybrid cache is dict(ssm (L, B, H, P, N) f32,
conv (L, B, CONV_W - 1, di), shared=dict(k, v)), the shared block's
k / v (n_shared, B, Hkv, T, D) as the dense cache's; the xlstm cache is
the reference's tuple ((C, n, m), (h, c, n, m)) of f32 states, the
mLSTMs' (G, M, B, ...), the sLSTMs' (G, B, ...).  Decode updates the
cache in place and returns it.
Prefill and decode run under ``torch.inference_mode()``; forward does
not, so that training can take its gradient.

Training (``lm_loss`` and ``dense_forward`` under autograd): each block
runs under ``torch.utils.checkpoint`` when grad is enabled, the
counterpart of the reference's ``jax.checkpoint(...,
policy=nothing_saveable)``: only the blocks' inputs are kept, and each
block is run again in the backward.  The blocks hold no randomness, so
the gradients are the same bits with and without it.  Forward takes the
stacked leaves apart once (``unstack``: one ``unbind`` a leaf, whose
backward is one ``stack``); indexing ``v[i]`` once a layer would make,
in the backward, a zero gradient of the whole (L, ...) stack for every
layer.  The stacked tensors stay the parameters, so an optimizer sees
the reference's leaves and shapes.

Tensor parallel (``layers.model_grid``, the dense family under a sharded
step; ``TP_LEAVES`` names its leaves): ``tok_emb`` and ``lm_head`` are
this rank's vocab rows.  The embedding looks up the tokens in the
rank's range (zeros elsewhere) and sums over ``model``; the head gives
the rank's vocab columns of the logits; ``lm_loss`` is a vocab-parallel
cross-entropy (the max, the sum of exponentials and the true logit
summed over ``model``); a served step all-gathers the logits.  The
reference's model never calls ``proxy_embedding_grad``: the embedding's
gradient is the masked lookup's own.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as device_mod
from ..core.collectives import (copy_to_region, gather_from_region,
                                max_over, reduce_from_region)
from . import layers
from . import ssm as ssm_mod
from . import xlstm as xl_mod
from .layers import (DTYPE, apply_norm, attention, attention_decode,
                     attn_init, dense_init, embed_init, mla_attention,
                     mla_decode, mla_init, mlp, mlp_init, moe, moe_init,
                     norm_init)


# ------------------------------------------------------------------ shared
def _embed_in(params, batch, cfg):
    """The input embeddings: the lookup of the tokens in this rank's
    vocab rows of ``tok_emb`` (all of them on one device; under
    ``layers.model_grid`` its block), zeros elsewhere, summed over
    ``model``."""
    if isinstance(batch, dict) and "embeds" in batch:
        return batch["embeds"].to(DTYPE)
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    tp = layers.MODEL_GRID
    emb = params["tok_emb"]
    rows = emb.shape[0]
    ids = tokens.long() - tp.r * rows
    own = (ids >= 0) & (ids < rows)
    x = emb[ids.clamp(0, rows - 1)]
    x = torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return reduce_from_region(x, "model", grid=tp.grid)


def _head(params, x, cfg):
    """The logits of this rank's vocab columns (B, S, V / m; all of them
    on one device), the normed input entering the region (*f*)."""
    x = apply_norm(params["final_norm"], x)
    x = copy_to_region(x, "model", grid=layers.MODEL_GRID.grid)
    return torch.einsum("bsd,vd->bsv", x, params["lm_head"])


def _whole_vocab(logits):
    """Logits over the whole vocab: every rank's columns all-gathered
    over ``model`` (a served step samples from them)."""
    return gather_from_region(logits, logits.dim() - 1, "model",
                              grid=layers.MODEL_GRID.grid)


class _VocabParallelCE(torch.autograd.Function):
    """Each token's cross-entropy from this rank's vocab columns ``lf``
    (f32, B, S, V / m, those at or past the vocab already masked): the
    max all-reduced over ``model``, the sum of exponentials and the true
    logit (from the rank holding the label's column, zeros elsewhere)
    summed over it.  The backward is ``logsumexp``'s and the label
    ``gather``'s on the rank's columns."""

    @staticmethod
    def forward(ctx, lf, labels, lo, grid):
        cols = lf.shape[-1]
        mx = max_over(torch.amax(lf, dim=-1), "model", grid=grid)
        se = reduce_from_region(torch.sum(torch.exp(lf - mx[..., None]), -1),
                                "model", grid=grid)
        lse = torch.log(se) + mx
        lab = labels.long() - lo
        own = (lab >= 0) & (lab < cols)
        idx = lab.clamp(0, cols - 1)[..., None]
        true = torch.where(own, torch.gather(lf, -1, idx)[..., 0], 0.0)
        true = reduce_from_region(true, "model", grid=grid)
        ctx.save_for_backward(lf, lse, idx, own)
        return lse - true

    @staticmethod
    def backward(ctx, g):
        lf, lse, idx, own = ctx.saved_tensors
        grad = g[..., None] * torch.exp(lf - lse[..., None])
        grad.scatter_add_(-1, idx, torch.where(own, -g, 0.0)[..., None])
        return grad, None, None, None


def lm_loss(logits, labels, cfg, aux=0.0):
    """Mean cross-entropy in f32 over the (padded) logits, plus
    ``cfg.moe_aux_weight * aux``.  Columns at or past ``cfg.vocab`` are
    masked to -1e30 before the logsumexp, as the reference masks them.
    The true logit is a ``gather`` of the label's column: the
    reference's iota-compare masked sum adds that one value to zeros,
    so both give the same number.  The logits are this rank's vocab
    columns (all of them on one device) and the cross-entropy is
    vocab-parallel over ``model`` (``_VocabParallelCE``); a group of one
    rank computes ``logsumexp`` minus the true logit, bit for bit."""
    tp = layers.MODEL_GRID
    lf = logits.float()
    cols = lf.shape[-1]
    lo = tp.r * cols
    if lo + cols > cfg.vocab:         # this rank holds padding columns
        vids = lo + torch.arange(cols, device=lf.device)
        lf = torch.where(vids < cfg.vocab, lf, -1e30)
    ce = torch.mean(_VocabParallelCE.apply(lf, labels, lo, tp.grid))
    return ce + cfg.moe_aux_weight * aux


def _base_init(cfg, gen):
    p = dict(final_norm=norm_init(cfg.d_model, with_bias=cfg.norm_bias,
                                  device=gen.device),
             lm_head=embed_init(gen, cfg.vocab_pad, cfg.d_model))
    # every family of this module keeps the token embedding (the
    # reference's rule, ``lm.py:71-73``)
    p["tok_emb"] = embed_init(gen, cfg.vocab_pad, cfg.d_model)
    return p


def _stack(layer_fn, n: int):
    """``layer_fn()``'s dict of tensors, drawn ``n`` times and stacked on
    a leading axis; each draw is written into the stack as it is made,
    so no more than one layer's draws are held beside it (a stack of one
    is the draw itself, viewed with the axis added)."""
    first = layer_fn()
    if n == 1:
        return _tree_map(lambda t: t[None], first)

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, layer_fn(), i)
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer(stack, i: int):
    """Layer ``i`` of a stacked parameter dict (views, no copy)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def unstack(stack, n: int) -> list:
    """Every layer of a stacked parameter dict, each leaf taken apart by
    one ``unbind`` (views, no copy; under autograd one ``stack`` in the
    backward, where ``layer`` would add a zero (L, ...) gradient a
    layer)."""
    def parts(t):
        if isinstance(t, dict):
            return {k: parts(v) for k, v in t.items()}
        return torch.unbind(t, 0)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]

    cut = parts(stack)
    return [pick(cut, i) for i in range(n)]


def _check_generator(gen, device, who: str) -> None:
    dev = device_mod.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"{who}: a generator on {gen.device} cannot draw "
                         f"parameters on {dev}")


def _remat(fn, *args):
    """``fn(*args)``, under ``checkpoint`` when grad is enabled (the
    reference's ``jax.checkpoint(..., policy=nothing_saveable)``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ======================================================================
# dense
# ======================================================================
def dense_init_params(cfg, gen, device=None):
    """The dense family's parameters on ``device`` (the card unless
    ``"cpu"`` is asked for), drawn from ``gen``, a ``torch.Generator``
    on that device.  Layer by layer on the device: a full-width stack
    is never drawn in f32 at once."""
    _check_generator(gen, device, "dense_init_params")
    with torch.no_grad():
        p = _base_init(cfg, gen)
        p["layers"] = _stack(lambda: dict(attn=attn_init(gen, cfg),
                                          mlp=mlp_init(gen, cfg)),
                             cfg.n_layers)
    return p


def _dense_block(lp, x, cfg, positions):
    x, kv = attention(lp["attn"], x, cfg, positions)
    x = mlp(lp["mlp"], x, cfg)
    return x, kv


def _block_out(lp, x, cfg, positions):
    return _dense_block(lp, x, cfg, positions)[0]


def dense_forward(params, batch, cfg):
    """(logits, aux); under grad each block runs under ``checkpoint``
    (the reference's remat)."""
    x = _embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in unstack(params["layers"], cfg.n_layers):
        x = _remat(_block_out, lp, x, cfg, positions)
    return _head(params, x, cfg), 0.0


@torch.inference_mode()
def dense_prefill(params, batch, cfg):
    """(logits of the last position, cache); under ``layers.model_grid``
    the cache holds the KV heads each layer's attention returns (this
    rank's where ``wk`` is cut on its heads, else every head) and the
    logits are all-gathered over ``model``."""
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    cache = {}
    for i in range(cfg.n_layers):
        x, (k, v) = _dense_block(layer(params["layers"], i), x, cfg,
                                 positions)
        if not cache:
            shape = (cfg.n_layers, b, k.shape[2], s, cfg.head_dim)
            cache = dict(k=torch.empty(shape, dtype=x.dtype,
                                       device=x.device),
                         v=torch.empty(shape, dtype=x.dtype,
                                       device=x.device))
        cache["k"][i] = k.transpose(1, 2)
        cache["v"][i] = v.transpose(1, 2)
    logits = _whole_vocab(_head(params, x[:, -1:], cfg))
    return logits, cache


@torch.inference_mode()
def dense_decode(params, cache, tokens, pos: int, cfg):
    """One step; under ``layers.model_grid`` on this rank's blocks of the
    weights and of the cache (as its ``kv_cut`` says), the logits
    all-gathered over ``model``."""
    x = _embed_in(params, dict(tokens=tokens), cfg)
    t = layers.MODEL_GRID.t_global(cache["k"].shape[3])
    ring = cfg.swa_window > 0 and t == cfg.swa_window
    pos = int(pos)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        x, _ = attention_decode(lp["attn"], x,
                                dict(k=cache["k"][i], v=cache["v"][i]),
                                pos, cfg, ring=ring)
        x = mlp(lp["mlp"], x, cfg)
    return _whole_vocab(_head(params, x, cfg))[:, 0], cache


def dense_init_cache(cfg, batch, cache_len, device=None):
    """Zeros, (L, B, Hkv, T, D) bf16 each of k and v; ``device="meta"``
    sizes it without memory (``serving.kvcache.plan_cache``)."""
    t = cache_len if not cfg.swa_window else min(cache_len, cfg.swa_window)
    shape = (cfg.n_layers, batch, cfg.n_kv, t, cfg.head_dim)
    dev = device_mod.resolve(device)
    return dict(k=torch.zeros(shape, dtype=DTYPE, device=dev),
                v=torch.zeros(shape, dtype=DTYPE, device=dev))


# ======================================================================
# moe (dense attention + routed MoE mlp)
# ======================================================================
def moe_init_params(cfg, gen, device=None):
    _check_generator(gen, device, "moe_init_params")
    with torch.no_grad():
        p = _base_init(cfg, gen)
        p["layers"] = _stack(lambda: dict(attn=attn_init(gen, cfg),
                                          moe=moe_init(gen, cfg)),
                             cfg.n_layers)
    return p


def _moe_block(lp, x, cfg, positions):
    x, kv = attention(lp["attn"], x, cfg, positions)
    x, aux = moe(lp["moe"], x, cfg)
    return x, aux, kv


def _moe_block_out(lp, x, cfg, positions):
    return _moe_block(lp, x, cfg, positions)[:2]


def moe_forward(params, batch, cfg):
    """(logits, aux), aux the layers' load-balance losses summed and
    divided by ``n_layers``."""
    x = _embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = 0.0
    for lp in unstack(params["layers"], cfg.n_layers):
        x, a = _remat(_moe_block_out, lp, x, cfg, positions)
        aux = aux + a
    return _head(params, x, cfg), aux / cfg.n_layers


@torch.inference_mode()
def moe_prefill(params, batch, cfg):
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    shape = (cfg.n_layers, b, cfg.n_kv, s, cfg.head_dim)
    cache = dict(k=torch.empty(shape, dtype=x.dtype, device=x.device),
                 v=torch.empty(shape, dtype=x.dtype, device=x.device))
    for i in range(cfg.n_layers):
        x, _, (k, v) = _moe_block(layer(params["layers"], i), x, cfg,
                                  positions)
        cache["k"][i] = k.transpose(1, 2)
        cache["v"][i] = v.transpose(1, 2)
    return _head(params, x[:, -1:], cfg), cache


@torch.inference_mode()
def moe_decode(params, cache, tokens, pos: int, cfg):
    """One step; the batch's B tokens are routed as one group (the
    reference's meaning: a slot's output depends on the others')."""
    x = _embed_in(params, dict(tokens=tokens), cfg)
    pos = int(pos)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        x, _ = attention_decode(lp["attn"], x,
                                dict(k=cache["k"][i], v=cache["v"][i]),
                                pos, cfg)
        x, _ = moe(lp["moe"], x, cfg)
    return _head(params, x, cfg)[:, 0], cache


moe_init_cache = dense_init_cache


# ======================================================================
# mla_moe (deepseek-v3: MLA attention, leading dense layers, MoE + MTP)
# ======================================================================
def _mla_dense_layer(gen, cfg):
    return dict(attn=mla_init(gen, cfg), mlp=mlp_init(gen, cfg))


def mla_moe_init_params(cfg, gen, device=None):
    """``dense_layers`` (the first ``n_dense_layers``), ``moe_layers`` (the
    rest) and, with ``cfg.mtp``, the MTP head (``proj``, one dense
    ``block``, ``norm``).  A full-width expert stack is drawn expert by
    expert into bf16 (``layers.moe_init``)."""
    _check_generator(gen, device, "mla_moe_init_params")
    with torch.no_grad():
        p = _base_init(cfg, gen)
        p["dense_layers"] = _stack(lambda: _mla_dense_layer(gen, cfg),
                                   cfg.n_dense_layers)
        p["moe_layers"] = _stack(lambda: dict(attn=mla_init(gen, cfg),
                                              moe=moe_init(gen, cfg)),
                                 cfg.n_layers - cfg.n_dense_layers)
        if cfg.mtp:
            p["mtp"] = dict(proj=dense_init(gen, 2 * cfg.d_model,
                                            cfg.d_model),
                            block=_mla_dense_layer(gen, cfg),
                            norm=norm_init(cfg.d_model,
                                           with_bias=cfg.norm_bias,
                                           device=gen.device))
    return p


def _mla_dense_block(lp, x, cfg, positions):
    x, _ = mla_attention(lp["attn"], x, cfg, positions)
    return mlp(lp["mlp"], x, cfg)


def _mla_moe_block(lp, x, cfg, positions):
    x, _ = mla_attention(lp["attn"], x, cfg, positions)
    return moe(lp["moe"], x, cfg)


def mla_moe_forward(params, batch, cfg):
    """(logits, aux), or ((logits, mtp_logits), aux) when ``cfg.mtp`` is
    set and the batch has tokens: the MTP head predicts token t + 2 from
    the last hidden state at t and the embedding of token t + 1.  aux is
    divided by the number of MoE layers."""
    x = _embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    n_moe = cfg.n_layers - cfg.n_dense_layers
    for lp in unstack(params["dense_layers"], cfg.n_dense_layers):
        x = _remat(_mla_dense_block, lp, x, cfg, positions)
    aux = 0.0
    for lp in unstack(params["moe_layers"], n_moe):
        x, a = _remat(_mla_moe_block, lp, x, cfg, positions)
        aux = aux + a
    logits = _head(params, x, cfg)
    aux = aux / max(n_moe, 1)
    if cfg.mtp and isinstance(batch, dict) and "tokens" in batch:
        mtp = params["mtp"]
        emb_next = params["tok_emb"][torch.roll(batch["tokens"], -1, 1)]
        xn = apply_norm(mtp["norm"], x)
        h = torch.cat([xn, emb_next], dim=-1) @ mtp["proj"]
        h, _ = mla_attention(mtp["block"]["attn"], h, cfg, positions)
        h = mlp(mtp["block"]["mlp"], h, cfg)
        return (logits, _head(params, h, cfg)), aux
    return logits, aux


@torch.inference_mode()
def mla_moe_prefill(params, batch, cfg):
    x = _embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    lat = dict(dc=[], dkr=[], mc=[], mkr=[])
    for i in range(cfg.n_dense_layers):
        lp = layer(params["dense_layers"], i)
        x, (c, kr) = mla_attention(lp["attn"], x, cfg, positions)
        x = mlp(lp["mlp"], x, cfg)
        lat["dc"].append(c)
        lat["dkr"].append(kr)
    for i in range(cfg.n_layers - cfg.n_dense_layers):
        lp = layer(params["moe_layers"], i)
        x, (c, kr) = mla_attention(lp["attn"], x, cfg, positions)
        x, _ = moe(lp["moe"], x, cfg)
        lat["mc"].append(c)
        lat["mkr"].append(kr)
    cache = {k: torch.stack(v) for k, v in lat.items()}
    return _head(params, x[:, -1:], cfg), cache


@torch.inference_mode()
def mla_moe_decode(params, cache, tokens, pos: int, cfg):
    x = _embed_in(params, dict(tokens=tokens), cfg)
    pos = int(pos)
    for i in range(cfg.n_dense_layers):
        lp = layer(params["dense_layers"], i)
        x, _ = mla_decode(lp["attn"], x, dict(c=cache["dc"][i],
                                              kr=cache["dkr"][i]), pos, cfg)
        x = mlp(lp["mlp"], x, cfg)
    for i in range(cfg.n_layers - cfg.n_dense_layers):
        lp = layer(params["moe_layers"], i)
        x, _ = mla_decode(lp["attn"], x, dict(c=cache["mc"][i],
                                              kr=cache["mkr"][i]), pos, cfg)
        x, _ = moe(lp["moe"], x, cfg)
    return _head(params, x, cfg)[:, 0], cache


def mla_moe_init_cache(cfg, batch, cache_len, device=None):
    """Zeros, (L, B, T, r) bf16: the latent ``dc`` / ``mc`` (r =
    ``kv_lora_rank``) and the rope keys ``dkr`` / ``mkr`` (r =
    ``qk_rope_dim``) of the dense and MoE layers."""
    nd = cfg.n_dense_layers
    nm = cfg.n_layers - nd
    dev = device_mod.resolve(device)

    def zeros(n, r):
        return torch.zeros((n, batch, cache_len, r), dtype=DTYPE,
                           device=dev)
    return dict(dc=zeros(nd, cfg.kv_lora_rank),
                dkr=zeros(nd, cfg.qk_rope_dim),
                mc=zeros(nm, cfg.kv_lora_rank),
                mkr=zeros(nm, cfg.qk_rope_dim))


# ======================================================================
# xlstm (groups of (slstm_every - 1) mLSTM + 1 sLSTM)
# ======================================================================
def xlstm_init_params(cfg, gen, device=None):
    """``groups``: G = n_layers // xlstm_slstm_every groups, each a stack
    of M = xlstm_slstm_every - 1 mLSTMs and one sLSTM, so the mLSTM
    leaves are (G, M, ...) (6 x 7 and 6 sLSTMs at full width)."""
    _check_generator(gen, device, "xlstm_init_params")
    g = cfg.n_layers // cfg.xlstm_slstm_every
    m_per = cfg.xlstm_slstm_every - 1
    with torch.no_grad():
        p = _base_init(cfg, gen)
        p["groups"] = _stack(lambda: dict(
            mlstm=_stack(lambda: xl_mod.mlstm_init(gen, cfg), m_per),
            slstm=xl_mod.slstm_init(gen, cfg)), g)
    return p


def _stack_states(states):
    """A list of equal state tuples as one tuple of stacked tensors."""
    return tuple(torch.stack(z) for z in zip(*states))


def _xlstm_group(gp, x, cfg, keep: bool = True):
    """One group from the zero state.  Returns (x, (m_states, s_state)),
    the mLSTMs' states stacked on M (None without ``keep``: training
    needs only x)."""
    m_states = []
    for lp in unstack(gp["mlstm"], cfg.xlstm_slstm_every - 1):
        x, st = xl_mod.mlstm_forward(lp, x, cfg)
        if keep:
            m_states.append(st)
    x, s_state = xl_mod.slstm_forward(gp["slstm"], x, cfg)
    if not keep:
        return x, None
    return x, (_stack_states(m_states), s_state)


def _xlstm_group_out(gp, x, cfg):
    return _xlstm_group(gp, x, cfg, keep=False)[0]


def xlstm_forward(params, batch, cfg):
    """(logits, 0.0); under grad each group runs under ``checkpoint``."""
    x = _embed_in(params, batch, cfg)
    g = cfg.n_layers // cfg.xlstm_slstm_every
    for gp in unstack(params["groups"], g):
        x = _remat(_xlstm_group_out, gp, x, cfg)
    return _head(params, x, cfg), 0.0


@torch.inference_mode()
def xlstm_prefill(params, batch, cfg):
    x = _embed_in(params, batch, cfg)
    m_states, s_states = [], []
    for i in range(cfg.n_layers // cfg.xlstm_slstm_every):
        x, (ms, ss) = _xlstm_group(layer(params["groups"], i), x, cfg)
        m_states.append(ms)
        s_states.append(ss)
    cache = (_stack_states(m_states), _stack_states(s_states))
    return _head(params, x[:, -1:], cfg), cache


@torch.inference_mode()
def xlstm_decode(params, cache, tokens, pos: int, cfg):
    """One step of every mLSTM's and sLSTM's recurrence, each state
    written into its slice of ``cache`` (``pos`` is not read: the state
    is O(1))."""
    x = _embed_in(params, dict(tokens=tokens), cfg)
    (mc, mn, mm), s_st = cache
    m_per = cfg.xlstm_slstm_every - 1
    for gi in range(cfg.n_layers // cfg.xlstm_slstm_every):
        gp = layer(params["groups"], gi)
        for mi in range(m_per):
            x, _ = xl_mod.mlstm_decode(layer(gp["mlstm"], mi), x,
                                       (mc[gi, mi], mn[gi, mi], mm[gi, mi]),
                                       cfg)
        mine = tuple(t[gi] for t in s_st)
        x, new = xl_mod.slstm_decode(gp["slstm"], x, mine, cfg)
        for t, n in zip(mine, new):
            t.copy_(n)
    return _head(params, x, cfg)[:, 0], cache


def xlstm_init_cache(cfg, batch, cache_len, device=None):
    """The O(1) state (``cache_len`` is not read): the mLSTMs' C (G, M,
    B, H, P, P), n (G, M, B, H, P) and m (G, M, B, H), the sLSTMs' h, c,
    n (G, B, H, P) and m (G, B, H); f32, m at -1e30."""
    del cache_len
    g = cfg.n_layers // cfg.xlstm_slstm_every
    m_per = cfg.xlstm_slstm_every - 1
    di = cfg.xlstm_proj * cfg.d_model
    pp = di // cfg.n_heads
    sp = cfg.d_model // cfg.n_heads
    dev = device_mod.resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    h = cfg.n_heads
    m_states = (torch.zeros((g, m_per, batch, h, pp, pp), **f32),
                torch.zeros((g, m_per, batch, h, pp), **f32),
                torch.full((g, m_per, batch, h), xl_mod.NEG, **f32))
    s_state = (torch.zeros((g, batch, h, sp), **f32),
               torch.zeros((g, batch, h, sp), **f32),
               torch.zeros((g, batch, h, sp), **f32),
               torch.full((g, batch, h), xl_mod.NEG, **f32))
    return (m_states, s_state)


# ======================================================================
# hybrid (zamba2: Mamba2 backbone + shared attention block every k layers)
# ======================================================================
def hybrid_init_params(cfg, gen, device=None):
    """``mamba``: the L Mamba2 layers; ``shared``: the one attention + MLP
    block applied after every ``hybrid_every``-th of them."""
    _check_generator(gen, device, "hybrid_init_params")
    with torch.no_grad():
        p = _base_init(cfg, gen)
        p["mamba"] = _stack(lambda: ssm_mod.ssd_init(gen, cfg), cfg.n_layers)
        p["shared"] = dict(attn=attn_init(gen, cfg), mlp=mlp_init(gen, cfg))
    return p


def _n_shared(cfg):
    return cfg.n_layers // cfg.hybrid_every


def _applies_shared(cfg, idx: int) -> bool:
    """The shared block follows layer ``idx`` (5, 11, ..., 35 of
    zamba2's 38); its cache slice is ``idx // hybrid_every``."""
    return idx % cfg.hybrid_every == cfg.hybrid_every - 1


def _hybrid_block(lp, shared, x, cfg, positions, apply_shared: bool):
    x, _ = ssm_mod.ssd_forward(lp, x, cfg)
    if apply_shared:
        x, _ = attention(shared["attn"], x, cfg, positions)
        x = mlp(shared["mlp"], x, cfg)
    return x


def hybrid_forward(params, batch, cfg):
    """(logits, 0.0); under grad each block (a Mamba2 layer and the
    shared block after it) runs under ``checkpoint``."""
    x = _embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for idx, lp in enumerate(unstack(params["mamba"], cfg.n_layers)):
        x = _remat(_hybrid_block, lp, params["shared"], x, cfg, positions,
                   _applies_shared(cfg, idx))
    return _head(params, x, cfg), 0.0


@torch.inference_mode()
def hybrid_prefill(params, batch, cfg):
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    shared = params["shared"]
    t = s if not cfg.swa_window else min(s, cfg.swa_window)
    shape = (_n_shared(cfg), b, cfg.n_kv, t, cfg.head_dim)
    sh = dict(k=torch.zeros(shape, dtype=DTYPE, device=x.device),
              v=torch.zeros(shape, dtype=DTYPE, device=x.device))
    ssm_st, conv_st = [], []
    for idx in range(cfg.n_layers):
        x, (st, cv) = ssm_mod.ssd_forward(layer(params["mamba"], idx), x, cfg)
        ssm_st.append(st)
        conv_st.append(cv)
        if _applies_shared(cfg, idx):
            sidx = idx // cfg.hybrid_every
            x, (k, v) = attention(shared["attn"], x, cfg, positions)
            x = mlp(shared["mlp"], x, cfg)
            sh["k"][sidx] = k[:, -t:].transpose(1, 2)
            sh["v"][sidx] = v[:, -t:].transpose(1, 2)
    cache = dict(ssm=torch.stack(ssm_st), conv=torch.stack(conv_st),
                 shared=sh)
    return _head(params, x[:, -1:], cfg), cache


@torch.inference_mode()
def hybrid_decode(params, cache, tokens, pos: int, cfg):
    """One step: every Mamba2 layer's recurrence (its ssm / conv slices
    written in place) and, after every ``hybrid_every``-th, the shared
    block's decode attention (``ops.decode_attention``) on its slice of
    ``shared``."""
    x = _embed_in(params, dict(tokens=tokens), cfg)
    shared, sh = params["shared"], cache["shared"]
    t = sh["k"].shape[3]
    ring = cfg.swa_window > 0 and t == cfg.swa_window
    pos = int(pos)
    for idx in range(cfg.n_layers):
        s_ssm, s_conv = cache["ssm"][idx], cache["conv"][idx]
        x, (n_ssm, n_conv) = ssm_mod.ssd_decode(
            layer(params["mamba"], idx), x, (s_ssm, s_conv), cfg)
        s_ssm.copy_(n_ssm)
        s_conv.copy_(n_conv)
        if _applies_shared(cfg, idx):
            sidx = idx // cfg.hybrid_every
            x, _ = attention_decode(shared["attn"], x,
                                    dict(k=sh["k"][sidx], v=sh["v"][sidx]),
                                    pos, cfg, ring=ring)
            x = mlp(shared["mlp"], x, cfg)
    return _head(params, x, cfg)[:, 0], cache


def hybrid_init_cache(cfg, batch, cache_len, device=None):
    """Zeros: ssm (L, B, H, P, N) f32, conv (L, B, CONV_W - 1, di) bf16,
    shared k / v (n_shared, B, Hkv, T, D) bf16."""
    di = cfg.ssm_expand * cfg.d_model
    t = cache_len if not cfg.swa_window else min(cache_len, cfg.swa_window)
    dev = device_mod.resolve(device)
    kv = (_n_shared(cfg), batch, cfg.n_kv, t, cfg.head_dim)
    return dict(
        ssm=torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                         cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=dev),
        conv=torch.zeros((cfg.n_layers, batch, ssm_mod.CONV_W - 1, di),
                         dtype=DTYPE, device=dev),
        shared=dict(k=torch.zeros(kv, dtype=DTYPE, device=dev),
                    v=torch.zeros(kv, dtype=DTYPE, device=dev)))


# ----------------------------------------------------------------- dispatch
FAMILIES: Dict[str, Dict[str, Any]] = {
    "dense": dict(init=dense_init_params, forward=dense_forward,
                  prefill=dense_prefill, decode=dense_decode,
                  init_cache=dense_init_cache),
    "moe": dict(init=moe_init_params, forward=moe_forward,
                prefill=moe_prefill, decode=moe_decode,
                init_cache=moe_init_cache),
    "mla_moe": dict(init=mla_moe_init_params, forward=mla_moe_forward,
                    prefill=mla_moe_prefill, decode=mla_moe_decode,
                    init_cache=mla_moe_init_cache),
    "xlstm": dict(init=xlstm_init_params, forward=xlstm_forward,
                  prefill=xlstm_prefill, decode=xlstm_decode,
                  init_cache=xlstm_init_cache),
    "hybrid": dict(init=hybrid_init_params, forward=hybrid_forward,
                   prefill=hybrid_prefill, decode=hybrid_decode,
                   init_cache=hybrid_init_cache),
}

# {family: the names of the leaves it computes on in their 'model' blocks
# under a sharded step (``layers.model_grid``)}: the dense family's column,
# row, embedding and head weights; the other families gather every leaf
# over 'model' (ROADMAP A.10e-2, A.10e-3)
TP_LEAVES: Dict[str, tuple] = {
    "dense": ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "tok_emb",
              "lm_head"),
}
