"""Decoder-only LM assembly: the dense family of ``repro/models/lm.py``.

  dense - GQA/SWA attention + MLP  (starcoder2, deepseek-7b, h2o-danube,
                                    the pixtral backbone)

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
The cache is dict(k, v), each (L, B, Hkv, T, D): one layer's slice is
the contiguous (B, Hkv, T, D) block ``ops.decode_attention`` reads
(the reference keeps (L, B, T, Hkv, D); ``convert.lm_cache_from_numpy``
transposes).  Decode updates the cache in place and returns it.
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
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as device_mod
from .layers import (DTYPE, apply_norm, attention, attention_decode,
                     attn_init, embed_init, mlp, mlp_init, norm_init)


# ------------------------------------------------------------------ shared
def _embed_in(params, batch, cfg):
    if isinstance(batch, dict) and "embeds" in batch:
        return batch["embeds"].to(DTYPE)
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    return params["tok_emb"][tokens]


def _head(params, x, cfg):
    x = apply_norm(params["final_norm"], x)
    return torch.einsum("bsd,vd->bsv", x, params["lm_head"])


def lm_loss(logits, labels, cfg, aux=0.0):
    """Mean cross-entropy in f32 over the (padded) logits, plus
    ``cfg.moe_aux_weight * aux``.  Columns at or past ``cfg.vocab`` are
    masked to -1e30 before the logsumexp, as the reference masks them.
    The true logit is a ``gather`` of the label's column: the
    reference's iota-compare masked sum adds that one value to zeros,
    so both give the same number."""
    lf = logits.float()
    if lf.shape[-1] > cfg.vocab:
        vids = torch.arange(lf.shape[-1], device=lf.device)
        lf = torch.where(vids < cfg.vocab, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)                     # (B, S)
    true = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(lse - true)
    return ce + cfg.moe_aux_weight * aux


def _base_init(cfg, gen):
    p = dict(final_norm=norm_init(cfg.d_model, with_bias=cfg.norm_bias,
                                  device=gen.device),
             lm_head=embed_init(gen, cfg.vocab_pad, cfg.d_model))
    # every family the port has keeps the token embedding (the
    # reference's rule, ``lm.py:71-73``)
    p["tok_emb"] = embed_init(gen, cfg.vocab_pad, cfg.d_model)
    return p


def _stack(layer_fn, n: int):
    """``layer_fn()``'s dict of tensors, drawn ``n`` times and stacked on
    a leading axis; each draw is written into the stack as it is made,
    so no more than one layer's draws are held beside it."""
    first = layer_fn()

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


# ======================================================================
# dense
# ======================================================================
def dense_init_params(cfg, gen, device=None):
    """The dense family's parameters on ``device`` (the card unless
    ``"cpu"`` is asked for), drawn from ``gen``, a ``torch.Generator``
    on that device.  Layer by layer on the device: a full-width stack
    is never drawn in f32 at once."""
    dev = device_mod.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"dense_init_params: a generator on {gen.device} "
                         f"cannot draw parameters on {dev}")
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
    remat = torch.is_grad_enabled()
    for lp in unstack(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_block_out, lp, x, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block_out(lp, x, cfg, positions)
    return _head(params, x, cfg), 0.0


@torch.inference_mode()
def dense_prefill(params, batch, cfg):
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    shape = (cfg.n_layers, b, cfg.n_kv, s, cfg.head_dim)
    cache = dict(k=torch.empty(shape, dtype=x.dtype, device=x.device),
                 v=torch.empty(shape, dtype=x.dtype, device=x.device))
    for i in range(cfg.n_layers):
        x, (k, v) = _dense_block(layer(params["layers"], i), x, cfg,
                                 positions)
        cache["k"][i] = k.transpose(1, 2)
        cache["v"][i] = v.transpose(1, 2)
    logits = _head(params, x[:, -1:], cfg)
    return logits, cache


@torch.inference_mode()
def dense_decode(params, cache, tokens, pos: int, cfg):
    x = _embed_in(params, dict(tokens=tokens), cfg)
    ring = cfg.swa_window > 0 and cache["k"].shape[3] == cfg.swa_window
    pos = int(pos)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        x, _ = attention_decode(lp["attn"], x,
                                dict(k=cache["k"][i], v=cache["v"][i]),
                                pos, cfg, ring=ring)
        x = mlp(lp["mlp"], x, cfg)
    return _head(params, x, cfg)[:, 0], cache


def dense_init_cache(cfg, batch, cache_len, device=None):
    """Zeros, (L, B, Hkv, T, D) bf16 each of k and v; ``device="meta"``
    sizes it without memory (``serving.kvcache.plan_cache``)."""
    t = cache_len if not cfg.swa_window else min(cache_len, cfg.swa_window)
    shape = (cfg.n_layers, batch, cfg.n_kv, t, cfg.head_dim)
    dev = device_mod.resolve(device)
    return dict(k=torch.zeros(shape, dtype=DTYPE, device=dev),
                v=torch.zeros(shape, dtype=DTYPE, device=dev))


# ----------------------------------------------------------------- dispatch
FAMILIES: Dict[str, Dict[str, Any]] = {
    "dense": dict(init=dense_init_params, forward=dense_forward,
                  prefill=dense_prefill, decode=dense_decode,
                  init_cache=dense_init_cache),
}
