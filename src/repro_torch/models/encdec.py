"""Encoder-decoder model (whisper-tiny), the port of
``repro/models/encdec.py``.

The conv / audio front end is a stub, as in the reference: the batch
carries precomputed frame embeddings (B, S_enc, d).  The transformer
backbone is whole: a bidirectional encoder and a causal decoder with
cross-attention, sinusoidal positions on both.

The cache is dict(k, v, ck, cv): the decoder's self-attention k / v are
(L, B, Hkv, T, D), whose layer slices ``ops.decode_attention`` reads as
in the dense family; the cross-attention's ``ck`` / ``cv`` keep the
reference's (L, B, S_enc, Hkv, D) (the plain full-mask attention reads
them; ``convert`` swaps only ``k`` / ``v``).  ``init_cache`` makes
``ck`` / ``cv`` of ``cache_len`` zero positions, as the reference does,
so that a decode step from it attends to zeros (``ServeScheduler``'s
meaning, kept).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .. import device as device_mod
from .layers import (DTYPE, apply_norm, attention, attention_decode,
                     attn_init, cross_attention, embed_init, mlp, mlp_init,
                     norm_init)
from .lm import _check_generator, _remat, _stack, layer, unstack


def sinusoidal(positions, dim: int):
    """positions: (...,) -> (..., dim) sinusoidal embedding, f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encdec_init_params(cfg, gen, device=None):
    """The reference's keys: ``tok_emb``, ``enc_layers`` (attn, mlp),
    ``dec_layers`` (self, cross, mlp), ``enc_norm``, ``final_norm``,
    ``lm_head``."""
    _check_generator(gen, device, "encdec_init_params")
    d = cfg.d_model
    with torch.no_grad():
        return dict(
            tok_emb=embed_init(gen, cfg.vocab_pad, d),
            enc_layers=_stack(lambda: dict(attn=attn_init(gen, cfg),
                                           mlp=mlp_init(gen, cfg)),
                              cfg.enc_layers),
            dec_layers=_stack(lambda: dict(self=attn_init(gen, cfg),
                                           cross=attn_init(gen, cfg),
                                           mlp=mlp_init(gen, cfg)),
                              cfg.dec_layers),
            enc_norm=norm_init(d, with_bias=cfg.norm_bias, device=gen.device),
            final_norm=norm_init(d, with_bias=cfg.norm_bias,
                                 device=gen.device),
            lm_head=embed_init(gen, cfg.vocab_pad, d),
        )


def _encode(params, embeds, cfg):
    """The bidirectional encoder.  The frames and their positions are
    rounded to bf16 whatever the parameters' dtype (the reference's
    ``astype(DTYPE)``)."""
    s, d = embeds.shape[1:]
    pos = sinusoidal(torch.arange(s, device=embeds.device), d)
    x = embeds.to(DTYPE) + pos[None].to(DTYPE)
    for lp in unstack(params["enc_layers"], cfg.enc_layers):
        x, _ = attention(lp["attn"], x, cfg, bidirectional=True)
        x = mlp(lp["mlp"], x, cfg)
    return apply_norm(params["enc_norm"], x)


def _cross_kv(params, enc_out, cfg):
    """Every decoder layer's cross (k, v) of the encoder output, stacked:
    (L, B, S, Hkv, D) each."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.n_kv, cfg.head_dim
    ks, vs = [], []
    for i in range(cfg.dec_layers):
        cp = layer(params["dec_layers"], i)["cross"]
        xn = apply_norm(cp["norm"], enc_out)
        ks.append((xn @ cp["wk"]).reshape(b, s, hkv, hd))
        vs.append((xn @ cp["wv"]).reshape(b, s, hkv, hd))
    return torch.stack(ks), torch.stack(vs)


def _dec_embed(params, tokens, pos0: int, cfg):
    x = params["tok_emb"][tokens]
    s = tokens.shape[1]
    pos = sinusoidal(pos0 + torch.arange(s, device=tokens.device),
                     cfg.d_model)
    return x + pos[None].to(x.dtype)


def _dec_block(lp, k, v, x, cfg, positions):
    x, _ = attention(lp["self"], x, cfg, positions)
    x = cross_attention(lp["cross"], x, (k, v), cfg)
    return mlp(lp["mlp"], x, cfg)


def encdec_forward(params, batch, cfg):
    """Teacher-forced pass.  batch: {embeds, tokens, labels}.  Returns
    (logits, 0.0); under grad each decoder block runs under
    ``checkpoint`` (the encoder does not, as in the reference)."""
    enc_out = _encode(params, batch["embeds"], cfg)
    ck, cv = _cross_kv(params, enc_out, cfg)
    x = _dec_embed(params, batch["tokens"], 0, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i, lp in enumerate(unstack(params["dec_layers"], cfg.dec_layers)):
        x = _remat(_dec_block, lp, ck[i], cv[i], x, cfg, positions)
    x = apply_norm(params["final_norm"], x)
    return torch.einsum("bsd,vd->bsv", x, params["lm_head"]), 0.0


@torch.inference_mode()
def encdec_prefill(params, batch, cfg):
    """Encode the frames and run the decoder prefix; returns (logits of
    the last position, cache)."""
    enc_out = _encode(params, batch["embeds"], cfg)
    ck, cv = _cross_kv(params, enc_out, cfg)
    x = _dec_embed(params, batch["tokens"], 0, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    shape = (cfg.dec_layers, b, cfg.n_kv, s, cfg.head_dim)
    cache = dict(k=torch.empty(shape, dtype=x.dtype, device=x.device),
                 v=torch.empty(shape, dtype=x.dtype, device=x.device),
                 ck=ck, cv=cv)
    for i in range(cfg.dec_layers):
        lp = layer(params["dec_layers"], i)
        x, (k, v) = attention(lp["self"], x, cfg, positions)
        x = cross_attention(lp["cross"], x, (ck[i], cv[i]), cfg)
        x = mlp(lp["mlp"], x, cfg)
        cache["k"][i] = k.transpose(1, 2)
        cache["v"][i] = v.transpose(1, 2)
    x = apply_norm(params["final_norm"], x[:, -1:])
    return torch.einsum("bsd,vd->bsv", x, params["lm_head"]), cache


@torch.inference_mode()
def encdec_decode(params, cache, tokens, pos: int, cfg):
    """One decoder step: each layer's self-attention through
    ``ops.decode_attention`` on its slice of ``k`` / ``v`` (written in
    place), its cross-attention over ``ck`` / ``cv``."""
    pos = int(pos)
    x = _dec_embed(params, tokens, pos, cfg)
    for i in range(cfg.dec_layers):
        lp = layer(params["dec_layers"], i)
        x, _ = attention_decode(lp["self"], x,
                                dict(k=cache["k"][i], v=cache["v"][i]), pos,
                                cfg)
        x = cross_attention(lp["cross"], x, (cache["ck"][i], cache["cv"][i]),
                            cfg)
        x = mlp(lp["mlp"], x, cfg)
    x = apply_norm(params["final_norm"], x)
    logits = torch.einsum("bsd,vd->bsv", x, params["lm_head"])
    return logits[:, 0], cache


def encdec_init_cache(cfg, batch, cache_len, device=None):
    """Zeros, bf16: k / v (L, B, Hkv, T, D), ck / cv (L, B, T, Hkv, D)."""
    dev = device_mod.resolve(device)
    l, hkv, hd = cfg.dec_layers, cfg.n_kv, cfg.head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=DTYPE, device=dev)
    return dict(k=zeros(l, batch, hkv, cache_len, hd),
                v=zeros(l, batch, hkv, cache_len, hd),
                ck=zeros(l, batch, cache_len, hkv, hd),
                cv=zeros(l, batch, cache_len, hkv, hd))


ENCDEC_FAMILY: Dict[str, Any] = dict(
    init=encdec_init_params, forward=encdec_forward, prefill=encdec_prefill,
    decode=encdec_decode, init_cache=encdec_init_cache)
