"""Serving steps: prefill + single-token decode with sampling, the port
of ``repro/serving/decode.py``.

``serve_step`` is one new token against a KV cache, optimizer-free; in
the dense family each of its layers runs the ``decode_attention``
kernel once.  The steps run eagerly under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable

import torch


def sample_logits(logits, gen=None, temperature: float = 0.0,
                  vocab: int = 0):
    """Greedy (T=0) or temperature sampling from ``gen`` (a
    ``torch.Generator`` on the logits' device).  logits: (B, V_pad);
    ``vocab`` masks the padding.  Returns (B,) int32."""
    if vocab:
        vids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vids < vocab, logits,
                             torch.tensor(-torch.inf, dtype=logits.dtype,
                                          device=logits.device))
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def make_prefill(cfg, fam) -> Callable:
    """prefill(params, batch) -> (logits_last, cache)."""

    def prefill(params, batch):
        return fam["prefill"](params, batch, cfg)

    return prefill


def make_serve_step(cfg, fam, temperature: float = 0.0) -> Callable:
    """serve_step(params, cache, tokens, pos, gen)
       -> (next_tokens, logits, cache).

    tokens: (B, 1) current token; pos: the absolute position (an int).
    """

    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos, gen=None):
        logits, cache = fam["decode"](params, cache, tokens, pos, cfg)
        nxt = sample_logits(logits, gen, temperature, cfg.vocab)
        return nxt[:, None], logits, cache

    return serve_step


@torch.inference_mode()
def generate(cfg, fam, params, batch, steps: int, temperature: float = 0.0,
             gen=None):
    """Host loop: prefill then ``steps`` decode steps (example/test path).
    Returns (B, steps) int32 tokens on the parameters' device."""
    from .kvcache import pad_cache
    prefill = make_prefill(cfg, fam)
    step = make_serve_step(cfg, fam, temperature)
    logits, cache = prefill(params, batch)
    cache = pad_cache(cfg, cache, steps)           # decode headroom
    tok = sample_logits(logits[:, -1], gen, temperature, cfg.vocab)[:, None]
    pos0 = batch["tokens" if "tokens" in batch else "embeds"].shape[1]
    out = [tok]
    for i in range(steps - 1):
        tok, _, cache = step(params, cache, tok, pos0 + i, gen)
        out.append(tok)
    return torch.cat(out, dim=1)
