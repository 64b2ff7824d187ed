"""Synthetic data sources.

zipf_tokens: heavy-tailed token stream (Zipf ids mirror the hot-vertex
skew the paper's proxies exploit — hot token ids concentrate embedding
gradient traffic exactly like hot vertices concentrate updates).

SyntheticLM: deterministic, seekable LM batch source with a learnable
structure (order-2 mixture) so a ~100M model's loss demonstrably drops.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def zipf_tokens(rng: np.random.Generator, vocab: int, shape,
                alpha: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return rng.choice(vocab, size=shape, p=probs).astype(np.int32)


@dataclasses.dataclass
class SyntheticLM:
    """Order-2 synthetic language: token t depends on (t-1, t-2) through a
    fixed random hash, with Zipf unigram noise.  Deterministic per
    (seed, step) — restart-safe without data-state checkpointing."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    noise: float = 0.1
    d_model: int = 0            # >0 => also emit stub 'embeds'

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.batch, self.seq_len, self.vocab
        mix = rng.integers(0, v, size=(b, 2)).astype(np.int64)
        toks = np.zeros((b, s + 1), np.int64)
        toks[:, 0], toks[:, 1] = mix[:, 0], mix[:, 1]
        c1, c2, c3 = 1000003, 10007, 101
        for t in range(2, s + 1):
            det = (toks[:, t - 1] * c1 + toks[:, t - 2] * c2 + c3) % v
            noise = zipf_tokens(rng, v, (b,))
            pick = rng.random(b) < self.noise
            toks[:, t] = np.where(pick, noise, det)
        out = dict(tokens=toks[:, :-1].astype(np.int32),
                   labels=toks[:, 1:].astype(np.int32))
        if self.d_model:
            out["embeds"] = rng.standard_normal(
                (b, s, self.d_model)).astype(np.float32)
        return out
