"""Synthetic dataset generators: RMAT (Graph500-style Kronecker) and a
Wikipedia-like heavy-tailed graph.

A verbatim copy of ``repro.graph.rmat`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in. ``tests/test_torch_base.py``
holds the copy against the original.

The paper evaluates RMAT-22..26 (2^s vertices, ~16 edges/vertex before
dedup, a=0.57 b=c=0.19 per Graph500) and the real Wikipedia graph
(V=4.2M, E=101M).  We reproduce RMAT faithfully at reduced scales
(laptop-class) and provide a power-law generator standing in for
Wikipedia; all claims we validate are *relative* (proxy vs no-proxy,
queue ratios), which the paper shows hold across datasets.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR, csr_from_edges


def rmat_edges(scale: int, edge_factor: int = 16, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 42,
               weighted: bool = True) -> CSR:
    """Graph500 Kronecker generator (undirected edges added both ways)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor // 2
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        # standard RMAT quadrant draw: pick row half with P(a+b), then the
        # column half conditioned on the row half.
        q = rng.random(m)
        src_bit = q >= ab
        cond = np.where(src_bit, c / max(c + (1.0 - abc), 1e-12), a / ab)
        dst_bit = rng.random(m) >= cond
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # permute vertex ids to decorrelate hubs from low ids (Graph500 does this)
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    w = None
    if weighted:
        w = rng.integers(1, 256, size=s2.shape[0]).astype(np.float32)
    return csr_from_edges(s2, d2, n, weights=w)


def wikipedia_like(n: int = 1 << 14, avg_deg: int = 24, alpha: float = 2.1,
                   seed: int = 7) -> CSR:
    """Power-law digraph standing in for the Wikipedia dataset (V=4.2M,
    E=101M, avg degree ~24) at reduced scale."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    # heavy-tailed destination popularity (hot vertices = the paper's
    # work-imbalance story)
    pop = (rng.pareto(alpha - 1.0, n) + 1.0)
    pop /= pop.sum()
    dst = rng.choice(n, size=m, p=pop)
    src = rng.integers(0, n, size=m)
    w = rng.integers(1, 256, size=m).astype(np.float32)
    return csr_from_edges(src, dst, n, weights=w)


def histogram_input(g: CSR, bins: int) -> np.ndarray:
    """The paper's Histogram input: 'E elements to be filtered into V/8
    bins (values = edge array index plus its value, modulo #bins)'."""
    idx = np.arange(g.nnz, dtype=np.int64)
    val = g.weights if g.weights is not None else np.ones(g.nnz)
    return ((idx + val.astype(np.int64)) % bins).astype(np.int32)
