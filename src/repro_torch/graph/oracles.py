"""Pure-numpy oracles for the six applications (used by tests and by the
benchmark harness to verify engine output before timing it).

A verbatim copy of ``repro.graph.oracles`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in. ``tests/test_torch_base.py``
holds the copy against the original.
"""
from __future__ import annotations

import heapq

import numpy as np

from .csr import CSR


def bfs_oracle(g: CSR, root: int) -> np.ndarray:
    n = g.n_rows
    dist = np.full(n, np.inf, np.float32)
    dist[root] = 0
    frontier = [root]
    d = 0
    while frontier:
        nxt = []
        d += 1
        for u in frontier:
            for v in g.col_idx[g.row_ptr[u]: g.row_ptr[u + 1]]:
                if dist[v] == np.inf:
                    dist[v] = d
                    nxt.append(int(v))
        frontier = nxt
    return dist


def sssp_oracle(g: CSR, root: int) -> np.ndarray:
    n = g.n_rows
    w = g.weights if g.weights is not None else np.ones(g.nnz, np.float32)
    dist = np.full(n, np.inf, np.float32)
    dist[root] = 0.0
    pq = [(0.0, root)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        lo, hi = g.row_ptr[u], g.row_ptr[u + 1]
        for v, wv in zip(g.col_idx[lo:hi], w[lo:hi]):
            nd = np.float32(d + wv)
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (float(nd), int(v)))
    return dist


def wcc_oracle(g: CSR) -> np.ndarray:
    """Min-label per weak component; input graph must already contain both
    directions (matching apps.wcc)."""
    n = g.n_rows
    label = np.arange(n)
    # union-find over edges
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    src = np.repeat(np.arange(n), g.out_degree())
    for u, v in zip(src, g.col_idx):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    for i in range(n):
        label[i] = find(i)
    return label.astype(np.float32)


def pagerank_oracle(g: CSR, epochs: int = 10,
                    damping: float = 0.85) -> np.ndarray:
    """Power iteration exactly matching apps.pagerank's epoch semantics
    (dangling mass dropped, same constant term)."""
    n = g.n_rows
    deg = np.maximum(g.out_degree(), 1).astype(np.float32)
    ranks = np.full(n, 1.0 / n, np.float32)
    src = np.repeat(np.arange(n), g.out_degree())
    for _ in range(epochs):
        contrib = damping * ranks / deg
        acc = np.zeros(n, np.float32)
        np.add.at(acc, g.col_idx, contrib[src])
        ranks = (1.0 - damping) / n + acc
    return ranks


def spmv_oracle(a: CSR, x: np.ndarray) -> np.ndarray:
    w = a.weights if a.weights is not None else np.ones(a.nnz, np.float32)
    src = np.repeat(np.arange(a.n_rows), a.out_degree())
    y = np.zeros(a.n_rows, np.float32)
    np.add.at(y, src, w * np.asarray(x, np.float32)[a.col_idx])
    return y


def histogram_oracle(values: np.ndarray, bins: int) -> np.ndarray:
    return np.bincount(np.asarray(values), minlength=bins).astype(np.float32)
