"""CSR graph/matrix container.

A verbatim copy of ``repro.graph.csr`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in. ``tests/test_torch_base.py``
holds the copy against the original.

The paper reads "the CSR structure from disk" with no preprocessing
(§IV-D); data placement is the engine's equal-chunk scatter of the CSR
arrays themselves.  We keep CSR in plain numpy (host-side dataset) — the
engine converts to device arrays at construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSR:
    """Compressed-sparse-row adjacency / matrix.

    row_ptr: (n_rows+1,) int64 offsets into col_idx.
    col_idx: (nnz,) int32 column / neighbor indices.
    weights: (nnz,) float32 edge weights (None => unweighted).
    n_cols:  number of columns (== n_rows for graphs).
    """

    row_ptr: np.ndarray
    col_idx: np.ndarray
    weights: np.ndarray | None
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def row_lo(self) -> np.ndarray:
        return self.row_ptr[:-1].astype(np.int32)

    @property
    def row_hi(self) -> np.ndarray:
        return self.row_ptr[1:].astype(np.int32)

    def out_degree(self) -> np.ndarray:
        return (self.row_ptr[1:] - self.row_ptr[:-1]).astype(np.int64)

    def footprint_bytes(self) -> int:
        b = self.row_ptr.nbytes + self.col_idx.nbytes
        if self.weights is not None:
            b += self.weights.nbytes
        return b


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n: int,
                   weights: np.ndarray | None = None,
                   dedup: bool = False) -> CSR:
    """Build CSR from an edge list (sorted by src internally)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if dedup:
        key = src * n + dst
        _, keep = np.unique(key, return_index=True)
        src, dst = src[keep], dst[keep]
        if weights is not None:
            weights = weights[keep]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    if weights is not None:
        weights = np.asarray(weights, np.float32)[order]
    counts = np.bincount(src, minlength=n)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSR(row_ptr=row_ptr, col_idx=dst.astype(np.int32),
               weights=weights, n_cols=n)


def transpose_csr(g: CSR) -> CSR:
    """Transpose (in-edges CSR), preserving weights."""
    n = g.n_cols
    src = np.repeat(np.arange(g.n_rows, dtype=np.int64), g.out_degree())
    return csr_from_edges(g.col_idx.astype(np.int64), src, max(n, g.n_rows),
                          weights=g.weights)
