"""Block-sparse SpMV: the BCSR format, its host conversion, and the
kernel.

``BCSR`` and ``bcsr_from_csr`` are the port's own copy of
``repro/kernels/spmv_csr.py``'s (host numpy; the same arrays, byte for
byte): each block-row holds exactly ``kmax`` dense (bm x bk) blocks,
ELL-padded with all-zero blocks of column 0.

``spmv_bcsr`` replaces that module's ``spmv_bcsr``.  The TPU kernel
walked a sequential (block-row, k) grid, picked each x block through the
scalar-prefetched ``cols`` table and accumulated on the MXU; this one
(``csrc/spmv_bcsr.cu``) gives each block-row to one block of threads,
which stages the picked x blocks in shared memory and reduces each row
with warp shuffles, in a fixed order.  Bound by device-memory bytes: a
GEMV reads every block element once for one multiply-add.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build
from .ref import spmv_ref as plain

DEFAULT_BM = 128
DEFAULT_BK = 128


@dataclasses.dataclass
class BCSR:
    """ELL-padded block-sparse matrix: every block-row holds exactly
    ``kmax`` (bm x bk) blocks; absent blocks are all-zero with col 0.
    ``blocks`` and ``cols`` are numpy arrays, or tensors after ``to``."""

    blocks: np.ndarray     # (Mb, kmax, bm, bk) float32
    cols: np.ndarray       # (Mb, kmax) int32 block-column ids
    shape: tuple           # (M, K) logical
    bm: int
    bk: int

    @property
    def mb(self) -> int:
        return self.blocks.shape[0]

    @property
    def kmax(self) -> int:
        return self.blocks.shape[1]

    def to(self, device) -> "BCSR":
        """The same matrix with ``blocks`` and ``cols`` as tensors on
        ``device`` (moved once, not at every product)."""
        return dataclasses.replace(
            self, blocks=torch.as_tensor(self.blocks).to(device, torch.float32),
            cols=torch.as_tensor(self.cols).to(device, torch.int32))


def bcsr_from_csr(row_ptr, col_idx, weights, shape, bm: int = DEFAULT_BM,
                  bk: int = DEFAULT_BK) -> BCSR:
    """Host-side CSR -> BCSR conversion (the 'dataset load' step)."""
    m, k = shape
    mb = -(-m // bm)
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    weights = (np.ones_like(col_idx, np.float32) if weights is None
               else np.asarray(weights, np.float32))
    # collect per-block-row set of touched block-columns
    block_maps = []
    kmax = 1
    for mblk in range(mb):
        r0, r1 = mblk * bm, min((mblk + 1) * bm, m)
        lo, hi = row_ptr[r0], row_ptr[r1]
        bcols = np.unique(col_idx[lo:hi] // bk) if hi > lo else np.zeros(0, np.int64)
        block_maps.append(bcols)
        kmax = max(kmax, len(bcols))
    blocks = np.zeros((mb, kmax, bm, bk), np.float32)
    cols = np.zeros((mb, kmax), np.int32)
    for mblk in range(mb):
        bcols = block_maps[mblk]
        lut = {int(c): i for i, c in enumerate(bcols)}
        cols[mblk, : len(bcols)] = bcols
        r0, r1 = mblk * bm, min((mblk + 1) * bm, m)
        for r in range(r0, r1):
            for e in range(row_ptr[r], row_ptr[r + 1]):
                c = int(col_idx[e])
                slot = lut[c // bk]
                blocks[mblk, slot, r - r0, c % bk] += weights[e]
    return BCSR(blocks=blocks, cols=cols, shape=(m, k), bm=bm, bk=bk)


def spmv_bcsr(blocks, cols, x, m: int):
    """Hopper kernel.  blocks: (Mb, kmax, bm, bk) f32 CUDA tensor; cols:
    (Mb, kmax) int32; x: (K,) f32.  Returns y = A @ x, (m,) f32."""
    dev = x.device
    _build.check("spmv_bcsr x", x, (torch.float32,))
    if blocks.dim() != 4 or cols.shape != blocks.shape[:2]:
        raise ValueError(f"spmv_bcsr: blocks {tuple(blocks.shape)} and cols "
                         f"{tuple(cols.shape)} are not (Mb, kmax, bm, bk) "
                         f"and (Mb, kmax)")
    mb, kmax, bm, bk = blocks.shape
    if not 0 <= m <= mb * bm:
        raise ValueError(f"spmv_bcsr: {m} rows do not fit {mb} block-rows "
                         f"of {bm}")
    _build.check("spmv_bcsr blocks", blocks.reshape(-1), (torch.float32,),
                 None, dev)
    _build.check("spmv_bcsr cols", cols.reshape(-1), (torch.int32,), None,
                 dev)
    if not (blocks.is_contiguous() and cols.is_contiguous()):
        raise ValueError("spmv_bcsr: blocks and cols must be contiguous")
    y = torch.empty((m,), dtype=torch.float32, device=dev)
    fn = _build.bind("spmv_bcsr", "spmv_bcsr_launch", 4, 3, 3)
    with torch.cuda.device(dev):
        _build.launch("spmv_bcsr", fn, blocks.data_ptr(), cols.data_ptr(),
                      x.data_ptr(), y.data_ptr(), mb, m, x.numel(), kmax,
                      bm, bk, torch.cuda.current_stream(dev).cuda_stream)
    spmv_bcsr.launches += 1
    return y


spmv_bcsr.launches = 0
__all__ = ["BCSR", "bcsr_from_csr", "spmv_bcsr", "plain"]
