"""Hopper kernels, with their plain versions.

relax_min        fused mailbox drain (min/add fold + improved mask)
segment_combine  segment min/add -- the P$ and cascade group reduction
deliver_fused    owner-mailbox delivery + per-index arrival counts
histogram_bin    bin counts (standalone, through ``ops.histogram``)
spmv_csr         BCSR format + block-sparse SpMV (``ops.spmv``)
decode_attention split-KV flash-decode GQA attention
                 (``ops.decode_attention``)

Each is hand-written CUDA C++ for sm_90a in ``csrc/`` (the engine's three
in ``engine_kernels.cu``, the other three a file each), built on first use
by ``_build`` and bound through ``ctypes``.  ``ops``
dispatches on the tensor's device; ``ref`` holds the plain versions.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
