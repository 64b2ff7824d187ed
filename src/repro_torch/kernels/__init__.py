"""Hopper kernels for the engine's hot spots, with their plain versions.

relax_min        fused mailbox drain (min/add fold + improved mask)
segment_combine  segment min/add -- the P$ group reduction
deliver_fused    owner-mailbox delivery + per-index arrival counts

Each is hand-written CUDA C++ for sm_90a in ``csrc/engine_kernels.cu``,
built on first use by ``_build`` and bound through ``ctypes``.  ``ops``
dispatches on the tensor's device; ``ref`` holds the plain versions.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
