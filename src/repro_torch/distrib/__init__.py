"""Distributed multi-chip runtime: chip partitioning, every chip's tiles
of a process in one batched superstep, the board exchange (across the
ranks of a ``torch.distributed`` group with ``distrib.mesh``), and the
1 -> 256-chip scaling harness."""
from .driver import DistributedEngine, partition, run_distributed  # noqa: F401
