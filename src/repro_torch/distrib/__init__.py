"""Distributed multi-chip runtime in one process: chip partitioning,
every chip's tiles in one batched superstep, the board exchange, and the
1 -> 256-chip scaling harness."""
from .driver import DistributedEngine, partition, run_distributed  # noqa: F401
