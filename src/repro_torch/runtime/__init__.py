from .fault import (ChipLostError, FaultInjector, FaultTolerantLoop,
                    SimulatedFailure)
from .straggler import detect_stragglers, rebalance_chunks
from .elastic import reshard_checkpoint

__all__ = ["ChipLostError", "FaultInjector", "FaultTolerantLoop",
           "SimulatedFailure", "detect_stragglers", "rebalance_chunks",
           "reshard_checkpoint"]
