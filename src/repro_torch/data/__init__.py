from .synthetic import SyntheticLM, zipf_tokens
from .pipeline import DataPipeline, shard_batch

__all__ = ["SyntheticLM", "zipf_tokens", "DataPipeline", "shard_batch"]
