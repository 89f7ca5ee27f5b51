"""Deterministic synthetic token streams (the port of ``repro.data``)."""
from .pipeline import DataConfig, MarkovStream, TokenStream, shard_batch

__all__ = ["DataConfig", "MarkovStream", "TokenStream", "shard_batch"]
