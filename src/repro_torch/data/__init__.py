"""Deterministic synthetic token streams (the port of ``repro.data``)."""
from .pipeline import DataConfig, MarkovStream, TokenStream

__all__ = ["DataConfig", "MarkovStream", "TokenStream"]
