"""Paper experiments in PyTorch: BayesLR (Sec. 4.1) in this slice."""
from . import bayeslr

__all__ = ["bayeslr"]
