"""Paper experiments in PyTorch: BayesLR (Sec. 4.1) and stochastic
volatility (Sec. 4.3)."""
from . import bayeslr, stochvol

__all__ = ["bayeslr", "stochvol"]
