"""Paper experiments in PyTorch: BayesLR (Sec. 4.1), the joint DP mixture
(Sec. 4.2) and stochastic volatility (Sec. 4.3)."""
from . import bayeslr, jointdpm, stochvol

__all__ = ["bayeslr", "jointdpm", "stochvol"]
