"""Inference kernels beside subsampled MH: the port of ``repro.inference``
(sequential Monte Carlo for the stochastic-volatility paths)."""
from .smc import SMCResult, csmc, particle_filter

__all__ = ["SMCResult", "csmc", "particle_filter"]
