"""Inference kernels beside subsampled MH: the port of ``repro.inference``
(sequential Monte Carlo for the stochastic-volatility paths, the collapsed
NIW component model of the joint DP mixture, and the kernel combinators)."""
from .kernels import Cycle, Mixture, Repeat, run_inference
from .niw import ClusterStats, NIWPrior, posterior_predictive_logpdf, predictive_all_clusters
from .smc import SMCResult, csmc, particle_filter

__all__ = [
    "ClusterStats",
    "Cycle",
    "Mixture",
    "NIWPrior",
    "Repeat",
    "SMCResult",
    "csmc",
    "particle_filter",
    "posterior_predictive_logpdf",
    "predictive_all_clusters",
    "run_inference",
]
