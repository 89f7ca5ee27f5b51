"""PyTorch/CUDA port of the sublinear-time approximate MCMC system.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.core.ensemble`` is the counterpart of
``repro.core.ensemble``) and never imports it or JAX. Hand CUDA kernels for
Hopper live in :mod:`repro_torch.kernels`; entry points put their tensors on
the card unless told ``device="cpu"``.
"""
from . import (bayes, checkpoint, configs, convert, core, data, distributed, experiments, fleet,
               inference, kernels, models, obs, optim, partition, ppl, runtime, serving)

__all__ = ["bayes", "checkpoint", "configs", "convert", "core", "data", "distributed",
           "experiments", "fleet", "inference", "kernels", "models", "obs", "optim", "partition",
           "ppl", "runtime", "serving"]
