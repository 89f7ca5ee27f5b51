"""Hand CUDA kernels for Hopper, their plain PyTorch versions, and the
dispatch between them (:mod:`repro_torch.kernels.ops`), and the tuner of
their launch parameters (:mod:`repro_torch.kernels.autotune`).

Importing this package builds nothing: the kernels are compiled at their
first launch (:mod:`repro_torch.kernels._build`).
"""
from . import autotune, ops, ref

__all__ = ["autotune", "ops", "ref"]
