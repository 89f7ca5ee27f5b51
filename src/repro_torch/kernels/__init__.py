"""Hand CUDA kernels for Hopper, their plain PyTorch versions, and the
dispatch between them (:mod:`repro_torch.kernels.ops`).

Importing this package builds nothing: the kernels are compiled at their
first launch (:mod:`repro_torch.kernels._build`).
"""
from . import ops, ref

__all__ = ["ops", "ref"]
