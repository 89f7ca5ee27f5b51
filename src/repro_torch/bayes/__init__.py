"""The paper's transition operator at LM scale (the port of ``repro.bayes``)."""
from .train import (
    LMTrainInfo,
    TrainConfig,
    exact_decide,
    make_cached_train_step,
    make_exact_step,
    make_train_step,
    propose,
    subsampled_decide,
)

__all__ = [
    "LMTrainInfo",
    "TrainConfig",
    "exact_decide",
    "make_cached_train_step",
    "make_exact_step",
    "make_train_step",
    "propose",
    "subsampled_decide",
]
