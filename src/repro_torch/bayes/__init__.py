"""The paper's transition operator at LM scale (the port of ``repro.bayes``)."""
from .train import (
    LMTrainInfo,
    LogLikCache,
    TrainConfig,
    cached_decide,
    exact_decide,
    make_cached_train_step,
    make_exact_step,
    make_train_step,
    mala_grads,
    mala_move,
    propose,
    subsampled_decide,
)

__all__ = [
    "LMTrainInfo",
    "LogLikCache",
    "TrainConfig",
    "cached_decide",
    "exact_decide",
    "make_cached_train_step",
    "make_exact_step",
    "make_train_step",
    "mala_grads",
    "mala_move",
    "propose",
    "subsampled_decide",
]
