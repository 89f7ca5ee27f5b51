"""Optimizer substrate: Adam / SGD / SGLD for the hybrid-inference examples
(the port of ``repro.optim``): Adam on the bulk weights interoperating with
subsampled MH on selected blocks, the paper's "interleave with other
general-purpose inference" property."""
from .optimizers import (
    AdamState,
    adam_init,
    adam_step,
    lm_loss_fn,
    sgd_step,
    sgld_step,
)

__all__ = ["AdamState", "adam_init", "adam_step", "lm_loss_fn", "sgd_step", "sgld_step"]
