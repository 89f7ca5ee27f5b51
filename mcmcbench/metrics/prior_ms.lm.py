"""bayes/train.py _prior_delta: the prior's log ratio, its stream
milliseconds a step (the ``lm.prior`` span's ``dev_dur_s``), the mean over
the traced segment's steps."""
from mcmcbench.lib import spans


def read(run):
    return spans.mean_step_ms(run, "lm.prior")
