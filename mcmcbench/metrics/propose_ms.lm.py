"""bayes/train.py propose: the proposal's stream milliseconds a step (log u
and theta', the ``lm.propose`` span's ``dev_dur_s``), the mean over the
traced segment's steps."""
from mcmcbench.lib import spans


def read(run):
    return spans.mean_step_ms(run, "lm.propose")
