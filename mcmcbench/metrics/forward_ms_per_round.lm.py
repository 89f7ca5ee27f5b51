"""models/transformer.py forward_loglik: the stream milliseconds of a test
round's forwards (its ``lm.forward`` spans, theta' and theta, summed), the
mean over the traced segment's rounds."""
from mcmcbench.lib import spans


def read(run):
    return spans.mean_round_ms(run, lambda own, forwards: forwards)
