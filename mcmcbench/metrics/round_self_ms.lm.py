"""core/sequential_test.py: a test round's self time on the stream, in ms:
the ``test.round`` span's stream time less its ``lm.forward`` children's
(the draw, the round op, and the device waiting on the host around the read
of ``done``), the mean over the traced segment's rounds."""
from mcmcbench.lib import spans


def read(run):
    return spans.mean_round_ms(run, lambda own, forwards: own - forwards)
