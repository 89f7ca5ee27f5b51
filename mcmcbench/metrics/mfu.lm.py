"""The model step's share of the card's bf16 peak, in %: the operations of
the forwards the window ran (two a round, theta and theta', over the round's
sequences; ``n_evaluated`` sequences a step), counted from the
configuration's shapes, over the window's seconds times the peak."""
from mcmcbench.lib import counts


def read(run):
    s = run.stats
    peak = counts.peaks(run.kind)
    if not s.get("steps") or peak is None:
        return None
    rb, seq = s["round_batch"], s["seq_len"] - 1
    flops = 2 * sum(n // rb for n in s["n_evaluated"]) * counts.dense_forward_flops(
        s["sizes"], rb, seq)
    return 100.0 * flops / (s["window_s"] * peak["bf16_flops"])
