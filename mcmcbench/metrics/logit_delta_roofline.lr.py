"""kernels/ops.py -> logit_delta.cu: the pair-delta kernel's share of its
roofline in the traced segment, in %: the least time its launches could
take (each launch's bytes, ``counts.pair_delta_bytes``, over the card's
bandwidth; the kernel is bound by bytes) over their profiled device time.
Launches and kernel records are matched in order."""
from mcmcbench.lib import counts

KERNEL = "pair_delta_kernel"


def read(run):
    seg, tr = run.segment, run.trace
    peak = counts.peaks(run.kind)
    if seg is None or tr is None or peak is None:
        return None
    calls = seg.get("pair_delta_calls") or []
    times = tr.kernel_times(KERNEL)
    if not calls or len(calls) != len(times):
        return None
    bound = sum(counts.pair_delta_bytes(shape, rows, seg["dim"]) for shape, rows in calls)
    return 100.0 * bound / peak["hbm_bytes_per_s"] / sum(times)
