"""The device's idle share of the traced segment: 1 - the union of its
operations' intervals (from the profiler's trace) over the segment's
length, in %."""


def read(run):
    return None if run.trace is None else run.trace.idle_percent()
