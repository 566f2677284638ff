"""The 90th percentile of the host-clock times of every frame in the
window, in ms (statistics.quantiles, inclusive). In a traced run, of the
timed frames before the profiled stretch (profiler off)."""

import statistics


def percentile(values, q: int) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def window(w):
    return percentile([t * 1e3 for t in w.frame_s], 90)


def read(trace):
    w = trace.counters.get("window")
    return window(w) if w is not None and w.frame_s else None
