"""The device's idle share of the traced stretch: the stretch minus the
union of kernel, copy and fill intervals, over the stretch, in %."""


def read(trace):
    lo, hi = trace.window
    busy = sum(b - a for a, b in trace.busy())
    if hi <= lo or busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
