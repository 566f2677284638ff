"""SVGF's device time a frame: CUDA events recorded on the stream around
each call of denoise/svgf.py's run_svgf in the traced stretch."""


def read(trace):
    ms = trace.counters.get("events:svgf") or []
    return sum(ms) / len(trace.frames) if ms else None
