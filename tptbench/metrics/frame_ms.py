"""Milliseconds a frame: the window's seconds over the frames completed
in it. In a traced run, of the timed frames before the profiled stretch
(profiler off)."""


def window(w):
    return w.seconds * 1e3 / len(w.frame_s)


def read(trace):
    w = trace.counters.get("window")
    return window(w) if w is not None and w.frame_s else None
