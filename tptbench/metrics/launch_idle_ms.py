"""Device idle ms a frame that the host's launch path leaves: the idle
gaps of the traced frames that open while the innermost of the port's
spans open on the host is not a `tpt_torch.wait.*` span (a gap that
opens under a wait is the device drained by a host sync), over the
frames."""

from .. import program


def hooks(store):
    program.capture(store)
    return {}


def read(trace):
    if not program.spans(trace):
        return None
    idle_us = sum(b - a for a, b, s in program.idle_gaps(trace)
                  if s is None or not s.name.startswith(program.WAIT_PREFIX))
    return idle_us / 1e3 / len(trace.frames)
