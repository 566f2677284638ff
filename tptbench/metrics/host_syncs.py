"""Host syncs a frame: the port's `tpt_torch.wait.*` spans (each a point
where the host blocks on the device: the image's fetch, SVGF's history
check, the sweep's tail compaction) that start inside the traced frames,
over the frames."""

from .. import program


def hooks(store):
    program.capture(store)
    return {}


def read(trace):
    spans = program.spans(trace)
    if not spans:
        return None
    lo, hi = trace.window
    waits = [s for s in spans if s.name.startswith(program.WAIT_PREFIX)
             and lo <= s.start < hi]
    return len(waits) / len(trace.frames)
