"""The port's own spans (`tpt_torch.trace`: `tpt_torch.<stage>`, and
`tpt_torch.wait.<name>` where the host blocks on the device), read from
the profiler's Chrome trace of a traced run, and the arithmetic the
readers of host_syncs and launch_idle_ms share.

The run's `trace.load_chrome_trace` keeps the benchmark's own spans
(`tptbench.*`) only. A reader that needs the port's calls `capture(store)`
from its `hooks`: when the run exports the profiler's Chrome trace,
`store["program"]` receives the port's spans, and `read` finds them as
`trace.counters["program"]`. A program without spans of its own leaves
the list empty, and the readers return None."""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Sequence

from .trace import Span, gaps

PROGRAM_PREFIX = "tpt_torch."
WAIT_PREFIX = PROGRAM_PREFIX + "wait."


def load_program_spans(path: str) -> List[Span]:
    """The `tpt_torch.` user annotations of a Chrome trace, by start."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(PROGRAM_PREFIX)):
            ts = float(e["ts"])
            out.append(Span(e["name"], ts, ts + float(e.get("dur", 0.0))))
    return sorted(out, key=lambda s: (s.start, -s.end))


def capture(store: dict) -> None:
    """Have the run's next export of a profiler's Chrome trace also put
    the port's spans into store["program"]."""
    import torch

    store.setdefault("program", [])
    prof = torch.profiler.profile
    inner = getattr(prof.export_chrome_trace, "inner",
                    prof.export_chrome_trace)

    def export(self, path):
        prof.export_chrome_trace = inner
        out = inner(self, path)
        store["program"] = load_program_spans(path)
        return out

    export.inner = inner
    prof.export_chrome_trace = export


def spans(trace) -> List[Span]:
    """The port's spans that `capture` handed the run's trace, if any."""
    return trace.counters.get("program") or []


def innermost(spans: Sequence[Span], times: Sequence[float]
              ) -> List[Optional[Span]]:
    """For each time, the innermost span open then (start <= t < end), or
    None. The spans nest, as one thread's spans do."""
    order = sorted(spans, key=lambda s: (s.start, -s.end))
    starts = [s.start for s in order]
    out = []
    for t in times:
        # of the spans open at t, the innermost started last
        i = bisect.bisect_right(starts, t)
        out.append(next((s for s in reversed(order[:i]) if s.end > t), None))
    return out


def idle_gaps(trace) -> List[tuple]:
    """(start, end, innermost program span or None) of each idle gap of the
    device in the traced frames, the span taken where the gap opens."""
    lo, hi = trace.window
    g = gaps(trace.busy(), lo, hi)
    return [(a, b, s) for (a, b), s in zip(g, innermost(spans(trace),
                                                        [a for a, _ in g]))]


def idle_ms_by_span(trace) -> Dict[str, float]:
    """Idle ms a frame by the innermost program span open where each gap
    opens ("none" outside every span)."""
    out: Dict[str, float] = {}
    for a, b, s in idle_gaps(trace):
        name = s.name[len(PROGRAM_PREFIX):] if s is not None else "none"
        out[name] = out.get(name, 0.0) + (b - a) / 1e3 / len(trace.frames)
    return out
