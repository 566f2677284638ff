"""What a traced run reads: device intervals and the benchmark's own
spans, from the profiler's Chrome trace, and the arithmetic that the
per-layer metrics share (interval union, idle gaps, attribution of a
kernel to the span open on the host when it was launched)."""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SPAN_PREFIX = "tptbench."
FRAME_SPAN = SPAN_PREFIX + "frame"
# device activity: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass(frozen=True)
class Op:
    name: str
    cat: str
    start: float           # microseconds, the trace's clock
    end: float
    launch: Optional[float]  # host time of its launch call, if traced


@dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    """A traced stretch of whole frames. `counters` holds what the run's
    counting wrappers and span events stored, by name."""

    ops: List[Op]
    spans: List[Span]
    counters: Dict[str, object] = field(default_factory=dict)

    @property
    def frames(self) -> List[Span]:
        return sorted((s for s in self.spans if s.name == FRAME_SPAN),
                      key=lambda s: s.start)

    @property
    def window(self) -> Tuple[float, float]:
        f = self.frames
        if not f:
            raise ValueError("a traced stretch holds no frame span")
        return f[0].start, max(s.end for s in f)

    def kernels(self) -> List[Op]:
        lo, hi = self.window
        return [o for o in self.ops if o.cat == "kernel" and lo <= o.start < hi]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device-op intervals inside the window."""
        lo, hi = self.window
        ivs = sorted((max(o.start, lo), min(o.end, hi)) for o in self.ops
                     if o.end > lo and o.start < hi)
        return union(ivs)

    def spans_named(self, names: Sequence[str]) -> List[Span]:
        want = {SPAN_PREFIX + n for n in names}
        return [s for s in self.spans if s.name in want]

    def launched_in(self, spans: Sequence[Span]) -> List[Op]:
        """The kernels whose launch call lies inside one of `spans`."""
        ivs = union(sorted((s.start, s.end) for s in spans))
        starts = [a for a, _ in ivs]
        out = []
        for o in self.kernels():
            if o.launch is None:
                continue
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and o.launch <= ivs[i][1]:
                out.append(o)
        return out

    def open_span(self, t: float) -> str:
        """The innermost benchmark span (other than the frame) open on the
        host at time t, or the frame, or "host"."""
        best = None
        for s in self.spans:
            if s.start <= t < s.end and (best is None or s.start >= best.start):
                if s.name != FRAME_SPAN or best is None:
                    best = s
        return best.name[len(SPAN_PREFIX):] if best is not None else "host"


def union(ivs: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge sorted (start, end) intervals."""
    out: List[List[float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def load_chrome_trace(path: str) -> Tuple[List[Op], List[Span]]:
    """Device ops (with their launch's host time, matched by the CUPTI
    correlation id) and the benchmark's spans."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    launches: Dict[int, float] = {}
    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "cuda_runtime" or cat == "cuda_driver":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat in DEVICE_CATS:
            dev.append(e)
        elif cat == "user_annotation" and e.get("name", "").startswith(
                SPAN_PREFIX):
            ts = float(e["ts"])
            spans.append(Span(e["name"], ts, ts + float(e.get("dur", 0.0))))
    ops = []
    for e in dev:
        ts = float(e["ts"])
        corr = e.get("args", {}).get("correlation")
        ops.append(Op(e.get("name", ""), e["cat"], ts,
                      ts + float(e.get("dur", 0.0)), launches.get(corr)))
    return ops, spans
