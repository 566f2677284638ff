"""Metric readers, one file per quantity, found by the part of the
metric's name before its first dot (`eager_ms.offline` and
`eager_ms.realtime` both read with eager_ms.py).

- An end-to-end metric's file defines `window(w) -> float` over the
  run's `run.Window` (the timed frames' host-clock times, the window's
  length, the paths a frame traces, the peak memory, the set-up time).
- A per-layer metric's file defines `read(trace) -> float or None` (None:
  nothing to read, and the metric is left out of the line) and may
  define `hooks(store) -> {target: fn}` to count, in one frame after the
  traced stretch, what calls into the port took and returned
  (fn(args, kwargs, result), writing into `store`, which `read` finds as
  `trace.counters`; the timed frames' `run.Window` is there as
  "window")."""
