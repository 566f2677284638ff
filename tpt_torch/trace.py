"""Spans and per-frame counters of tpt_torch, the one place where the port
records what it does.

Spans. `span(name)` marks a stage of the frame, `wait(name)` a point
where the host blocks on the device. While a PyTorch profiler records,
each is `torch.profiler.record_function("tpt_torch." + name)` (a wait is
`tpt_torch.wait.<name>`), so it lands in the profiler's Chrome trace on
the clock of the CUDA kernels, and CUPTI's correlation ids tie each
kernel to the span that launched it. While no profiler records, both
return one shared no-op context: no allocation, no `record_function`,
no device work. The profiler is the only switch. To trace frames:

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as p:
        renderer.frame()
    p.export_chrome_trace("frame.json")

A frame's span `frame` (Renderer.frame; its `record_function` args
carry the renderer's iteration) holds, in order, `raygen`, one `bounce`
a depth (`sort`, `cast.ext`, `logic`, `shade.nee` holding `cast.shadow`,
`shade.env`, `shade.bsdf`), `finish`, in the real-time mode `svgf`
(`svgf.demodulate`, `svgf.temporal`, `svgf.variance`, `svgf.blur`,
`svgf.atrous`, `svgf.modulate`), and `wait.fetch`. Inside the casts: `cast.tail` with
`wait.tail` (BVH_SWEEP's compaction of unresolved lanes) and
`wait.merge` (each boolean-mask gather of the tail's winners),
`wait.cascade` (the cascade's compactions) and `wait.walk` (BVH_XLA's
live-lane check); `wait.history` is SVGF's check for pixels without
history.

Counters. `count(name, value)` adds to the current frame's record, always
(with or without a profiler): a host int is summed at once, a 0-dim
device tensor that the code computes anyway is kept and summed only when
the record is read, so a counter adds no reduction, sync or launch.
`wavefront.trace_frame` starts a new record (`reset`); `frame_counters()`
returns the last frame's as host ints, paying one sync for the device
values. Per frame: `lanes` (the pool width, each bounce), `live` (lanes
cast at each bounce's extension cast), `shadow` (light-NEE shadow rays),
`env` (env-NEE shadow rays), whose sum `live + shadow + env` is
`FrameOutput.rays_traced`; `syncs` (one each `wait`); `walk.walks` and
`walk.steps` (BVH_XLA's walks and their loop iterations).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

PREFIX = "tpt_torch."
_OFF = contextlib.nullcontext()

# the current frame's record: host sums, and device values kept unsummed
_ints: Dict[str, int] = {}
_tensors: Dict[str, List[torch.Tensor]] = {}


def span(name: str, args: Optional[str] = None):
    """A stage `name`: record_function("tpt_torch." + name, args) while a
    profiler records, else a shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name, args)


def wait(name: str):
    """A point where the host blocks on the device: the span
    "wait." + name, and one more `syncs` in the frame's record."""
    count("syncs", 1)
    return span("wait." + name)


def count(name: str, value) -> None:
    """Add `value` (a host int, or a 0-dim integer tensor already
    computed) to the current frame's counter `name`."""
    if isinstance(value, torch.Tensor):
        _tensors.setdefault(name, []).append(value)
    else:
        _ints[name] = _ints.get(name, 0) + int(value)


def reset() -> None:
    """Start a new frame's record."""
    _ints.clear()
    _tensors.clear()


def frame_counters() -> Dict[str, int]:
    """The current (last) frame's counters as host ints; the device
    values are summed here, one sync a device."""
    out = dict(_ints)
    by_dev: Dict[torch.device, list] = {}
    for name, kept in _tensors.items():
        for v in kept:
            by_dev.setdefault(v.device, []).append((name, v))
    for items in by_dev.values():
        vals = torch.stack([v.reshape(()).to(torch.int64)
                            for _, v in items]).tolist()
        for (name, _), x in zip(items, vals):
            out[name] = out.get(name, 0) + x
    return out
