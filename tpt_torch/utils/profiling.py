"""Profiling helpers: per-stage timing with a real device sync, paths/s
and MRays/s, and a `torch.profiler` trace.

Counterpart of `tpt/utils/profiling.py`. Where tpt fetches one element
of each result to wait for the device, the port synchronizes the CUDA
devices the result lives on; on a CUDA device each stage is also timed
by CUDA events (`device_totals`), beside the host's wall clock
(`totals`)."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def force_sync(tree) -> None:
    """Wait until the CUDA work behind every tensor of `tree` (tensors in
    dicts, lists, tuples and dataclasses, such as Vec3) is done."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclass
class StageTimer:
    """Accumulating per-stage timer:

        with timer.stage("trace_ext", result=hit): ...
    """

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    device_totals: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        events = None
        if torch.cuda.is_available():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        holder = {}
        yield holder
        sync_target = holder.get("result", result)
        if sync_target is not None:
            force_sync(sync_target)
        if events is not None:
            events[1].record()
            events[1].synchronize()
            self.device_totals[name] = (self.device_totals.get(name, 0.0)
                                        + events[0].elapsed_time(events[1])
                                        * 1e-3)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t * 1000:9.1f} ms  "
                         f"{t / total * 100:5.1f}%  x{self.counts[name]}")
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.totals.items()})


@contextlib.contextmanager
def device_trace(log_dir: str = "tpt_torch_trace"):
    """A torch.profiler trace of the block (CPU activity, and CUDA
    activity where a device is present), written as a Chrome trace into
    `log_dir`. Best effort: a profiler that cannot start leaves the block
    running untraced."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield log_dir
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except Exception:
                pass


def throughput(num_paths: int, num_rays: int, seconds: float) -> dict:
    """MRays/s and Mpaths/s, as the reference GUI's counters."""
    return {
        "mpaths_per_sec": num_paths / seconds / 1e6,
        "mrays_per_sec": num_rays / seconds / 1e6,
        "ms_per_frame": seconds * 1000.0,
    }
