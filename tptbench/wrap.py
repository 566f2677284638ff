"""The benchmark's own spans around calls into the port, installed only
in a traced run and before the renderer is built (the raycaster binds
its cast functions when it is made). Each file under spans/ lists
{"target": "module:attr" or "module:Class.method", "span": name, and
"events": true to time each call with CUDA events}; a metric's reader
may hook a target to count what its calls took and returned."""

from __future__ import annotations

import functools
import glob
import importlib
import json
import os
from typing import Callable, Dict, List

import torch

from .trace import SPAN_PREFIX

HERE = os.path.dirname(os.path.abspath(__file__))


def span_specs() -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, "spans", "*.json"))):
        with open(path) as f:
            out += json.load(f)
    return out


class Spans:
    """Installs the wrappers and restores the originals on close().
    `hooks[target]` are called as hook(args, kwargs, result) while
    `counting` is on; `events[span]` collects (start, end) CUDA events of
    the calls made while `timing` is on."""

    def __init__(self, hooks: Dict[str, List[Callable]]):
        self.hooks = hooks
        self.counting = False
        self.timing = False
        self.events: Dict[str, list] = {}
        self._undo = []
        for spec in span_specs():
            self._wrap(spec)

    def _wrap(self, spec: dict) -> None:
        mod_name, attr = spec["target"].split(":")
        owner = importlib.import_module(mod_name)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        inner = getattr(owner, name)
        label = SPAN_PREFIX + spec["span"]
        hooks = self.hooks.get(spec["target"], [])
        timed = bool(spec.get("events"))

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            ev = None
            if timed and self.timing and torch.cuda.is_available():
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with torch.profiler.record_function(label):
                result = inner(*args, **kwargs)
            if ev is not None:
                ev[1].record()
                self.events.setdefault(spec["span"], []).append(ev)
            if self.counting:
                for hook in hooks:
                    hook(args, kwargs, result)
            return result

        setattr(owner, name, wrapped)
        self._undo.append((owner, name, inner))

    def event_ms(self, span: str) -> List[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events.get(span, [])]

    def close(self) -> None:
        for owner, name, inner in reversed(self._undo):
            setattr(owner, name, inner)
        self._undo = []
