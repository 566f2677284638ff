"""tpt_torch's spans and per-frame counters (`tpt_torch/trace.py`) at the
benchmark's two configurations (tptbench/configs), cut as tptbench's
tiny cells are: a 3,000-triangle fireplace at 48x27, depth 3.

- Under torch.profiler every stage span of a frame nests in a `bounce`
  inside `frame`, one `bounce` a depth, and with `denoiser_on` SVGF's six
  stages nest in `svgf`; every sync of the frame sits in a `wait.` span.
- With no profiler recording the port enters no `record_function`, and
  its image equals, bit for bit, the profiled frame's.
- The counters: live + shadow (+ env) is the frame's `rays_traced`,
  bounce 0 casts the whole pool, the lanes sum to pool x depth, and the
  record of a frame does not grow with the frames before it.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpt_torch import trace
from tpt_torch.config import RayCastBackend, RenderConfig, SVGFConfig
from tpt_torch.engine import Renderer
from tpt_torch.integrators import wavefront
from tpt_torch.scene import procedural

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("fireplace_sweep", "fireplace_svgf")
RES = (48, 27)
DEPTH = 3
STAGES = {"sort", "cast.ext", "logic", "shade.nee", "cast.shadow",
          "shade.env", "shade.bsdf"}
SVGF = {"svgf.demodulate", "svgf.temporal", "svgf.variance", "svgf.blur",
        "svgf.atrous", "svgf.modulate"}


@pytest.fixture(scope="module")
def cells():
    """Each configuration's scene and RenderConfig, cut to tiny size."""
    host = procedural.fireplace_like(num_triangles=3000, resolution=RES,
                                     seed=11)
    out = {}
    for name in CONFIGS:
        with open(os.path.join(ROOT, "tptbench", "configs",
                               name + ".json")) as f:
            conf = json.load(f)
        render = dict(conf["render"], trace_depth=DEPTH)
        render["backend"] = RayCastBackend[render["backend"]]
        cfg = RenderConfig(svgf=SVGFConfig(**conf.get("svgf", {})), **render)
        out[name] = (host.build(device="cpu", **conf["build"]), host.camera,
                     cfg)
    return out


def _spans(prof, tmp_path):
    """The port's spans of a profiler's Chrome trace: (name, start, end)."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][len(trace.PREFIX):], e["ts"], e["ts"] + e["dur"])
            for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(trace.PREFIX)]


def _inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


@pytest.mark.parametrize("name", CONFIGS)
def test_spans_nest_and_cost_nothing_off(cells, name, monkeypatch, tmp_path):
    scene, cam, cfg = cells[name]
    prof_img = None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prof_img = Renderer(scene, cam, cfg).frame()
    spans = _spans(prof, tmp_path)
    frames = [s for s in spans if s[0] == "frame"]
    bounces = [s for s in spans if s[0] == "bounce"]
    assert len(frames) == 1 and len(bounces) == DEPTH
    assert all(_inside(b, frames[0]) for b in bounces)
    stages = [s for s in spans if s[0] in STAGES]
    assert {s[0] for s in stages} >= {"cast.ext", "logic", "shade.nee",
                                      "cast.shadow", "shade.bsdf"}
    assert sum(s[0] == "sort" for s in spans) == DEPTH - 1
    assert all(any(_inside(s, b) for b in bounces) for s in stages)
    for s in spans:
        if s[0] in ("raygen", "finish", "svgf", "wait.fetch"):
            assert _inside(s, frames[0])
    svgf = [s for s in spans if s[0] == "svgf"]
    subs = [s for s in spans if s[0] in SVGF]
    if cfg.denoiser_on:
        assert len(svgf) == 1 and {s[0] for s in subs} == SVGF
        assert all(_inside(s, svgf[0]) for s in subs)
        assert [s[0] for s in spans if s[0].startswith("wait.")] == [
            "wait.history", "wait.fetch"]
    else:
        assert not svgf and not subs
        # one tail compaction a bounce after the first, then the fetch
        tails = [s for s in spans if s[0] == "cast.tail"]
        assert len(tails) == DEPTH - 1
        assert all(any(_inside(t, b) for b in bounces) for t in tails)
        assert sum(s[0] == "wait.tail" for s in spans) == DEPTH - 1
        assert {s[0] for s in spans if s[0].startswith("wait.")} <= {
            "wait.tail", "wait.merge", "wait.fetch"}
    assert trace.frame_counters()["syncs"] == sum(
        s[0].startswith("wait.") for s in spans)

    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    img = Renderer(scene, cam, cfg).frame()
    assert entered == []
    np.testing.assert_array_equal(img.view(np.uint32),
                                  prof_img.view(np.uint32))


@pytest.mark.parametrize("name", CONFIGS)
def test_counters_add_up_to_the_rays(cells, name, monkeypatch):
    scene, cam, cfg = cells[name]
    outs, counted = [], []
    inner_trace_frame, inner_count = wavefront.trace_frame, trace.count

    def keep_output(*args, **kwargs):
        outs.append(inner_trace_frame(*args, **kwargs))
        return outs[-1]

    def keep_count(name, value):
        counted.append((name, int(value)))
        inner_count(name, value)

    monkeypatch.setattr(wavefront, "trace_frame", keep_output)
    monkeypatch.setattr(trace, "count", keep_count)
    Renderer(scene, cam, cfg).frame()
    c = trace.frame_counters()
    pool = cam.num_pixels * cfg.spp_batch
    assert c["live"] + c["shadow"] + c.get("env", 0) == int(
        outs[0].rays_traced)
    assert c["lanes"] == pool * DEPTH
    assert [v for k, v in counted if k == "lanes"] == [pool] * DEPTH
    # bounce 0 casts every lane of the pool
    assert next(v for k, v in counted if k == "live") == pool
    assert 0 < c["live"] < c["lanes"]


def test_record_does_not_grow(cells):
    scene, cam, cfg = cells["fireplace_svgf"]
    r = Renderer(scene, cam, cfg)
    sizes = []
    for _ in range(3):
        r.frame()
        sizes.append((dict(trace._ints),
                      {k: len(v) for k, v in trace._tensors.items()}))
    assert sizes[0][1] == sizes[2][1] == {"live": DEPTH, "shadow": DEPTH}
    assert sizes[0][0] == sizes[2][0]


def test_counts_and_spans_alone():
    assert trace.span("a") is trace.span("b", "1") is trace.wait("c")
    trace.reset()
    trace.count("n", 2)
    trace.count("n", torch.tensor(5))
    trace.count("m", torch.ones(4, dtype=torch.bool).sum())
    with trace.wait("x"):
        pass
    assert trace.frame_counters() == {"n": 7, "m": 4, "syncs": 1}
    trace.reset()
    assert trace.frame_counters() == {}
