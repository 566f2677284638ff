"""The readers of the port's own spans and counters (host_syncs,
launch_idle_ms, live_lane_pct, program.py) on a synthetic trace with
known gaps under wait and stage spans; the existing readers and the
breakdown read the same with the port's spans present; and a traced
tiny run on the CPU hands the readers the port's spans and counters."""

import json

import pytest
import torch

from tptbench import program, run
from tptbench.metrics import cast_roofline, device_idle_pct, eager_ms
from tptbench.metrics import frame_ms, frame_ms_p90, host_syncs
from tptbench.metrics import launch_idle_ms, launches_per_frame
from tptbench.metrics import live_lane_pct, svgf_ms
from tptbench.tests import tiny
from tptbench.tests.test_tptbench_arith import synthetic
from tptbench.trace import Span

EXISTING = (cast_roofline, device_idle_pct, eager_ms, frame_ms, frame_ms_p90,
            launches_per_frame, svgf_ms)
P = program.PROGRAM_PREFIX


def program_spans():
    """Frames 0-100 and 100-200 of test_tptbench_arith.synthetic(), whose
    device is idle 0-12, 60-120 and 150-190."""
    return [Span(P + "frame", 1, 99), Span(P + "bounce", 5, 70),
            Span(P + "cast.ext", 10, 45), Span(P + "wait.tail", 65, 68),
            Span(P + "wait.fetch", 80, 99),
            Span(P + "frame", 101, 199), Span(P + "svgf", 140, 195),
            Span(P + "wait.history", 148, 160),
            Span(P + "wait.fetch", 185, 199),
            # outside the traced frames
            Span(P + "wait.fetch", 250, 260)]


def with_program(tr, spans):
    tr.counters["program"] = spans
    return tr


def test_readers_of_program_spans():
    tr = with_program(synthetic(), program_spans())
    # 4 waits start inside the frames: 2 a frame
    assert host_syncs.read(tr) == 2.0
    # gaps 0-12 (no span open at 0), 60-120 (opens in bounce), 150-190
    # (opens in wait.history): 72 us over 2 frames
    assert launch_idle_ms.read(tr) == pytest.approx(72 / 1e3 / 2)
    assert program.idle_ms_by_span(tr) == pytest.approx(
        {"none": 0.006, "bounce": 0.030, "wait.history": 0.020})
    assert [s and s.name for s in program.innermost(
        program_spans(), [0, 10, 44.9, 45, 66, 99, 150])] == [
        None, P + "cast.ext", P + "cast.ext", P + "bounce", P + "wait.tail",
        None, P + "wait.history"]
    tr.counters["frame_counters"] = {"lanes": 400, "live": 350, "syncs": 3}
    assert live_lane_pct.read(tr) == pytest.approx(87.5)


def test_program_readers_find_nothing_without_the_ports_spans():
    tr = synthetic()
    for mod in (host_syncs, launch_idle_ms, live_lane_pct):
        assert mod.read(tr) is None
    tr.counters["frame_counters"] = {}
    assert live_lane_pct.read(tr) is None


def test_existing_readers_read_the_same_with_program_spans():
    plain, full = synthetic(), with_program(synthetic(), program_spans())
    full.counters["frame_counters"] = {"lanes": 400, "live": 350}
    for mod in EXISTING:
        assert mod.read(plain) == mod.read(full)
    assert run.breakdown(plain) == run.breakdown(full)
    assert plain.spans == full.spans


def test_capture_loads_the_ports_spans_once(tmp_path):
    store: dict = {}
    original = torch.profiler.profile.export_chrome_trace
    program.capture(store)
    program.capture(store)   # a second reader of the same run
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(P + "frame"):
            with torch.profiler.record_function("tptbench.frame"):
                torch.ones(3).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    assert torch.profiler.profile.export_chrome_trace is original
    assert [s.name for s in store["program"]] == [P + "frame"]
    assert store["program"] == program.load_program_spans(path)
    with open(path) as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("cell", ["fireplace_sweep.static",
                                  "fireplace_svgf.orbit"])
def test_traced_tiny_run_hands_the_readers_the_ports_record(cell):
    out = tiny.run_tiny(cell, trace=True)
    tr = out["trace"]
    names = {s.name for s in program.spans(tr)}
    assert {P + "frame", P + "bounce", P + "wait.fetch"} <= names
    m = out["metrics"]
    kind = "offline" if cell.startswith("fireplace_sweep") else "realtime"
    # a CPU run has no device activity: the whole stretch is one gap
    assert m["host_syncs." + kind]["value"] >= 2
    assert 50 < m["live_lane_pct." + kind]["value"] <= 100
    assert m["launch_idle_ms." + kind]["value"] > 0
