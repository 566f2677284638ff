"""Audit of the port's spans and counters on a CUDA card, per benchmark cell.

    python scripts/trace_audit.py [--cells a,b] [--seed n] [--rounds 2]
                                  [--out trace_audit_out]

For each cell of BENCHMARK.json, built as `tptbench.run` builds it, after
the traffic's warm-up frames:

1. Sync audit: one frame under `torch.cuda.set_sync_debug_mode("warn")`.
   Every synchronizing PyTorch call it reports is listed with its source
   line and the `tpt_torch.wait.*` span open around it (None: a sync
   outside every wait span).
2. Tracing cost: blocks of the traffic's `trace_frames` frames under
   torch.profiler, in turns with the port's spans (`trace.span` and
   `trace.wait` as they are) and with both replaced by the no-op, then
   plain frames with no profiler; the median host-clock ms a frame of
   each.
3. Where the idle time goes: from the first profiled block with spans,
   the device's idle ms a frame by the innermost program span open where
   each gap opens, the waits a frame by name, and the readers of
   host_syncs, launch_idle_ms and live_lane_pct; the live lanes of each
   bounce of one frame.

First it times one span's enter and exit, with and without a profiler.
Prints one JSON line a cell and writes it to <out>/<cell>.json. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def audit_cell(name: str, seed: int, rounds: int) -> dict:
    import torch

    from tpt_torch import trace as tt
    from tptbench import program, run
    from tptbench.camera_path import camera_path
    from tptbench.metrics import host_syncs, launch_idle_ms
    from tptbench.trace import Trace, load_chrome_trace
    from tptbench.wrap import Spans

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = run.cell_spec(json.load(f), name)
    inner_span, inner_wait = tt.span, tt.wait
    traffic = spec["traffic"]
    spans = Spans({})   # the benchmark's frame span marks the frames
    try:
        prog = run.Program(spec["config"], "cuda")
        r = prog.renderer
        path = camera_path(traffic["camera"], seed)
        calls = [0]

        def frame():
            k = calls[0]
            if path.moved(k):
                r.move_camera(prog.camera(path.yaw(k)))
            calls[0] += 1
            r.frame()

        for _ in range(int(traffic["warmup_frames"])):
            frame()
        torch.cuda.synchronize()

        # 1. the syncs of one frame, and the wait span open around each
        open_wait = []

        @contextlib.contextmanager
        def marked_wait(w):
            open_wait.append(w)
            try:
                with inner_wait(w):
                    yield
            finally:
                open_wait.pop()

        syncs = []

        def show(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" not in str(message):
                return
            site = next((f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
                         for fr in reversed(traceback.extract_stack())
                         if "tpt_torch" in fr.filename),
                        f"{os.path.relpath(filename, ROOT)}:{lineno}")
            syncs.append({"site": site, "wait": open_wait[-1] if open_wait
                          else None, "message": str(message)[:120]})

        tt.wait = marked_wait
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            old_show = warnings.showwarning
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                frame()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                warnings.showwarning = old_show
                tt.wait = inner_wait
        counted = tt.frame_counters()

        # 2. tracing cost, and 3. the idle time by program span
        n = int(traffic["trace_frames"])
        off = lambda *a, **k: contextlib.nullcontext()
        times = {"spans": [], "no_op": [], "no_profiler": []}
        table = None
        order = ["spans", "no_op", "no_op", "spans"] * rounds
        for kind in order:
            if kind == "no_op":
                tt.span, tt.wait = off, off
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            with prof:
                for _ in range(n):
                    t0 = time.perf_counter()
                    frame()
                    times[kind].append((time.perf_counter() - t0) * 1e3)
            tt.span, tt.wait = inner_span, inner_wait
            if kind == "spans" and table is None:
                fd, tpath = tempfile.mkstemp(suffix=".json")
                os.close(fd)
                try:
                    prof.export_chrome_trace(tpath)
                    ops, bench_spans = load_chrome_trace(tpath)
                    pspans = program.load_program_spans(tpath)
                finally:
                    os.remove(tpath)
                tr = Trace(ops, bench_spans, {"program": pspans})
                lo, hi = tr.window
                waits = {}
                for s in pspans:
                    if s.name.startswith(program.WAIT_PREFIX) and \
                            lo <= s.start < hi:
                        waits[s.name] = waits.get(s.name, 0) + 1
                busy = sum(b - a for a, b in tr.busy())
                table = {
                    "frames": len(tr.frames),
                    "frame_ms_device_window": (hi - lo) / 1e3 / len(
                        tr.frames),
                    "idle_ms": (hi - lo - busy) / 1e3 / len(tr.frames),
                    "idle_ms_by_span": dict(sorted(
                        program.idle_ms_by_span(tr).items(),
                        key=lambda kv: -kv[1])),
                    "waits_per_frame": {k: v / len(tr.frames)
                                        for k, v in waits.items()},
                    "host_syncs": host_syncs.read(tr),
                    "launch_idle_ms": launch_idle_ms.read(tr),
                    "spans_per_frame": len([s for s in pspans
                                            if lo <= s.start < hi])
                    / len(tr.frames)}
            del prof
        for _ in range(n * rounds):
            t0 = time.perf_counter()
            frame()
            times["no_profiler"].append((time.perf_counter() - t0) * 1e3)

        # the live lanes of each bounce of one frame
        per_bounce = []
        inner_count = tt.count

        def keep(k, v):
            if k == "live":
                per_bounce.append(v)
            inner_count(k, v)

        tt.count = keep
        try:
            frame()
        finally:
            tt.count = inner_count
        live = [int(v) for v in per_bounce]
        last = tt.frame_counters()
    finally:
        spans.close()

    ms = {k: statistics.median(v) for k, v in times.items()}
    return {
        "cell": name, "card": card(), "seed": seed,
        "syncs": syncs, "syncs_outside_wait": sum(s["wait"] is None
                                                  for s in syncs),
        "audited_frame_counters": counted,
        "frame_ms": ms, "frame_ms_all": times,
        "spans_cost_pct": (100.0 * (ms["spans"] - ms["no_op"]) / ms["no_op"]
                           if ms["no_op"] else None),
        "trace": table,
        "live_per_bounce": live,
        "live_lane_pct": 100.0 * last["live"] / last["lanes"],
        "frame_counters": last,
    }


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds one `trace.span` costs, entered and left, with a
    profiler recording (CPU and CUDA activity) and with none."""
    import torch

    from tpt_torch import trace as tt

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with tt.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = loop()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        on = loop()
    return {"profiler": on, "no_profiler": off}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="fireplace_sweep.static,"
                    "fireplace_svgf.orbit")
    ap.add_argument("--seed", type=int, default=2**31 + 123)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "trace_audit_out"))
    args = ap.parse_args(argv)

    from tptbench import run

    for k, v in run.CACHE_ENV.items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("trace_audit needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    print(json.dumps({"span_cost_us": span_cost_us()}), flush=True)
    for name in args.cells.split(","):
        res = audit_cell(name, args.seed, args.rounds)
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(res, f, indent=1)
        brief = {k: v for k, v in res.items() if k != "frame_ms_all"}
        print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
