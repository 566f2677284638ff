"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 -m tptbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the first timed frame) builds the
configuration's scene and a `tpt_torch.engine.Renderer`, and runs the
traffic's warm-up frames. The window then calls `Renderer.frame()` in a
closed loop, one frame after the other as a render or a viewer issues
them (the traffic's camera path moved before each frame), until
`--seconds` have passed. With `--trace 1` the profiler covers a stretch
of whole frames inside the window, the benchmark's spans wrap calls into
the port, and the line carries the cell's per-layer metrics instead of
its end-to-end ones. Once the window has closed and the program's state
is freed, the plain reference (tptbench/reference) recomputes a sample
of what the window's frames produced, drawn from the seed, and
`correct` says whether every compared number is within its limit.

Without a CUDA card the run fails: it never falls back to the CPU.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """perf_counter() at the process's start (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402


HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache the program or PyTorch writes, at fixed paths in the checkout
CACHE_DIR = os.path.join(ROOT, ".tptbench_cache")
CACHE_ENV = {
    "TPT_TORCH_SCENE_CACHE_DIR": os.path.join(CACHE_DIR, "scene"),
    "TORCH_EXTENSIONS_DIR": os.path.join(CACHE_DIR, "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(CACHE_DIR, "triton"),
}
FORBIDDEN = ("jax", "jaxlib", "flax", "tpt")
NAME_CHARS = 200


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    """The cell, its configuration and traffic, and the metrics it
    reports (end-to-end and per-layer), all found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = confs[cell["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    return dict(
        cell=cell,
        config=load_json(ROOT, conf["file"]),
        traffic=load_json(HERE, "traffic", cell["traffic"] + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def reader(metric_name: str):
    """The module of tptbench/metrics/<name before the first dot>.py: an
    end-to-end metric's defines `window(w)`, a per-layer one's
    `read(trace)`."""
    return importlib.import_module(
        "tptbench.metrics." + metric_name.split(".")[0])


def raw_scene(host) -> dict:
    """The host scene's raw arrays: the input both sides get."""
    m = host.mesh
    for mat in host.materials:
        if max(mat.tex_diffuse, mat.tex_metallic_roughness,
               mat.tex_normal) >= 0:
            raise ValueError("the reference renders untextured scenes")
    if host.env_map is not None:
        raise ValueError("the reference renders scenes without an env map")
    return dict(positions=m.positions, normals=m.normals, indices=m.indices,
                material_ids=m.material_ids,
                materials=[dict(basecolor=mat.basecolor,
                                metallic=mat.metallic,
                                roughness=mat.roughness,
                                emittance=mat.emittance, ior=mat.ior,
                                mtype=int(mat.mtype))
                           for mat in host.materials])


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclass(frozen=True)
class Window:
    """What the end-to-end metrics read: the timed frames' host-clock
    seconds, the window's length, the paths a frame traces, the peak of
    device memory over the window and the set-up time."""

    frame_s: Tuple[float, ...]
    seconds: float
    paths_per_frame: int
    peak_bytes: int
    setup_s: float


class Program:
    """The system under test, built from a configuration file."""

    def __init__(self, config: dict, device):
        from tpt_torch.config import RayCastBackend, RenderConfig, SVGFConfig
        from tpt_torch.engine import Renderer
        from tpt_torch.scene import procedural

        scn = config["scene"]
        self.host = getattr(procedural, scn["builder"])(**scn["args"])
        tris = self.host.mesh.num_triangles
        if tris != scn["triangles"]:
            raise RuntimeError(f"the scene has {tris} triangles, the "
                               f"configuration {scn['triangles']}")
        self.scene = self.host.build(device=device, **config["build"])
        render = dict(config["render"])
        render["backend"] = RayCastBackend[render["backend"]]
        self.cfg = RenderConfig(svgf=SVGFConfig(**config.get("svgf", {})),
                                **render)
        self.cam0 = self.host.camera
        self.renderer = Renderer(self.scene, self.cam0, self.cfg)

    def camera(self, yaw_deg: float):
        from tpt_torch.core.camera import Camera

        from .camera_path import yawed_position

        c = self.cam0
        return Camera.build(c.resolution,
                            yawed_position(c.position, c.look_at, c.up,
                                           yaw_deg),
                            c.look_at, c.up, c.fovy_deg)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """Set-up, window, (trace), reference check: the result line's
    fields, and the compared numbers and their limits under "checks"."""
    import torch

    from . import check
    from .camera_path import camera_path
    from .wrap import Spans
    from .trace import Trace, load_chrome_trace

    config, traffic = spec["config"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)

    readers = {m["name"]: reader(m["name"]) for m in spec["per_layer"]} \
        if trace else {}
    store: dict = {}
    hooks: Dict[str, list] = {}
    for mod in readers.values():
        for target, fn in (getattr(mod, "hooks", lambda s: {})(store)).items():
            hooks.setdefault(target, []).append(fn)
    spans = Spans(hooks) if trace else None
    try:
        prog = Program(config, device)
        r = prog.renderer
        r.pipeline = bool(traffic.get("pipeline", False))
        path = camera_path(traffic["camera"], seed)
        calls = [0]

        def one_frame():
            """Frame k's call: the image it returns, and which frame that
            is (a pipelined renderer returns the frame before)."""
            k = calls[0]
            if path.moved(k):
                r.move_camera(prog.camera(path.yaw(k)))
            calls[0] += 1
            return r.frame(), (k - 1 if r.pipeline and k > 0 else k)

        for _ in range(int(traffic["warmup_frames"])):
            one_frame()
        sync()
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        capped = int(r.raycaster.capped)
        setup_s = time.perf_counter() - t0

        sampler = check.Sampler(seed, int(traffic["check"]["frames"]))
        frame_s: List[float] = []
        state = {"failed": 0, "capped": capped}

        def step(offer: bool):
            """One frame of the loop: its time, failure and sampling."""
            f0 = time.perf_counter()
            try:
                img, k = one_frame()
                now_capped = int(r.raycaster.capped)
                if now_capped > state["capped"]:
                    state["failed"] += 1
                state["capped"] = now_capped
            except Exception:  # a failed frame counts; the loop goes on
                traceback.print_exc(file=sys.stderr)
                state["failed"] += 1
                img = None
            frame_s.append(time.perf_counter() - f0)
            if img is not None and offer:
                sampler.offer(k, img)

        w0 = time.perf_counter()
        while True:
            step(True)
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        failed = state["failed"]
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        paths = prog.cam0.num_pixels * max(1, prog.cfg.spp_batch)
        win = Window(tuple(frame_s), window_s, paths, window_peak, setup_s)
        if trace:
            # after the timed frames: the profiled stretch of whole frames,
            # then one frame in which the readers' hooks count
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            with prof:
                spans.timing = True
                for _ in range(int(traffic["trace_frames"])):
                    step(False)
                spans.timing = False
            if hooks:
                spans.counting = True
                step(False)
                spans.counting = False
        peak = max(setup_peak,
                   torch.cuda.max_memory_allocated() if cuda else 0)

        result: dict = {"attempted": len(win.frame_s), "failed": failed}
        if trace:
            fd, tpath = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                prof.export_chrome_trace(tpath)
                ops, spn = load_chrome_trace(tpath)
            finally:
                os.remove(tpath)
            del prof
            counters = dict(store, window=win)
            for s in spans.events:
                counters["events:" + s] = spans.event_ms(s)
            tr = Trace(ops, spn, counters)
            metrics = {}
            # a stretch with no frame span has nothing to read
            for m in (spec["per_layer"] if tr.frames else []):
                value = readers[m["name"]].read(tr)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["metrics"] = metrics
            if tr.frames:
                result["trace"] = tr
        else:
            result["metrics"] = {
                m["name"]: {"value": reader(m["name"]).window(win),
                            "unit": m["unit"]}
                for m in spec["end_to_end"]}
        result["memory_peak_bytes"] = int(peak)
        result["power_limit_w"] = power_limit_w() if cuda else None
    finally:
        if spans is not None:
            spans.close()

    # ---- the reference, once the program's state is freed -------------
    raw, cam0 = raw_scene(prog.host), prog.cam0
    kept = sampler.kept
    del prog, r
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    limits = config["limits"]
    indices = [k for k, _ in kept]
    history = [path.history(k) for k in indices]
    if kept:
        numbers = check.numbers(config, traffic, seed, raw, cam0, history,
                                [img for _, img in kept], device)
        whole = check.pixels(config, traffic, seed, cam0.resolution) is None
        sample = (f"frames {indices} (view, frames since its last move: "
                  f"{history}), " + ("whole frames" if whole else
                                     f"{traffic['check']['pixels']} pixels"))
    else:
        numbers = {k: float("inf") for k in limits}
        sample = "no frame completed"
    result["checks"] = {"numbers": numbers, "limits": limits,
                        "sample": sample, "frames": indices,
                        "history": history}
    print(f"tptbench: set-up {setup_s:.3f} s, window {window_s:.3f} s of "
          f"{len(win.frame_s)} frames, reference "
          f"{time.perf_counter() - r0:.3f} s", file=sys.stderr)
    return result


def breakdown(tr) -> dict:
    """The device ops that took most time and the longest idle gaps, by
    the benchmark span open on the host (summed by name), in seconds."""
    from .trace import gaps

    by_op: Dict[str, float] = {}
    for o in tr.kernels():
        by_op[o.name] = by_op.get(o.name, 0.0) + (o.end - o.start) / 1e6
    lo, hi = tr.window
    by_gap: Dict[str, float] = {}
    for a, b in gaps(tr.busy(), lo, hi):
        name = tr.open_span(a)
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e6
    # a kernel's name up to NAME_CHARS characters (templates run long)
    top = lambda d: [[k[:NAME_CHARS], v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        raise SystemExit("--seconds must be positive")
    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(bench_path):
        print(f"no BENCHMARK.json at {ROOT}", file=sys.stderr)
        return 2
    spec = cell_spec(load_json(bench_path), args.workload)
    chips = int(spec["cell"]["chips"])

    for k, v in CACHE_ENV.items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"tptbench needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tpt_torch")):
        print("tptbench: the checkout holds no tpt_torch package",
              file=sys.stderr)
        return 2

    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                   T0)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"tptbench: the process loaded {found}; the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 3
    checks = out["checks"]
    limits, numbers = checks["limits"], checks["numbers"]
    from .check import judge

    correct = judge(numbers, limits) and out["attempted"] > 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit_w": out["power_limit_w"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    tr = out.get("trace")
    if tr is not None:
        lo, hi = tr.window
        device["busy_s"] = sum(b - a for a, b in tr.busy()) / 1e6
        device["window_s"] = (hi - lo) / 1e6
        device["traced_frames"] = len(tr.frames)
        line["breakdown"] = breakdown(tr)
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                      for k in limits}
    print(f"check sample: {checks['sample']}", file=sys.stderr)
    for k in limits:
        print(f"check {k}: {numbers[k]!r} (limit {limits[k]!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
