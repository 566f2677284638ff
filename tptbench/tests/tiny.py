"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
same harness, configuration keys and traffic, on a 3,460-triangle
fireplace at 48x27, depth 3."""

from __future__ import annotations

import copy
import json
import os

from tptbench import run

TRIS = 3000
TRIANGLES = 3460
RES = (48, 27)
DEPTH = 3

# mixes the benchmark has no cell of yet, as a later PR would add them as
# data: a camera at rest (SVGF's history builds up), bursts of moves and
# rests, and a pipelined viewer
MIXES = {
    "still": {"camera": {"yaw_step_deg": 0.0, "yaw_amplitude_deg": 0.5,
                         "moves": 0, "rests": 1},
              "warmup_frames": 1, "trace_frames": 2,
              "check": {"frames": 2, "pixels": 400}},
    "bursts": {"camera": {"yaw_step_deg": 0.3, "yaw_amplitude_deg": 15.0,
                          "moves": 2, "rests": 3},
               "warmup_frames": 2, "trace_frames": 2,
               "check": {"frames": 3, "pixels": 400}},
    "pipelined": {"camera": {"yaw_step_deg": 0.3, "yaw_amplitude_deg": 15.0,
                             "moves": 1, "rests": 1},
                  "pipeline": True, "warmup_frames": 2, "trace_frames": 2,
                  "check": {"frames": 2, "pixels": 400}},
}


def bench() -> dict:
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cut(s: dict) -> dict:
    s = copy.deepcopy(s)
    s["config"]["scene"]["args"].update(num_triangles=TRIS,
                                        resolution=list(RES))
    s["config"]["scene"]["triangles"] = TRIANGLES
    s["config"]["render"]["trace_depth"] = DEPTH
    s["traffic"]["check"]["pixels"] = 400
    return s


def spec(cell: str) -> dict:
    return cut(run.cell_spec(bench(), cell))


def spec_of(config: str, mix: str) -> dict:
    """A cell of configuration `config` under the mix `mix`: a traffic
    file of the benchmark, or one of MIXES."""
    cell = next(w["name"] for w in bench()["workloads"]
                if w["config"] == config)
    s = copy.deepcopy(run.cell_spec(bench(), cell))
    s["traffic"] = copy.deepcopy(MIXES[mix]) if mix in MIXES else \
        run.load_json(run.HERE, "traffic", mix + ".json")
    return cut(s)


def run_tiny(cell, seed: int = 3, seconds: float = 0.5,
             trace: bool = False) -> dict:
    """`cell`: a cell's name, or a spec."""
    import time

    s = spec(cell) if isinstance(cell, str) else cell
    return run.run_cell(s, seed, seconds, trace, "cpu", time.perf_counter())
