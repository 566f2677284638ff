"""The precision control of `correct`: the plain reference computed one
precision below the configuration's float32 (bfloat16: the scene's
tables, the rays and every value a path carries rounded to bfloat16
after each stage) put in the program's place, and compared with the
float32 reference by check.numbers, on the frames and pixels a run with
the same seed, warm-up and window frames compares. Its readings have to
exceed the limits.

    python3 -m tptbench.control --workload <cell> --seeds 1,2,3 --frames <n>

`--frames`: the frames of the run's window (its `attempted`). Prints one
JSON line of readings per seed."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import check, run
from .camera_path import camera_path


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def readings(spec: dict, seed: int, frames: int, device) -> dict:
    """The control's numbers against the float32 reference on what a run
    with `seed` and `frames` window frames compares."""
    from tpt_torch.scene import procedural

    config, traffic = spec["config"], spec["traffic"]
    scn = config["scene"]
    host = getattr(procedural, scn["builder"])(**scn["args"])
    path = camera_path(traffic["camera"], seed)
    warm = int(traffic["warmup_frames"])
    # a pipelined renderer returns, from the window's calls, the frames
    # before them
    first = warm - 1 if traffic.get("pipeline", False) and warm > 0 else warm
    kept = check.Sampler.indices(seed, int(traffic["check"]["frames"]),
                                 first, frames)
    return check.numbers(config, traffic, seed, run.raw_scene(host),
                         host.camera, [path.history(k) for k in kept], None,
                         device, quantize=bf16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, required=True)
    args = ap.parse_args(argv)
    for k, v in run.CACHE_ENV.items():
        os.environ[k] = v
    if not torch.cuda.is_available():
        print("tptbench.control needs a CUDA card", file=sys.stderr)
        return 2
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        spec = run.cell_spec(json.load(f), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = readings(spec, seed, args.frames, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "frames": args.frames, "control": nums,
                          "limits": spec["config"]["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
