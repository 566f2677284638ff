"""What SVGF over row windows saves a rank of the multi-device render
(`tpt_torch/parallel/halo.py`), against the simpler design in which every
rank gathers the frame's current planes and denoises the whole frame.

It renders two frames of `procedural.fireplace_like()` at 1920x1080 on
BVH_PALLAS (depth 8, 1 spp, the camera turning 3 px before the second,
the SVGF history carried), and times, on the second frame's planes and
the first frame's history, what one rank runs for SVGF at world sizes 1,
2, 4 and 8:

- the window design: `run_svgf` on the largest rank window [r0 - m,
  r1 + m) of the world, m = R + M + 1, with motion_v rebased, as
  `halo.svgf_rows` runs it without its exchange;
- the whole-frame design: `run_svgf` on all 1080 rows (world 1's time).

Each time is the median of REPS calls between CUDA events, after WARM
calls (the state is the same in every call); beside it the device's
busy time and kernel launches a call, by torch.profiler over PROF_REPS
calls, which tell the card's work from the host's launch path. Beside
each it prints the bytes a rank receives a frame under each design: the
window's 34 planes (18 history, 16 current) of the rows it does not
own, against the 16 current planes of every row it does not own (the
whole-frame design keeps the whole history on every rank). A CUDA card
is needed. Run it from the repository's root:

    python scripts/svgf_window_cost.py
"""

import json
import math
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tpt_torch.config import RayCastBackend, RenderConfig  # noqa: E402
from tpt_torch.core.vec import Vec3  # noqa: E402
from tpt_torch.denoise import svgf  # noqa: E402
from tpt_torch.integrators import common, wavefront  # noqa: E402
from tpt_torch.parallel import halo  # noqa: E402
from tpt_torch.scene import procedural  # noqa: E402

RES = (1920, 1080)
PAN_PX = 3.0
WORLDS = (1, 2, 4, 8)
WARM, REPS, PROF_REPS = 3, 15, 5
CURRENT_PLANES, STATE_PLANES = 16, 18


def panned(cam, k: int):
    """The camera turned about its up axis by k * PAN_PX pixels at the
    image centre (chip_smoke.panned)."""
    h = cam.resolution[1]
    angle = k * PAN_PX * 2.0 * math.tan(math.radians(cam.fovy_deg) / 2.0) / h
    axis = np.asarray(cam.true_up)
    v = np.asarray(cam.look_at) - np.asarray(cam.position)
    c, s = math.cos(angle), math.sin(angle)
    rot = v * c + np.cross(axis, v) * s + axis * axis.dot(v) * (1.0 - c)
    return cam.moved(look_at=tuple(np.asarray(cam.position) + rot))


def frame_inputs(scene, cam, cfg):
    """The second frame's 16 planes and the history after the first."""
    w, h = cam.resolution
    rc = common.make_raycaster(scene, cfg)
    state = svgf.SVGFState.zeros(h, w, scene.device)
    plane = lambda a: a.reshape(h, w)
    p3 = lambda v: v.map(plane)
    prev = None
    for k in range(2):
        c = panned(cam, k)
        vp = wavefront.camera_view_proj(c)
        out = wavefront.trace_frame(scene, rc, c, cfg, 1 + k, view_proj=vp,
                                    prev_view_proj=vp if prev is None else prev)
        prev, g = vp, out.gbuf
        planes = [p3(out.direct), p3(out.indirect), p3(g.albedo),
                  plane(g.depth), p3(g.normal), plane(g.mat_id),
                  plane(g.motion_u), plane(g.motion_v)]
        if k == 0:
            _, state = svgf.run_svgf(cfg.svgf, state, *planes)
    return state, planes


def window_call(cfg, state, planes, a: int, b: int):
    """run_svgf on rows [a, b) as halo.svgf_rows runs it (rebased mv)."""
    rows = lambda t: t[a:b]
    st = svgf.SVGFState.from_leaves(map(rows, state.leaves()))
    args = [p.map(rows) if isinstance(p, Vec3) else rows(p) for p in planes]
    args[-1] = halo.rebase_motion_v(args[-1], a)
    return lambda: svgf.run_svgf(cfg.svgf, st, *args)


def timed(fn) -> float:
    for _ in range(WARM):
        fn()
    ms = []
    for _ in range(REPS):
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return statistics.median(ms)


def device_busy(fn) -> tuple:
    """(device busy ms, kernel launches) a call of fn, by torch.profiler's
    kernel times over PROF_REPS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROF_REPS):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in dev) / 1e3 / PROF_REPS,
            sum(e.count for e in dev) / PROF_REPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("svgf_window_cost: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    host = procedural.fireplace_like(resolution=RES)
    scene = host.build(with_bvh=True, device="cuda")
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=8,
                       sort_bounce_rays=True, denoiser_on=True)
    state, planes = frame_inputs(scene, host.camera, cfg)
    w, h = RES
    R = halo.svgf_reach(cfg.svgf)
    mv = torch.nan_to_num(planes[-1].abs(), nan=0.0, posinf=float(h))
    M = min(math.ceil(float(mv.max())), h)
    whole_ms = None
    out = dict(nvidia_smi=smi, R=R, M=M, reps=REPS, worlds=[])
    for world in WORLDS:
        rows = h // world
        wins = halo.windows(h, world, R + M + 1)
        a, b = max(wins, key=lambda ab: ab[1] - ab[0])
        call = window_call(cfg, state, planes, a, b)
        ms = timed(call)
        busy_ms, launches = device_busy(call)
        if world == 1:
            whole_ms = ms
        plane_bytes = w * 4
        window_planes = STATE_PLANES + CURRENT_PLANES
        rec = dict(world=world, rows=rows, window=[a, b],
                   window_ms=ms, whole_frame_ms=whole_ms,
                   window_device_busy_ms=busy_ms, window_launches=launches,
                   window_recv_mb=window_planes * (b - a - rows) * plane_bytes
                   / 1e6,
                   whole_recv_mb=CURRENT_PLANES * (h - rows) * plane_bytes
                   / 1e6)
        out["worlds"].append(rec)
        print(f"world {world}: rows {rows}, window [{a}, {b}) = {b - a} rows, "
              f"SVGF {ms:.3f} ms (whole frame {whole_ms:.3f}), device busy "
              f"{busy_ms:.3f} ms, {launches:.0f} launches; a rank "
              f"receives {rec['window_recv_mb']:.1f} MB (window) against "
              f"{rec['whole_recv_mb']:.1f} MB (whole frame)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
