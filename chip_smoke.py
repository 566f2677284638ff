#!/usr/bin/env python3
"""Smoke run of the tpt_torch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's main path — the wavefront integrator on the wide-BVH
kernels K2 (closest hit) and K1 (any hit) — at full size: the
139k-triangle `fireplace_like` bench interior at 1920x1080, depth 8. One
line per phase (name, seconds, key numbers):

  device     nvidia-smi name and power limit, torch and CUDA versions
  build      nvcc (sm_90a) of tpt_torch/csrc/packet_wide.cu and g++ of the
             native SAH builder, from the sources in this checkout
  scene      host scene, SAH BVH and wide pack, uploaded to the card
  kernels    K2/K1 against their plain PyTorch versions on 262,144 live
             rays (camera primaries and one real diffuse bounce of the
             render, and the NEE shadow rays of both bounces), then on all
             2,073,600 lanes of each of those casts as the render launches
             them, dead lanes included; then CUDA-event timings
  render     wavefront.render, BVH_PALLAS, depth 8, 4 iterations at 1080p,
             with the kernels' launch counters zeroed just before and read
             just after
  agreement  the same scene at 240x135, 2 iterations, through the kernels
             and through the plain versions: the images must agree to the
             golden-image tolerance of tests/test_golden.py

Then one JSON line describing each ported kernel, the nvidia-smi line,
and last `{"ok": true, "device": {...}}`. Any failed check raises, so the
run exits nonzero and prints no result; so does a run without a CUDA
device or outside the repository. A watchdog ends the whole run, with a
traceback of every thread, after WATCHDOG_S seconds.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

WATCHDOG_S = 600          # whole run, builds included
DEVICE = "cuda"
RES = (1920, 1080)
DEPTH = 8
RENDER_ITERS = 4
AGREE_RES = (240, 135)
AGREE_ITERS = 2
N_COMPARE = 262_144       # rays held against the plain versions, per kernel
TIMING_REPS = 7
# tolerances of the kernel-vs-plain comparison (the kernel is built without
# multiply-add contraction and walks the same order, so these have slack)
T_RTOL = 1e-4
TRI_MISMATCH_MAX = 1e-4   # fraction of hit rays whose triangle may differ
# card peaks for the bound (H100 SXM data sheet: 3.35 TB/s HBM3; 67
# TFLOP/s fp32 outside the tensor cores, which counts each FMA as two
# operations). The kernels are built with -fmad=false and issue separate
# fp32 mul, add, min/max and compare instructions, so their peak is one
# instruction per fp32 lane per clock: half the data-sheet figure. (CUDA's
# throughput table gives min/max and compare half that rate again; using
# the higher one keeps the bound a least time.)
PEAK_BYTES_S = 3.35e12
PEAK_F32_INSTR_S = 67e12 / 2
# fp32 instructions per slab test (6 sub, 6 mul, 12 min/max, 1 compare)
# and per Moller-Trumbore triangle test (counting the divide as one),
# counted from the kernel source; the kernels count the tests they do
OPS_PER_SLAB = 25
OPS_PER_TRI = 52

REPO = os.path.dirname(os.path.abspath(__file__))


def phase(name: str, t0: float, **numbers) -> None:
    import torch

    torch.cuda.synchronize()
    items = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{name}] {time.perf_counter() - t0:.2f}s {items}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over `reps` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


class Recorder:
    """A Raycaster wrapper that keeps the inputs of every cast."""

    def __init__(self, inner):
        from tpt_torch.integrators.common import Raycaster

        self.ext, self.shadow = [], []

        def closest(o, d, t_max=None):
            self.ext.append((o, d, t_max))
            return inner.closest_hit(o, d, t_max)

        def any_hit(o, d, t_max):
            self.shadow.append((o, d, t_max))
            return inner.any_hit(o, d, t_max)

        self.raycaster = Raycaster(closest_hit=closest, any_hit=any_hit,
                                   name="recorder", capped=inner.capped)


class CastTimer:
    """A Raycaster wrapper that times every cast with CUDA events."""

    def __init__(self, inner):
        import torch

        from tpt_torch.integrators.common import Raycaster

        self.events = {"closest_hit": [], "any_hit": []}

        def timed(kind, fn):
            def call(*args):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*args)
                e.record()
                self.events[kind].append((s, e))
                return out
            return call

        self.raycaster = Raycaster(
            closest_hit=timed("closest_hit", inner.closest_hit),
            any_hit=timed("any_hit", inner.any_hit),
            name="timed", capped=inner.capped)

    def ms(self, kind: str) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events[kind])


def pick(o, d, t_max, mask, k: int):
    """k rays evenly spread over the lanes where `mask` holds."""
    import torch

    from tpt_torch.core.vec import Vec3

    idx = torch.nonzero(mask).squeeze(1)
    if idx.numel() < k:
        raise RuntimeError(f"only {idx.numel()} rays to pick {k} from")
    idx = idx[torch.linspace(0, idx.numel() - 1, k, device=idx.device).long()]
    g = lambda v: Vec3(v.x[idx].contiguous(), v.y[idx].contiguous(),
                       v.z[idx].contiguous())
    return g(o), g(d), t_max[idx].contiguous()


def cat_rays(a, b):
    import torch

    from tpt_torch.core.vec import Vec3

    cv = lambda u, v: Vec3(torch.cat([u.x, v.x]), torch.cat([u.y, v.y]),
                           torch.cat([u.z, v.z]))
    return cv(a[0], b[0]), cv(a[1], b[1]), torch.cat([a[2], b[2]])


def bound(pack, n: int, out_bytes: int, stats) -> tuple:
    """(bound_ms, bound_by) of one launch over n lanes: bytes = rays in
    (7 floats) + tables + outputs; operations = this run's slab tests and
    triangle tests (stats: node visits, slab tests, triangle tests) at the
    fp32 instruction peak."""
    table_bytes = sum(t.numel() * t.element_size()
                      for t in (pack.node_f32, pack.node_child, pack.tri_f32))
    byts = n * 28 + table_bytes + n * out_bytes
    ops = OPS_PER_SLAB * int(stats[1]) + OPS_PER_TRI * int(stats[2])
    b_ms = byts / PEAK_BYTES_S * 1e3
    o_ms = ops / PEAK_F32_INSTR_S * 1e3
    return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")


def check_k2(label: str, res_k, res_p) -> float:
    """Hold K2's (HitRecord, capped) against the plain version's; returns
    the largest absolute difference of t on hits and of u, v where the
    triangles agree."""
    import torch

    (hk, cap_k), (hp, cap_p) = res_k, res_p
    if int(cap_k) or int(cap_p):
        raise RuntimeError(f"{label}: capped rays, kernel {int(cap_k)}, "
                           f"plain {int(cap_p)}")
    hit_k, hit_p = hk.tri >= 0, hp.tri >= 0
    if not torch.equal(hit_k, hit_p):
        raise RuntimeError(f"{label}: K2 hit mask differs on "
                           f"{int((hit_k != hit_p).sum())} rays")
    if not torch.equal(hk.t[~hit_k], hp.t[~hit_k]):
        raise RuntimeError(f"{label}: K2 t differs on misses")
    n_hit = int(hit_k.sum())
    tk, tp = hk.t[hit_k], hp.t[hit_k]
    t_rel = float(((tk - tp).abs() / tp.abs().clamp_min(1e-30)).max()) \
        if n_hit else 0.0
    if t_rel > T_RTOL:
        raise RuntimeError(f"{label}: K2 t differs, max rel {t_rel}")
    same = hk.tri == hp.tri
    tri_diff = int((~same).sum())
    if tri_diff > TRI_MISMATCH_MAX * n_hit:
        raise RuntimeError(f"{label}: K2 triangle differs on {tri_diff} rays")
    err = float((tk - tp).abs().max()) if n_hit else 0.0
    if bool(same.any()):
        err = max(err, float((hk.u - hp.u)[same].abs().max()),
                  float((hk.v - hp.v)[same].abs().max()))
    print(f"  K2 vs plain, {label}: {hk.tri.numel()} rays, {n_hit} hits, "
          f"t max rel {t_rel:.3g}, tri differs {tri_diff}, "
          f"max abs err {err:.3g}")
    return err


def check_k1(label: str, res_k, res_p, t_max) -> float:
    """Hold K1's (occluded, capped) against the plain version's; returns
    the largest absolute difference of the occlusion flags (0 or 1)."""
    (ok, cap_k), (op, cap_p) = res_k, res_p
    if int(cap_k) or int(cap_p):
        raise RuntimeError(f"{label}: capped rays, kernel {int(cap_k)}, "
                           f"plain {int(cap_p)}")
    occ_diff = int((ok != op).sum())
    if occ_diff:
        raise RuntimeError(f"{label}: K1 occlusion differs on {occ_diff} rays")
    dead = t_max - 1e-3 <= 0
    if not bool(ok[dead].all()):
        raise RuntimeError(f"{label}: K1 reports a dead lane unoccluded")
    print(f"  K1 vs plain, {label}: {ok.numel()} rays ({int(dead.sum())} "
          f"dead), {int(ok.sum())} occluded, differs {occ_diff}")
    return float((ok.float() - op.float()).abs().max())


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpt_torch import _build
    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.core.camera import Camera
    from tpt_torch.integrators import wavefront
    from tpt_torch.integrators.common import Raycaster, make_raycaster
    from tpt_torch.scene import native, procedural

    dev = torch.device(DEVICE)
    t_all = time.perf_counter()

    # ---- device -----------------------------------------------------------
    t0 = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    phase("device", t0, nvidia_smi=repr(smi), kind=repr(kind), count=count,
          torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build --------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # nvcc and g++ side by side
        builds = [pool.submit(pt.build_kernels), pool.submit(native._load)]
        for b in builds:
            b.result()
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")
    phase("build", t0, **{f"{k}_s": f"{v:.2f}"
                           for k, v in _build.build_seconds.items()})

    # ---- scene --------------------------------------------------------------
    t0 = time.perf_counter()
    host = procedural.fireplace_like(resolution=RES)
    scene = host.build(with_bvh=True, device=dev)
    cam = host.camera
    pack = scene.pack
    phase("scene", t0, triangles=host.mesh.num_triangles,
          nodes=pack.num_nodes, tri_rows=pack.tri_f32.shape[0],
          arity=pack.arity, cluster=pack.max_cluster)

    # ---- kernels vs plain ---------------------------------------------------
    t0 = time.perf_counter()
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH)
    rec = Recorder(make_raycaster(scene, cfg))
    vp = wavefront.camera_view_proj(cam)
    carry = wavefront.batched_raygen(cam, cfg, 1, dev)
    for depth in range(2):
        carry = wavefront._bounce_body(scene, rec.raycaster, cam, cfg, vp, vp,
                                       depth, carry)
    (p_o, p_d, p_t), (b_o, b_d, b_t) = rec.ext
    (s0_o, s0_d, s0_t), (s1_o, s1_d, s1_t) = rec.shadow
    half = N_COMPARE // 2
    ext = cat_rays(pick(p_o, p_d, p_t, p_t > 0, half),
                   pick(b_o, b_d, b_t, b_t > 0, half))
    shd = cat_rays(pick(s0_o, s0_d, s0_t, s0_t > 0, half),
                   pick(s1_o, s1_d, s1_t, s1_t > 0, half))

    k2 = lambda o, d, t: (pt.packet_closest_hit_wide(pack, o, d, t),
                          pt.closest_hit_wide_plain(pack, o, d, t))
    k1 = lambda o, d, t: (pt.packet_any_hit_wide(pack, o, d, t),
                          pt.any_hit_wide_plain(pack, o, d, t))
    k2_err = check_k2("picked live rays", *k2(*ext))
    k1_err = check_k1("picked live rays", *k1(*shd), shd[2])
    # every lane of each cast, dead lanes included, as the render launches
    # them: the camera primaries, the sorted bounce-1 pool and the shadow
    # rays of both bounces
    k2_err = max(k2_err, check_k2("primaries, all lanes", *k2(p_o, p_d, p_t)),
                 check_k2("bounce-1 pool, all lanes", *k2(b_o, b_d, b_t)))
    k1_err = max(k1_err,
                 check_k1("bounce-0 shadow, all lanes", *k1(s0_o, s0_d, s0_t),
                          s0_t),
                 check_k1("bounce-1 shadow, all lanes", *k1(s1_o, s1_d, s1_t),
                          s1_t))

    # timings on all lanes: K2 on the camera primaries, K1 on the bounce-0
    # shadow rays (dead lanes included, as the render launches them)
    n_full = p_t.shape[0]
    stats2 = torch.zeros(3, dtype=torch.int64, device=dev)
    stats1 = torch.zeros(3, dtype=torch.int64, device=dev)
    pt.packet_closest_hit_wide(pack, p_o, p_d, p_t, stats=stats2)
    pt.packet_any_hit_wide(pack, s0_o, s0_d, s0_t, stats=stats1)
    k2_ms = cuda_time_ms(lambda: pt.packet_closest_hit_wide(pack, p_o, p_d, p_t),
                         TIMING_REPS)
    k2b_ms = cuda_time_ms(lambda: pt.packet_closest_hit_wide(pack, b_o, b_d, b_t),
                          TIMING_REPS)
    k1_ms = cuda_time_ms(lambda: pt.packet_any_hit_wide(pack, s0_o, s0_d, s0_t),
                         TIMING_REPS)
    k2_plain_ms = cuda_time_ms(
        lambda: pt.closest_hit_wide_plain(pack, p_o, p_d, p_t), 1)
    k1_plain_ms = cuda_time_ms(
        lambda: pt.any_hit_wide_plain(pack, s0_o, s0_d, s0_t), 1)
    k2_bound, k2_by = bound(pack, n_full, 16, stats2.cpu())
    k1_bound, k1_by = bound(pack, n_full, 1, stats1.cpu())
    mr = lambda ms: n_full / (ms * 1e-3) / 1e6
    print(f"  K2 primaries: {k2_ms:.3f} ms ({mr(k2_ms):.1f} Mrays/s), "
          f"bounce-1 pool: {k2b_ms:.3f} ms ({mr(k2b_ms):.1f} Mrays/s), "
          f"plain {k2_plain_ms:.1f} ms, bound {k2_bound:.3f} ms ({k2_by}); "
          f"node visits {int(stats2[0])}, slab tests {int(stats2[1])}, "
          f"tri tests {int(stats2[2])}")
    print(f"  K1 bounce-0 shadow: {k1_ms:.3f} ms ({mr(k1_ms):.1f} Mrays/s), "
          f"plain {k1_plain_ms:.1f} ms, bound {k1_bound:.3f} ms ({k1_by}); "
          f"node visits {int(stats1[0])}, slab tests {int(stats1[1])}, "
          f"tri tests {int(stats1[2])}")
    print("  kernels: K2 packet_closest_hit_wide ported (cuda); "
          "K1 packet_any_hit_wide ported (cuda); K3-K11 not yet ported")
    phase("kernels", t0, n_compare=N_COMPARE, lanes=n_full,
          k2_ms=f"{k2_ms:.3f}", k1_ms=f"{k1_ms:.3f}")
    del rec, carry, ext, shd

    # ---- render: the main path ------------------------------------------------
    t0 = time.perf_counter()
    rc = make_raycaster(scene, cfg)
    wavefront.trace_frame(scene, rc, cam, cfg, 100)   # warm-up frame
    torch.cuda.synchronize()
    for k in pt.LAUNCHES:
        pt.LAUNCHES[k] = 0
    tr = time.perf_counter()
    img = wavefront.render(scene, cam, cfg, iterations=RENDER_ITERS,
                           raycaster=rc)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - tr
    launches = dict(pt.LAUNCHES)
    if min(launches.values()) == 0:
        raise RuntimeError(f"main path skipped a kernel: {launches}")
    if int(rc.capped):
        raise RuntimeError(f"render had {int(rc.capped)} capped rays")
    import numpy as np

    if img.shape != (RES[1], RES[0], 3) or not np.isfinite(img).all() \
            or not img.mean() > 0:
        raise RuntimeError(f"bad image: shape {img.shape}, "
                           f"mean {float(np.nanmean(img))}")
    frame_ms = render_s * 1e3 / RENDER_ITERS
    # where one frame's time goes: the casts (CUDA events around each
    # launch) against the whole frame (events around the frame)
    timer = CastTimer(rc)
    s_ev = torch.cuda.Event(enable_timing=True)
    e_ev = torch.cuda.Event(enable_timing=True)
    th = time.perf_counter()
    s_ev.record()
    wavefront.trace_frame(scene, timer.raycaster, cam, cfg, 101)
    e_ev.record()
    host_ms = (time.perf_counter() - th) * 1e3   # enqueue only, no sync
    e_ev.synchronize()
    f_ms = s_ev.elapsed_time(e_ev)
    k2_f, k1_f = timer.ms("closest_hit"), timer.ms("any_hit")
    print(f"  one frame: {f_ms:.1f} ms; K2 casts {k2_f:.1f} ms "
          f"({len(timer.events['closest_hit'])} launches), K1 casts "
          f"{k1_f:.1f} ms ({len(timer.events['any_hit'])} launches), rest "
          f"(raygen, sort, shading, PyTorch launches) {f_ms - k2_f - k1_f:.1f} ms; "
          f"host enqueue {host_ms:.1f} ms")
    # device busy share of one frame: torch.profiler's kernel times against
    # the frame's wall time (profiling itself slows the host side)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        wavefront.trace_frame(scene, rc, cam, cfg, 102)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tw) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"  profiled frame: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.0f}%), {sum(e.count for e in dev_events)} "
          f"kernel launches; top: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
              for e in top))
    phase("render", t0, frame_ms=f"{frame_ms:.1f}",
          mpaths_s=f"{cam.num_pixels / (frame_ms * 1e-3) / 1e6:.3f}",
          launches=json.dumps(launches).replace(" ", ""),
          image_mean=f"{float(img.mean()):.5f}")

    # ---- agreement: kernels vs plain versions, whole renders ------------------
    t0 = time.perf_counter()
    small = Camera.build(AGREE_RES, cam.position, cam.look_at, cam.up,
                         cam.fovy_deg)
    kernel_rc = make_raycaster(scene, cfg)
    img_k = wavefront.render(scene, small, cfg, iterations=AGREE_ITERS,
                             raycaster=kernel_rc)
    plain_capped = torch.zeros((), dtype=torch.int32, device=dev)

    def plain_cast(walk):
        def cast(o, d, t_max):
            out, capped = walk(pack, o, d, t_max)
            plain_capped.add_(capped)
            return out
        return cast

    plain_rc = Raycaster(closest_hit=plain_cast(pt.closest_hit_wide_plain),
                         any_hit=plain_cast(pt.any_hit_wide_plain),
                         name="plain", capped=plain_capped)
    img_p = wavefront.render(scene, small, cfg, iterations=AGREE_ITERS,
                             raycaster=plain_rc)
    if int(kernel_rc.capped) or int(plain_capped):
        raise RuntimeError(f"agreement renders had capped rays: kernels "
                           f"{int(kernel_rc.capped)}, plain {int(plain_capped)}")
    close = float(np.isclose(img_k, img_p, atol=5e-3, rtol=1e-3).mean())
    mean_rel = abs(float(img_k.mean()) / float(img_p.mean()) - 1.0)
    if not (np.isfinite(img_k).all() and close > 0.97 and mean_rel <= 0.02):
        raise RuntimeError(f"kernel and plain renders disagree: close "
                           f"{close}, mean rel {mean_rel}")
    phase("agreement", t0, close=f"{close:.6f}", mean_rel=f"{mean_rel:.3g}",
          max_abs=f"{float(np.abs(img_k - img_p).max()):.3g}")

    kernels = [
        dict(name="packet_closest_hit_wide", route="cuda",
             source="tpt_torch/csrc/packet_wide.cu",
             replaces="tpt/bvh/pallas_traverse.py:893",
             launches=launches["packet_closest_hit_wide"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
             bound_ms=k2_bound, bound_by=k2_by, library_ms=None),
        dict(name="packet_any_hit_wide", route="cuda",
             source="tpt_torch/csrc/packet_wide.cu",
             replaces="tpt/bvh/pallas_traverse.py:959",
             launches=launches["packet_any_hit_wide"],
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=k1_bound, bound_by=k1_by, library_ms=None),
    ]
    print(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
