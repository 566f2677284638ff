#!/usr/bin/env python3
"""Smoke run of the tpt_torch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's four main paths at full size on the 139k-triangle
`fireplace_like` bench interior at 1920x1080, depth 8: the wavefront
integrator on the wide-BVH kernels K2 (closest hit) and K1 (any hit)
(BVH_PALLAS); the bench's own BVH_SWEEP configuration, whose bounces
after the first run the dense treelet scan K3, the bin sort, the demand
sweep K4 and a K2 tail; the engine's real-time denoised frame
(`Renderer` with the denoiser on: a BVH_PALLAS frame, then SVGF with the
temporal reprojection K6 and five a-trous passes K5); and the
BVH_TREELET backend, whose camera rays go through the self-rebinning
closest hit K10 and whose later bounces run the treelet scan K9, the
hybrid easy/hard split and one sort, K10 seeded on the easy rays and K2
on the hard ones. One line per phase (name, seconds, key numbers):

  device     nvidia-smi name and power limit, torch and CUDA versions
  build      nvcc (sm_90a) of tpt_torch/csrc/packet_wide.cu,
             tpt_torch/csrc/sweep.cu, tpt_torch/csrc/svgf.cu and
             tpt_torch/csrc/treelet.cu and g++ of the native SAH library,
             all at once, from the sources in this checkout
  scene      host scene, SAH BVH, wide pack, treelet cut and sweep tables
             (chunk_align 8, as bench.py builds them), uploaded to the card
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
  sweep_kernels
             the bench configuration's pools (spp_batch 4: 8,294,400 lanes):
             K3 against its plain version on every lane of the unsorted
             bounce-1 pool, K4 on every lane of the bin-sorted bounce-1 pool
             and on 262,144 lanes (whole blocks) of the bounce-4 pool, both
             bit for bit; the final sweep_cast_sorted hits against K2 on
             every lane of bounce 1 (t bit-equal, triangles up to equal-t
             ties); CUDA-event timings, bounds, union sizes, tail share
  sweep_render
             wavefront.render in the bench configuration (BVH_SWEEP, depth
             8, spp_batch 4, sweep_unroll 8) at 1080p, with all launch
             counters zeroed just before and read just after; frame ms,
             Mpaths/s, and one frame split by stage with CUDA events
  sweep_agreement
             BVH_SWEEP at 240x135 through the kernels, through the plain
             versions and against the BVH_PALLAS render
  svgf_kernels
             a denoised 1080p sequence (BVH_PALLAS, depth 8), 3 frames with
             the camera turning and the SVGF history carried across the
             turns; on the third frame K6 and K5 at each of its 5 steps
             against their plain versions on every pixel, bit for bit;
             CUDA-event timings (launches back to back) and bounds
  svgf_render
             Renderer at 1080p, denoiser on, 8 frames with the camera
             turning a few pixels a frame, with all launch counters zeroed
             just before and read just after (5 K5 and 1 K6 launches a
             frame); frame ms, a moving and a resting frame split by CUDA
             events into the trace and SVGF (K6, K5 x5, the rest), the
             device busy share of a profiled frame, the share of pixels
             with history, the median motion
  svgf_agreement
             both sequences at 240x135 through the kernels and through the
             plain versions: each denoised frame must agree to the
             golden-image tolerance
  treelet_kernels
             BVH_TREELET with tpt's defaults (treelets of <= 256
             triangles, 4 slots, hybrid split at 3 candidates, packets of
             2048 lanes on bounces and 4096 for camera rays): K9 against
             its plain version on every lane of the unsorted bounce-1
             pool, K10 seeded on whole packets of the sorted bounce-1 pool
             and unseeded on whole packets of the camera rays, all bit for
             bit; the extension cast's hits (K10 and K2 picked by the hard
             flag) against K2 alone on every lane; CUDA-event timings,
             bounds (K10's from the tests K2's per-ray walk needs on the
             same lanes), drains per packet, hard and seeded shares
  treelet_render
             wavefront.render with BVH_TREELET at 1080p, depth 8, with all
             launch counters zeroed just before and read just after (K10 8,
             K9 7, K2 7, K1 8 a frame); frame ms, Mpaths/s, and one frame
             split by CUDA events into K9 and the sort, K10, K2, K1 and
             the rest
  treelet_agreement
             BVH_TREELET at 240x135, depth 8, both samples in one pool
             (spp_batch 2), through the kernels, through the plain versions
             and against the BVH_PALLAS render; it refuses to start with
             less than twice its plain render's time left on the watchdog

Then one JSON line describing each ported kernel (K9's and K10's with
the lanes their times and bound were taken on), the nvidia-smi line,
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
T_START = time.perf_counter()
DEVICE = "cuda"
RES = (1920, 1080)
DEPTH = 8
RENDER_ITERS = 4
AGREE_RES = (240, 135)
AGREE_ITERS = 2
N_COMPARE = 262_144       # rays held against the plain versions, per kernel
TIMING_REPS = 7
KERNEL_REPS = 20          # back-to-back launches of a short kernel (kernel_ms)
# bench.py:264-266: BVH_SWEEP, depth 8, spp_batch 4, sweep_unroll 8 on
# tables built with chunk_align 8
SWEEP_ALIGN = 8
SWEEP_KNOBS = dict(trace_depth=DEPTH, spp_batch=4, sweep_unroll=8)
SWEEP_FRAMES = 4          # frames of the timed sweep render
SWEEP_BOUNCES = (1, 4)    # pools whose K4 result is held against plain
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
TAIL_TRI_MISMATCH_MAX = 1e-4   # of live lanes: equal-t ties between treelets
# the denoised sequence: frames of the timed render, and the camera's turn
# per frame in pixels at the image centre (the viewer's navigation)
SVGF_FRAMES = 8
SVGF_PAN_PX = 3.0
# bytes a pixel moves (float32/int32 planes read once and written once)
# and fp32 operations it needs (counted from tpt_torch/csrc/svgf.cu; exp,
# pow and the divides counted as one each, so the bound stays a least
# time): K5 reads 12 planes and writes 8; K6 reads 15 history and 7
# current planes and writes 11
ATROUS_BYTES_PX, ATROUS_OPS_PX = 80, 532
REPROJECT_BYTES_PX, REPROJECT_OPS_PX = 132, 210
# BVH_TREELET: whole packets held against the plain versions (seeded
# 2048-lane bounce packets, unseeded 4096-lane camera-ray packets), frames
# of the timed render, and back-to-back launches timed per kernel
TREELET_SEEDED_PACKETS = 128
TREELET_PRIMARY_PACKETS = 64
TREELET_FRAMES = 2
TREELET_REPS = 3
# the plain 240x135 BVH_TREELET render of treelet_agreement, at most, on an
# H100 80GB HBM3 at 700 W: 113-138 s; its sequential steps are set by the
# slowest packet, so a slower host takes longer
TREELET_PLAIN_RENDER_S = 140.0

REPO = os.path.dirname(os.path.abspath(__file__))


def phase(name: str, t0: float, **numbers) -> None:
    import torch

    torch.cuda.synchronize()
    items = " ".join(f"{k}={v}" for k, v in numbers.items())
    now = time.perf_counter()
    print(f"[{name}] {now - t0:.2f}s (run at {now - T_START:.1f}s, "
          f"{100 * (now - T_START) / WATCHDOG_S:.0f}% of the {WATCHDOG_S} s "
          f"watchdog) {items}", flush=True)


def golden_agree(label: str, img, ref) -> dict:
    """Hold image `img` against `ref` at tests/test_golden.py's tolerance:
    finite, more than 97% of pixels within atol 5e-3 / rtol 1e-3, means
    within 2%. Raises if they disagree; returns (close share, mean rel,
    max abs)."""
    import numpy as np

    close = float(np.isclose(img, ref, atol=5e-3, rtol=1e-3).mean())
    mean_rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
    if not (np.isfinite(img).all() and close > 0.97 and mean_rel <= 0.02):
        raise RuntimeError(f"{label} disagrees: close {close}, mean rel "
                           f"{mean_rel}")
    return close, mean_rel, float(np.abs(img - ref).max())


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_once(fn):
    """(fn(), its CUDA-event time in ms), without a warm-up: for the plain
    versions, whose one run on a full pool is also their comparison."""
    import torch

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


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


def kernel_ms(fn, reps: int) -> float:
    """Device time in ms of one fn() (a short kernel launch), by CUDA
    events around `reps` launches that the host enqueues while the card
    runs a sleep kernel: the events then time the kernels back to back,
    not the host's launch overhead, which CUDA events around one short
    launch also catch when the card waits for the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))              # ~100 ms at the H100's clocks
    th = time.perf_counter()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    host_ms = (time.perf_counter() - th) * 1e3
    e.synchronize()
    if host_ms > 60.0:
        raise RuntimeError(f"enqueueing {reps} launches took {host_ms:.1f} ms, "
                           "longer than the sleep that hides it")
    return s.elapsed_time(e) / reps


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


class Patch:
    """Swaps module attributes and puts them back (the sweep path calls
    its kernels and stages through their modules, so a run can time them
    or route them to the plain versions)."""

    def __init__(self):
        self._undo = []

    def set(self, mod, attr, value) -> None:
        self._undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    def restore(self) -> None:
        while self._undo:
            mod, attr, value = self._undo.pop()
            setattr(mod, attr, value)


def plain_kernels() -> Patch:
    """Route K1-K6, K9 and K10 to their plain PyTorch versions (on the
    card)."""
    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.bvh import treelet_traverse as tlt
    from tpt_torch.denoise import reproject, stencil, svgf

    p = Patch()
    p.set(tlt, "treelet_scan", tlt.treelet_scan_plain)
    p.set(tlt, "treelet_closest_hit", tlt.treelet_closest_hit_plain)
    p.set(stencil, "atrous", stencil.atrous_plain)
    p.set(reproject, "reproject", svgf._reproject_taps)
    p.set(sw, "dense_scan", sw.dense_scan_plain)
    p.set(sw, "sweep8_closest_hit", sw.sweep8_closest_hit_plain)
    p.set(pt, "packet_closest_hit_wide", pt.closest_hit_wide_plain)
    p.set(pt, "packet_any_hit_wide", pt.any_hit_wide_plain)
    return p


class StageTimer:
    """CUDA events around every call of the sweep path's stages."""

    def __init__(self):
        self.events = {}
        self.patch = Patch()

    def timed(self, label, fn):
        import torch

        def call(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kw)
            e.record()
            self.events.setdefault(label, []).append((s, e))
            return out

        return call

    def wrap(self, mod, attr, label):
        self.patch.set(mod, attr, self.timed(label, getattr(mod, attr)))

    def ms(self, label: str) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events.get(label, []))


def equal_hits(label: str, a, b) -> None:
    """Two HitRecords bit for bit (t, tri, u, v)."""
    import torch

    for f in ("t", "tri", "u", "v"):
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x, y):
            raise RuntimeError(f"{label}: {f} differs on "
                               f"{int((x != y).sum())} lanes")


def whole_blocks(n: int, k: int, device, lanes: int = 128):
    """Lane indices of k // lanes whole `lanes`-lane blocks spread evenly
    over the first n lanes."""
    import torch

    nb = n // lanes
    if nb < k // lanes:
        raise RuntimeError(f"only {nb} whole blocks to pick {k // lanes} from")
    blocks = torch.linspace(0, nb - 1, k // lanes, device=device).long()
    return (blocks[:, None] * lanes
            + torch.arange(lanes, device=device)).reshape(-1)


def sweep_bound(n: int, in_bytes: int, out_bytes: int, table_bytes: int,
                ops: int) -> tuple:
    """(bound_ms, bound_by): bytes = n lanes in and out + tables once;
    operations at the fp32 instruction peak."""
    b_ms = (n * (in_bytes + out_bytes) + table_bytes) / PEAK_BYTES_S * 1e3
    o_ms = ops / PEAK_F32_INSTR_S * 1e3
    return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")


def sweep_phases(scene, cam, dev) -> list:
    """The sweep_kernels, sweep_render and sweep_agreement phases; returns
    the K3 and K4 entries of the kernels line."""
    import numpy as np
    import torch

    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.bvh import sweepcast as tsc
    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.core.camera import Camera
    from tpt_torch.core.vec import Vec3
    from tpt_torch.integrators import common, wavefront

    tables = scene.sweep
    cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, **SWEEP_KNOBS)
    S, unroll = cfg.sweep_slots, cfg.sweep_unroll

    # ---- sweep_kernels: the pools of one bench frame ------------------------
    t0 = time.perf_counter()
    grabbed = {}
    scan_keys, bin_sort = wavefront._sweep_scan_keys, wavefront._sweep_bin_sort
    depth_now = [0]

    def grab_scan(scn, c, pool):
        out = scan_keys(scn, c, pool)
        if depth_now[0] == 1:
            grabbed["scan_in"], grabbed["scan_out"] = pool, out[1]
        return out

    def grab_sort(c, pool, keys, raw):
        out = bin_sort(c, pool, keys, raw)
        if depth_now[0] in SWEEP_BOUNCES:
            grabbed[depth_now[0]] = out
        return out

    patch = Patch()
    patch.set(wavefront, "_sweep_scan_keys", grab_scan)
    patch.set(wavefront, "_sweep_bin_sort", grab_sort)
    try:
        rc = common.make_raycaster(scene, cfg)
        vp = wavefront.camera_view_proj(cam)
        carry = wavefront.batched_raygen(cam, cfg, 1, dev)
        for depth in range(max(SWEEP_BOUNCES) + 1):
            depth_now[0] = depth
            carry = wavefront._bounce_body(scene, rc, cam, cfg, vp, vp,
                                           depth, carry)
    finally:
        patch.restore()
    del carry
    pool = grabbed["scan_in"]
    n = pool[0].x.shape[0]
    pre_tmax = torch.where(pool[5], 3.4e38, -1.0)
    # K3 on every lane of the unsorted bounce-1 pool, dead lanes included
    k3 = grabbed["scan_out"]
    k3_plain, k3_plain_ms = timed_once(lambda: sw.dense_scan_plain(
        tables, pool[0], pool[1], pre_tmax, slots=S))
    for a, b, what in zip(k3, k3_plain, ("entry t", "ordinal", "thr")):
        if not torch.equal(a, b):
            raise RuntimeError(f"K3 {what} differs from plain on "
                               f"{int((a != b).sum())} of {a.numel()} values")
    k3_err = max(float((a.float() - b.float()).abs().max())
                 for a, b in zip(k3, k3_plain))
    print(f"  K3 vs plain, unsorted bounce-1 pool: {n} lanes "
          f"({int((~pool[5]).sum())} dead), bit-equal")
    k3_ms = cuda_time_ms(lambda: sw.dense_scan(tables, pool[0], pool[1],
                                               pre_tmax, slots=S), TIMING_REPS)
    st3 = torch.zeros(1, dtype=torch.int64, device=dev)
    sw.dense_scan(tables, pool[0], pool[1], pre_tmax, slots=S, stats=st3)
    k3_bound, k3_by = sweep_bound(
        n, 28, 8 * S + 4, tables.boxes.numel() * 4,
        OPS_PER_SLAB * int(st3[0]))
    del k3_plain, pool

    # K4 on the bin-sorted pools: all of bounce 1, whole blocks of bounce 4
    k4_err = 0.0
    for b in SWEEP_BOUNCES:
        spool, (s_o, s_t, thr) = grabbed[b]
        ori, d = spool[0], spool[1]
        tmax = torch.where(spool[5], 3.4e38, -1.0)
        if b != SWEEP_BOUNCES[0]:
            idx = whole_blocks(n, N_COMPARE, dev)
            g = lambda a: a[idx].contiguous()
            ori, d = Vec3(g(ori.x), g(ori.y), g(ori.z)), Vec3(g(d.x), g(d.y), g(d.z))
            tmax, s_o, s_t = g(tmax), s_o[:, idx], s_t[:, idx]
        hk = sw.sweep8_closest_hit(tables, ori, d, tmax, s_o, s_t, unroll=unroll)
        hp, plain_ms = timed_once(lambda: sw.sweep8_closest_hit_plain(
            tables, ori, d, tmax, s_o, s_t, unroll=unroll))
        if b == SWEEP_BOUNCES[0]:
            k4_plain_ms = plain_ms       # the whole bounce-1 pool
        equal_hits(f"K4 bounce {b}", hk, hp)
        k4_err = max([k4_err] + [float((getattr(hk, f) - getattr(hp, f))
                                       .abs().max()) for f in ("t", "u", "v")])
        print(f"  K4 vs plain, bin-sorted bounce-{b} pool: "
              f"{tmax.numel()} lanes ({int((tmax <= 0).sum())} dead, "
              f"{int((hk.tri >= 0).sum())} hits), bit-equal")
    spool, (s_o, s_t, thr) = grabbed[SWEEP_BOUNCES[0]]
    ori, d = spool[0], spool[1]
    tmax = torch.where(spool[5], 3.4e38, -1.0)
    sweep_call = lambda: sw.sweep8_closest_hit(tables, ori, d, tmax, s_o, s_t,
                                               unroll=unroll)
    k4_ms = cuda_time_ms(sweep_call, TIMING_REPS)
    st4 = torch.zeros(3, dtype=torch.int64, device=dev)
    raw = sw.sweep8_closest_hit(tables, ori, d, tmax, s_o, s_t, unroll=unroll,
                                stats=st4)
    nb = -(-n // 128)
    union = int(st4[0]) / nb
    resolved, _ = tsc.resolved_lanes(raw, thr)
    live = tmax > 0
    tail_frac = float((~resolved & live).sum()) / max(1, int(live.sum()))
    k4_bound, k4_by = sweep_bound(
        n, 28 + 8 * S, 16,
        (tables.tri_f32.numel() + tables.ranges.numel()) * 4,
        OPS_PER_TRI * int(st4[1]))
    # the final hits of bounce 1 against K2 on the same pool
    fin, capped = tsc.sweep_cast_sorted(scene.pack, tables, ori, d, tmax, s_o,
                                        s_t, thr, unroll=unroll)
    ref, capped2 = pt.packet_closest_hit_wide(scene.pack, ori, d, tmax)
    if int(capped) or int(capped2):
        raise RuntimeError(f"capped rays: sweep tail {int(capped)}, "
                           f"K2 {int(capped2)}")
    if not torch.equal(fin.t, ref.t):
        raise RuntimeError(f"sweep cast t differs from K2 on "
                           f"{int((fin.t != ref.t).sum())} lanes")
    tri_diff = int((fin.tri != ref.tri).sum())
    if tri_diff > TAIL_TRI_MISMATCH_MAX * int(live.sum()):
        raise RuntimeError(f"sweep cast triangle differs from K2 on "
                           f"{tri_diff} lanes")
    mr = lambda ms: n / (ms * 1e-3) / 1e6
    print(f"  sweep_cast_sorted vs K2, bounce-1 pool: {n} lanes, t bit-equal, "
          f"tri differs on {tri_diff} (equal-t ties), 0 capped")
    print(f"  K3: {k3_ms:.3f} ms ({mr(k3_ms):.1f} Mrays/s), plain "
          f"{k3_plain_ms:.1f} ms, bound {k3_bound:.3f} ms ({k3_by}); "
          f"slab tests {int(st3[0])}")
    print(f"  K4: {k4_ms:.3f} ms ({mr(k4_ms):.1f} Mrays/s), plain "
          f"{k4_plain_ms:.1f} ms, bound {k4_bound:.3f} ms ({k4_by}); "
          f"treelet sweeps {int(st4[0])} over {nb} blocks (mean union "
          f"{union:.2f}), tri tests {int(st4[1])}, live lanes {int(st4[2])}, "
          f"unresolved (tail) {100 * tail_frac:.3f}% of live lanes")
    phase("sweep_kernels", t0, lanes=n, k3_ms=f"{k3_ms:.3f}",
          k4_ms=f"{k4_ms:.3f}", mean_union=f"{union:.2f}",
          tail_pct=f"{100 * tail_frac:.3f}")
    del grabbed, spool, ori, d, tmax, s_o, s_t, thr, raw, fin, ref

    # ---- sweep_render: the bench configuration, the second main path -----
    t0 = time.perf_counter()
    rc = common.make_raycaster(scene, cfg)
    wavefront.trace_frame(scene, rc, cam, cfg, 200)   # warm-up frame
    torch.cuda.synchronize()
    for counts in (pt.LAUNCHES, sw.LAUNCHES):
        for k in counts:
            counts[k] = 0
    tr = time.perf_counter()
    img = wavefront.render(scene, cam, cfg,
                           iterations=SWEEP_FRAMES * cfg.spp_batch,
                           raycaster=rc)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - tr
    launches = dict(pt.LAUNCHES, **sw.LAUNCHES)
    if min(launches.values()) == 0:
        raise RuntimeError(f"sweep path skipped a kernel: {launches}")
    per_frame = (DEPTH - 1) * SWEEP_FRAMES
    if launches["dense_scan"] != per_frame or \
            launches["sweep8_closest_hit"] != per_frame:
        raise RuntimeError(f"expected {per_frame} K3/K4 launches: {launches}")
    if int(rc.capped):
        raise RuntimeError(f"sweep render had {int(rc.capped)} capped rays")
    if img.shape != (RES[1], RES[0], 3) or not np.isfinite(img).all() \
            or not img.mean() > 0:
        raise RuntimeError(f"bad sweep image: shape {img.shape}, "
                           f"mean {float(np.nanmean(img))}")
    frame_ms = render_s * 1e3 / SWEEP_FRAMES
    paths = cam.num_pixels * cfg.spp_batch
    # one frame split by stage: CUDA events around each stage's calls
    timer = StageTimer()
    timer.wrap(wavefront, "_sweep_scan_keys", "scan (K3 + keys)")
    timer.wrap(wavefront, "_sweep_bin_sort", "bin sort")
    timer.wrap(sw, "sweep8_closest_hit", "sweep (K4)")
    timer.wrap(tsc, "_tail_compact_cast", "tail (K2)")
    inner = common.make_raycaster(scene, cfg)
    primaries = timer.timed("primaries (K2)", inner.closest_hit)

    def closest(o, dd, t_max=None, sweep_slots=None):
        if sweep_slots is None:   # camera rays
            return primaries(o, dd, t_max)
        return inner.closest_hit(o, dd, t_max, sweep_slots=sweep_slots)

    timed_rc = common.Raycaster(
        closest_hit=closest, any_hit=timer.timed("shadow (K1)", inner.any_hit),
        name="timed", capped=inner.capped)
    s_ev = torch.cuda.Event(enable_timing=True)
    e_ev = torch.cuda.Event(enable_timing=True)
    try:
        th = time.perf_counter()
        s_ev.record()
        wavefront.trace_frame(scene, timed_rc, cam, cfg, 201)
        e_ev.record()
        host_ms = (time.perf_counter() - th) * 1e3
        e_ev.synchronize()
    finally:
        timer.patch.restore()
    f_ms = s_ev.elapsed_time(e_ev)
    split = {k: timer.ms(k) for k in timer.events}
    split["shading and the rest"] = f_ms - sum(split.values())
    print(f"  one frame: {f_ms:.1f} ms by CUDA events (host enqueue "
          f"{host_ms:.1f} ms); " + "; ".join(
              f"{k} {v:.1f} ms ({100 * v / f_ms:.1f}%)" for k, v in split.items()))
    phase("sweep_render", t0, frame_ms=f"{frame_ms:.1f}",
          mpaths_s=f"{paths / (frame_ms * 1e-3) / 1e6:.3f}",
          launches=json.dumps(launches).replace(" ", ""), capped=int(rc.capped),
          image_mean=f"{float(img.mean()):.5f}")

    # ---- sweep_agreement: kernels vs plain, and vs BVH_PALLAS -------------
    t0 = time.perf_counter()
    small = Camera.build(AGREE_RES, cam.position, cam.look_at, cam.up,
                         cam.fovy_deg)
    acfg = cfg.with_(spp_batch=1)
    rc_k = common.make_raycaster(scene, acfg)
    img_k = wavefront.render(scene, small, acfg, iterations=AGREE_ITERS,
                             raycaster=rc_k)
    patch = plain_kernels()
    try:
        rc_p = common.make_raycaster(scene, acfg)
        img_p = wavefront.render(scene, small, acfg, iterations=AGREE_ITERS,
                                 raycaster=rc_p)
    finally:
        patch.restore()
    pcfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH)
    rc_w = common.make_raycaster(scene, pcfg)
    img_w = wavefront.render(scene, small, pcfg, iterations=AGREE_ITERS,
                             raycaster=rc_w)
    if int(rc_k.capped) or int(rc_p.capped) or int(rc_w.capped):
        raise RuntimeError("agreement renders had capped rays")
    out = {}
    for label, ref in (("plain", img_p), ("pallas", img_w)):
        close, _, max_abs = golden_agree(f"sweep render vs {label}", img_k,
                                         ref)
        out[f"{label}_close"] = f"{close:.6f}"
        out[f"{label}_max_abs"] = f"{max_abs:.3g}"
    phase("sweep_agreement", t0, **out)

    return [
        dict(name="dense_scan", route="cuda", source="tpt_torch/csrc/sweep.cu",
             replaces="tpt/bvh/pallas_sweep.py:337",
             launches=launches["dense_scan"], max_abs_err=k3_err, ms=k3_ms,
             plain_ms=k3_plain_ms, bound_ms=k3_bound, bound_by=k3_by,
             library_ms=None),
        dict(name="sweep8_closest_hit", route="cuda",
             source="tpt_torch/csrc/sweep.cu",
             replaces="tpt/bvh/pallas_sweep.py:623",
             launches=launches["sweep8_closest_hit"], max_abs_err=k4_err,
             ms=k4_ms, plain_ms=k4_plain_ms, bound_ms=k4_bound,
             bound_by=k4_by, library_ms=None),
    ]


def panned(cam, k: int):
    """The camera turned about its up axis by k * SVGF_PAN_PX pixels at
    the image centre (the viewer's look navigation)."""
    import math

    import numpy as np

    h = cam.resolution[1]
    angle = (k * SVGF_PAN_PX * 2.0 * math.tan(math.radians(cam.fovy_deg) / 2.0)
             / h)
    axis = np.asarray(cam.true_up)
    v = np.asarray(cam.look_at) - np.asarray(cam.position)
    c, s_ = math.cos(angle), math.sin(angle)
    rot = v * c + np.cross(axis, v) * s_ + axis * axis.dot(v) * (1.0 - c)
    return cam.moved(look_at=tuple(np.asarray(cam.position) + rot))


def svgf_sequence(renderer, cam, frames: int) -> list:
    """The Renderer's `frames` denoised frames, the camera turning before
    each after the first (the engine, like tpt's, clears the SVGF history
    on every move)."""
    out = []
    for k in range(frames):
        if k:
            renderer.move_camera(panned(cam, k))
        out.append(renderer.frame())
    return out


def carried_sequence(scene, cam, cfg, frames: int, on_frame=None) -> list:
    """`frames` denoised frames with the camera turning before each after
    the first, through wavefront.trace_frame and svgf.run_svgf with the
    SVGF history carried across the moves (the motion vectors bridge
    them, as run_svgf is built to do); on_frame(k) runs before frame k.
    Returns the [H, W, 3] images on the device."""
    from tpt_torch.core.vec import Vec3
    from tpt_torch.denoise import svgf
    from tpt_torch.integrators import common, wavefront

    w, h = cam.resolution
    rc = common.make_raycaster(scene, cfg)
    state = svgf.SVGFState.zeros(h, w, scene.device)
    plane = lambda a: a.reshape(h, w)
    p3 = lambda v: Vec3(plane(v.x), plane(v.y), plane(v.z))
    prev, imgs = None, []
    for k in range(frames):
        c = panned(cam, k)
        vp = wavefront.camera_view_proj(c)
        if on_frame is not None:
            on_frame(k)
        out = wavefront.trace_frame(scene, rc, c, cfg, 1 + k, view_proj=vp,
                                    prev_view_proj=vp if prev is None else prev)
        prev, g = vp, out.gbuf
        rgb, state = svgf.run_svgf(
            cfg.svgf, state, p3(out.direct), p3(out.indirect), p3(g.albedo),
            plane(g.depth), p3(g.normal), plane(g.mat_id), plane(g.motion_u),
            plane(g.motion_v))
        imgs.append(rgb.stacked())
    return imgs


def svgf_phases(scene, cam, dev) -> list:
    """The svgf_kernels, svgf_render and svgf_agreement phases; returns
    the K5 and K6 entries of the kernels line."""
    import numpy as np
    import torch

    from tpt_torch import Renderer
    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.core.camera import Camera
    from tpt_torch.denoise import reproject, stencil, svgf
    from tpt_torch.integrators import wavefront

    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH,
                       denoiser_on=True)
    sig = (cfg.svgf.sigma_z, cfg.svgf.sigma_n, cfg.svgf.sigma_l)
    npx = cam.num_pixels

    # ---- svgf_kernels: K5/K6 inputs of the third frame of a sequence -------
    t0 = time.perf_counter()
    grabbed = {"atrous": []}
    record = [False]
    patch = Patch()

    def grab_reproject(*args):
        if record[0]:
            grabbed["reproject"] = args
        return kernel_reproject(*args)

    def grab_atrous(*args):
        if record[0]:
            grabbed["atrous"].append(args)
        return kernel_atrous(*args)

    kernel_reproject, kernel_atrous = reproject.reproject, stencil.atrous
    patch.set(reproject, "reproject", grab_reproject)
    patch.set(stencil, "atrous", grab_atrous)
    try:
        carried_sequence(scene, cam, cfg, 3,
                         on_frame=lambda k: record.__setitem__(0, k == 2))
    finally:
        patch.restore()

    def compare(label, got, want) -> tuple:
        """(max abs err, mismatching pixels) of two plane lists; raises
        unless bit-equal (NaN equal to NaN)."""
        err, bad = 0.0, 0
        for a, b in zip(got, want):
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            bad += int((~same).sum())
            d = (a - b).abs()
            err = max(err, float(torch.where(same, 0.0, d).nan_to_num(
                nan=float("inf")).max()))
        if bad:
            raise RuntimeError(f"{label}: kernel differs from plain on {bad} "
                               f"values, max abs err {err}")
        return err, bad

    flat = lambda o: [o[0].x, o[0].y, o[0].z, o[1], o[2].x, o[2].y, o[2].z,
                      o[3]]
    r_args = grabbed["reproject"]
    sums, wsum = reproject.reproject(*r_args)
    (psums, pw), k6_plain_ms = timed_once(
        lambda: svgf._reproject_taps(*r_args))
    k6_err, _ = compare("K6", [sums[k] for k in svgf.DATA_KEYS] + [wsum],
                        [psums[k] for k in svgf.DATA_KEYS] + [pw])
    carried_share = float((wsum > 1e-4).float().mean())
    print(f"  K6 vs plain, frame 3: {npx} pixels x 11 planes bit-equal "
          f"(0 mismatching), {100 * carried_share:.2f}% of pixels with "
          f"history weight > 1e-4 (history carried across the moves)")
    k6_ms = kernel_ms(lambda: reproject.reproject(*r_args), KERNEL_REPS)
    k5_err, k5_ms_steps, k5_plain_steps = 0.0, [], []
    if [a[6] for a in grabbed["atrous"]] != [1, 2, 4, 8, 16]:
        raise RuntimeError("the frame did not run K5 at steps 1..16")
    for a in grabbed["atrous"]:
        got = flat(stencil.atrous(*a))
        want, p_ms = timed_once(lambda: flat(stencil.atrous_plain(*a)))
        err, _ = compare(f"K5 step {a[6]}", got, want)
        k5_err = max(k5_err, err)
        k5_plain_steps.append(p_ms)
        k5_ms_steps.append(kernel_ms(lambda: stencil.atrous(*a),
                                     KERNEL_REPS))
    print(f"  K5 vs plain, frame 3, steps 1-16: {npx} pixels x 8 planes "
          f"bit-equal at every step (0 mismatching)")
    k5_ms = sum(k5_ms_steps) / len(k5_ms_steps)
    k5_plain_ms = sum(k5_plain_steps) / len(k5_plain_steps)

    def bound(bytes_px, ops_px):
        b_ms = npx * bytes_px / PEAK_BYTES_S * 1e3
        o_ms = npx * ops_px / PEAK_F32_INSTR_S * 1e3
        return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")

    k5_bound, k5_by = bound(ATROUS_BYTES_PX, ATROUS_OPS_PX)
    k6_bound, k6_by = bound(REPROJECT_BYTES_PX, REPROJECT_OPS_PX)
    print(f"  K5: {k5_ms:.4f} ms a pass (steps 1..16: "
          + ", ".join(f"{m:.4f}" for m in k5_ms_steps)
          + f"), plain {k5_plain_ms:.2f} ms, bound {k5_bound:.4f} ms "
          f"({k5_by}), {100 * k5_bound / k5_ms:.1f}% of bound")
    print(f"  K6: {k6_ms:.4f} ms, plain {k6_plain_ms:.2f} ms, bound "
          f"{k6_bound:.4f} ms ({k6_by}), {100 * k6_bound / k6_ms:.1f}% of bound")
    phase("svgf_kernels", t0, pixels=npx, k5_ms=f"{k5_ms:.4f}",
          k6_ms=f"{k6_ms:.4f}", k5_max_abs_err=k5_err, k6_max_abs_err=k6_err)
    del grabbed, r_args, sums, wsum, psums, pw

    # ---- svgf_render: the engine's real-time denoised frame --------------
    t0 = time.perf_counter()
    renderer = Renderer(scene, cam, cfg)
    renderer.frame()                                  # warm-up frame
    torch.cuda.synchronize()
    counts = (pt.LAUNCHES, sw.LAUNCHES, stencil.LAUNCHES, reproject.LAUNCHES)
    for c in counts:
        for k in c:
            c[k] = 0
    tr = time.perf_counter()
    imgs = svgf_sequence(renderer, cam, SVGF_FRAMES)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - tr) * 1e3 / SVGF_FRAMES
    launches = {k: v for c in counts for k, v in c.items()}
    want = dict(atrous=5 * SVGF_FRAMES, reproject=SVGF_FRAMES)
    if any(launches[k] != v for k, v in want.items()) or \
            min(pt.LAUNCHES.values()) == 0 or any(sw.LAUNCHES.values()):
        raise RuntimeError(f"denoised path launches {launches}, expected "
                           f"{want} and K1/K2 but no K3/K4")
    if int(renderer.raycaster.capped):
        raise RuntimeError(f"{int(renderer.raycaster.capped)} capped rays")
    for img in imgs:
        if img.shape != (RES[1], RES[0], 3) or not np.isfinite(img).all() \
                or not img.mean() > 0:
            raise RuntimeError(f"bad denoised image: shape {img.shape}, "
                               f"mean {float(np.nanmean(img))}")
    hist_share = float((renderer.svgf_state.history_len > 0).float().mean())

    def split_frame(move: bool) -> tuple:
        """One more Renderer frame split by CUDA events: the trace, SVGF,
        and inside it K6, the five K5 passes and the plain-PyTorch rest;
        returns (frame ms, split, that frame's FrameOutput)."""
        timer = StageTimer()
        timer.wrap(wavefront, "trace_frame", "trace")
        timer.wrap(svgf, "run_svgf", "svgf")
        timer.wrap(reproject, "reproject", "K6")
        timer.wrap(stencil, "atrous", "K5")
        outs = []
        trace = wavefront.trace_frame

        def keep(*a, **kw):
            outs.append(trace(*a, **kw))
            return outs[-1]

        timer.patch.set(wavefront, "trace_frame", keep)
        try:
            if move:
                renderer.move_camera(panned(cam, SVGF_FRAMES))
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            renderer.frame()
            e_ev.record()
            e_ev.synchronize()
        finally:
            timer.patch.restore()
        f_ms = s_ev.elapsed_time(e_ev)
        split = {k: timer.ms(k) for k in ("trace", "svgf", "K6", "K5")}
        split["svgf rest"] = split["svgf"] - split["K6"] - split["K5"]
        split["other"] = f_ms - split["trace"] - split["svgf"]
        return f_ms, split, outs[-1]

    def show(label, f_ms, split):
        print(f"  {label}: {f_ms:.1f} ms by CUDA events; trace "
              f"{split['trace']:.1f} ms, SVGF {split['svgf']:.2f} ms (K6 "
              f"{split['K6']:.3f} ms, K5 x5 {split['K5']:.3f} ms, "
              f"plain-PyTorch rest {split['svgf rest']:.2f} ms), other "
              f"{split['other']:.2f} ms")

    f_ms, split, out = split_frame(move=True)
    g = out.gbuf
    live = g.depth > 0
    motion = torch.sqrt(g.motion_u * g.motion_u + g.motion_v * g.motion_v)
    med_motion = float(motion[live].median())
    show("one moving frame", f_ms, split)
    for _ in range(5):                      # the camera rests
        renderer.frame()
    rest_ms, rest_split, _ = split_frame(move=False)
    rest_share = float((renderer.svgf_state.history_len >= 4).float().mean())
    show("one resting frame (6th at rest)", rest_ms, rest_split)
    # device busy share of one moving denoised frame, and the SVGF
    # kernels' device time in it
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        renderer.move_camera(panned(cam, SVGF_FRAMES + 1))
        renderer.frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tw) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    by_key = lambda k: "{:.1f} x{}".format(*(
        sum(getattr(e, f) for e in dev_events if k in e.key)
        for f in ("self_device_time_total", "count")))
    print(f"  profiled moving frame: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}%), "
          f"{sum(e.count for e in dev_events)} kernel launches; device time "
          f"(us) of K5 {by_key('atrous_kernel')}, K6 "
          f"{by_key('reproject_kernel')}")
    print(f"  pixels with history: {100 * hist_share:.2f}% after "
          f"{SVGF_FRAMES} moving frames (each move clears it), "
          f"{100 * rest_share:.2f}% with >= 4 frames at rest, "
          f"{100 * carried_share:.2f}% when carried across moves "
          f"(svgf_kernels); median |motion| {med_motion:.3f} px")
    phase("svgf_render", t0, frame_ms=f"{frame_ms:.1f}",
          split_ms=json.dumps({k: round(v, 3) for k, v in split.items()}
                              ).replace(" ", ""),
          rest_split_ms=json.dumps({k: round(v, 3)
                                    for k, v in rest_split.items()}
                                   ).replace(" ", ""),
          launches=json.dumps(launches).replace(" ", ""),
          history_pct=f"{100 * hist_share:.2f}",
          median_motion_px=f"{med_motion:.3f}",
          image_mean=f"{float(imgs[-1].mean()):.5f}")
    del renderer, out, g

    # ---- svgf_agreement: the sequence through kernels and plain ----------
    t0 = time.perf_counter()
    small = Camera.build(AGREE_RES, cam.position, cam.look_at, cam.up,
                         cam.fovy_deg)
    runs = {
        "renderer": lambda: svgf_sequence(Renderer(scene, small, cfg), small,
                                          SVGF_FRAMES),
        "carried": lambda: [i.cpu().numpy() for i in carried_sequence(
            scene, small, cfg, SVGF_FRAMES)],
    }
    worst_close, worst_abs = 1.0, 0.0
    for label, run in runs.items():
        img_k = run()
        patch = plain_kernels()
        try:
            img_p = run()
        finally:
            patch.restore()
        for k, (a, b) in enumerate(zip(img_k, img_p)):
            close, _, max_abs = golden_agree(f"{label} frame {k} vs plain",
                                             a, b)
            worst_close = min(worst_close, close)
            worst_abs = max(worst_abs, max_abs)
    phase("svgf_agreement", t0, frames=2 * SVGF_FRAMES,
          min_close=f"{worst_close:.6f}", max_abs=f"{worst_abs:.3g}")

    return [
        dict(name="atrous", route="cuda", source="tpt_torch/csrc/svgf.cu",
             replaces="tpt/denoise/pallas_stencil.py:180",
             launches=launches["atrous"], max_abs_err=k5_err, ms=k5_ms,
             plain_ms=k5_plain_ms, bound_ms=k5_bound, bound_by=k5_by,
             library_ms=None),
        dict(name="reproject", route="cuda", source="tpt_torch/csrc/svgf.cu",
             replaces="tpt/denoise/pallas_reproject.py:227",
             launches=launches["reproject"], max_abs_err=k6_err, ms=k6_ms,
             plain_ms=k6_plain_ms, bound_ms=k6_bound, bound_by=k6_by,
             library_ms=None),
    ]


def treelet_phases(scene, cam, dev, pallas_frame_ms: float) -> list:
    """The treelet_kernels, treelet_render and treelet_agreement phases;
    returns the K9 and K10 entries of the kernels line."""
    import numpy as np
    import torch

    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.bvh import treelet_traverse as tlt
    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.core.camera import Camera
    from tpt_torch.core.vec import Vec3
    from tpt_torch.integrators import common, wavefront

    pack = scene.pack
    cfg = RenderConfig(backend=RayCastBackend.BVH_TREELET, trace_depth=DEPTH)
    lanes = 1024 * cfg.trav_group
    lanes0 = 1024 * cfg.trav_group_primary
    knobs = dict(slots=cfg.treelet_slots, max_rounds=cfg.treelet_max_rounds)
    sub = lambda v, idx: Vec3(v.x[idx].contiguous(), v.y[idx].contiguous(),
                              v.z[idx].contiguous())

    # ---- treelet_kernels: the pools of one frame --------------------------
    t0 = time.perf_counter()
    grabbed = {}
    seed_sort = wavefront._treelet_seed_sort

    def grab(scn, c, pool):
        out = seed_sort(scn, c, pool)
        grabbed["in"], grabbed["out"] = pool, out
        return out

    patch = Patch()
    patch.set(wavefront, "_treelet_seed_sort", grab)
    try:
        rc = common.make_raycaster(scene, cfg)
        vp = wavefront.camera_view_proj(cam)
        carry = wavefront.batched_raygen(cam, cfg, 1, dev)
        cam_o, cam_d = carry[0], carry[1]
        for depth in range(2):
            carry = wavefront._bounce_body(scene, rc, cam, cfg, vp, vp, depth,
                                           carry)
    finally:
        patch.restore()
    del carry
    if int(rc.capped):
        raise RuntimeError(f"{int(rc.capped)} capped lanes in bounces 0-1")
    pool = grabbed["in"]
    n = pool[0].x.shape[0]
    alive = pool[5]
    pre_tmax = torch.where(alive, 3.4e38, -1.0)
    # K9 on every lane of the unsorted bounce-1 pool, dead lanes included
    k9 = tlt.treelet_scan(pack, pool[0], pool[1], pre_tmax,
                          group=cfg.trav_group)
    k9_plain, k9_plain_ms = timed_once(lambda: tlt.treelet_scan_plain(
        pack, pool[0], pool[1], pre_tmax, group=cfg.trav_group))
    for a, b, what in zip(k9, k9_plain, ("entry t", "code", "ordinal",
                                          "overflow", "count", "capped")):
        if not torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.float32 else b):
            raise RuntimeError(f"K9 {what} differs from plain on "
                               f"{int((a != b).sum())} of {a.numel()} values")
    if int(k9[5]):
        raise RuntimeError(f"K9 capped {int(k9[5])} lanes")
    k9_err = max(float((a.float() - b.float()).abs().max())
                 for a, b in zip(k9[:5], k9_plain[:5]))
    seeded_share = float((alive & (k9[1] != tlt.NONE_CODE)).sum()) / max(
        1, int(alive.sum()))
    print(f"  K9 vs plain, unsorted bounce-1 pool: {n} lanes "
          f"({int((~alive).sum())} dead), bit-equal, 0 capped")
    st9 = torch.zeros(2, dtype=torch.int64, device=dev)
    tlt.treelet_scan(pack, pool[0], pool[1], pre_tmax, group=cfg.trav_group,
                     stats=st9)
    k9_ms = kernel_ms(lambda: tlt.treelet_scan(pack, pool[0], pool[1],
                                               pre_tmax,
                                               group=cfg.trav_group),
                      TREELET_REPS)
    top_bytes = sum(t.numel() * t.element_size() for t in (
        pack.top_f32, pack.top_child, pack.top_tref, pack.top_tord))
    k9_bound, k9_by = sweep_bound(n, 28, 20, top_bytes,
                                  OPS_PER_SLAB * int(st9[1]))
    del k9_plain

    # K10 seeded on the sorted bounce-1 pool, as the cast launches it
    spool, seed, hard, _ = grabbed["out"]
    ori, d, salive = spool[0], spool[1], spool[5]
    ext_tmax = torch.where(salive, 3.4e38, -1.0)
    easy_tmax = torch.where(hard, -1.0, ext_tmax)
    full, cap_full = tlt.treelet_closest_hit(pack, ori, d, easy_tmax,
                                             group=cfg.trav_group, seed=seed,
                                             **knobs)
    if int(cap_full):
        raise RuntimeError(f"K10 capped {int(cap_full)} lanes")
    n_live = int(salive.sum())
    idx = whole_blocks(-(-n_live // lanes) * lanes,
                       TREELET_SEEDED_PACKETS * lanes, dev, lanes)
    g = lambda a: a[idx].contiguous()
    s_seed = tuple(g(a) for a in seed)
    hk, ck = tlt.treelet_closest_hit(pack, sub(ori, idx), sub(d, idx),
                                     g(easy_tmax), group=cfg.trav_group,
                                     seed=s_seed, **knobs)
    (hp, cp), k10_plain_ms = timed_once(lambda: tlt.treelet_closest_hit_plain(
        pack, sub(ori, idx), sub(d, idx), g(easy_tmax), group=cfg.trav_group,
        seed=s_seed, **knobs))
    if int(ck) or int(cp):
        raise RuntimeError(f"K10 seeded capped: kernel {int(ck)}, plain "
                           f"{int(cp)}")
    equal_hits("K10 seeded vs plain", hk, hp)
    equal_hits("K10 seeded, packets alone vs in the pool", hk,
               type(hk)(t=g(full.t), tri=g(full.tri), u=g(full.u),
                        v=g(full.v)))
    k10_err = max(float((getattr(hk, f) - getattr(hp, f)).abs().max())
                  for f in ("t", "u", "v"))
    print(f"  K10 seeded vs plain, sorted bounce-1 pool: "
          f"{TREELET_SEEDED_PACKETS} whole {lanes}-lane packets "
          f"({idx.numel()} lanes, {int((g(easy_tmax) > 0).sum())} easy live, "
          f"{int((hk.tri >= 0).sum())} hits), bit-equal, and equal to the "
          f"same lanes of the whole-pool launch; plain {k10_plain_ms:.1f} ms")
    # K10 unseeded on whole 4096-lane packets of the camera rays
    idx0 = whole_blocks(cam_o.x.shape[0], TREELET_PRIMARY_PACKETS * lanes0,
                        dev, lanes0)
    t_cam = torch.full((idx0.numel(),), 3.4e38, device=dev)
    hk0, ck0 = tlt.treelet_closest_hit(pack, sub(cam_o, idx0),
                                       sub(cam_d, idx0), t_cam,
                                       group=cfg.trav_group_primary, **knobs)
    (hp0, cp0), k10p_plain_ms = timed_once(
        lambda: tlt.treelet_closest_hit_plain(
            pack, sub(cam_o, idx0), sub(cam_d, idx0), t_cam,
            group=cfg.trav_group_primary, **knobs))
    if int(ck0) or int(cp0):
        raise RuntimeError(f"K10 primary capped: kernel {int(ck0)}, plain "
                           f"{int(cp0)}")
    equal_hits("K10 unseeded primaries vs plain", hk0, hp0)
    k10_err = max([k10_err] + [float((getattr(hk0, f) - getattr(hp0, f))
                                     .abs().max()) for f in ("t", "u", "v")])
    print(f"  K10 unseeded vs plain, camera rays: {TREELET_PRIMARY_PACKETS} "
          f"whole {lanes0}-lane packets ({idx0.numel()} lanes, "
          f"{int((hk0.tri >= 0).sum())} hits), bit-equal; plain "
          f"{k10p_plain_ms:.1f} ms")
    # the whole extension cast against K2 alone on every lane
    fin = rc.closest_hit(ori, d, ext_tmax, seed=seed, hard=hard)
    ref, cap2 = pt.packet_closest_hit_wide(pack, ori, d, ext_tmax)
    if int(rc.capped) or int(cap2):
        raise RuntimeError(f"capped lanes: treelet cast {int(rc.capped)}, "
                           f"K2 {int(cap2)}")
    if not torch.equal(fin.t, ref.t):
        raise RuntimeError(f"treelet cast t differs from K2 on "
                           f"{int((fin.t != ref.t).sum())} lanes")
    tri_diff = int((fin.tri != ref.tri).sum())
    if tri_diff > TAIL_TRI_MISMATCH_MAX * n_live:
        raise RuntimeError(f"treelet cast triangle differs from K2 on "
                           f"{tri_diff} lanes")
    print(f"  treelet cast (K10 easy + K2 hard) vs K2, sorted bounce-1 "
          f"pool: {n} lanes, t bit-equal, tri differs on {tri_diff} "
          f"(equal-t ties), 0 capped")
    # timings on the whole pools, as the frame launches them
    st10 = torch.zeros(6, dtype=torch.int64, device=dev)
    tlt.treelet_closest_hit(pack, ori, d, easy_tmax, group=cfg.trav_group,
                            seed=seed, stats=st10, **knobs)
    k10_ms = kernel_ms(lambda: tlt.treelet_closest_hit(
        pack, ori, d, easy_tmax, group=cfg.trav_group, seed=seed, **knobs),
        TREELET_REPS)
    sub_o, sub_d, sub_t = sub(ori, idx), sub(d, idx), g(easy_tmax)
    k10s_ms = kernel_ms(lambda: tlt.treelet_closest_hit(
        pack, sub_o, sub_d, sub_t, group=cfg.trav_group, seed=s_seed,
        **knobs), TREELET_REPS)
    t_all = torch.full((cam_o.x.shape[0],), 3.4e38, device=dev)
    st0 = torch.zeros(6, dtype=torch.int64, device=dev)
    tlt.treelet_closest_hit(pack, cam_o, cam_d, t_all,
                            group=cfg.trav_group_primary, stats=st0, **knobs)
    k10p_ms = kernel_ms(lambda: tlt.treelet_closest_hit(
        pack, cam_o, cam_d, t_all, group=cfg.trav_group_primary, **knobs),
        TREELET_REPS)
    hard_k2 = torch.where(hard, ext_tmax, -1.0)
    k2h_ms = kernel_ms(lambda: pt.packet_closest_hit_wide(pack, ori, d,
                                                          hard_k2),
                       TREELET_REPS)
    k2f_ms = kernel_ms(lambda: pt.packet_closest_hit_wide(pack, ori, d,
                                                          ext_tmax),
                       TREELET_REPS)
    # K10's bound counts the tests the closest hit needs, not those its
    # packets do (each lane tests every cluster its packet drains): the
    # slab and triangle tests of K2's per-ray walk on the same lanes
    wide_bytes = sum(t.numel() * t.element_size() for t in (
        pack.node_f32, pack.node_child, pack.tri_f32))

    def k10_bound(o_, d_, t_, seeded: bool) -> tuple:
        need = torch.zeros(3, dtype=torch.int64, device=dev)
        pt.packet_closest_hit_wide(pack, o_, d_, t_, stats=need)
        b = sweep_bound(t_.shape[0], 28 + (12 if seeded else 0), 16,
                        wide_bytes + top_bytes, OPS_PER_SLAB * int(need[1])
                        + OPS_PER_TRI * int(need[2]))
        return b + (need.cpu(),)

    k10_b, k10_by, need10 = k10_bound(ori, d, easy_tmax, True)
    k10s_b, k10s_by, _ = k10_bound(sub_o, sub_d, sub_t, True)
    k10p_b, k10p_by, need0 = k10_bound(cam_o, cam_d, t_all, False)
    npk = -(-n // lanes)
    npk0 = -(-cam_o.x.shape[0] // lanes0)
    hard_share = float(hard.sum()) / max(1, n_live)
    mr = lambda ms, k: k / (ms * 1e-3) / 1e6
    print(f"  K9: {k9_ms:.3f} ms ({mr(k9_ms, n):.1f} Mrays/s), plain "
          f"{k9_plain_ms:.1f} ms, bound {k9_bound:.3f} ms ({k9_by}); top "
          f"pops {int(st9[0])} over {npk} packets, slab tests {int(st9[1])}")
    print(f"  K10 seeded bounce 1: {k10_ms:.3f} ms "
          f"({mr(k10_ms, n_live):.2f} M live rays/s), bound {k10_b:.3f} ms "
          f"({k10_by}) from the per-ray walk's {int(need10[1])} slab and "
          f"{int(need10[2])} tri tests; work done: drains {int(st10[3])} "
          f"over {npk} packets (mean {int(st10[3]) / npk:.2f}, max "
          f"{int(st10[5])}), scan rounds {int(st10[4])}, node pops "
          f"{int(st10[0])}, slab tests {int(st10[1])}, tri tests "
          f"{int(st10[2])} ({int(st10[2]) / max(1, int(need10[2])):.1f}x "
          f"the per-ray walk's); on the {TREELET_SEEDED_PACKETS} packets "
          f"held against plain ({idx.numel()} lanes): kernel "
          f"{k10s_ms:.3f} ms, plain {k10_plain_ms:.1f} ms, bound "
          f"{k10s_b:.3f} ms ({k10s_by})")
    print(f"  K10 unseeded camera rays: {k10p_ms:.3f} ms "
          f"({mr(k10p_ms, cam_o.x.shape[0]):.2f} Mrays/s), bound "
          f"{k10p_b:.3f} ms ({k10p_by}) from the per-ray walk's "
          f"{int(need0[2])} tri tests; work done: drains {int(st0[3])} over "
          f"{npk0} packets (mean {int(st0[3]) / npk0:.2f}, max "
          f"{int(st0[5])}), tri tests {int(st0[2])}")
    print(f"  bounce 1: {n_live} live lanes, hard {100 * hard_share:.2f}% "
          f"(K2 on them: {k2h_ms:.3f} ms; K2 on every live lane: "
          f"{k2f_ms:.3f} ms), with a K9 seed {100 * seeded_share:.2f}%")
    phase("treelet_kernels", t0, lanes=n, k9_ms=f"{k9_ms:.3f}",
          k10_ms=f"{k10_ms:.3f}", k10_bound_ms=f"{k10_b:.3f}",
          k10_primary_ms=f"{k10p_ms:.3f}",
          mean_drains=f"{int(st10[3]) / npk:.2f}", max_drains=int(st10[5]),
          hard_pct=f"{100 * hard_share:.2f}",
          seeded_pct=f"{100 * seeded_share:.2f}")
    del grabbed, spool, pool, seed, hard, ori, d, fin, ref, full

    # ---- treelet_render: the BVH_TREELET frame at 1080p -------------------
    t0 = time.perf_counter()
    rc = common.make_raycaster(scene, cfg)
    wavefront.trace_frame(scene, rc, cam, cfg, 300)   # warm-up frame
    torch.cuda.synchronize()
    counts = (pt.LAUNCHES, sw.LAUNCHES, tlt.LAUNCHES)
    for c in counts:
        for k in c:
            c[k] = 0
    tr = time.perf_counter()
    img = wavefront.render(scene, cam, cfg, iterations=TREELET_FRAMES,
                           raycaster=rc)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - tr
    launches = {k: v for c in counts for k, v in c.items()}
    want = dict(treelet_closest_hit=DEPTH, treelet_scan=DEPTH - 1,
                packet_closest_hit_wide=DEPTH - 1, packet_any_hit_wide=DEPTH,
                dense_scan=0, sweep8_closest_hit=0)
    if any(launches[k] != v * TREELET_FRAMES for k, v in want.items()):
        raise RuntimeError(f"treelet path launches {launches}, expected "
                           f"{want} a frame")
    if int(rc.capped):
        raise RuntimeError(f"treelet render had {int(rc.capped)} capped lanes")
    if img.shape != (RES[1], RES[0], 3) or not np.isfinite(img).all() \
            or not img.mean() > 0:
        raise RuntimeError(f"bad treelet image: shape {img.shape}, "
                           f"mean {float(np.nanmean(img))}")
    frame_ms = render_s * 1e3 / TREELET_FRAMES
    # one frame split by stage: CUDA events around each stage's calls
    timer = StageTimer()
    timer.wrap(wavefront, "_treelet_seed_sort", "K9 + sort")
    timer.wrap(tlt, "treelet_closest_hit", "K10")
    timer.wrap(pt, "packet_closest_hit_wide", "K2 (hard rays)")
    timer.wrap(pt, "packet_any_hit_wide", "K1 (shadow)")
    s_ev = torch.cuda.Event(enable_timing=True)
    e_ev = torch.cuda.Event(enable_timing=True)
    try:
        timed_rc = common.make_raycaster(scene, cfg)
        th = time.perf_counter()
        s_ev.record()
        wavefront.trace_frame(scene, timed_rc, cam, cfg, 301)
        e_ev.record()
        host_ms = (time.perf_counter() - th) * 1e3
        e_ev.synchronize()
    finally:
        timer.patch.restore()
    f_ms = s_ev.elapsed_time(e_ev)
    split = {k: timer.ms(k) for k in timer.events}
    split["shading and the rest"] = f_ms - sum(split.values())
    print(f"  one frame: {f_ms:.1f} ms by CUDA events (host enqueue "
          f"{host_ms:.1f} ms); " + "; ".join(
              f"{k} {v:.1f} ms ({100 * v / f_ms:.1f}%)"
              for k, v in split.items()))
    print(f"  against the BVH_PALLAS frame of this run: "
          f"{frame_ms / pallas_frame_ms:.2f}x ({frame_ms:.1f} ms vs "
          f"{pallas_frame_ms:.1f} ms)")
    phase("treelet_render", t0, frame_ms=f"{frame_ms:.1f}",
          mpaths_s=f"{cam.num_pixels / (frame_ms * 1e-3) / 1e6:.3f}",
          launches=json.dumps(launches).replace(" ", ""),
          capped=int(rc.capped), image_mean=f"{float(img.mean()):.5f}")

    # ---- treelet_agreement: kernels vs plain, and vs BVH_PALLAS ------------
    t0 = time.perf_counter()
    left = WATCHDOG_S - (t0 - T_START)
    if left < 2 * TREELET_PLAIN_RENDER_S:
        raise RuntimeError(
            f"treelet_agreement: its plain render takes up to "
            f"{TREELET_PLAIN_RENDER_S:.0f} s and only {left:.0f} s of the "
            f"{WATCHDOG_S} s watchdog are left, less than twice that: the "
            f"earlier phases ran slow on this host")
    small = Camera.build(AGREE_RES, cam.position, cam.look_at, cam.up,
                         cam.fovy_deg)
    # both samples in one pool: the plain K10 takes as many sequential
    # steps as the slowest packet of a cast needs, so one cast of twice
    # the packets costs about as much as one of one sample
    acfg = cfg.with_(spp_batch=AGREE_ITERS)
    rc_k = common.make_raycaster(scene, acfg)
    img_k = wavefront.render(scene, small, acfg, iterations=AGREE_ITERS,
                             raycaster=rc_k)
    patch = plain_kernels()
    try:
        rc_p = common.make_raycaster(scene, acfg)
        tp = time.perf_counter()
        img_p = wavefront.render(scene, small, acfg, iterations=AGREE_ITERS,
                                 raycaster=rc_p)
        plain_s = time.perf_counter() - tp
    finally:
        patch.restore()
    pcfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH,
                        spp_batch=AGREE_ITERS)
    rc_w = common.make_raycaster(scene, pcfg)
    img_w = wavefront.render(scene, small, pcfg, iterations=AGREE_ITERS,
                             raycaster=rc_w)
    if int(rc_k.capped) or int(rc_p.capped) or int(rc_w.capped):
        raise RuntimeError("treelet agreement renders had capped lanes")
    out = {"plain_render_s": f"{plain_s:.1f}"}
    for label, ref in (("plain", img_p), ("pallas", img_w)):
        close, _, max_abs = golden_agree(f"treelet render vs {label}", img_k,
                                         ref)
        out[f"{label}_close"] = f"{close:.6f}"
        out[f"{label}_max_abs"] = f"{max_abs:.3g}"
    phase("treelet_agreement", t0, **out)

    return [
        dict(name="treelet_scan", route="cuda",
             source="tpt_torch/csrc/treelet.cu",
             replaces="tpt/bvh/pallas_treelet.py:522",
             launches=launches["treelet_scan"], max_abs_err=k9_err,
             ms=k9_ms, plain_ms=k9_plain_ms, bound_ms=k9_bound,
             bound_by=k9_by, library_ms=None, lanes=n),
        dict(name="treelet_closest_hit", route="cuda",
             source="tpt_torch/csrc/treelet.cu",
             replaces="tpt/bvh/pallas_treelet.py:570",
             launches=launches["treelet_closest_hit"], max_abs_err=k10_err,
             ms=k10s_ms, plain_ms=k10_plain_ms, bound_ms=k10s_b,
             bound_by=k10s_by, library_ms=None, lanes=int(idx.numel())),
    ]


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpt_torch import _build
    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.bvh import treelet_traverse as tlt
    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.core.camera import Camera
    from tpt_torch.denoise import stencil
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
    with ThreadPoolExecutor(5) as pool:   # the nvcc and g++ side by side
        builds = [pool.submit(pt.build_kernels), pool.submit(sw.build_kernels),
                  pool.submit(stencil.build_kernels),
                  pool.submit(tlt.build_kernels), pool.submit(native._load)]
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
    scene = host.build(with_bvh=True, sweep_chunk_align=SWEEP_ALIGN, device=dev)
    cam = host.camera
    pack = scene.pack
    phase("scene", t0, triangles=host.mesh.num_triangles,
          nodes=pack.num_nodes, tri_rows=pack.tri_f32.shape[0],
          arity=pack.arity, cluster=pack.max_cluster,
          treelets=scene.sweep.num_treelets, top_nodes=pack.num_top,
          max_chunks=scene.sweep.max_chunks,
          sweep_rows=scene.sweep.tri_f32.shape[0])

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
    print("  kernels: K2 packet_closest_hit_wide, K1 packet_any_hit_wide, "
          "K3 dense_scan, K4 sweep8_closest_hit, K5 atrous, K6 reproject, "
          "K9 treelet_scan, K10 treelet_closest_hit ported (cuda); K7, K8a, "
          "K8b, K11 not yet ported")
    phase("kernels", t0, n_compare=N_COMPARE, lanes=n_full,
          k2_ms=f"{k2_ms:.3f}", k1_ms=f"{k1_ms:.3f}")
    del rec, carry, ext, shd

    # ---- render: the main path ------------------------------------------------
    t0 = time.perf_counter()
    rc = make_raycaster(scene, cfg)
    wavefront.trace_frame(scene, rc, cam, cfg, 100)   # warm-up frame
    torch.cuda.synchronize()
    for counts in (pt.LAUNCHES, sw.LAUNCHES):
        for k in counts:
            counts[k] = 0
    tr = time.perf_counter()
    img = wavefront.render(scene, cam, cfg, iterations=RENDER_ITERS,
                           raycaster=rc)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - tr
    launches = dict(pt.LAUNCHES)
    if min(launches.values()) == 0:
        raise RuntimeError(f"main path skipped a kernel: {launches}")
    if any(sw.LAUNCHES.values()):
        raise RuntimeError(f"BVH_PALLAS path launched sweep kernels: "
                           f"{sw.LAUNCHES}")
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
    close, mean_rel, max_abs = golden_agree("kernel render vs plain", img_k,
                                            img_p)
    phase("agreement", t0, close=f"{close:.6f}", mean_rel=f"{mean_rel:.3g}",
          max_abs=f"{max_abs:.3g}")

    sweep_kernels = sweep_phases(scene, cam, dev)
    svgf_kernels = svgf_phases(scene, cam, dev)
    treelet_kernels = treelet_phases(scene, cam, dev, frame_ms)

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
    ] + sweep_kernels + svgf_kernels + treelet_kernels
    print(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
