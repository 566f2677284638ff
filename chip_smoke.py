#!/usr/bin/env python3
"""Smoke run of the tpt_torch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's main paths at full size on the 139k-triangle
`fireplace_like` bench interior at 1920x1080, depth 8: the wavefront
integrator on the wide-BVH kernels K2 (closest hit) and K1 (any hit)
(BVH_PALLAS); the bench's own BVH_SWEEP configuration, whose bounces
after the first run the dense treelet scan K3, the bin sort, the demand
sweep K4 and a K2 tail; the engine's real-time denoised frame
(`Renderer` with the denoiser on: a BVH_PALLAS frame, then SVGF with the
temporal reprojection K6 and five a-trous passes K5); BVH_PALLAS on the
binary (arity-2) pack, whose casts run the binary kernels K8a (closest
hit) and K8b (any hit); the megakernel integrator (`Renderer` in
RenderMode.MEGAKERNEL) on the binary pack and on the wide one; and the
BVH_TREELET backend, whose camera rays go through the self-rebinning
closest hit K10 and whose later bounces run the treelet scan K9, the
hybrid easy/hard split and one sort, K10 seeded on the easy rays and K2
on the hard ones; and the BVH_SWEEP variants: the lane sweep K7 and K4's
group and any-hit modes in two wavefront configurations, the megakernel
and the wavefront without the pool sort on the unsorted sweep cast, and
the multi-slot top-tree scan K11 feeding the sweep cast; and the hero
scene, loaded from scenes/hero.json (JSON, OBJ/MTL, four PNG textures
in one atlas, an HDR sky with its alias table) with textured,
normal-mapped and env-lit shading and environment NEE, on BVH_PALLAS
with and without the denoiser and on BVH_SWEEP; then the LBVH builder
on the card, the BVH_XLA backend (a plain-PyTorch walk, no kernel of
its own) on the hero, the engine's BVH heatmap, and the command line,
`tpt_torch.cli`, rendering the hero on BVH_XLA with SVGF (K6 and K5)
against tests/golden_hero_120x68.npz; and last the multi-device render
(`tpt_torch.parallel`: pixels sharded by rows, SVGF over row windows)
over NCCL in this process and over gloo in two processes on this card.
One line per phase (name, seconds, key numbers):

  device     nvidia-smi name and power limit, torch and CUDA versions
  build      nvcc (sm_90a) of tpt_torch/csrc/packet_wide.cu (K1, K2,
             K8a, K8b),
             tpt_torch/csrc/sweep.cu, tpt_torch/csrc/svgf.cu and
             tpt_torch/csrc/treelet.cu and g++ of the native SAH library,
             all at once, from the sources in this checkout
  scene      host scene, SAH BVH, wide pack, treelet cut and sweep tables
             (chunk_align 8, as bench.py builds them), and the binary pack
             (HostScene.build with packet_arity=2), uploaded to the card
  kernels    K2/K1 against their plain PyTorch versions, bit for bit,
             on 262,144 live rays (camera primaries and one real diffuse
             bounce of the render, and the NEE shadow rays of both
             bounces), then on all 2,073,600 lanes of each of those casts
             as the render launches them, dead lanes included; then each
             cast timed back to back (kernel_ms) and as one launch
             between events, and K2's and K1's registers a thread
  flatgroup_check
             K4 (default, groups, any-hit) and K7 (demand, any-hit)
             against their plain versions, bit for bit, on flat groups at
             coordinate 0 (tests/torch_flatgroup.py): the two-triangle
             warp (K4 must take the nearer triangle B), 4096 rays at the
             shared edge, and a flat grid on each axis with its rays in
             mixed warps and alone in their warps
  render     wavefront.render, BVH_PALLAS, depth 8, 4 iterations at 1080p,
             with all launch counters zeroed just before and read just
             after (K2 and K1 8 a frame, no other kernel); the device busy
             share of a profiled frame, and one frame split by CUDA events
             into the casts and the rest
  agreement  the same scene at 240x135, 2 iterations, through the kernels
             and through the plain versions: the images must agree to the
             golden-image tolerance of tests/test_golden.py
  sweep_kernels
             the bench configuration's pools (spp_batch 4: 8,294,400 lanes):
             K3 against its plain version on every lane of the unsorted
             bounce-1 pool, K4 on every lane of the bin-sorted bounce-1 pool
             and on 262,144 lanes (whole blocks) of the bounce-4 pool, both
             bit for bit (floats as bit patterns); the final
             sweep_cast_sorted hits against K2 on every lane of bounce 1 (t
             bit-equal, triangles up to equal-t ties); CUDA-event timings,
             bounds (K4's by the tests its result needs,
             sweep.sweep_need), union sizes, tail share; K2 on the frame's
             compacted bounce-1 tail and K1 on its bounce-1 shadow rays,
             against plain bit for bit, timed alone with bounds from their
             stats
  sweep_render
             wavefront.render in the bench configuration (BVH_SWEEP, depth
             8, spp_batch 4, sweep_unroll 8) at 1080p, with all launch
             counters zeroed just before and read just after; frame ms,
             Mpaths/s, and one frame split by stage with CUDA events, with
             K3's and K4's time a bounce and the tail stage split into K2's
             launches and the compaction around them
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
             both sequences at 240x135, depth 4, through the kernels and
             through the plain versions: each denoised frame must agree to
             the golden-image tolerance
  binary_kernels
             K8a/K8b against their plain versions, bit for bit with no
             capped ray, on 262,144 live rays (camera primaries and one
             real diffuse bounce of the binary render, and the NEE shadow
             rays of both bounces), then on all 2,073,600 lanes of each of
             those casts as the render launches them, dead lanes included;
             each cast timed back to back and as one launch between
             events, bounds from the tests the kernels count, K8a's and
             K8b's registers, and K2/K1 on the same primaries and shadow
             rays (wide pack) beside them
  binary_render
             wavefront.render with BVH_PALLAS on the binary pack at 1080p,
             depth 8, with all launch counters zeroed just before and read
             just after (K8a and K8b 8 a frame, no other kernel); frame ms
             and Mpaths/s beside the wide BVH_PALLAS frame of the run, and
             the device busy share of a profiled frame
  mega_render
             Renderer in RenderMode.MEGAKERNEL at 1080p, depth 8, a
             warm-up frame and 3 timed frames on the binary pack (K8a/K8b
             launched) and the same on the wide pack (K2/K1 launched), each
             frame in one pass; frame ms, Mpaths/s, the device busy share
             of a profiled binary-pack frame
  mega_agreement
             the megakernel on the binary pack at 240x135, 2 iterations,
             through the kernels, through the plain versions and against
             the binary wavefront render; and tests/test_golden.py:63-76's
             configuration through the binary wavefront against its
             stored image; all at the golden-image tolerance
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
             BVH_TREELET at 240x135, depth 4, both samples in one pool
             (spp_batch 2), through the kernels, through the plain versions
             and against the BVH_PALLAS render; it refuses to start with
             less than twice its plain render's time left on the watchdog
  sweepvar_kernels
             the BVH_SWEEP variants' kernels on the bench configuration's
             bounce-1 pools: K7 (demand, and every requested slot) and K4's
             group mode against their plain versions on whole 1024-lane
             blocks (262,144 lanes) of the bin-sorted pool, bit for bit,
             and on every lane how often K4's group mode (tpt's window)
             differs from K4 without groups, with both modes held against
             their plain versions on the blocks where they differ; K7's
             and K4's any-hit modes on whole blocks of the shadow rays; K11
             against its plain version on the first 2,073,600 lanes of the
             unsorted pool, its slots equal to K3's, then through the bin
             sort and sweep_cast_sorted to K2's hits on every lane (t
             bit-equal, triangles up to equal-t ties); CUDA-event times on
             the whole pools (K7 beside K4), mean unions, 0 capped, and
             bounds from the tests the results need (K7's and K4's modes'
             by sweep.sweep_need, K11's a per-ray top-tree walk's)
  sweepvar_render
             wavefront.render at 1080p in two variants of the bench
             configuration, 2 frames each after a warm-up frame, with the
             launch counters zeroed just before and read just after against
             an expected table: "lane" (sweep_kernel="lane", sweep_shadow:
             K3, K7, K7 any-hit, K2 and K1 tails) and "cascade"
             (sweep_groups, sweep_shadow, sweep_cascade, sweep_primary: K3
             on bounce 0 too, K4's group mode in both cascade phases, K4's
             any-hit mode); frame ms and Mpaths/s beside the bench frame,
             and the device busy share of one profiled frame of each
  sweepvar_mega
             Renderer in RenderMode.MEGAKERNEL on BVH_SWEEP at 1080p, 1 spp,
             a warm-up frame and 2 timed frames (every cast the unsorted
             sweep_cast), and one wavefront frame of BVH_SWEEP without
             sort_bounce_rays, each against its expected launches
  sweepvar_agreement
             those four configurations at 240x135, depth 4, through the
             kernels, through the plain versions and against the bench
             BVH_SWEEP render, at the golden-image tolerance with 0 capped
             rays; it refuses to start with less than twice its plain
             renders' time left on the watchdog
  hero_render
             scenes/hero.json with its textures written into a scratch
             directory by tpt_torch.scene.hero_assets, loaded by
             load_scene and built on the card, at its own 960x540, depth
             8, env NEE on: K2 and K1 against their plain versions, bit for
             bit, on every lane of bounces 0 and 1 (extension rays, light
             and env NEE shadow rays) and timed back to back; the Renderer
             without and with the denoiser, a warm-up frame and 3 timed
             frames each, launch counters zeroed just before and read just
             after (K2 8 and K1 16 a frame, and K6 1 and K5 5 denoised); one
             frame split by CUDA events into the casts and the rest; one
             BVH_SWEEP frame (K3, K4, the K2 tail, 0 capped) held against
             the BVH_PALLAS render of the same iteration; the triangle
             count, atlas and env map sizes, frame ms and Mpaths/s
  hero_agreement
             the hero at 240x135 through the kernels and through the plain
             versions: a 2-sample wavefront render and the third denoised
             Renderer frame, at the golden-image tolerance; with the
             hero_render phase it refuses to start with less than twice
             their allowance left on the watchdog
  lbvh_build
             the fireplace's LBVH (tpt_torch/bvh/build.py) built on the
             card, twice (the first with its warm-up), against the CPU
             build of the same mesh, every array bit for bit; both trees
             validated (tpt_torch/bvh/validate.py); depths, and the mean
             traversal cost (steps of the escape-link walk) of the 1080p
             primaries on the LBVH and on the SAH tree
  xla_render
             the hero at its own 960x540, depth 8, env NEE on BVH_XLA (the
             plain-PyTorch walk of tpt_torch/bvh/traverse.py): one
             wavefront frame with the launch counters zeroed just before
             and read just after (no kernel), and one denoised Renderer
             frame (K6 1, K5 5), each held against BVH_PALLAS's frame of
             the same iteration at the golden-image tolerance, 0 capped
             rays; frame ms, walks and loop iterations a walk
  heatmap
             Renderer in DisplayMode.BVH_HEATMAP on the fireplace at
             1080p (a BVH_PALLAS frame, then the traversal-cost map of the
             SAH tree); the map's ms and the cost percentiles
  cli_hero
             tpt_torch.cli.main on the hero at tests/test_hero.py's
             settings (120x68, 3 iterations, depth 4, --backend bvh
             --denoise --env-nee), launch counters zeroed just before and
             read just after (K6 1, K5 5 a frame): its PNG against
             tests/golden_hero_120x68.npz as tests/test_hero.py holds
             tpt's (> 97% of values within 2/255, means within 2%); then
             2 iterations at the file's own 960x540, depth 8, and their
             ms a frame
  sharded    tpt_torch.parallel's sharded render, 2 denoised frames of
             BVH_SWEEP at 1080p (depth 8, 1 spp, sweep_unroll 8, the
             chunk_align-8 tables, SVGF over row windows), the camera
             turning before the second: world 1 over NCCL in this process
             and world 2 over gloo in two spawned processes on this one
             card, each frame's image and all 18 SVGF state leaves held
             against carried_sequence as bit patterns, the rays summed over
             the ranks against its count, 0 capped; each rank's launches
             (K2, K3, K4, K1, K6, K5) between its counters' zeroing and
             reading, its window's rows, R and M, and its frame ms (two
             processes sharing one card: not a scaling figure)

Then one JSON line describing each of the twelve ported kernels, K4's
and K7's modes under their own entries (with the lanes their times and
bound were taken on where these are not the main path's), the
nvidia-smi line,
and last `{"ok": true, "device": {...}}`. Any failed check raises, so the
run exits nonzero and prints no result; so does a run without a CUDA
device or outside the repository. A watchdog ends the whole run, with a
traceback of every thread, after WATCHDOG_S seconds.

tests/ is the shared home of the check inputs this script and the tests
both use: the stored golden image (tests/golden_cornell_pallas_64.npz)
and the flat-group tables and rays of tests/torch_flatgroup.py, a module
that imports only numpy, torch and tpt_torch.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

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
# svgf_agreement traces at depth 4, not 8: its 32 plain and kernel
# sequence frames took 60.0-98.9 s at depth 8 (NVIDIA H100 80GB HBM3,
# 700 W), and on the slower host of those runs the hero phases then
# refused to start; the denoiser it checks sees the same planes
SVGF_AGREE_DEPTH = 4
SHARDED_FRAMES = 2      # the sharded phase's frames, the camera turning
# bytes a pixel moves (float32/int32 planes read once and written once)
# and fp32 operations it needs (counted from tpt_torch/csrc/svgf.cu, the
# divides as one each, so the bound stays a least time): K5 reads 12
# planes and writes 8; K6 reads 15 history and 7 current planes and
# writes 11. K5's 500 besides its 24 expf and its normal weights: one
# powf for each of a pixel's 4 edges (an edge's weight is the same from
# either end), expf and powf counted at their lengths as compiled with
# the port's flags (8 and 96 SASS instructions: scripts/svgf_sass.py on
# an NVIDIA H100 80GB HBM3)
EXPF_OPS, POWF_OPS = 8, 96
ATROUS_BYTES_PX = 80
ATROUS_OPS_PX = 500 + 24 * EXPF_OPS + 4 * POWF_OPS
REPROJECT_BYTES_PX, REPROJECT_OPS_PX = 132, 210
# BVH_TREELET: whole packets held against the plain versions (seeded
# 2048-lane bounce packets, unseeded 4096-lane camera-ray packets), frames
# of the timed render, and back-to-back launches timed per kernel
TREELET_SEEDED_PACKETS = 128
TREELET_PRIMARY_PACKETS = 64
TREELET_FRAMES = 2
TREELET_REPS = 3
# treelet_agreement renders at depth 4, not 8: its plain 240x135 render
# took 113-145 s at depth 8 (NVIDIA H100 80GB HBM3, 700 W), and with the
# LBVH, BVH_XLA, CLI and sharded phases behind it a run on a slow host
# ended at 552.7 s of its watchdog. Its sequential steps are set by the
# slowest packet, so a slower host takes longer; at depth 4 it takes at
# most this long
TREELET_AGREE_DEPTH = 4
TREELET_PLAIN_RENDER_S = 80.0

# the BVH_SWEEP variants on the bench configuration: frames of each timed
# render, the two wavefront configurations, K11's lanes (a 1080p frame's
# worth of the unsorted bounce-1 pool), and the plain 240x135 renders of
# sweepvar_agreement together, at most
SWEEPVAR_FRAMES = 2
SWEEPVAR = {
    "lane": dict(sweep_kernel="lane", sweep_shadow=True),
    "cascade": dict(sweep_groups=True, sweep_shadow=True, sweep_cascade=True,
                    sweep_primary=True),
}
K11_LANES = 2_073_600
# sweepvar_agreement renders at depth 4, not 8: its four plain renders took
# 84.4 s together at depth 8 (NVIDIA H100 80GB HBM3, 700 W), too long for
# the watchdog behind the treelet phases; at most this long at depth 4
SWEEPVAR_AGREE_DEPTH = 4
SWEEPVAR_PLAIN_RENDERS_S = 60.0

# launch-counter keys of the wide (K2, K1) and binary (K8a, K8b) casts
WIDE = ("packet_closest_hit_wide", "packet_any_hit_wide")
BINARY = ("packet_closest_hit", "packet_any_hit")
# the binary pack's phases: frames of the timed BVH_PALLAS render and of
# the megakernel Renderer
BINARY_FRAMES = 3
MEGA_FRAMES = 3
# tests/test_golden.py:63-76, held against its stored image on the card
GOLDEN_PALLAS = ("tests", "golden_cornell_pallas_64.npz")
# the hero scene (scenes/hero.json: its own 960x540 and depth 8): frames
# of each timed Renderer run, the iteration of the BVH_SWEEP frame, and
# both hero phases together, at most
HERO_RES, HERO_DEPTH = (960, 540), 8
HERO_FRAMES = 3
HERO_SWEEP_ITER = 7
HERO_PHASES_S = 60.0
# this slice's phases: the hero's BVH_XLA frames, the CLI run at
# tests/test_hero.py's settings (held to its golden) and its timed run
# at the file's own size, and all four phases together, at most
XLA_ITER = 7
CLI_HERO = dict(res=[120, 68], iterations=3, depth=4)
GOLDEN_HERO = ("tests", "golden_hero_120x68.npz")
CLI_TIMED_ITERS = 2
XLA_PHASES_S = 90.0

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


def check_closest_hit(label: str, res_k, res_p, kernel: str) -> float:
    """Hold a closest-hit kernel's (HitRecord, capped) against the plain
    version's, bit for bit with no capped ray; returns the largest
    absolute difference of t, u and v (0)."""
    (hk, cap_k), (hp, cap_p) = res_k, res_p
    if int(cap_k) or int(cap_p):
        raise RuntimeError(f"{label}: capped rays, kernel {int(cap_k)}, "
                           f"plain {int(cap_p)}")
    equal_hits(f"{kernel} vs plain, {label}", hk, hp)
    print(f"  {kernel} vs plain, {label}: {hk.tri.numel()} rays, "
          f"{int((hk.tri >= 0).sum())} hits, bit-equal")
    return 0.0


def check_any_hit(label: str, res_k, res_p, t_max, kernel: str) -> float:
    """Hold an any-hit kernel's (occluded, capped) against the plain
    version's, flag for flag with no capped ray; returns the largest
    absolute difference of the occlusion flags (0 or 1)."""
    (ok, cap_k), (op, cap_p) = res_k, res_p
    if int(cap_k) or int(cap_p):
        raise RuntimeError(f"{label}: capped rays, kernel {int(cap_k)}, "
                           f"plain {int(cap_p)}")
    occ_diff = int((ok != op).sum())
    if occ_diff:
        raise RuntimeError(f"{label}: {kernel} occlusion differs on "
                           f"{occ_diff} rays")
    dead = t_max - 1e-3 <= 0
    if not bool(ok[dead].all()):
        raise RuntimeError(f"{label}: {kernel} reports a dead lane unoccluded")
    print(f"  {kernel} vs plain, {label}: {ok.numel()} rays ({int(dead.sum())} "
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
    """Route K1-K11 to their plain PyTorch versions (on the card)."""
    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.bvh import treelet_traverse as tlt
    from tpt_torch.denoise import reproject, stencil, svgf

    p = Patch()
    p.set(tlt, "treelet_scan", tlt.treelet_scan_plain)
    p.set(tlt, "treelet_closest_hit", tlt.treelet_closest_hit_plain)
    p.set(tlt, "treelet_scan_multi", tlt.treelet_scan_multi_plain)
    p.set(sw, "sweep_closest_hit", sw.sweep_closest_hit_plain)
    p.set(stencil, "atrous", stencil.atrous_plain)
    p.set(stencil, "atrous_passes", stencil.atrous_passes_plain)
    p.set(reproject, "reproject", svgf._reproject_taps)
    p.set(sw, "dense_scan", sw.dense_scan_plain)
    p.set(sw, "sweep8_closest_hit", sw.sweep8_closest_hit_plain)
    p.set(pt, "packet_closest_hit_wide", pt.closest_hit_wide_plain)
    p.set(pt, "packet_any_hit_wide", pt.any_hit_wide_plain)
    p.set(pt, "packet_closest_hit", pt.closest_hit_plain)
    p.set(pt, "packet_any_hit", pt.any_hit_plain)
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


def bit_patterns(a):
    """A float32 tensor's bit patterns (int32), so that -0 differs from
    +0 and NaNs compare; other tensors as they are."""
    import torch

    return a.view(torch.int32) if a.dtype == torch.float32 else a


def equal_hits(label: str, a, b) -> None:
    """Two HitRecords bit for bit (t, tri, u, v; floats as bit
    patterns)."""
    import torch

    for f in ("t", "tri", "u", "v"):
        x, y = bit_patterns(getattr(a, f)), bit_patterns(getattr(b, f))
        if not torch.equal(x, y):
            raise RuntimeError(f"{label}: {f} differs on "
                               f"{int((x != y).sum())} lanes")


def profiled_frame(label: str, fn) -> float:
    """Device busy share of one frame fn(): torch.profiler's kernel times
    against the frame's wall time (profiling itself slows the host side).
    Prints them and the top kernels under `label`; returns the share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tw) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"  profiled {label} frame: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.0f}%), {sum(e.count for e in dev_events)} "
          f"kernel launches; top: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
              for e in top))
    return busy_ms / wall_ms


def zero_launches() -> tuple:
    """Set every kernel's launch counter to 0; returns the counters."""
    from tpt_torch.parallel.dryrun import launch_counters

    return launch_counters()


def expect_launches(label: str, counts, want: dict,
                    frames: int = 1) -> dict:
    """Every counter within want's entry times `frames` (an int, or
    (least, most) for a cast that runs only when some lane needs it, as a
    tail does), every other counter 0; returns them."""
    got = {k: v for c in counts for k, v in c.items()}
    for k, v in got.items():
        lo = hi = want.get(k, 0)
        if isinstance(lo, tuple):
            lo, hi = lo
        if not lo * frames <= v <= hi * frames:
            raise RuntimeError(f"{label} launches {got}, expected {want} a "
                               f"frame over {frames} frames and no other "
                               "kernel")
    return got


def nonzero(launches: dict) -> str:
    """The counters that moved, as compact JSON."""
    return json.dumps({k: v for k, v in launches.items() if v}
                      ).replace(" ", "")


def tests_done(stats) -> str:
    """A kernel's stats counts (node visits, slab tests, triangle tests)."""
    return (f"node visits {int(stats[0])}, slab tests {int(stats[1])}, "
            f"tri tests {int(stats[2])}")


def check_image(label: str, img) -> None:
    """A 1080p frame: the right shape, finite, not black."""
    import numpy as np

    if img.shape != (RES[1], RES[0], 3) or not np.isfinite(img).all() \
            or not img.mean() > 0:
        raise RuntimeError(f"bad {label} image: shape {img.shape}, "
                           f"mean {float(np.nanmean(img))}")


def cast_phase(scene, cam, dev, names: tuple, closest, any_hit,
               closest_plain, any_plain) -> dict:
    """The cast kernels of `scene`'s pack, closest(pack, o, d, t_max) and
    any_hit(...), against their plain versions on the casts of bounces 0
    and 1 of a BVH_PALLAS frame: first on N_COMPARE live rays (camera
    primaries and one real diffuse bounce, and the NEE shadow rays of both
    bounces), then on every lane of each of those casts as the render
    launches them, dead lanes included (check_closest_hit,
    check_any_hit: bit for bit). Then each cast's device time on all
    lanes, by back-to-back launches (kernel_ms) and, beside it, one launch
    between two events (which also catches the host's launch path): the
    closest hit on the primaries and the bounce-1 pool, the any hit on
    the shadow rays of bounces 0 and 1; bounds from the tests the kernels
    count. `names` are the two kernels' labels.
    Returns the lane count, the four casts, and each kernel's numbers for
    the kernels line (the primaries, the bounce-0 shadow rays)."""
    import torch

    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.integrators import common, wavefront

    kc, ka = names
    pack = scene.pack
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH)
    rec = Recorder(common.make_raycaster(scene, cfg))
    vp = wavefront.camera_view_proj(cam)
    carry = wavefront.batched_raygen(cam, cfg, 1, dev)
    for depth in range(2):
        carry = wavefront._bounce_body(scene, rec.raycaster, cam, cfg, vp, vp,
                                       depth, carry)
    del carry
    prim, pool = rec.ext
    shd0, shd1 = rec.shadow
    live = lambda rays: pick(*rays, rays[2] > 0, N_COMPARE // 2)

    def check_c(label, rays):
        res_p, plain_ms = timed_once(lambda: closest_plain(pack, *rays))
        err = check_closest_hit(label, closest(pack, *rays), res_p, kc)
        return err, plain_ms

    def check_a(label, rays):
        res_p, plain_ms = timed_once(lambda: any_plain(pack, *rays))
        err = check_any_hit(label, any_hit(pack, *rays), res_p, rays[2], ka)
        return err, plain_ms

    c_err = check_c("picked live rays", cat_rays(live(prim), live(pool)))[0]
    a_err = check_a("picked live rays", cat_rays(live(shd0), live(shd1)))[0]
    err, c_plain_ms = check_c("primaries, all lanes", prim)
    c_err = max(c_err, err, check_c("bounce-1 pool, all lanes", pool)[0])
    err, a_plain_ms = check_a("bounce-0 shadow, all lanes", shd0)
    a_err = max(a_err, err, check_a("bounce-1 shadow, all lanes", shd1)[0])

    n = prim[2].shape[0]
    out = {}
    for label, kernel, fn, rays, out_bytes in (
            ("primaries", kc, closest, prim, 16),
            ("bounce-1 pool", kc, closest, pool, 16),
            ("bounce-0 shadow", ka, any_hit, shd0, 1),
            ("bounce-1 shadow", ka, any_hit, shd1, 1)):
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        fn(pack, *rays, stats=stats)
        launch = lambda: fn(pack, *rays)
        ms, ev_ms = kernel_ms(launch, KERNEL_REPS), cuda_time_ms(
            launch, TIMING_REPS)
        b_ms, b_by = bound(pack, rays[2].numel(), out_bytes, stats.cpu())
        out[label] = (ms, b_ms, b_by, ev_ms)
        print(f"  {kernel} {label}: {ms:.3f} ms back to back "
              f"({rays[2].numel() / (ms * 1e-3) / 1e6:.1f} Mrays/s), one "
              f"launch between events {ev_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}); {tests_done(stats.cpu())}")
    print(f"  plain: {kc} primaries {c_plain_ms:.1f} ms, {ka} bounce-0 "
          f"shadow {a_plain_ms:.1f} ms")
    # `ms` is the back-to-back time; one launch between events (what
    # older kernels lines gave as `ms`) stands beside it as ms_one_launch
    entry = lambda label, err, plain_ms: dict(
        max_abs_err=err, ms=out[label][0], timing="back_to_back",
        ms_one_launch=out[label][3], plain_ms=plain_ms,
        bound_ms=out[label][1], bound_by=out[label][2])
    return dict(lanes=n, casts=(prim, pool, shd0, shd1),
                closest=entry("primaries", c_err, c_plain_ms),
                any_hit=entry("bounce-0 shadow", a_err, a_plain_ms))


def render_phase(label: str, scene, cam, cfg, frames: int, want: dict,
                 seed_iter: int) -> tuple:
    """wavefront.render of `frames` 1080p frames of cfg.spp_batch samples
    after a warm-up frame, with every launch counter zeroed just before
    and read just after: they must equal `want` a frame (expect_launches)
    and every other counter 0. No capped ray, a good image. Then the
    device busy share of one profiled frame. Returns (ms a frame by the
    host clock, the counters, the image, the raycaster)."""
    import torch

    from tpt_torch.integrators import common, wavefront

    rc = common.make_raycaster(scene, cfg)
    wavefront.trace_frame(scene, rc, cam, cfg, seed_iter)   # warm-up frame
    torch.cuda.synchronize()
    counts = zero_launches()
    tr = time.perf_counter()
    img = wavefront.render(scene, cam, cfg, iterations=frames * cfg.spp_batch,
                           raycaster=rc)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - tr) * 1e3 / frames
    launches = expect_launches(label, counts, want, frames)
    if int(rc.capped):
        raise RuntimeError(f"{label} had {int(rc.capped)} capped rays")
    check_image(label, img)
    profiled_frame(label, lambda: wavefront.trace_frame(scene, rc, cam, cfg,
                                                        seed_iter + 1))
    return frame_ms, launches, img, rc


def walk_registers(arity: int) -> str:
    """The closest-hit and any-hit walks' registers a thread and local
    bytes (cudaFuncGetAttributes), as built: K2/K1 for arity 4 or 8,
    K8a/K8b for arity 2."""
    from tpt_torch.bvh import packet_traverse as pt

    names = ("K8a", "K8b") if arity == 2 else ("K2", "K1")
    return "; ".join(
        f"{k} " + "{regs} regs, {local_bytes} B local, {shared_bytes} B "
        "shared".format(**pt.kernel_attributes(a, arity))
        for k, a in zip(names, (0, 1)))


def binary_phases(scene, bscene, cam, dev,
                  pallas_frame_ms: Optional[float]) -> tuple:
    """The binary_kernels and binary_render phases on the binary pack
    `bscene` (the wide `scene` times K2 and K1 on the same primaries and
    shadow rays); the binary frame is set beside the wide BVH_PALLAS
    frame `pallas_frame_ms` of the run, if one was measured. Returns the
    K8a and K8b entries of the kernels line and the binary frame's ms."""
    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.config import RayCastBackend, RenderConfig

    # ---- binary_kernels: the casts of bounces 0 and 1 ----------------------
    t0 = time.perf_counter()
    res = cast_phase(bscene, cam, dev, ("K8a", "K8b"), pt.packet_closest_hit,
                     pt.packet_any_hit, pt.closest_hit_plain,
                     pt.any_hit_plain)
    prim, pool, shd0, shd1 = res.pop("casts")
    print(f"  {walk_registers(2)}")
    wide = {}
    for k, fn, rays in (("K2", pt.packet_closest_hit_wide, prim),
                        ("K1", pt.packet_any_hit_wide, shd0)):
        launch = lambda: fn(scene.pack, *rays)
        wide[k] = kernel_ms(launch, KERNEL_REPS)
        print(f"  {k} on the same {'primaries' if k == 'K2' else 'bounce-0 shadow rays'}"
              f" (wide pack): {wide[k]:.3f} ms back to back, one launch "
              f"between events {cuda_time_ms(launch, TIMING_REPS):.3f} ms")
    print(f"  {walk_registers(scene.pack.arity)}")
    k8a_ms, k8b_ms = res["closest"]["ms"], res["any_hit"]["ms"]
    print(f"  K8a/K2 {k8a_ms / wide['K2']:.2f}x, K8b/K1 "
          f"{k8b_ms / wide['K1']:.2f}x")
    phase("binary_kernels", t0, n_compare=N_COMPARE, lanes=res["lanes"],
          nodes=bscene.pack.num_nodes, k8a_ms=f"{k8a_ms:.3f}",
          k8b_ms=f"{k8b_ms:.3f}", k2_ms=f"{wide['K2']:.3f}",
          k1_ms=f"{wide['K1']:.3f}")
    del prim, pool, shd0, shd1

    # ---- binary_render: BVH_PALLAS on the binary pack -----------------------
    t0 = time.perf_counter()
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH)
    frame_ms, launches, img, rc = render_phase(
        "binary render", bscene, cam, cfg, BINARY_FRAMES,
        dict(packet_closest_hit=DEPTH, packet_any_hit=DEPTH), 400)
    if pallas_frame_ms is not None:
        print(f"  against the wide BVH_PALLAS frame of this run: "
              f"{frame_ms / pallas_frame_ms:.2f}x ({frame_ms:.1f} ms vs "
              f"{pallas_frame_ms:.1f} ms)")
    phase("binary_render", t0, frame_ms=f"{frame_ms:.1f}",
          mpaths_s=f"{cam.num_pixels / (frame_ms * 1e-3) / 1e6:.3f}",
          launches=json.dumps({k: launches[k] for k in BINARY + WIDE}
                              ).replace(" ", ""),
          capped=int(rc.capped), image_mean=f"{float(img.mean()):.5f}")

    source = "tpt_torch/csrc/packet_wide.cu"
    entries = [
        dict(name="packet_closest_hit", route="cuda", source=source,
             replaces="tpt/bvh/pallas_traverse.py:350",
             launches=launches["packet_closest_hit"], **res["closest"],
             library_ms=None),
        dict(name="packet_any_hit", route="cuda", source=source,
             replaces="tpt/bvh/pallas_traverse.py:394",
             launches=launches["packet_any_hit"], **res["any_hit"],
             library_ms=None),
    ]
    return entries, frame_ms


def mega_phases(scene, bscene, cam, dev, pallas_frame_ms: Optional[float],
                binary_frame_ms: float, agreement: bool = True) -> None:
    """The mega_render and mega_agreement (unless not `agreement`) phases:
    the megakernel through the engine on the binary pack (K8a/K8b) and on
    the wide one (K2/K1), beside the wavefront frames of the run (the
    wide one if `pallas_frame_ms` was measured)."""
    import numpy as np
    import torch

    from tpt_torch import Renderer
    from tpt_torch.config import RayCastBackend, RenderConfig, RenderMode
    from tpt_torch.core.camera import Camera
    from tpt_torch.integrators import common, megakernel, wavefront
    from tpt_torch.scene import procedural
    from tpt_torch.scene.structs import MaterialType

    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH,
                       mode=RenderMode.MEGAKERNEL)
    npx = cam.num_pixels

    # ---- mega_render: the engine's megakernel mode at 1080p -----------------
    t0 = time.perf_counter()

    def frames(renderer, k):
        """k frames of `renderer` from zeroed launch counters: (ms a
        frame by the host clock, the counters, the last image)."""
        counts = zero_launches()
        tr = time.perf_counter()
        for _ in range(k):
            img = renderer.frame()
        torch.cuda.synchronize()
        return (time.perf_counter() - tr) * 1e3 / k, counts, img

    r = Renderer(bscene, cam, cfg)
    r.frame()                                      # warm-up frame
    frame_ms, counts, img = frames(r, MEGA_FRAMES)
    per = DEPTH * MEGA_FRAMES
    launches = expect_launches("megakernel (binary pack)", counts,
                               dict(packet_closest_hit=per,
                                    packet_any_hit=per))
    if int(r.raycaster.capped):
        raise RuntimeError(f"megakernel had {int(r.raycaster.capped)} "
                           "capped rays")
    check_image("megakernel (binary pack)", img)
    if r.iteration != MEGA_FRAMES + 1:
        raise RuntimeError(f"megakernel Renderer at iteration {r.iteration}")
    busy = profiled_frame("megakernel (binary pack)", r.frame)
    # the wide pack, timed as the binary one
    wide = Renderer(scene, cam, cfg)
    wide.frame()                                   # warm-up frame
    wide_ms, counts, wimg = frames(wide, MEGA_FRAMES)
    wide_launches = expect_launches(
        "megakernel (wide pack)", counts,
        dict(packet_closest_hit_wide=per, packet_any_hit_wide=per))
    if int(wide.raycaster.capped):
        raise RuntimeError(f"wide megakernel had {int(wide.raycaster.capped)} "
                           "capped rays")
    check_image("megakernel (wide pack)", wimg)
    mp = lambda ms: npx / (ms * 1e-3) / 1e6
    wide_wf = ("" if pallas_frame_ms is None
               else f", wide {pallas_frame_ms:.1f} ms")
    print(f"  {MEGA_FRAMES} frames after a warm-up frame: binary pack "
          f"{frame_ms:.1f} ms a frame ({mp(frame_ms):.3f} Mpaths/s), wide "
          f"pack {wide_ms:.1f} ms ({mp(wide_ms):.3f} Mpaths/s); wavefront "
          f"frames of this run: binary {binary_frame_ms:.1f} ms{wide_wf}")
    phase("mega_render", t0, frame_ms=f"{frame_ms:.1f}",
          mpaths_s=f"{mp(frame_ms):.3f}", wide_ms=f"{wide_ms:.1f}",
          busy=f"{busy:.3f}",
          launches=json.dumps({k: launches[k] for k in BINARY}
                              ).replace(" ", ""),
          wide_launches=json.dumps({k: wide_launches[k] for k in WIDE}
                                   ).replace(" ", ""),
          image_mean=f"{float(img.mean()):.5f}")
    del r, wide
    if not agreement:
        return

    # ---- mega_agreement: kernels vs plain, vs the wavefront, the golden -----
    t0 = time.perf_counter()
    small = Camera.build(AGREE_RES, cam.position, cam.look_at, cam.up,
                         cam.fovy_deg)
    acfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH)
    rc_k = common.make_raycaster(bscene, acfg)
    img_k = megakernel.render(bscene, small, acfg, iterations=AGREE_ITERS,
                              raycaster=rc_k)
    patch = plain_kernels()
    try:
        rc_p = common.make_raycaster(bscene, acfg)
        tp = time.perf_counter()
        img_p = megakernel.render(bscene, small, acfg, iterations=AGREE_ITERS,
                                  raycaster=rc_p)
        plain_s = time.perf_counter() - tp
    finally:
        patch.restore()
    rc_w = common.make_raycaster(bscene, acfg)
    img_w = wavefront.render(bscene, small, acfg, iterations=AGREE_ITERS,
                             raycaster=rc_w)
    # tests/test_golden.py:63-76's configuration on the binary pack
    gs = procedural.cornell_box(resolution=(64, 64), sphere_materials=(
        MaterialType.MICROFACET_PBR, MaterialType.SPECULAR_REFRACTION))
    gdata = gs.build(with_bvh=True, packet_arity=2, device=dev)
    gcfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3)
    rc_g = common.make_raycaster(gdata, gcfg)
    img_g = wavefront.render(gdata, gs.camera, gcfg, iterations=2,
                             raycaster=rc_g)
    if any(int(c.capped) for c in (rc_k, rc_p, rc_w, rc_g)):
        raise RuntimeError("megakernel agreement renders had capped rays")
    golden = np.load(os.path.join(REPO, *GOLDEN_PALLAS))["image"]
    out = {"plain_render_s": f"{plain_s:.1f}"}
    for label, a, b in (("plain", img_k, img_p), ("wavefront", img_k, img_w),
                        ("golden", img_g, golden)):
        close, _, max_abs = golden_agree(f"megakernel agreement, {label}", a,
                                         b)
        out[f"{label}_close"] = f"{close:.6f}"
        out[f"{label}_max_abs"] = f"{max_abs:.3g}"
    phase("mega_agreement", t0, **out)


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


def need_bound(n: int, S: int, tables, need) -> tuple:
    """(bound_ms, bound_by) of a demand sweep over n lanes from
    sweep.sweep_need's counts: bytes = rays and S slots in, hits out, the
    tables once (rows, ranges, group boxes); operations = the triangle and
    group slab tests its result needs, whatever implements it."""
    table_bytes = 4 * (tables.tri_f32.numel() + tables.ranges.numel()
                       + tables.group_boxes.numel())
    return sweep_bound(n, 28 + 8 * S, 16, table_bytes,
                       OPS_PER_TRI * need[0] + OPS_PER_SLAB * need[1])


def flatgroup_phase(dev) -> None:
    """The flatgroup_check phase: K4 (default, groups, any-hit) and K7
    (demand, any-hit) on flat groups at coordinate 0 (tests/
    torch_flatgroup.py), bit for bit against their plain versions: the
    two-triangle warp (one live lane; the plain sweeps take the nearer
    triangle B, which a sweep that culled by group boxes dropped), 4096
    rays at the triangles' shared edge, and a flat grid on each axis with
    its rays in mixed warps and alone in their warps (K4's group mode
    active)."""
    import torch

    from tpt_torch.bvh import sweep as sw

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_flatgroup as fg

    t0 = time.perf_counter()

    def modes(label, tables, pool):
        o, d, t_max, s_o, s_t = pool
        out = {}
        for mode in ("K4", "K4 groups", "K4 any-hit", "K7", "K7 any-hit"):
            any_hit = "any-hit" in mode
            if mode.startswith("K4"):
                kw = dict(unroll=1, any_hit=any_hit,
                          use_groups=mode == "K4 groups")
                k = sw.sweep8_closest_hit(tables, o, d, t_max, s_o, s_t, **kw)
                p = sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o, s_t,
                                                **kw)
            else:
                k = sw.sweep_closest_hit(tables, o, d, t_max, s_o, s_t,
                                         any_hit=any_hit)
                p = sw.sweep_closest_hit_plain(tables, o, d, t_max, s_o, s_t,
                                               any_hit=any_hit)
            equal_hits(f"{mode}, {label}", k, p)
            out[mode] = k
        live = t_max > 0
        print(f"  K4 (default, groups, any-hit) and K7 (demand, any-hit) vs "
              f"plain, {label}: {t_max.numel()} lanes ({int(live.sum())} "
              f"live, {int((out['K4'].tri[live] >= 0).sum())} hits), "
              "bit-equal")
        return out

    tables = fg.flat_tables(dev)
    warp = modes("flat-group warp", tables, fg.flat_warp(dev))["K4"]
    if int(warp.tri[0]) != fg.PLAIN_TRI:
        raise RuntimeError(f"flat-group warp: K4 took triangle "
                           f"{int(warp.tri[0])}, not {fg.PLAIN_TRI}")
    modes("4096-ray edge pool", tables, fg.edge_pool(4096, 3, dev))
    for axis in range(3):
        grid, p, q = fg.stress_tables(axis, 60 + axis, dev)
        modes(f"flat grid, axis {axis}", grid,
              fg.stress_pool(axis, (p, q), 4096, 70 + axis, dev))
        modes(f"flat grid, axis {axis}, lone lanes", grid,
              fg.stress_pool(axis, (p, q), 1024, 80 + axis, dev, lone=True))
    torch.cuda.synchronize()
    phase("flatgroup_check", t0, warp_t=f"{float(warp.t[0]):.6f}",
          warp_tri=int(warp.tri[0]))


def bench_wide_casts(pack, tail, shadow) -> dict:
    """K2 on the bench frame's compacted bounce-1 tail and K1 on its
    bounce-1 shadow rays, as the frame launched them, held against the
    plain versions bit for bit with 0 capped; then each kernel alone by
    CUDA events (kernel_ms), with bounds from the tests the kernels count
    (stats) and their registers a thread. Returns their times (tail,
    shadow)."""
    import torch

    from tpt_torch.bvh import packet_traverse as pt

    n_t, n_s = tail[2].numel(), shadow[2].numel()
    dev = tail[2].device
    res_p, p_ms = timed_once(lambda: pt.closest_hit_wide_plain(pack, *tail))
    check_closest_hit("bench bounce-1 tail",
                      pt.packet_closest_hit_wide(pack, *tail), res_p, "K2")
    occ_p, a_plain_ms = timed_once(lambda: pt.any_hit_wide_plain(pack, *shadow))
    check_any_hit("bench bounce-1 shadow",
                  pt.packet_any_hit_wide(pack, *shadow), occ_p, shadow[2],
                  "K1")
    st_t = torch.zeros(3, dtype=torch.int64, device=dev)
    st_s = torch.zeros(3, dtype=torch.int64, device=dev)
    pt.packet_closest_hit_wide(pack, *tail, stats=st_t)
    pt.packet_any_hit_wide(pack, *shadow, stats=st_s)
    # device time by back-to-back launches (kernel_ms); beside it one
    # launch between two events, which also catches the host's launch path
    k2 = lambda: pt.packet_closest_hit_wide(pack, *tail)
    k1 = lambda: pt.packet_any_hit_wide(pack, *shadow)
    t_ms, t_ev = kernel_ms(k2, KERNEL_REPS), cuda_time_ms(k2, TIMING_REPS)
    s_ms, s_ev = kernel_ms(k1, KERNEL_REPS), cuda_time_ms(k1, TIMING_REPS)
    t_bound, t_by = bound(pack, n_t, 16, st_t.cpu())
    s_bound, s_by = bound(pack, n_s, 1, st_s.cpu())
    print(f"  K2 on the bench bounce-1 tail: {n_t} lanes, {t_ms:.3f} ms "
          f"(one launch between events {t_ev:.3f}), plain {p_ms:.1f} ms, "
          f"bound {t_bound:.4f} ms ({t_by}); {tests_done(st_t.cpu())}")
    print(f"  K1 on the bench bounce-1 shadow rays: {n_s} lanes "
          f"({int((shadow[2] - 1e-3 <= 0).sum())} dead), {s_ms:.3f} ms "
          f"(one launch between events {s_ev:.3f}), plain {a_plain_ms:.1f} "
          f"ms, bound {s_bound:.4f} ms ({s_by}); {tests_done(st_s.cpu())}")
    print(f"  {walk_registers(pack.arity)}")
    return t_ms, s_ms


def sweep_phases(scene, cam, dev) -> tuple:
    """The sweep_kernels, sweep_render and sweep_agreement phases; returns
    the K3 and K4 entries of the kernels line and the bench frame's ms."""
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

    # bounce 1's K2 launch (the sweep's unresolved tail, compacted) and
    # K1 launch (the shadow rays), as the frame makes them
    k2, k1 = pt.packet_closest_hit_wide, pt.packet_any_hit_wide

    def grab_cast(key, fn):
        def cast(pack_, o, dd, t_max, **kw):
            if depth_now[0] == 1:
                grabbed[key] = (o, dd, t_max)
            return fn(pack_, o, dd, t_max, **kw)
        return cast

    patch = Patch()
    patch.set(wavefront, "_sweep_scan_keys", grab_scan)
    patch.set(wavefront, "_sweep_bin_sort", grab_sort)
    patch.set(pt, "packet_closest_hit_wide", grab_cast("tail", k2))
    patch.set(pt, "packet_any_hit_wide", grab_cast("shadow", k1))
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
        a, b = bit_patterns(a), bit_patterns(b)
        if not torch.equal(a, b):
            raise RuntimeError(f"K3 {what} differs from plain on "
                               f"{int((a != b).sum())} of {a.numel()} values")
    k3_err = max(float((a.float() - b.float()).abs().max())
                 for a, b in zip(k3, k3_plain))
    print(f"  K3 vs plain, unsorted bounce-1 pool: {n} lanes "
          f"({int((~pool[5]).sum())} dead), bit patterns equal")
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
    # the bound counts the tests K4's result needs (sweep_need), read from
    # the inputs and the raw hits; the kernel's own tests are work done
    need4 = sw.sweep_need(tables, ori, d, tmax, s_o, s_t, raw)
    k4_bound, k4_by = need_bound(n, S, tables, need4)
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
          f"{k4_plain_ms:.1f} ms, bound {k4_bound:.3f} ms ({k4_by}) by the "
          f"need: {need4[0]} tri tests and {need4[1]} group slab tests over "
          f"a mean {need4[2] / nb:.2f} needed treelets a block; treelet "
          f"sweeps {int(st4[0])} over {nb} blocks (mean union "
          f"{union:.2f}), tri tests made {int(st4[1])} "
          f"({int(st4[1]) / max(1, need4[0]):.2f}x the need), live lanes "
          f"{int(st4[2])}, unresolved (tail) {100 * tail_frac:.3f}% of "
          f"live lanes")
    k2_tail_ms, k1_shadow_ms = bench_wide_casts(scene.pack, grabbed["tail"],
                                                grabbed["shadow"])
    phase("sweep_kernels", t0, lanes=n, k3_ms=f"{k3_ms:.3f}",
          k4_ms=f"{k4_ms:.3f}", mean_union=f"{union:.2f}",
          tail_pct=f"{100 * tail_frac:.3f}",
          k2_tail_ms=f"{k2_tail_ms:.3f}", k1_shadow_ms=f"{k1_shadow_ms:.3f}")
    del grabbed, spool, ori, d, tmax, s_o, s_t, thr, raw, fin, ref

    # ---- sweep_render: the bench configuration, the second main path -----
    t0 = time.perf_counter()
    rc = common.make_raycaster(scene, cfg)
    wavefront.trace_frame(scene, rc, cam, cfg, 200)   # warm-up frame
    torch.cuda.synchronize()
    counts = zero_launches()
    tr = time.perf_counter()
    img = wavefront.render(scene, cam, cfg,
                           iterations=SWEEP_FRAMES * cfg.spp_batch,
                           raycaster=rc)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - tr
    # K2 on the camera rays, then on the tails that have lanes
    launches = expect_launches("sweep render", counts, dict(
        dense_scan=DEPTH - 1, sweep8_closest_hit=DEPTH - 1,
        packet_closest_hit_wide=(1, DEPTH), packet_any_hit_wide=DEPTH),
        SWEEP_FRAMES)
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
    timer.wrap(sw, "dense_scan", "K3")
    timer.wrap(wavefront, "_sweep_bin_sort", "bin sort")
    timer.wrap(sw, "sweep8_closest_hit", "sweep (K4)")
    # the tail stage, and inside it K2's launch alone: the rest of the
    # stage is the compaction (nonzero, gathers, merges)
    in_tail = [False]
    tail_stage = timer.timed("tail (K2)", tsc._tail_compact_cast)
    tail_k2 = timer.timed("tail K2 kernel", pt.packet_closest_hit_wide)

    def tail_cast(*a, **kw):
        in_tail[0] = True
        try:
            return tail_stage(*a, **kw)
        finally:
            in_tail[0] = False

    k2_now = pt.packet_closest_hit_wide
    timer.patch.set(tsc, "_tail_compact_cast", tail_cast)
    timer.patch.set(pt, "packet_closest_hit_wide",
                    lambda *a, **kw: (tail_k2 if in_tail[0] else k2_now)(
                        *a, **kw))
    inner = common.make_raycaster(scene, cfg)
    primaries = timer.timed("primaries (K2)", inner.closest_hit)

    def closest(o, dd, t_max=None, sweep_slots=None, **kw):
        if sweep_slots is None:   # camera rays
            return primaries(o, dd, t_max, **kw)
        return inner.closest_hit(o, dd, t_max, sweep_slots=sweep_slots, **kw)

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
    split["bin keys"] = split.pop("scan (K3 + keys)") - split["K3"]
    tail_kernel = split.pop("tail K2 kernel")
    split["shading and the rest"] = f_ms - sum(split.values())
    tail_n = len(timer.events.get("tail K2 kernel", []))
    print(f"  tail stage {split['tail (K2)']:.2f} ms a frame: K2 kernel "
          f"{tail_kernel:.2f} ms ({tail_n} launches: " + ", ".join(
              f"{s.elapsed_time(e):.3f}"
              for s, e in timer.events.get("tail K2 kernel", [])) +
          f" ms), compaction (nonzero, gathers, merges) "
          f"{split['tail (K2)'] - tail_kernel:.2f} ms")
    print(f"  one frame: {f_ms:.1f} ms by CUDA events (host enqueue "
          f"{host_ms:.1f} ms); " + "; ".join(
              f"{k} {v:.1f} ms ({100 * v / f_ms:.1f}%)" for k, v in split.items()))
    # K3 and K4 a bounce (bounces 1..DEPTH-1 scan and sweep once each)
    bounce_ms = {k: [s.elapsed_time(e) for s, e in timer.events[k]]
                 for k in ("K3", "sweep (K4)")}
    print("  per bounce 1.." + str(DEPTH - 1) + ": " + "; ".join(
        f"{k} " + ", ".join(f"{v:.2f}" for v in vals) + " ms"
        for k, vals in bounce_ms.items()))
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
    ], frame_ms


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


def carried_sequence(scene, cam, cfg, frames: int, on_frame=None,
                     record: Optional[list] = None) -> list:
    """`frames` denoised frames with the camera turning before each after
    the first, through wavefront.trace_frame and svgf.run_svgf with the
    SVGF history carried across the moves (the motion vectors bridge
    them, as run_svgf is built to do); on_frame(k) runs before frame k;
    `record` gets each frame's state leaves, rays and capped count so
    far. Returns the [H, W, 3] images on the device."""
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
        if record is not None:
            record.append(dict(leaves=state.leaves(),
                               rays=int(out.rays_traced),
                               capped=int(rc.capped)))
    return imgs


def svgf_kernel_check(scene, cam, cfg) -> dict:
    """K5 and K6 on the inputs of the third frame of a carried sequence:
    K6 bit-equal to its plain version; K5 bit-equal to its plain version
    at steps 1..16, each single pass on the plain chain's input, and the
    frame's five passes in one call (`stencil.atrous_passes`, where the
    tree has it) in both planes it returns; each timed back to back.
    Returns their numbers."""
    import torch

    from tpt_torch.denoise import reproject, stencil, svgf

    sig = (cfg.svgf.sigma_z, cfg.svgf.sigma_n, cfg.svgf.sigma_l)
    iters = cfg.svgf.atrous_iterations
    npx = cam.num_pixels
    grabbed = {"atrous": []}
    record = [False]
    patch = Patch()
    kernels = {k: getattr(mod, k) for mod, k in (
        (reproject, "reproject"), (stencil, "atrous"),
        (stencil, "atrous_passes")) if hasattr(mod, k)}

    def grab(key):
        def call(*args):
            if record[0]:
                grabbed.setdefault(key, []).append(args)
            return kernels[key](*args)
        return call

    for key in kernels:
        patch.set(reproject if key == "reproject" else stencil, key,
                  grab(key))
    try:
        carried_sequence(scene, cam, cfg, 3,
                         on_frame=lambda k: record.__setitem__(0, k == 2))
    finally:
        patch.restore()
    planes_in = (grabbed["atrous_passes"][0] if "atrous_passes" in kernels
                 else grabbed["atrous"][0])[:6]

    def compare(label, got, want) -> float:
        """max abs err of two plane lists; raises unless bit-equal (NaN
        equal to NaN)"""
        err, bad = 0.0, 0
        for a, b in zip(got, want):
            same = (bit_patterns(a) == bit_patterns(b)) | (
                torch.isnan(a) & torch.isnan(b))
            bad += int((~same).sum())
            d = (a - b).abs()
            err = max(err, float(torch.where(same, 0.0, d).nan_to_num(
                nan=float("inf")).max()))
        if bad:
            raise RuntimeError(f"{label}: kernel differs from plain on {bad} "
                               f"values, max abs err {err}")
        return err

    flat = lambda o: [o[0].x, o[0].y, o[0].z, o[1], o[2].x, o[2].y, o[2].z,
                      o[3]]
    r_args = grabbed["reproject"][0]
    sums, wsum = reproject.reproject(*r_args)
    (psums, pw), k6_plain_ms = timed_once(
        lambda: svgf._reproject_taps(*r_args))
    k6_err = compare("K6", [sums[k] for k in svgf.DATA_KEYS] + [wsum],
                     [psums[k] for k in svgf.DATA_KEYS] + [pw])
    carried_share = float((wsum > 1e-4).float().mean())
    print(f"  K6 vs plain, frame 3: {npx} pixels x 11 planes bit-equal "
          f"(0 mismatching), {100 * carried_share:.2f}% of pixels with "
          f"history weight > 1e-4 (history carried across the moves)")
    k6_ms = kernel_ms(lambda: reproject.reproject(*r_args), KERNEL_REPS)
    del sums, wsum, psums, pw, r_args

    # each pass on the plain chain's input, at steps 1, 2, 4, ...
    k5_err, steps_ms, plain_steps, chain = 0.0, [], [], [tuple(planes_in)]
    rest = tuple(planes_in[4:])
    for it in range(iters):
        a = chain[-1][:4] + rest + (1 << it,) + sig
        want, p_ms = timed_once(lambda: stencil.atrous_plain(*a))
        k5_err = max(k5_err, compare(f"K5 step {1 << it}",
                                     flat(stencil.atrous(*a)), flat(want)))
        plain_steps.append(p_ms)
        steps_ms.append(kernel_ms(lambda: stencil.atrous(*a), KERNEL_REPS))
        chain.append(tuple(want))
    print(f"  K5 vs plain, frame 3, steps 1-{1 << (iters - 1)}: {npx} pixels "
          f"x 8 planes bit-equal at every step (0 mismatching), one pass "
          f"a call")
    if "atrous_passes" in kernels:
        fa = tuple(planes_in) + (iters,) + sig
        fin, hist = stencil.atrous_passes(*fa)
        k5_err = max(k5_err, compare("K5 frame passes, last",
                                     flat(fin), flat(chain[-1])))
        k5_err = max(k5_err, compare("K5 frame passes, history",
                                     flat(hist), flat(chain[-2])))
        print(f"  K5's {iters} passes in one call: last and history passes "
              f"bit-equal to the plain chain ({npx} pixels x 8 planes each)")
        frame_ms = kernel_ms(lambda: stencil.atrous_passes(*fa), KERNEL_REPS)
        per_pass = frame_ms / iters
    else:
        frame_ms = sum(steps_ms)
        per_pass = frame_ms / iters
    del chain, grabbed

    def bound(bytes_px, ops_px):
        b_ms = npx * bytes_px / PEAK_BYTES_S * 1e3
        o_ms = npx * ops_px / PEAK_F32_INSTR_S * 1e3
        return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")

    k5_bound, k5_by = bound(ATROUS_BYTES_PX, ATROUS_OPS_PX)
    k6_bound, k6_by = bound(REPROJECT_BYTES_PX, REPROJECT_OPS_PX)
    k5_plain_ms = sum(plain_steps) / len(plain_steps)
    print(f"  K5: {per_pass:.4f} ms a pass on the frame's path ({iters} "
          f"passes {frame_ms:.4f} ms back to back"
          + (", one call" if "atrous_passes" in kernels else "")
          + "); one pass a call at steps 1..16: "
          + ", ".join(f"{m:.4f}" for m in steps_ms)
          + f" ms; plain {k5_plain_ms:.2f} ms, bound {k5_bound:.4f} ms "
          f"({k5_by}), {100 * k5_bound / per_pass:.1f}% of bound")
    print(f"  K6: {k6_ms:.4f} ms, plain {k6_plain_ms:.2f} ms, bound "
          f"{k6_bound:.4f} ms ({k6_by}), {100 * k6_bound / k6_ms:.1f}% of "
          f"bound")
    return dict(k5_ms=per_pass, k5_frame_ms=frame_ms, k5_steps_ms=steps_ms,
                k5_plain_ms=k5_plain_ms, k5_err=k5_err, k5_bound=k5_bound,
                k5_by=k5_by, k6_ms=k6_ms, k6_plain_ms=k6_plain_ms,
                k6_err=k6_err, k6_bound=k6_bound, k6_by=k6_by,
                carried_share=carried_share)


def svgf_phases(scene, cam, dev, agreement: bool = True) -> list:
    """The svgf_kernels, svgf_render and (with `agreement`) svgf_agreement
    phases; returns the K5 and K6 entries of the kernels line."""
    import numpy as np
    import torch

    from tpt_torch import Renderer
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.core.camera import Camera
    from tpt_torch.denoise import reproject, stencil, svgf
    from tpt_torch.integrators import wavefront

    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH,
                       denoiser_on=True)

    # ---- svgf_kernels: K5/K6 inputs of the third frame of a sequence -------
    t0 = time.perf_counter()
    kc = svgf_kernel_check(scene, cam, cfg)
    carried_share = kc["carried_share"]
    phase("svgf_kernels", t0, pixels=cam.num_pixels,
          k5_ms=f"{kc['k5_ms']:.4f}", k5_frame_ms=f"{kc['k5_frame_ms']:.4f}",
          k6_ms=f"{kc['k6_ms']:.4f}", k5_max_abs_err=kc["k5_err"],
          k6_max_abs_err=kc["k6_err"])

    # ---- svgf_render: the engine's real-time denoised frame --------------
    t0 = time.perf_counter()
    renderer = Renderer(scene, cam, cfg)
    renderer.frame()                                  # warm-up frame
    torch.cuda.synchronize()
    counts = zero_launches()
    tr = time.perf_counter()
    imgs = svgf_sequence(renderer, cam, SVGF_FRAMES)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - tr) * 1e3 / SVGF_FRAMES
    launches = {k: v for c in counts for k, v in c.items()}
    want = dict(atrous=5 * SVGF_FRAMES, reproject=SVGF_FRAMES)
    if any(launches[k] != v for k, v in want.items()) or \
            min(launches[k] for k in WIDE) == 0 or any(sw.LAUNCHES.values()) \
            or any(launches[k] for k in BINARY):
        raise RuntimeError(f"denoised path launches {launches}, expected "
                           f"{want} and K1/K2 but no K3/K4 or K8a/K8b")
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
        for name in ("atrous", "atrous_passes"):     # a tree has either
            if hasattr(stencil, name):
                timer.wrap(stencil, name, "K5")
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
    if agreement:
        t0 = time.perf_counter()
        small = Camera.build(AGREE_RES, cam.position, cam.look_at, cam.up,
                             cam.fovy_deg)
        acfg = cfg.with_(trace_depth=SVGF_AGREE_DEPTH)
        runs = {
            "renderer": lambda: svgf_sequence(Renderer(scene, small, acfg),
                                              small, SVGF_FRAMES),
            "carried": lambda: [i.cpu().numpy() for i in carried_sequence(
                scene, small, acfg, SVGF_FRAMES)],
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
                close, _, max_abs = golden_agree(
                    f"{label} frame {k} vs plain", a, b)
                worst_close = min(worst_close, close)
                worst_abs = max(worst_abs, max_abs)
        phase("svgf_agreement", t0, depth=SVGF_AGREE_DEPTH,
              frames=2 * SVGF_FRAMES, min_close=f"{worst_close:.6f}",
              max_abs=f"{worst_abs:.3g}")

    return [
        dict(name="atrous", route="cuda", source="tpt_torch/csrc/svgf.cu",
             replaces="tpt/denoise/pallas_stencil.py:180",
             launches=launches["atrous"], max_abs_err=kc["k5_err"],
             ms=kc["k5_ms"], plain_ms=kc["k5_plain_ms"],
             bound_ms=kc["k5_bound"], bound_by=kc["k5_by"], library_ms=None,
             frame_ms=kc["k5_frame_ms"]),
        dict(name="reproject", route="cuda", source="tpt_torch/csrc/svgf.cu",
             replaces="tpt/denoise/pallas_reproject.py:227",
             launches=launches["reproject"], max_abs_err=kc["k6_err"],
             ms=kc["k6_ms"], plain_ms=kc["k6_plain_ms"],
             bound_ms=kc["k6_bound"], bound_by=kc["k6_by"], library_ms=None),
    ]


def sharded_phase(host, scene, cam) -> None:
    """The `sharded` phase: tpt_torch.parallel's sharded render with SVGF
    over row windows, SHARDED_FRAMES denoised frames of BVH_SWEEP (depth
    8, 1 spp, sweep_unroll 8, the scene's chunk_align-8 tables), the
    camera turning before the second, held against carried_sequence in
    this process: every frame's image and all 18 SVGF state leaves as bit
    patterns, the rays summed over the ranks equal to its count, 0 capped
    rays, and each rank launching K2, K3, K4, K1, K6 and K5 between its
    counters' zeroing and reading. World 1 over NCCL in this process,
    then world 2 over gloo in two spawned processes on the one card (their
    frame times are two processes sharing one card, not a scaling
    figure)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.parallel import dryrun
    from tpt_torch.parallel.sharding import make_pixel_mesh

    t0 = time.perf_counter()
    cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, trace_depth=DEPTH,
                       sweep_unroll=8, denoiser_on=True)
    cams = [panned(cam, k) for k in range(SHARDED_FRAMES)]
    ref = []
    ref_imgs = carried_sequence(scene, cam, cfg, SHARDED_FRAMES, record=ref)
    if ref[-1]["capped"]:
        raise RuntimeError(f"sharded reference: {ref[-1]['capped']} capped")
    want = dict(packet_closest_hit_wide=(1, DEPTH), dense_scan=DEPTH - 1,
                sweep8_closest_hit=DEPTH - 1, packet_any_hit_wide=DEPTH,
                reproject=1, atrous=cfg.svgf.atrous_iterations)

    def same(label, got, want_t) -> None:
        got = got.to(want_t.device)
        if got.shape != want_t.shape or got.dtype != want_t.dtype or \
                not torch.equal(bit_patterns(got), bit_patterns(want_t)):
            raise RuntimeError(f"sharded {label} differs from "
                               "carried_sequence")

    def check(label, frames, launches, capped) -> None:
        """frames: per frame the gathered [H, W, 3] image and 18 leaves"""
        for k, f in enumerate(frames):
            same(f"{label} frame {k} image", f["rgb"], ref_imgs[k])
            for j, (a, b) in enumerate(zip(f["leaves"], ref[k]["leaves"])):
                same(f"{label} frame {k} leaf {j}", a, b)
        # every kernel of the path at least once a frame, no other kernel
        expect_launches(label, (launches,), want, SHARDED_FRAMES)
        if capped:
            raise RuntimeError(f"{label}: {capped} capped rays")

    def show(label, rank, rays, windows, frame_ms, launches, capped) -> None:
        w0 = windows[-1]
        print(f"  {label} rank {rank}: launches {nonzero(launches)}, capped "
              f"{capped}, rays summed over the ranks {rays} (one process "
              f"{[r['rays'] for r in ref]}), window rows {w0['rows']} "
              f"{list(w0['window'])}, R {w0['R']}, M {[w['M'] for w in windows]}"
              f", frame ms {', '.join(f'{m:.1f}' for m in frame_ms)}")

    # ---- world 1 over NCCL, in this process ----------------------------
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl" if DEVICE == "cuda" else "gloo",     # gloo: a CPU rehearsal
            init_method="file://" + os.path.join(d, "rendezvous"), rank=0,
            world_size=1)
        try:
            mesh = make_pixel_mesh(device=DEVICE)
            counts = zero_launches()
            frames, step = dryrun.run_sequence(mesh, scene, cfg, cams,
                                               torch.cuda.synchronize)
            launches = {k: v for c in counts for k, v in c.items()}
            capped = int(step.raycaster.capped)
        finally:
            dist.destroy_process_group()
    rays = [f["rays"] for f in frames]
    if rays != [r["rays"] for r in ref]:
        raise RuntimeError(f"nccl world 1 rays {rays}, one process "
                           f"{[r['rays'] for r in ref]}")
    check("nccl world 1", [dict(rgb=f["rgb"].stacked(), leaves=f["leaves"])
                           for f in frames], launches, capped)
    show("nccl world 1", 0, rays, [f["window"] for f in frames],
         [f["ms"] for f in frames], launches, capped)
    nccl_ms = [f["ms"] for f in frames]
    del frames, step

    # ---- world 2 over gloo, two spawned processes on the one card --------
    with tempfile.TemporaryDirectory() as d:
        dryrun.spawn(dryrun.sequence_rank, 2, host,
                     dict(with_bvh=True, sweep_chunk_align=SWEEP_ALIGN), cfg,
                     cams, d, DEVICE)
        gathered = torch.load(os.path.join(d, "frames.pt"))
        stats = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                stats.append(json.load(f))
    for st in stats:
        if st["rays"] != [r["rays"] for r in ref]:
            raise RuntimeError(f"gloo rank {st['rank']} rays {st['rays']}, "
                               f"one process {[r['rays'] for r in ref]}")
        check(f"gloo world 2 rank {st['rank']}", gathered, st["launches"],
              st["capped"])
        show("gloo world 2", st["rank"], st["rays"], st["windows"],
             st["frame_ms"], st["launches"], st["capped"])
    print(f"  sharded: {SHARDED_FRAMES} frames at {cam.resolution[0]}x"
          f"{cam.resolution[1]}, depth {DEPTH}, BVH_SWEEP + SVGF, every image "
          f"and SVGF state leaf bit-equal to carried_sequence at world 1 "
          f"(nccl) and world 2 (gloo, both ranks on this one card: their "
          f"frame times are two processes sharing it)")
    phase("sharded", t0, frames=SHARDED_FRAMES,
          rays=json.dumps([r["rays"] for r in ref]).replace(" ", ""),
          nccl_frame_ms=",".join(f"{m:.1f}" for m in nccl_ms),
          gloo_frame_ms=";".join(",".join(f"{m:.1f}" for m in st["frame_ms"])
                                 for st in stats),
          window_rows=",".join(str(st["windows"][-1]["rows"])
                               for st in stats),
          R=stats[0]["windows"][-1]["R"],
          M=",".join(str(w["M"]) for w in stats[0]["windows"]))


def treelet_phases(scene, cam, dev,
                   pallas_frame_ms: Optional[float]) -> list:
    """The treelet_kernels, treelet_render and treelet_agreement phases,
    the frame beside the BVH_PALLAS frame `pallas_frame_ms` of the run if
    one was measured; returns the K9 and K10 entries of the kernels
    line."""
    import numpy as np
    import torch

    from tpt_torch.bvh import packet_traverse as pt
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
    # the packet-semantics need: the tests tpt's packets make (each lane
    # tests every cluster its packet drains), the kernel's own counts
    sts = torch.zeros(6, dtype=torch.int64, device=dev)
    tlt.treelet_closest_hit(pack, sub_o, sub_d, sub_t, group=cfg.trav_group,
                            seed=s_seed, stats=sts, **knobs)

    def packet_bound(n_, st_, seeded: bool) -> tuple:
        return sweep_bound(n_, 28 + (12 if seeded else 0), 16,
                           wide_bytes + top_bytes,
                           OPS_PER_SLAB * int(st_[1])
                           + OPS_PER_TRI * int(st_[2]))

    k10_pb, _ = packet_bound(n, st10, True)
    k10s_pb, _ = packet_bound(idx.numel(), sts, True)
    k10p_pb, _ = packet_bound(cam_o.x.shape[0], st0, False)
    npk_s = TREELET_SEEDED_PACKETS
    attrs = {"K9": tlt.kernel_attributes(9, cfg.trav_group),
             "K10": tlt.kernel_attributes(10, cfg.trav_group,
                                          cfg.treelet_slots),
             "K10 camera": tlt.kernel_attributes(10, cfg.trav_group_primary,
                                                 cfg.treelet_slots),
             "K11": tlt.kernel_attributes(11, cfg.trav_group,
                                          cfg.treelet_slots)}
    for k, a in attrs.items():
        print(f"  {k}: {a['regs']} registers a thread, {a['local_bytes']} "
              f"local bytes, {a['shared_bytes']} static + "
              f"{a['dynamic_shared_bytes']} dynamic shared bytes, "
              f"{a['threads']} threads a block at most")
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
          f"{int(need10[2])} tri tests, packet-semantics bound "
          f"{k10_pb:.3f} ms from its own tests; work done: drains "
          f"{int(st10[3])} over {npk} packets (mean {int(st10[3]) / npk:.2f}, "
          f"max {int(st10[5])}), scan rounds {int(st10[4])}, node pops "
          f"{int(st10[0])}, slab tests {int(st10[1])}, tri tests "
          f"{int(st10[2])} ({int(st10[2]) / max(1, int(need10[2])):.1f}x "
          f"the per-ray walk's); on the {TREELET_SEEDED_PACKETS} packets "
          f"held against plain ({idx.numel()} lanes): kernel "
          f"{k10s_ms:.3f} ms, plain {k10_plain_ms:.1f} ms, bound "
          f"{k10s_b:.3f} ms ({k10s_by}), packet-semantics bound "
          f"{k10s_pb:.3f} ms; drains {int(sts[3])} (mean "
          f"{int(sts[3]) / npk_s:.2f}, max {int(sts[5])}), slab tests "
          f"{int(sts[1])}, tri tests {int(sts[2])}")
    print(f"  K10 unseeded camera rays: {k10p_ms:.3f} ms "
          f"({mr(k10p_ms, cam_o.x.shape[0]):.2f} Mrays/s), bound "
          f"{k10p_b:.3f} ms ({k10p_by}) from the per-ray walk's "
          f"{int(need0[2])} tri tests, packet-semantics bound "
          f"{k10p_pb:.3f} ms; work done: drains {int(st0[3])} over "
          f"{npk0} packets (mean {int(st0[3]) / npk0:.2f}, max "
          f"{int(st0[5])}), slab tests {int(st0[1])}, tri tests "
          f"{int(st0[2])}")
    print(f"  bounce 1: {n_live} live lanes, hard {100 * hard_share:.2f}% "
          f"(K2 on them: {k2h_ms:.3f} ms; K2 on every live lane: "
          f"{k2f_ms:.3f} ms), with a K9 seed {100 * seeded_share:.2f}%")
    phase("treelet_kernels", t0, lanes=n, k9_ms=f"{k9_ms:.3f}",
          k10_ms=f"{k10_ms:.3f}", k10_bound_ms=f"{k10_b:.3f}",
          k10_packet_bound_ms=f"{k10_pb:.3f}",
          k10_128_ms=f"{k10s_ms:.3f}", k10_primary_ms=f"{k10p_ms:.3f}",
          k10_primary_packet_bound_ms=f"{k10p_pb:.3f}",
          k10_regs=attrs["K10"]["regs"], k9_regs=attrs["K9"]["regs"],
          mean_drains=f"{int(st10[3]) / npk:.2f}", max_drains=int(st10[5]),
          hard_pct=f"{100 * hard_share:.2f}",
          seeded_pct=f"{100 * seeded_share:.2f}")
    del grabbed, spool, pool, seed, hard, ori, d, fin, ref, full

    # ---- treelet_render: the BVH_TREELET frame at 1080p -------------------
    t0 = time.perf_counter()
    rc = common.make_raycaster(scene, cfg)
    wavefront.trace_frame(scene, rc, cam, cfg, 300)   # warm-up frame
    torch.cuda.synchronize()
    counts = zero_launches()
    tr = time.perf_counter()
    img = wavefront.render(scene, cam, cfg, iterations=TREELET_FRAMES,
                           raycaster=rc)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - tr
    launches = {k: v for c in counts for k, v in c.items()}
    want = dict(treelet_closest_hit=DEPTH, treelet_scan=DEPTH - 1,
                packet_closest_hit_wide=DEPTH - 1, packet_any_hit_wide=DEPTH,
                dense_scan=0, sweep8_closest_hit=0, packet_closest_hit=0,
                packet_any_hit=0)
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
    if pallas_frame_ms is not None:
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
    acfg = cfg.with_(spp_batch=AGREE_ITERS, trace_depth=TREELET_AGREE_DEPTH)
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
    pcfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                        trace_depth=TREELET_AGREE_DEPTH,
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
    phase("treelet_agreement", t0, depth=TREELET_AGREE_DEPTH, **out)

    return [
        dict(name="treelet_scan", route="cuda",
             source="tpt_torch/csrc/treelet.cu",
             replaces="tpt/bvh/pallas_treelet.py:522",
             launches=launches["treelet_scan"], max_abs_err=k9_err,
             ms=k9_ms, plain_ms=k9_plain_ms, bound_ms=k9_bound,
             bound_by=k9_by, library_ms=None, lanes=n,
             regs=attrs["K9"]["regs"],
             shared_bytes=attrs["K9"]["shared_bytes"]),
        dict(name="treelet_closest_hit", route="cuda",
             source="tpt_torch/csrc/treelet.cu",
             replaces="tpt/bvh/pallas_treelet.py:570",
             launches=launches["treelet_closest_hit"], max_abs_err=k10_err,
             ms=k10s_ms, plain_ms=k10_plain_ms, bound_ms=k10s_b,
             bound_by=k10s_by, library_ms=None, lanes=int(idx.numel()),
             packet_bound_ms=k10s_pb, whole_pool_ms=k10_ms,
             whole_pool_bound_ms=k10_b, whole_pool_packet_bound_ms=k10_pb,
             mean_drains=int(sts[3]) / npk_s, max_drains=int(sts[5]),
             regs=attrs["K10"]["regs"],
             shared_bytes=attrs["K10"]["shared_bytes"]
             + attrs["K10"]["dynamic_shared_bytes"]),
    ]


def top_walk_need(pack, ori, d, t_max, window) -> int:
    """Slab tests a per-ray walk of the top tree needs for K11's slots:
    each live ray opens the root and every internal node whose box it
    enters within its t_max and no later than `window` [n] (its last
    slot's entry t, the window's final edge), and tests the child boxes
    of each node it opens. K11's packets open a node for every lane when
    one lane keeps it."""
    import torch

    from tpt_torch.bvh.packet_traverse import _slab
    from tpt_torch.integrators.intersect import safe_inv

    A = pack.arity
    o = (ori.x, ori.y, ori.z)
    inv = tuple(safe_inv(c) for c in (d.x, d.y, d.z))
    bt = torch.minimum(t_max, torch.tensor(3.0e38, device=t_max.device))
    child = pack.top_child[:, :A].cpu().tolist()
    todo, tests = [(0, t_max > 0)], 0
    while todo:
        nid, opens = todo.pop()
        k = int(opens.sum())
        if not k:
            continue
        tests += A * k
        row = pack.top_f32[nid]
        for s in range(A):
            if child[nid][s] >= 0:
                hit, tn = _slab(row[6 * s:6 * s + 6], o, inv, bt, entry=True)
                todo.append((child[nid][s], opens & hit & (tn <= window)))
    return tests


def sweep_bounce1(scene, cam, cfg, dev) -> dict:
    """Bounces 0 and 1 of one BVH_SWEEP frame of `cfg`, keeping bounce 1's
    pools: "unsorted" (as `_sweep_scan_keys` gets it), "sorted" (the
    bin-sorted pool and its K3 planes, as `_sweep_bin_sort` returns them)
    and "shadow" (its shadow rays)."""
    from tpt_torch.integrators import common, wavefront

    grabbed = {}
    scan_keys, bin_sort = wavefront._sweep_scan_keys, wavefront._sweep_bin_sort
    depth_now = [0]

    def grab_scan(scn, c, pool):
        grabbed["unsorted"] = pool
        return scan_keys(scn, c, pool)

    def grab_sort(c, pool, keys, raw):
        grabbed["sorted"] = bin_sort(c, pool, keys, raw)
        return grabbed["sorted"]

    inner = common.make_raycaster(scene, cfg)

    def grab_any(o, dd, t_max):
        if depth_now[0] == 1:
            grabbed["shadow"] = (o, dd, t_max)
        return inner.any_hit(o, dd, t_max)

    rc = common.Raycaster(closest_hit=inner.closest_hit, any_hit=grab_any,
                          name="recorder", capped=inner.capped)
    patch = Patch()
    patch.set(wavefront, "_sweep_scan_keys", grab_scan)
    patch.set(wavefront, "_sweep_bin_sort", grab_sort)
    try:
        vp = wavefront.camera_view_proj(cam)
        carry = wavefront.batched_raygen(cam, cfg, 1, dev)
        for depth in range(2):
            depth_now[0] = depth
            carry = wavefront._bounce_body(scene, rc, cam, cfg, vp, vp, depth,
                                           carry)
    finally:
        patch.restore()
    del carry
    return grabbed


def scanmulti_check(scene, upool, S: int, unroll: int, dev) -> dict:
    """K11 on the first K11_LANES lanes of `upool`, an unsorted bounce-1
    pool: bit-equal to its plain version in every plane and in capped,
    its slots equal to K3's and its thr at or below K3's, 0 capped; its
    sweep cast (one bin sort, K4) equal to K2's; timed back to back, with
    its per-ray and packet-semantics bounds, its registers and where its
    lane state lives. Returns its entry of the kernels line."""
    import torch

    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.bvh import sweepcast as tsc
    from tpt_torch.bvh import treelet_traverse as tlt
    from tpt_torch.core.vec import Vec3

    tables, pack = scene.sweep, scene.pack
    sub = lambda v, idx: Vec3(v.x[idx].contiguous(), v.y[idx].contiguous(),
                              v.z[idx].contiguous())
    m = min(K11_LANES, upool[5].numel())
    part = slice(0, m)
    ou, du = sub(upool[0], part), sub(upool[1], part)
    tu = torch.where(upool[5][:m], 3.4e38, -1.0)
    k11 = tlt.treelet_scan_multi(pack, ou, du, tu, slots=S)
    k11p, plain_ms = timed_once(lambda: tlt.treelet_scan_multi_plain(
        pack, ou, du, tu, slots=S))
    for a, b, what in zip(k11, k11p, ("entry t", "ordinal", "thr", "capped")):
        if not torch.equal(bit_patterns(a), bit_patterns(b)):
            raise RuntimeError(f"K11 {what} differs from plain")
    if int(k11[3]):
        raise RuntimeError(f"K11 capped {int(k11[3])} lanes")
    k3 = sw.dense_scan(tables, ou, du, tu, slots=S)
    if not (torch.equal(k11[1], k3[1]) and torch.equal(k11[0], k3[0])
            and bool((k11[2] <= k3[2]).all())):
        raise RuntimeError("K11's slots differ from K3's, or its thr lies "
                           "above K3's")
    counts = zero_launches()
    s_t11, s_o11, thr11, _ = tlt.treelet_scan_multi(pack, ou, du, tu, slots=S)
    launches = tlt.LAUNCHES["treelet_scan_multi"]
    key = tsc.bin_key(s_o11, du, tables.num_treelets, S)
    perm = tsc.bin_sort_perm([torch.where(tu > 0, key, 1 << 30)])
    g = lambda a: a[..., perm].contiguous()
    os_, ds_, ts_ = sub(ou, perm), sub(du, perm), g(tu)
    fin, capped = tsc.sweep_cast_sorted(pack, tables, os_, ds_, ts_, g(s_o11),
                                        g(s_t11), g(thr11), unroll=unroll)
    expect_launches("K11 into the sweep cast", counts, dict(
        treelet_scan_multi=1, sweep8_closest_hit=1,
        packet_closest_hit_wide=(0, 1)), 1)
    ref, capped2 = pt.packet_closest_hit_wide(pack, os_, ds_, ts_)
    if int(capped) or int(capped2):
        raise RuntimeError(f"capped rays: K11 sweep cast {int(capped)}, K2 "
                           f"{int(capped2)}")
    if not torch.equal(fin.t, ref.t):
        raise RuntimeError(f"K11-seeded sweep cast t differs from K2 on "
                           f"{int((fin.t != ref.t).sum())} lanes")
    tri_diff = int((fin.tri != ref.tri).sum())
    if tri_diff > TAIL_TRI_MISMATCH_MAX * int((tu > 0).sum()):
        raise RuntimeError(f"K11-seeded sweep cast triangle differs from K2 "
                           f"on {tri_diff} lanes")
    ms = cuda_time_ms(lambda: tlt.treelet_scan_multi(pack, ou, du, tu,
                                                     slots=S), TIMING_REPS)
    st11 = torch.zeros(2, dtype=torch.int64, device=dev)
    tlt.treelet_scan_multi(pack, ou, du, tu, slots=S, stats=st11)
    st11 = st11.cpu()
    top_bytes = sum(a.numel() * 4 for a in (pack.top_f32, pack.top_child,
                                            pack.top_tord))
    # K11's bound: the slab tests a per-ray walk needs for the same slots;
    # beside it the packet-semantics bound, from the tests its packets
    # make (its thr depends on each of them)
    need = top_walk_need(pack, ou, du, tu, s_t11[S - 1])
    bound = sweep_bound(m, 28, 8 * S + 4, top_bytes, OPS_PER_SLAB * need)
    packet_b = sweep_bound(m, 28, 8 * S + 4, top_bytes,
                           OPS_PER_SLAB * int(st11[1]))
    group = 2                     # treelet_scan_multi's default packet
    at = tlt.kernel_attributes(11, group, S)
    place = (tlt.multi_place(group, S) if hasattr(tlt, "multi_place")
             else "its output planes")   # a tree before K9's walk
    mr = m / (ms * 1e-3) / 1e6
    print(f"  K11 on {m} lanes: {ms:.3f} ms ({mr:.1f} Mrays/s), plain "
          f"{plain_ms:.1f} ms, top pops {int(st11[0])}, slab tests "
          f"{int(st11[1])} ({int(st11[1]) / need:.2f}x the {need} a per-ray "
          f"walk needs); bound {bound[0]:.3f} ms ({bound[1]}, per-ray), "
          f"packet-semantics bound {packet_b[0]:.3f} ms "
          f"({100 * packet_b[0] / ms:.1f}% of it); slots equal to K3's; its "
          f"sweep cast equals K2 (t bit-equal, tri differs on {tri_diff}), "
          f"0 capped")
    print(f"  K11 at {1024 * group} lanes a packet, S {S}: lane state in "
          f"{place}, {at['regs']} registers a thread, {at['local_bytes']} "
          f"local bytes, {at['shared_bytes']} static + "
          f"{at['dynamic_shared_bytes']} dynamic shared bytes")
    return dict(name="treelet_scan_multi", route="cuda",
                source="tpt_torch/csrc/treelet.cu",
                replaces="tpt/bvh/pallas_treelet.py:769", launches=launches,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None, lanes=m,
                packet_bound_ms=packet_b[0], registers=at["regs"],
                local_bytes=at["local_bytes"], lane_state=place)


def sweepvar_phases(scene, cam, dev, bench_frame_ms: float) -> list:
    """The sweepvar_kernels, sweepvar_render, sweepvar_mega and
    sweepvar_agreement phases (the BVH_SWEEP variants and K11); returns
    the entries of the kernels line for K7, K7's any-hit mode, K4's group
    and any-hit modes and K11."""
    import torch

    from tpt_torch import Renderer
    from tpt_torch.bvh import sweep as sw
    from tpt_torch.config import RayCastBackend, RenderConfig, RenderMode
    from tpt_torch.core.camera import Camera
    from tpt_torch.core.vec import Vec3
    from tpt_torch.integrators import common, megakernel, wavefront

    tables = scene.sweep
    cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, **SWEEP_KNOBS)
    S, unroll, spp = cfg.sweep_slots, cfg.sweep_unroll, cfg.spp_batch
    sub = lambda v, idx: Vec3(v.x[idx].contiguous(), v.y[idx].contiguous(),
                              v.z[idx].contiguous())
    D = DEPTH

    # ---- sweepvar_kernels: bounce 1 of one bench frame ----------------------
    t0 = time.perf_counter()
    grabbed = sweep_bounce1(scene, cam, cfg, dev)
    spool, (s_o, s_t, _) = grabbed["sorted"]
    ori, d = spool[0], spool[1]
    tmax = torch.where(spool[5], 3.4e38, -1.0)
    n = tmax.numel()
    nb4, nb7 = -(-n // sw.LANES), -(-n // sw.LANES_K7)
    # whole 1024-lane blocks (so also whole 128-lane ones) for the plain
    idx = whole_blocks(n, N_COMPARE, dev, lanes=sw.LANES_K7)
    pick_c = lambda: (sub(ori, idx), sub(d, idx), tmax[idx].contiguous(),
                      s_o[:, idx].contiguous(), s_t[:, idx].contiguous())

    def held(label, kernel_fn, plain_fn, args) -> float:
        """kernel vs plain on the same lanes, bit for bit; the plain's ms"""
        hk = kernel_fn(*args)
        hp, plain_ms = timed_once(lambda: plain_fn(*args))
        equal_hits(label, hk, hp)
        print(f"  {label} vs plain: {args[2].numel()} lanes "
              f"({int((args[2] <= 0).sum())} dead, {int((hk.tri >= 0).sum())} "
              f"hits), bit-equal")
        return plain_ms

    def timed_stats(fn, size: int):
        """(median ms over the whole pool, stats of one launch)"""
        ms = cuda_time_ms(fn, TIMING_REPS)
        st = torch.zeros(size, dtype=torch.int64, device=dev)
        fn(stats=st)
        return ms, st.cpu()

    # K7, demand closest hit (and every requested slot), against plain on
    # whole blocks of the bin-sorted bounce-1 pool; then K7 and K4 on it
    k7 = lambda *a, **kw: sw.sweep_closest_hit(tables, *a, **kw)
    k7p = lambda *a, **kw: sw.sweep_closest_hit_plain(tables, *a, **kw)
    c = pick_c()
    k7_plain_ms = held("K7 demand, bin-sorted bounce-1 pool", k7, k7p, c)
    held("K7 every requested slot, bin-sorted bounce-1 pool",
         lambda *a: k7(*a[:4]), lambda *a: k7p(*a[:4]), c)
    k7_ms, st7 = timed_stats(lambda **kw: k7(ori, d, tmax, s_o, s_t, **kw), 3)
    k4_ms, st4 = timed_stats(lambda **kw: sw.sweep8_closest_hit(
        tables, ori, d, tmax, s_o, s_t, unroll=unroll, **kw), 3)
    # each bound counts the tests its kernel's result needs (sweep_need,
    # from the inputs and the raw hits); the kernels' own tests are printed
    # beside them as the work they do
    need7 = sw.sweep_need(tables, ori, d, tmax, s_o, s_t,
                          k7(ori, d, tmax, s_o, s_t), lanes=sw.LANES_K7)
    k7_b = need_bound(n, S, tables, need7)
    # K4's group mode: against plain on the same blocks; on every lane,
    # how often tpt's window (which can drop a hit whose t Moller-Trumbore
    # puts before the lane's entry into a group box) differs from K4
    # without groups, and on the blocks where it does, both K4 modes bit
    # for bit against their plain versions, so every difference is the
    # plain window's own
    k4g = lambda *a, **kw: sw.sweep8_closest_hit(tables, *a, unroll=unroll,
                                                 use_groups=True, **kw)
    k4g_plain_ms = held(
        "K4 groups, bin-sorted bounce-1 pool", k4g,
        lambda *a: sw.sweep8_closest_hit_plain(tables, *a, unroll=unroll,
                                               use_groups=True), c)
    hg = k4g(ori, d, tmax, s_o, s_t)
    hf = sw.sweep8_closest_hit(tables, ori, d, tmax, s_o, s_t, unroll=unroll)
    differ = ((bit_patterns(hg.t) != bit_patterns(hf.t)) | (hg.tri != hf.tri)
              | (bit_patterns(hg.u) != bit_patterns(hf.u))
              | (bit_patterns(hg.v) != bit_patterns(hf.v)))
    n_differ = int(differ.sum())
    print(f"  K4 groups vs K4 without, every lane: t differs on "
          f"{int((hg.t != hf.t).sum())}, tri on "
          f"{int((hg.tri != hf.tri).sum())}, any field on {n_differ} of {n} "
          f"lanes")
    if n_differ:
        blocks = torch.unique(torch.nonzero(differ).flatten() // sw.LANES)
        bl = (blocks[:, None] * sw.LANES
              + torch.arange(sw.LANES, device=dev)).flatten()
        bl = bl[bl < n]
        args = (sub(ori, bl), sub(d, bl), tmax[bl].contiguous(),
                s_o[:, bl].contiguous(), s_t[:, bl].contiguous())
        pick = lambda h: type(h)(t=h.t[bl], tri=h.tri[bl], u=h.u[bl],
                                 v=h.v[bl])
        equal_hits("K4 groups on the blocks where it differs from K4", pick(hg),
                   sw.sweep8_closest_hit_plain(tables, *args, unroll=unroll,
                                               use_groups=True))
        equal_hits("K4 on the blocks where K4 groups differs", pick(hf),
                   sw.sweep8_closest_hit_plain(tables, *args, unroll=unroll))
        print(f"  on those {blocks.numel()} blocks both modes equal their "
              "plain versions bit for bit: the plain window differs there "
              "too")
    del hg, hf, differ
    k4g_ms, st4g = timed_stats(lambda **kw: k4g(ori, d, tmax, s_o, s_t, **kw),
                               3)
    galign = tables.chunk_align
    need4 = sw.sweep_need(tables, ori, d, tmax, s_o, s_t,
                          k4g(ori, d, tmax, s_o, s_t), galign=galign)
    k4g_b = need_bound(n, S, tables, need4)
    del c

    # the any-hit modes on the bounce-1 shadow rays and their K3 slots
    o_sh, d_sh, t_sh = grabbed["shadow"]
    n_sh = t_sh.numel()
    st_sh, so_sh, _ = sw.dense_scan(tables, o_sh, d_sh, t_sh, slots=S)
    idx_sh = whole_blocks(n_sh, N_COMPARE, dev, lanes=sw.LANES_K7)
    c = (sub(o_sh, idx_sh), sub(d_sh, idx_sh), t_sh[idx_sh].contiguous(),
         so_sh[:, idx_sh].contiguous(), st_sh[:, idx_sh].contiguous())
    k7a_plain_ms = held("K7 any-hit, bounce-1 shadow rays",
                        lambda *a: k7(*a, any_hit=True),
                        lambda *a: k7p(*a, any_hit=True), c)
    k4a = lambda *a, **kw: sw.sweep8_closest_hit(
        tables, *a, unroll=unroll, any_hit=True, use_groups=True, **kw)
    k4a_plain_ms = held(
        "K4 any-hit (groups), bounce-1 shadow rays", k4a,
        lambda *a: sw.sweep8_closest_hit_plain(
            tables, *a, unroll=unroll, any_hit=True, use_groups=True), c)
    k7a_ms, st7a = timed_stats(lambda **kw: k7(
        o_sh, d_sh, t_sh, so_sh, st_sh, any_hit=True, **kw), 3)
    k4a_ms, st4a = timed_stats(lambda **kw: k4a(o_sh, d_sh, t_sh, so_sh,
                                                st_sh, **kw), 3)
    need7a = sw.sweep_need(tables, o_sh, d_sh, t_sh, so_sh, st_sh,
                           k7(o_sh, d_sh, t_sh, so_sh, st_sh, any_hit=True),
                           lanes=sw.LANES_K7, any_hit=True)
    need4a = sw.sweep_need(tables, o_sh, d_sh, t_sh, so_sh, st_sh,
                           k4a(o_sh, d_sh, t_sh, so_sh, st_sh), any_hit=True,
                           galign=galign)
    k7a_b = need_bound(n_sh, S, tables, need7a)
    k4a_b = need_bound(n_sh, S, tables, need4a)
    del c, o_sh, d_sh, t_sh, st_sh, so_sh, spool, ori, d, tmax, s_o, s_t

    # K11 on the first K11_LANES lanes of the unsorted bounce-1 pool
    upool = grabbed.pop("unsorted")
    del grabbed
    k11 = scanmulti_check(scene, upool, S, unroll, dev)
    del upool
    mr = lambda ms, k: k / (ms * 1e-3) / 1e6
    made = lambda st, need: (f"tri tests made {int(st[1])}, "
                             f"{int(st[1]) / max(1, need[0]):.2f}x the "
                             f"{need[0]} its result needs")
    print(f"  whole bin-sorted bounce-1 pool ({n} lanes): K7 {k7_ms:.3f} ms "
          f"({mr(k7_ms, n):.1f} Mrays/s; treelet sweeps {int(st7[0])} over "
          f"{nb7} blocks, mean union {int(st7[0]) / nb7:.2f}; "
          f"{made(st7, need7)}), K4 {k4_ms:.3f} ms (mean union "
          f"{int(st4[0]) / nb4:.2f}), K7/K4 {k7_ms / k4_ms:.2f}x; K4 groups "
          f"{k4g_ms:.3f} ms ({made(st4g, need4)}; "
          f"{100 * int(st4g[1]) / max(1, int(st4[1])):.1f}% of K4's)")
    print(f"  bounce-1 shadow rays ({n_sh} lanes): K7 any-hit {k7a_ms:.3f} ms "
          f"({made(st7a, need7a)}), K4 any-hit with groups {k4a_ms:.3f} ms "
          f"({made(st4a, need4a)})")
    for label, (b_ms, by), ms, pms in (
            ("K7", k7_b, k7_ms, k7_plain_ms),
            ("K4 groups", k4g_b, k4g_ms, k4g_plain_ms),
            ("K7 any-hit", k7a_b, k7a_ms, k7a_plain_ms),
            ("K4 any-hit", k4a_b, k4a_ms, k4a_plain_ms)):
        print(f"  {label}: {ms:.3f} ms, bound {b_ms:.3f} ms ({by}), plain "
              f"{pms:.1f} ms")
    phase("sweepvar_kernels", t0, lanes=n, k7_ms=f"{k7_ms:.3f}",
          k4_ms=f"{k4_ms:.3f}", k4_groups_ms=f"{k4g_ms:.3f}",
          k7_any_ms=f"{k7a_ms:.3f}", k4_any_ms=f"{k4a_ms:.3f}",
          k11_ms=f"{k11['ms']:.3f}", k7_union=f"{int(st7[0]) / nb7:.2f}",
          k4_union=f"{int(st4[0]) / nb4:.2f}", capped=0)

    # ---- sweepvar_render: the "lane" and "cascade" wavefronts at 1080p -----
    t0 = time.perf_counter()
    tail = (1, D)      # a primary K2 or K1, then the tails that have lanes
    want = {
        "lane": dict(dense_scan=2 * D - 1, sweep_closest_hit=D - 1,
                     **{"sweep_closest_hit/any_hit": D},
                     packet_closest_hit_wide=tail, packet_any_hit_wide=tail),
        "cascade": dict(dense_scan=2 * D,
                        **{"sweep8_closest_hit/groups": (D, 2 * D - 1),
                           "sweep8_closest_hit/any_hit": D},
                        packet_closest_hit_wide=tail,
                        packet_any_hit_wide=tail),
    }
    out = {}
    for k, (label, knobs) in enumerate(SWEEPVAR.items()):
        f_ms, launches, _, _ = render_phase(
            f"{label} render", scene, cam, cfg.with_(**knobs),
            SWEEPVAR_FRAMES, want[label], 500 + 10 * k)
        print(f"  {label} ({knobs}): {f_ms:.1f} ms a frame "
              f"({cam.num_pixels * spp / (f_ms * 1e-3) / 1e6:.3f} Mpaths/s), "
              f"{f_ms / bench_frame_ms:.2f}x the bench frame of this run "
              f"({bench_frame_ms:.1f} ms); launches {json.dumps(launches)}")
        out[f"{label}_ms"] = f"{f_ms:.1f}"
        if label == "lane":
            k7_launches = launches
        else:
            k4_launches = launches
    phase("sweepvar_render", t0, bench_ms=f"{bench_frame_ms:.1f}", **out)

    # ---- sweepvar_mega: the megakernel and the unsorted wavefront ----------
    t0 = time.perf_counter()
    mcfg = cfg.with_(spp_batch=1, mode=RenderMode.MEGAKERNEL)
    r = Renderer(scene, cam, mcfg)
    r.frame()                                      # warm-up frame
    counts = zero_launches()
    tr = time.perf_counter()
    for _ in range(SWEEPVAR_FRAMES):
        img = r.frame()
    torch.cuda.synchronize()
    mega_ms = (time.perf_counter() - tr) * 1e3 / SWEEPVAR_FRAMES
    expect_launches("BVH_SWEEP megakernel", counts, dict(
        dense_scan=D, sweep8_closest_hit=D, packet_closest_hit_wide=(1, D),
        packet_any_hit_wide=D), SWEEPVAR_FRAMES)
    if int(r.raycaster.capped):
        raise RuntimeError("BVH_SWEEP megakernel had capped rays")
    check_image("BVH_SWEEP megakernel", img)
    mega_busy = profiled_frame("BVH_SWEEP megakernel", r.frame)
    del r
    unsorted_ms = render_phase(
        "unsorted BVH_SWEEP", scene, cam, cfg.with_(sort_bounce_rays=False),
        1, dict(dense_scan=D - 1, sweep8_closest_hit=D - 1,
                packet_closest_hit_wide=(1, D), packet_any_hit_wide=D),
        520)[0]
    print(f"  megakernel on BVH_SWEEP: {mega_ms:.1f} ms a frame "
          f"({cam.num_pixels / (mega_ms * 1e-3) / 1e6:.3f} Mpaths/s, 1 spp); "
          f"wavefront without the pool sort: {unsorted_ms:.1f} ms for one "
          f"frame of {spp} spp "
          f"({cam.num_pixels * spp / (unsorted_ms * 1e-3) / 1e6:.3f} "
          f"Mpaths/s), {unsorted_ms / bench_frame_ms:.2f}x the bench frame")
    phase("sweepvar_mega", t0, mega_ms=f"{mega_ms:.1f}",
          mega_busy=f"{mega_busy:.3f}", unsorted_ms=f"{unsorted_ms:.1f}")

    # ---- sweepvar_agreement: each variant vs plain and vs the bench --------
    t0 = time.perf_counter()
    left = WATCHDOG_S - (t0 - T_START)
    if left < 2 * SWEEPVAR_PLAIN_RENDERS_S:
        raise RuntimeError(
            f"sweepvar_agreement: its plain renders take up to "
            f"{SWEEPVAR_PLAIN_RENDERS_S:.0f} s and only {left:.0f} s of the "
            f"{WATCHDOG_S} s watchdog are left, less than twice that")
    small = Camera.build(AGREE_RES, cam.position, cam.look_at, cam.up,
                         cam.fovy_deg)
    acfg = cfg.with_(spp_batch=1, trace_depth=SWEEPVAR_AGREE_DEPTH)
    rc_b = common.make_raycaster(scene, acfg)
    img_b = wavefront.render(scene, small, acfg, iterations=AGREE_ITERS,
                             raycaster=rc_b)
    cases = [(k, wavefront.render, acfg.with_(**v)) for k, v in SWEEPVAR.items()]
    cases += [("unsorted", wavefront.render, acfg.with_(sort_bounce_rays=False)),
              ("mega", megakernel.render, acfg)]
    out = {}
    for label, render, vcfg in cases:
        rc_k = common.make_raycaster(scene, vcfg)
        img_k = render(scene, small, vcfg, iterations=AGREE_ITERS,
                       raycaster=rc_k)
        patch = plain_kernels()
        try:
            rc_p = common.make_raycaster(scene, vcfg)
            tp = time.perf_counter()
            img_p = render(scene, small, vcfg, iterations=AGREE_ITERS,
                           raycaster=rc_p)
            out[f"{label}_plain_s"] = f"{time.perf_counter() - tp:.1f}"
        finally:
            patch.restore()
        if int(rc_k.capped) or int(rc_p.capped) or int(rc_b.capped):
            raise RuntimeError(f"{label} agreement renders had capped rays")
        for ref_label, ref in (("plain", img_p), ("bench", img_b)):
            close, _, max_abs = golden_agree(
                f"{label} render vs {ref_label}", img_k, ref)
            out[f"{label}_{ref_label}"] = f"{close:.6f}/{max_abs:.3g}"
    phase("sweepvar_agreement", t0, depth=SWEEPVAR_AGREE_DEPTH, **out)

    src = "tpt_torch/csrc/sweep.cu"
    entry = lambda name, launches, ms, pms, b, **kw: dict(
        name=name, route="cuda", source=kw.pop("source", src),
        replaces=kw.pop("replaces", "tpt/bvh/pallas_sweep.py:168"),
        launches=launches, max_abs_err=0.0, ms=ms, plain_ms=pms,
        bound_ms=b[0], bound_by=b[1], library_ms=None, **kw)
    return [
        entry("sweep_closest_hit", k7_launches["sweep_closest_hit"], k7_ms,
              k7_plain_ms, k7_b, lanes=n, plain_lanes=int(idx.numel())),
        entry("sweep_closest_hit/any_hit",
              k7_launches["sweep_closest_hit/any_hit"], k7a_ms, k7a_plain_ms,
              k7a_b, lanes=n_sh, plain_lanes=int(idx_sh.numel())),
        entry("sweep8_closest_hit/groups",
              k4_launches["sweep8_closest_hit/groups"], k4g_ms, k4g_plain_ms,
              k4g_b, replaces="tpt/bvh/pallas_sweep.py:623", lanes=n,
              plain_lanes=int(idx.numel())),
        entry("sweep8_closest_hit/any_hit",
              k4_launches["sweep8_closest_hit/any_hit"], k4a_ms, k4a_plain_ms,
              k4a_b, replaces="tpt/bvh/pallas_sweep.py:623", lanes=n_sh,
              plain_lanes=int(idx_sh.numel())),
        k11,
    ]


def hero_phases(dev) -> tuple:
    """The hero_render and hero_agreement phases: scenes/hero.json (its
    textures written by tpt_torch.scene.hero_assets into a scratch
    directory) loaded by tpt_torch.scene.loader.load_scene and rendered
    at the file's own 960x540, depth 8, env NEE on. Returns the host
    scene and its tables on the card."""
    import tempfile

    import numpy as np
    import torch

    from tpt_torch import Renderer
    from tpt_torch.bvh import packet_traverse as pt
    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.core.camera import Camera
    from tpt_torch.integrators import common, wavefront
    from tpt_torch.scene import hero_assets, loader

    t0 = time.perf_counter()
    left = WATCHDOG_S - (t0 - T_START)
    if left < 2 * HERO_PHASES_S:
        raise RuntimeError(
            f"hero phases: they take up to {HERO_PHASES_S:.0f} s and only "
            f"{left:.0f} s of the {WATCHDOG_S} s watchdog are left, less "
            f"than twice that: the earlier phases ran slow on this host")

    # ---- hero_render ----------------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        tl = time.perf_counter()
        host = loader.load_scene(hero_assets.write_hero_assets(d))
        load_s = time.perf_counter() - tl
    tb = time.perf_counter()
    scene = host.build(with_bvh=True, sweep_chunk_align=SWEEP_ALIGN,
                       device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    cam = host.camera
    if cam.resolution != HERO_RES or host.trace_depth != HERO_DEPTH:
        raise RuntimeError(f"hero.json: {cam.resolution}, depth "
                           f"{host.trace_depth}; expected {HERO_RES}, depth "
                           f"{HERO_DEPTH}")
    atlas, env = scene.atlas, scene.env
    if not (env.enabled and atlas.num_textures == 4
            and scene.materials.any_tex_normal):
        raise RuntimeError("the hero scene lost its env map or textures")
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                       trace_depth=HERO_DEPTH, env_nee=True)
    # K2 and K1 against plain on every lane of bounces 0 and 1: the
    # extension casts, and the light and env NEE shadow rays
    rec = Recorder(common.make_raycaster(scene, cfg))
    vp = wavefront.camera_view_proj(cam)
    carry = wavefront.batched_raygen(cam, cfg, 1, dev)
    for depth in range(2):
        carry = wavefront._bounce_body(scene, rec.raycaster, cam, cfg, vp, vp,
                                       depth, carry)
    del carry
    if len(rec.ext) != 2 or len(rec.shadow) != 4:
        raise RuntimeError(f"hero bounces cast {len(rec.ext)} extension and "
                           f"{len(rec.shadow)} shadow sets, expected 2 and 4")
    pack = scene.pack
    for k, rays in enumerate(rec.ext):
        check_closest_hit(f"hero bounce {k}", pt.packet_closest_hit_wide(
            pack, *rays), pt.closest_hit_wide_plain(pack, *rays), "K2")
    for k, rays in enumerate(rec.shadow):
        check_any_hit(f"hero bounce {k // 2} {('light', 'env')[k % 2]} NEE",
                      pt.packet_any_hit_wide(pack, *rays),
                      pt.any_hit_wide_plain(pack, *rays), rays[2], "K1")
    prim, env_shadow = rec.ext[0], rec.shadow[1]
    del rec
    k2_ms = kernel_ms(lambda: pt.packet_closest_hit_wide(pack, *prim),
                      KERNEL_REPS)
    k1_ms = kernel_ms(lambda: pt.packet_any_hit_wide(pack, *env_shadow),
                      KERNEL_REPS)
    print(f"  hero K2 primaries {k2_ms:.3f} ms, K1 bounce-0 env NEE shadow "
          f"rays {k1_ms:.3f} ms ({cam.num_pixels} lanes, back-to-back "
          f"launches)")
    del prim, env_shadow

    def frames(rcfg, want):
        """HERO_FRAMES Renderer frames after a warm-up frame, launch
        counters zeroed just before and read just after; returns (ms a
        frame by the host clock, launches, last image, renderer)."""
        r = Renderer(scene, cam, rcfg)
        r.frame()
        torch.cuda.synchronize()
        counts = zero_launches()
        tr = time.perf_counter()
        for _ in range(HERO_FRAMES):
            img = r.frame()
        torch.cuda.synchronize()
        f_ms = (time.perf_counter() - tr) * 1e3 / HERO_FRAMES
        label = "hero" + (" denoised" if rcfg.denoiser_on else "")
        launches = expect_launches(label, counts, want, HERO_FRAMES)
        if int(r.raycaster.capped):
            raise RuntimeError(f"{label}: {int(r.raycaster.capped)} capped")
        if img.shape != (HERO_RES[1], HERO_RES[0], 3) or \
                not np.isfinite(img).all() or not img.mean() > 0:
            raise RuntimeError(f"bad {label} image: shape {img.shape}, "
                               f"mean {float(np.nanmean(img))}")
        return f_ms, launches, img, r

    # a bounce: one K2 extension cast, K1 for the light and the env NEE
    casts = dict(packet_closest_hit_wide=HERO_DEPTH,
                 packet_any_hit_wide=2 * HERO_DEPTH)
    frame_ms, launches, img, r = frames(cfg, casts)
    # one more frame split by CUDA events: the casts against the rest
    timer = CastTimer(r.raycaster)
    r.raycaster = timer.raycaster
    s_ev = torch.cuda.Event(enable_timing=True)
    e_ev = torch.cuda.Event(enable_timing=True)
    s_ev.record()
    r.frame()
    e_ev.record()
    e_ev.synchronize()
    f_ms = s_ev.elapsed_time(e_ev)
    k2_f, k1_f = timer.ms("closest_hit"), timer.ms("any_hit")
    rest_share = (f_ms - k2_f - k1_f) / f_ms
    print(f"  one hero frame: {f_ms:.1f} ms by CUDA events; K2 casts "
          f"{k2_f:.1f} ms ({len(timer.events['closest_hit'])}), K1 casts "
          f"{k1_f:.1f} ms ({len(timer.events['any_hit'])}), outside the "
          f"casts {f_ms - k2_f - k1_f:.1f} ms ({100 * rest_share:.1f}%)")
    profiled_frame("hero", r.frame)
    del r
    dn_ms, dn_launches, dn_img, r = frames(
        cfg.with_(denoiser_on=True), dict(casts, atrous=5, reproject=1))
    del r
    # one BVH_SWEEP frame (K2 primaries; K3, the bin sort, K4 and a K2
    # tail on later bounces; K1 shadows): the floor's flat groups on the
    # card. Its hits equal BVH_PALLAS's up to equal-t ties, so the image
    # agrees with the BVH_PALLAS render of the same iteration
    scfg = cfg.with_(backend=RayCastBackend.BVH_SWEEP)
    rc = common.make_raycaster(scene, scfg)
    counts = zero_launches()
    tr = time.perf_counter()
    sweep_img = wavefront.render(scene, cam, scfg, iterations=1,
                                 start_iter=HERO_SWEEP_ITER, raycaster=rc)
    sweep_ms = (time.perf_counter() - tr) * 1e3
    sweep_launches = expect_launches(
        "hero BVH_SWEEP", counts,
        dict(dense_scan=HERO_DEPTH - 1, sweep8_closest_hit=HERO_DEPTH - 1,
             packet_closest_hit_wide=(1, HERO_DEPTH),
             packet_any_hit_wide=2 * HERO_DEPTH))
    if int(rc.capped):
        raise RuntimeError(f"hero BVH_SWEEP: {int(rc.capped)} capped")
    pallas_img = wavefront.render(scene, cam, cfg, iterations=1,
                                  start_iter=HERO_SWEEP_ITER)
    sw_close, _, sw_abs = golden_agree("hero BVH_SWEEP vs BVH_PALLAS",
                                       sweep_img, pallas_img)
    mpaths = cam.num_pixels / (frame_ms * 1e-3) / 1e6
    phase("hero_render", t0, triangles=host.mesh.num_triangles,
          atlas=f"{atlas.r.shape[1]}x{atlas.r.shape[0]}x{atlas.num_textures}",
          env=f"{env.shape[1]}x{env.shape[0]}", load_s=f"{load_s:.2f}",
          build_s=f"{build_s:.2f}", frame_ms=f"{frame_ms:.1f}",
          mpaths_s=f"{mpaths:.3f}",
          outside_casts_pct=f"{100 * rest_share:.1f}",
          denoised_ms=f"{dn_ms:.1f}", sweep_ms=f"{sweep_ms:.1f}",
          sweep_close=f"{sw_close:.6f}", sweep_max_abs=f"{sw_abs:.3g}",
          launches=nonzero(launches), denoised_launches=nonzero(dn_launches),
          sweep_launches=nonzero(sweep_launches),
          k2_ms=f"{k2_ms:.3f}", k1_env_ms=f"{k1_ms:.3f}",
          image_mean=f"{float(img.mean()):.5f}",
          denoised_mean=f"{float(dn_img.mean()):.5f}")

    # ---- hero_agreement: kernels vs plain versions, whole renders -------
    t0 = time.perf_counter()
    small = Camera.build(AGREE_RES, cam.position, cam.look_at, cam.up,
                         cam.fovy_deg)
    dcfg = cfg.with_(denoiser_on=True)

    def run():
        """The wavefront render, and the last of HERO_FRAMES denoised
        Renderer frames."""
        rc = common.make_raycaster(scene, cfg)
        img = wavefront.render(scene, small, cfg, iterations=AGREE_ITERS,
                               raycaster=rc)
        r = Renderer(scene, small, dcfg)
        for _ in range(HERO_FRAMES):
            den = r.frame()
        if int(rc.capped) or int(r.raycaster.capped):
            raise RuntimeError("hero agreement renders had capped rays")
        return img, den

    img_k, den_k = run()
    patch = plain_kernels()
    try:
        tp = time.perf_counter()
        img_p, den_p = run()
        plain_s = time.perf_counter() - tp
    finally:
        patch.restore()
    out = {"plain_s": f"{plain_s:.1f}"}
    for label, a, b in (("render", img_k, img_p), ("denoised", den_k, den_p)):
        close, _, max_abs = golden_agree(f"hero {label} vs plain", a, b)
        out[f"{label}_close"] = f"{close:.6f}"
        out[f"{label}_max_abs"] = f"{max_abs:.3g}"
    phase("hero_agreement", t0, **out)
    return host, scene


def cli_run(argv: list) -> tuple:
    """tpt_torch.cli.main(argv) with its output captured: (exit code,
    the ms a frame of its last progress line, its output)."""
    import contextlib
    import io

    from tpt_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    iters = [ln for ln in text.splitlines() if ln.startswith("[tpt] iter ")]
    frame_ms = float(iters[-1].split()[3]) if iters else float("nan")
    return rc, frame_ms, text


def xla_phases(fire_host, fire, hero_host, hero, dev) -> None:
    """The lbvh_build, xla_render, heatmap and cli_hero phases: the LBVH
    builder on the card, the BVH_XLA backend (the plain-PyTorch walk of
    tpt_torch/bvh/traverse.py), the engine's BVH heatmap, and
    `python -m tpt_torch.cli` rendering the hero through BVH_XLA and SVGF
    (K6 and K5)."""
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch

    from tpt_torch import Renderer
    from tpt_torch import trace as tpt_trace
    from tpt_torch.bvh import traverse
    from tpt_torch.bvh.build import build_lbvh
    from tpt_torch.bvh.validate import validate_lbvh
    from tpt_torch.config import DisplayMode, RayCastBackend, RenderConfig
    from tpt_torch.core.camera import generate_camera_rays
    from tpt_torch.integrators import common, wavefront
    from tpt_torch.io.image import read_png
    from tpt_torch.scene import hero_assets

    t0 = time.perf_counter()
    left = WATCHDOG_S - (t0 - T_START)
    if left < XLA_PHASES_S:
        raise RuntimeError(
            f"xla phases: they take up to {XLA_PHASES_S:.0f} s and only "
            f"{left:.0f} s of the {WATCHDOG_S} s watchdog are left")

    # ---- lbvh_build: the fireplace's LBVH on the card, against the CPU --
    def timed_build(mesh):
        torch.cuda.synchronize()
        tb = time.perf_counter()
        bvh = build_lbvh(mesh)
        torch.cuda.synchronize()
        return bvh, time.perf_counter() - tb

    _, first_s = timed_build(fire.mesh)
    lbvh, build_s = timed_build(fire.mesh)
    cpu = lambda a: a.cpu()
    m = fire.mesh
    cpu_mesh = replace(m, positions=m.positions.map(cpu), i0=cpu(m.i0),
                       i1=cpu(m.i1), i2=cpu(m.i2))
    ref, cpu_s = timed_build(cpu_mesh)
    got, want = lbvh.numpy(), ref.numpy()
    differ = [k for k in want if not torch.equal(
        *(bit_patterns(torch.as_tensor(h[k])) for h in (got, want)))]
    if differ:
        raise RuntimeError(f"LBVH on the card differs from the CPU build in "
                           f"{differ}")
    rep, sah_rep = validate_lbvh(lbvh), validate_lbvh(fire.bvh)
    if not (rep.ok and sah_rep.ok):
        raise RuntimeError(f"BVH validation: LBVH {rep.errors[:3]}, SAH "
                           f"{sah_rep.errors[:3]}")
    cam = fire_host.camera
    ori, d, _ = generate_camera_rays(cam, 1, jitter=False, device=dev)
    torch.cuda.synchronize()
    tc = time.perf_counter()
    cost_l = traverse.traversal_cost(fire.mesh, lbvh, ori, d).cpu().numpy()
    lbvh_cost_s = time.perf_counter() - tc
    tc = time.perf_counter()
    cost_s = traverse.traversal_cost(fire.mesh, fire.bvh, ori, d).cpu().numpy()
    sah_cost_s = time.perf_counter() - tc
    del ori, d, lbvh, ref, cpu_mesh
    phase("lbvh_build", t0, triangles=fire_host.mesh.num_triangles,
          build_s=f"{build_s:.3f}", first_build_s=f"{first_s:.3f}",
          cpu_build_s=f"{cpu_s:.3f}", bit_equal_arrays=len(want),
          depth=rep.max_depth, sah_depth=sah_rep.max_depth,
          lbvh_cost_mean=f"{cost_l.mean():.2f}",
          sah_cost_mean=f"{cost_s.mean():.2f}",
          lbvh_cost_s=f"{lbvh_cost_s:.2f}", sah_cost_s=f"{sah_cost_s:.2f}")

    # ---- xla_render: the hero on BVH_XLA, against BVH_PALLAS ------------
    t0 = time.perf_counter()
    hcam = hero_host.camera
    xcfg = RenderConfig(backend=RayCastBackend.BVH_XLA, trace_depth=HERO_DEPTH,
                        env_nee=True)
    pcfg = xcfg.with_(backend=RayCastBackend.BVH_PALLAS)
    rc = common.make_raycaster(hero, xcfg)
    counts = zero_launches()
    tr = time.perf_counter()
    img_x = wavefront.render(hero, hcam, xcfg, iterations=1,
                             start_iter=XLA_ITER, raycaster=rc)
    frame_ms = (time.perf_counter() - tr) * 1e3
    launches = expect_launches("hero BVH_XLA", counts, {})
    walk = tpt_trace.frame_counters()
    walks, steps = walk["walk.walks"], walk["walk.steps"]
    img_p = wavefront.render(hero, hcam, pcfg, iterations=1,
                             start_iter=XLA_ITER)
    close, _, max_abs = golden_agree("hero BVH_XLA vs BVH_PALLAS", img_x,
                                     img_p)
    counts = zero_launches()
    r = Renderer(hero, hcam, xcfg.with_(denoiser_on=True))
    tr = time.perf_counter()
    den_x = r.frame()
    dn_ms = (time.perf_counter() - tr) * 1e3
    dn_launches = expect_launches("hero BVH_XLA denoised", counts,
                                  dict(atrous=5, reproject=1))
    den_p = Renderer(hero, hcam, pcfg.with_(denoiser_on=True)).frame()
    dn_close, _, dn_abs = golden_agree("hero BVH_XLA denoised vs BVH_PALLAS",
                                       den_x, den_p)
    if int(rc.capped) or int(r.raycaster.capped):
        raise RuntimeError(f"hero BVH_XLA: {int(rc.capped)} and "
                           f"{int(r.raycaster.capped)} capped rays")
    phase("xla_render", t0, frame_ms=f"{frame_ms:.1f}",
          mpaths_s=f"{hcam.num_pixels / (frame_ms * 1e-3) / 1e6:.3f}",
          denoised_ms=f"{dn_ms:.1f}", walks=walks,
          steps_per_walk=f"{steps / max(walks, 1):.1f}",
          capped=int(rc.capped) + int(r.raycaster.capped),
          pallas_close=f"{close:.6f}", pallas_max_abs=f"{max_abs:.3g}",
          denoised_close=f"{dn_close:.6f}", denoised_max_abs=f"{dn_abs:.3g}",
          launches=nonzero(launches), denoised_launches=nonzero(dn_launches))
    del r, img_x, img_p, den_x, den_p

    # ---- heatmap: DisplayMode.BVH_HEATMAP on the fireplace at 1080p -----
    t0 = time.perf_counter()
    r = Renderer(fire, cam, RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                                         trace_depth=DEPTH,
                                         display=DisplayMode.BVH_HEATMAP))
    th = time.perf_counter()
    heat = r.bvh_heatmap()
    heat_ms = (time.perf_counter() - th) * 1e3
    tf = time.perf_counter()
    img = r.frame()
    hframe_ms = (time.perf_counter() - tf) * 1e3
    if not (img.shape == (RES[1], RES[0], 3) and np.array_equal(img, heat)
            and np.isfinite(img).all()):
        raise RuntimeError(f"heatmap frame: shape {img.shape}, equal to "
                           f"bvh_heatmap {np.array_equal(img, heat)}")
    pct = np.percentile(cost_s, [50, 90, 98])
    phase("heatmap", t0, heatmap_ms=f"{heat_ms:.1f}",
          frame_ms=f"{hframe_ms:.1f}", cost_p50=f"{pct[0]:.0f}",
          cost_p90=f"{pct[1]:.0f}", cost_p98=f"{pct[2]:.0f}",
          cost_max=int(cost_s.max()))
    del r, img, heat

    # ---- cli_hero: python -m tpt_torch.cli on the hero ------------------
    t0 = time.perf_counter()
    flags = ["-wave", "--backend", "bvh", "--denoise", "--env-nee"]
    with tempfile.TemporaryDirectory() as tmp:
        full = hero_assets.write_hero_assets(tmp)
        with open(full) as f:
            doc = json.load(f)
        cam_doc = doc["Camera"]
        cam_doc.update(RES=CLI_HERO["res"], ITERATIONS=CLI_HERO["iterations"],
                       DEPTH=CLI_HERO["depth"])
        small = os.path.join(tmp, "hero_small.json")
        with open(small, "w") as f:
            json.dump(doc, f)
        out_small = os.path.join(tmp, "small")
        counts = zero_launches()
        ts = time.perf_counter()
        rc_s, _, _ = cli_run([small] + flags + ["--out-dir", out_small])
        small_s = time.perf_counter() - ts
        cli_launches = expect_launches("cli hero", counts,
                                       dict(atrous=5, reproject=1),
                                       CLI_HERO["iterations"])
        pngs = [f for f in os.listdir(out_small) if f.endswith(".png")]
        if rc_s != 0 or len(pngs) != 1 or not pngs[0].startswith("hero."):
            raise RuntimeError(f"cli hero: exit {rc_s}, images {pngs}")
        img = read_png(os.path.join(out_small, pngs[0]))[..., :3]
        img = img.astype(np.float32) / 255.0
        golden = np.load(os.path.join(REPO, *GOLDEN_HERO))["image"]
        g_close = float(np.isclose(img, golden, atol=2 / 255.0).mean())
        g_mean = abs(float(img.mean()) / float(golden.mean()) - 1.0)
        if not (img.shape == golden.shape and g_close > 0.97
                and g_mean <= 0.02):
            raise RuntimeError(f"cli hero vs {GOLDEN_HERO[1]}: close "
                               f"{g_close}, mean rel {g_mean}")
        out_full = os.path.join(tmp, "full")
        tt = time.perf_counter()
        rc_f, full_ms, text = cli_run(
            [full] + flags + ["--iterations", str(CLI_TIMED_ITERS),
                              "--out-dir", out_full])
        full_s = time.perf_counter() - tt
        if rc_f != 0 or not [f for f in os.listdir(out_full)
                             if f.endswith(".png")]:
            raise RuntimeError(f"cli hero at 960x540: exit {rc_f}\n{text}")
    phase("cli_hero", t0, golden_close=f"{g_close:.6f}",
          golden_mean_rel=f"{g_mean:.3g}", small_s=f"{small_s:.1f}",
          launches=nonzero(cli_launches), full_ms_per_frame=f"{full_ms:.1f}",
          full_s=f"{full_s:.1f}")



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
    # the binary pack, built by the host layer from the same
    # (deterministic) SAH BVH at the same cluster size
    bscene = host.build(with_bvh=True, packet_arity=2, device=dev)
    phase("scene", t0, triangles=host.mesh.num_triangles,
          nodes=pack.num_nodes, tri_rows=pack.tri_f32.shape[0],
          arity=pack.arity, cluster=pack.max_cluster,
          binary_nodes=bscene.pack.num_nodes,
          binary_tri_rows=bscene.pack.tri_f32.shape[0],
          treelets=scene.sweep.num_treelets, top_nodes=pack.num_top,
          max_chunks=scene.sweep.max_chunks,
          sweep_rows=scene.sweep.tri_f32.shape[0])

    # ---- kernels vs plain ---------------------------------------------------
    t0 = time.perf_counter()
    res = cast_phase(scene, cam, dev, ("K2", "K1"), pt.packet_closest_hit_wide,
                     pt.packet_any_hit_wide, pt.closest_hit_wide_plain,
                     pt.any_hit_wide_plain)
    del res["casts"]
    print(f"  {walk_registers(pack.arity)}")
    print("  kernels: K2 packet_closest_hit_wide, K1 packet_any_hit_wide, "
          "K3 dense_scan, K4 sweep8_closest_hit, K5 atrous, K6 reproject, "
          "K7 sweep_closest_hit, K8a packet_closest_hit, K8b packet_any_hit, "
          "K9 treelet_scan, K10 treelet_closest_hit, K11 treelet_scan_multi: "
          "all 12 ported (cuda)")
    phase("kernels", t0, n_compare=N_COMPARE, lanes=res["lanes"],
          k2_ms=f"{res['closest']['ms']:.3f}",
          k1_ms=f"{res['any_hit']['ms']:.3f}")
    flatgroup_phase(dev)

    # ---- render: the main path ------------------------------------------------
    t0 = time.perf_counter()
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=DEPTH)
    frame_ms, launches, img, rc = render_phase(
        "render", scene, cam, cfg, RENDER_ITERS,
        dict(packet_closest_hit_wide=DEPTH, packet_any_hit_wide=DEPTH), 100)
    # where one frame's time goes: the casts (CUDA events around each
    # launch) against the whole frame (events around the frame)
    timer = CastTimer(rc)
    s_ev = torch.cuda.Event(enable_timing=True)
    e_ev = torch.cuda.Event(enable_timing=True)
    th = time.perf_counter()
    s_ev.record()
    wavefront.trace_frame(scene, timer.raycaster, cam, cfg, 102)
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
    phase("render", t0, frame_ms=f"{frame_ms:.1f}",
          mpaths_s=f"{cam.num_pixels / (frame_ms * 1e-3) / 1e6:.3f}",
          launches=json.dumps({k: launches[k] for k in WIDE + BINARY}
                              ).replace(" ", ""),
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

    sweep_kernels, bench_frame_ms = sweep_phases(scene, cam, dev)
    svgf_kernels = svgf_phases(scene, cam, dev)
    binary_kernels, binary_frame_ms = binary_phases(scene, bscene, cam, dev,
                                                    frame_ms)
    mega_phases(scene, bscene, cam, dev, frame_ms, binary_frame_ms)
    del bscene
    treelet_kernels = treelet_phases(scene, cam, dev, frame_ms)
    sweepvar_kernels = sweepvar_phases(scene, cam, dev, bench_frame_ms)
    del pack, rc, kernel_rc, plain_rc
    hero_host, hero = hero_phases(dev)
    xla_phases(host, scene, hero_host, hero, dev)
    del hero
    sharded_phase(host, scene, cam)
    del scene

    source = "tpt_torch/csrc/packet_wide.cu"
    kernels = [
        dict(name="packet_closest_hit_wide", route="cuda", source=source,
             replaces="tpt/bvh/pallas_traverse.py:893",
             launches=launches["packet_closest_hit_wide"], **res["closest"],
             library_ms=None),
        dict(name="packet_any_hit_wide", route="cuda", source=source,
             replaces="tpt/bvh/pallas_traverse.py:959",
             launches=launches["packet_any_hit_wide"], **res["any_hit"],
             library_ms=None),
    ] + (sweep_kernels + svgf_kernels + binary_kernels + treelet_kernels
         + sweepvar_kernels)
    print(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
