"""Spawned ranks of the sharded render: the port's twin of tpt's
`__graft_entry__.dryrun_multichip`, and the sequence `chip_smoke.py`'s
`sharded` phase runs in gloo processes on one card.

    python -m tpt_torch.parallel.dryrun 4                # on the card
    python -m tpt_torch.parallel.dryrun 4 --device cpu   # plain versions

runs `dryrun_multichip(4)`: 4 gloo processes, each building
`cornell_box(resolution=(64, max(8, n) * 8), spheres=True)` with treelets
of <= 256 triangles and running one frame of BVH_SWEEP at depth 2 with
SVGF over its row window; rank 0 checks that the gathered image has the
frame's shape and is finite and prints one `ok` line. The ranks render
on the CUDA card (rank r on card r modulo the cards, the kernels) unless
the caller asks for the CPU (the kernels' plain versions).

The ranks are started with the spawn method (a parent with CUDA up
cannot fork) and meet through a `file://` rendezvous in a temporary
directory, so parallel test workers never race for a TCP port.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def spawn(fn, world: int, *args) -> None:
    """Run fn(rank, world, init_method, *args) in `world` spawned
    processes; raises if one fails."""
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(
            fn, args=(world, "file://" + os.path.join(d, "rendezvous"))
            + args, nprocs=world, join=True)


def _rank(rank: int, world: int, init: str, device: str) -> None:
    from ..config import RayCastBackend, RenderConfig
    from ..scene import procedural
    from .sharding import make_pixel_mesh, render_sharded

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        h = max(8, world) * 8
        host = procedural.cornell_box(resolution=(64, h), spheres=True)
        scene = host.build(with_bvh=True, treelet_max_tris=256, device=device)
        cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, trace_depth=2,
                           sort_bounce_rays=True, denoiser_on=True)
        img = render_sharded(scene, host.camera, cfg,
                             make_pixel_mesh(device=device), iterations=1,
                             with_svgf=True)
        if img.shape != (h, 64, 3) or not np.isfinite(img).all():
            raise RuntimeError(f"dryrun_multichip: image {img.shape}, "
                               f"finite {bool(np.isfinite(img).all())}")
        if rank == 0:
            print(f"[dryrun_multichip] ok: {world} gloo ranks on {device}, "
                  f"image {img.shape}, mean {img.mean():.4f}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: DeviceLike = None) -> None:
    """Spawn n gloo processes and run one sharded step, on the CUDA card
    unless the caller asks for the CPU (`device="cpu"`)."""
    spawn(_rank, n, resolve_device(device).type)


def run_sequence(mesh, scene, cfg, cams, sync=lambda: None):
    """Denoised frames k = 0, 1, .. of this rank's rows, frame k through
    cams[k] at iteration 1 + k, the previous frame's view-projection as
    its prev (the first its own) and the SVGF history carried
    (chip_smoke.carried_sequence's loop). Returns (frames, step): per
    frame the rgb Vec3 and 18 state leaves of the rows, the rays summed
    over the ranks, the window and its ms (`sync` before each clock)."""
    from ..integrators.wavefront import camera_view_proj
    from .sharding import make_sharded_step

    step, init_state, _ = make_sharded_step(scene, cams[0], cfg, mesh,
                                            with_svgf=True)
    carry, prev, frames = init_state(), None, []
    for k, cam in enumerate(cams):
        vp = camera_view_proj(cam)
        sync()
        t = time.perf_counter()
        rgb, carry = step(1 + k, vp if prev is None else prev, carry, cam=cam)
        rays = int(step.rays)
        sync()
        frames.append(dict(rgb=rgb, leaves=carry[2].leaves(), rays=rays,
                           window=step.window,
                           ms=(time.perf_counter() - t) * 1e3))
        prev = vp
    return frames, step


def launch_counters() -> tuple:
    """Every kernel's launch counter, zeroed."""
    from ..bvh import packet_traverse, sweep, treelet_traverse
    from ..denoise import reproject, stencil

    counts = (packet_traverse.LAUNCHES, sweep.LAUNCHES,
              treelet_traverse.LAUNCHES, stencil.LAUNCHES, reproject.LAUNCHES)
    for c in counts:
        for k in c:
            c[k] = 0
    return counts


def sequence_rank(rank: int, world: int, init: str, host, build_kw: dict,
                  cfg, cams, out_dir: str, device: str = "cuda") -> None:
    """One gloo rank of chip_smoke's `sharded` phase on the card: build
    the scene, run one warm-up frame, then the sequence with every launch
    counter zeroed just before and read just after; rank 0 writes the
    gathered frames (`frames.pt`), every rank its numbers
    (`rank{r}.json`)."""
    from .sharding import gather_rows, make_pixel_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        scene = host.build(device=device, **build_kw)
        mesh = make_pixel_mesh(device=device)
        sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
                else lambda: None)
        run_sequence(mesh, scene, cfg, cams[:1])          # warm-up
        sync()
        counts = launch_counters()
        frames, step = run_sequence(mesh, scene, cfg, cams, sync)
        launches = {k: v for c in counts for k, v in c.items()}
        gathered = [dict(rgb=gather_rows(mesh, f["rgb"].stacked()).cpu(),
                         leaves=[gather_rows(mesh, a).cpu()
                                 for a in f["leaves"]]) for f in frames]
        if rank == 0:
            torch.save(gathered, os.path.join(out_dir, "frames.pt"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, launches=launches,
                           capped=int(step.raycaster.capped),
                           rays=[f["rays"] for f in frames],
                           windows=[f["window"] for f in frames],
                           frame_ms=[f["ms"] for f in frames]), f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one sharded step in N gloo "
                                 "processes")
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    args = ap.parse_args()
    dryrun_multichip(args.n, args.device)
