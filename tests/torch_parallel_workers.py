"""The spawned ranks of tests/test_torch_parallel.py and the one-process
references they are held against. Imports numpy, torch and tpt_torch
only: a spawned child imports this module, and the tests' conftest
imports JAX.

`run_ranks(world, names, out_dir)` spawns `world` gloo processes on the
CPU; each runs the named cases in order, and rank 0 writes every case's
gathered result (or the error every rank raised) to
`out_dir/world{N}.pt`. A case is a function of the mesh; `reference`
computes the same thing in one process.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from tpt_torch.config import RayCastBackend, RenderConfig, SVGFConfig
from tpt_torch.denoise import svgf
from tpt_torch.integrators import common, wavefront
from tpt_torch.parallel import dryrun, sharding
from tpt_torch.scene import procedural

BF = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=3)
SWEEP = RenderConfig(backend=RayCastBackend.BVH_SWEEP, trace_depth=2,
                     sort_bounce_rays=True, sweep_unroll=8)
# the SVGF sequences: 3 frames turning 3 px a frame, then a tilt of 24 px
# (max |motion_v| beyond a rank's 16 rows at 64x64 on 4 ranks)
SEQ_TURNS = ((0.0, 0.0), (3.0, 0.0), (6.0, 0.0), (6.0, 24.0))
SEQ_CFG = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=2,
                       denoiser_on=True)

# name -> (scene spec, cfg, iterations, with_svgf); scene spec is
# (resolution, spheres, build keywords)
RENDERS = {
    "brute_force": (((64, 64), False, {}), BF, 2, False),
    "brute_force_svgf": (((64, 64), False, {}), BF.with_(denoiser_on=True),
                         2, True),
    "pallas_sorted": (((64, 64), False, dict(with_bvh=True)),
                      RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                                   trace_depth=3, sort_bounce_rays=True),
                      1, False),
    "sweep": (((32, 32), True, dict(with_bvh=True, treelet_max_tris=64,
                                    sweep_chunk_align=8)), SWEEP, 1, False),
    "cascade": (((32, 32), True, dict(with_bvh=True, treelet_max_tris=64,
                                      sweep_chunk_align=8)),
                SWEEP.with_(sweep_cascade=True), 1, False),
    "treelet": (((32, 32), True, dict(with_bvh=True)),
                RenderConfig(backend=RayCastBackend.BVH_TREELET,
                             trace_depth=2), 1, False),
}
# name -> (cfg, resolution)
SEQUENCES = {
    "svgf_sequence": (SEQ_CFG, (64, 64)),
    # R = 7: windows of a few rows past the rank's own, clipped nowhere on
    # the middle ranks; 60 rows, since at a power-of-two height every
    # y - motion_v is exact in float32 and the rebased motion would
    # change nothing
    "svgf_sequence_short_reach": (
        SEQ_CFG.with_(svgf=SVGFConfig(atrous_iterations=2)), (64, 60)),
    # on the subgroup of global ranks SUBGROUP of the world-4 spawn: 16
    # rows a rank, group ranks that are not the global ones
    "svgf_sequence_subgroup": (
        SEQ_CFG.with_(svgf=SVGFConfig(atrous_iterations=2)), (64, 48)),
}
SUBGROUP = (1, 2, 3)


def scene_of(spec, device="cpu"):
    res, spheres, kw = spec
    host = procedural.cornell_box(resolution=res, spheres=spheres)
    return host, host.build(device=device, **kw)


def turned(cam, yaw_px: float, pitch_px: float):
    """The camera turned by yaw_px about its up axis and tilted by
    pitch_px about its right axis (pixels at the image centre)."""
    h = cam.resolution[1]
    per_px = 2.0 * math.tan(math.radians(cam.fovy_deg) / 2.0) / h
    v = np.asarray(cam.look_at) - np.asarray(cam.position)
    for axis, px in ((cam.true_up, yaw_px), (cam.right, pitch_px)):
        k, ang = np.asarray(axis), px * per_px
        v = (v * math.cos(ang) + np.cross(k, v) * math.sin(ang)
             + k * k.dot(v) * (1.0 - math.cos(ang)))
    return cam.moved(look_at=tuple(np.asarray(cam.position) + v))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# one-process references
# ---------------------------------------------------------------------------

def reference(name: str) -> dict:
    """The one-process result of case `name` (renders only)."""
    if name in SEQUENCES:
        cfg, res = SEQUENCES[name]
        return reference_sequence(cfg, spec=(res, False, {}))
    spec, cfg, iters, with_svgf = RENDERS[name]
    if with_svgf:
        return reference_sequence(cfg, [(0.0, 0.0)] * iters, spec=spec)
    host, scene = scene_of(spec)
    rc = common.make_raycaster(scene, cfg)
    img = wavefront.render(scene, host.camera, cfg, iterations=iters,
                           raycaster=rc)
    return dict(image=img, capped=int(rc.capped))


def reference_sequence(cfg, turns=SEQ_TURNS, spec=((64, 64), False, {}),
                       device="cpu") -> dict:
    """trace_frame + run_svgf with the history carried, the camera turned
    before each frame (chip_smoke.carried_sequence's loop)."""
    host, scene = scene_of(spec, device)
    w, h = host.camera.resolution
    rc = common.make_raycaster(scene, cfg)
    state = svgf.SVGFState.zeros(h, w, scene.device)
    plane = lambda a: a.reshape(h, w)
    p3 = lambda v: v.map(plane)
    prev, out_imgs, leaves, rays = None, [], [], []
    for k, (yaw, pitch) in enumerate(turns):
        c = turned(host.camera, yaw, pitch)
        vp = wavefront.camera_view_proj(c)
        out = wavefront.trace_frame(
            scene, rc, c, cfg, 1 + k, view_proj=vp,
            prev_view_proj=vp if prev is None else prev)
        prev, g = vp, out.gbuf
        rgb, state = svgf.run_svgf(
            cfg.svgf, state, p3(out.direct), p3(out.indirect), p3(g.albedo),
            plane(g.depth), p3(g.normal), plane(g.mat_id), plane(g.motion_u),
            plane(g.motion_v))
        out_imgs.append(_np(rgb.stacked()))
        leaves.append([_np(a) for a in state.leaves()])
        rays.append(int(out.rays_traced))
    return dict(image=out_imgs[-1], images=np.stack(out_imgs),
                leaves=leaves, rays=rays, capped=int(rc.capped))


# ---------------------------------------------------------------------------
# the cases, run on every rank
# ---------------------------------------------------------------------------

def _render_case(mesh, name: str) -> dict:
    spec, cfg, iters, with_svgf = RENDERS[name]
    if with_svgf:
        return _sequence_case(mesh, cfg, [(0.0, 0.0)] * iters, spec)
    host, scene = scene_of(spec)
    step, init_state, vp = sharding.make_sharded_step(
        scene, host.camera, cfg, mesh, with_svgf=False)
    carry = init_state()
    for it in range(1, iters + 1):
        rgb, carry = step(it, vp, carry)
    img = _np(sharding.gather_rows(mesh, (rgb * (1.0 / iters)).stacked()))
    capped = int(mesh.all_reduce(step.raycaster.capped.reshape(1))[0])
    out = dict(image=img, capped=capped, rays=int(step.rays))
    if name == "brute_force":       # the same through the entry point
        out["image_render_sharded"] = sharding.render_sharded(
            scene, host.camera, cfg, mesh, iterations=iters)
    return out


def _sequence_case(mesh, cfg, turns=SEQ_TURNS, spec=((64, 64), False, {})
                   ) -> dict:
    host, scene = scene_of(spec)
    frames, step = dryrun.run_sequence(
        mesh, scene, cfg, [turned(host.camera, *t) for t in turns])
    gather = lambda t: _np(sharding.gather_rows(mesh, t))
    imgs = [gather(f["rgb"].stacked()) for f in frames]
    wins = [[tuple(int(v) for v in t) for t in mesh.all_gather(torch.tensor(
        f["window"]["window"] + (f["window"]["M"], f["window"]["R"])))]
        for f in frames]
    capped = int(mesh.all_reduce(step.raycaster.capped.reshape(1))[0])
    return dict(image=imgs[-1], images=np.stack(imgs),
                leaves=[[gather(a) for a in f["leaves"]] for f in frames],
                rays=[f["rays"] for f in frames], windows=wins, capped=capped)


def _refusal(mesh, name: str) -> dict:
    kw = {}
    res = (64, 64)
    cfg = BF
    if name == "refuse_spp_batch":
        cfg = BF.with_(spp_batch=2)
    elif name == "refuse_rows":
        res = (64, 66)
    elif name == "refuse_tables":
        kw = dict(with_bvh=True, treelet_max_tris=64 if mesh.rank else 32)
    host, scene = scene_of((res, True, kw))
    try:
        sharding.make_sharded_step(scene, host.camera, cfg, mesh)
    except (ValueError, NotImplementedError) as e:
        return dict(error=type(e).__name__, message=str(e))
    return dict(error=None)


def run_case(mesh, name: str) -> dict:
    if name.startswith("refuse_"):
        return _refusal(mesh, name)
    if name in SEQUENCES:
        cfg, res = SEQUENCES[name]
        return _sequence_case(mesh, cfg, spec=(res, False, {}))
    return _render_case(mesh, name)


def _try_case(mesh, name: str) -> dict:
    try:
        return run_case(mesh, name)
    except Exception as e:                  # recorded; the test fails on it
        return dict(crash=f"{type(e).__name__}: {e}")


def _rank_main(rank: int, world: int, init: str, names, out_path: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = sharding.make_pixel_mesh(device="cpu")
        # every rank of the world takes part in making the subgroup
        sub = dist.new_group(list(SUBGROUP)) if world > max(SUBGROUP) else None
        results = {}
        for name in names:
            if not name.endswith("_subgroup"):
                results[name] = _try_case(mesh, name)
                continue
            # the subgroup's ranks render; its first hands rank 0 the result
            res = [_try_case(sharding.make_pixel_mesh(sub, device="cpu"), name)
                   if rank in SUBGROUP else None]
            dist.broadcast_object_list(res, src=SUBGROUP[0])
            results[name] = res[0]
        if rank == 0:
            torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, names, out_dir: str) -> dict:
    """Spawn `world` gloo ranks that run the named cases; returns rank 0's
    results by name."""
    out_path = os.path.join(out_dir, f"world{world}.pt")
    init = "file://" + os.path.join(out_dir, f"rendezvous{world}")
    torch.multiprocessing.spawn(_rank_main,
                                args=(world, init, list(names), out_path),
                                nprocs=world, join=True)
    return torch.load(out_path, weights_only=False)
