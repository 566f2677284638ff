"""Megakernel integrator: one lane = one pixel = one whole path, the bounce
loop over all lanes with dead lanes masked. Counterpart of
`tpt/integrators/megakernel.py`, with the same per-lane RNG stream and
the same stage arithmetic, so a sample fed the same scene gives tpt's
radiance (tests).

Unlike the wavefront, the pool is never sorted: every bounce casts the
whole frame's lanes in pixel order, dead lanes with t_max = -1. On a
binary pack the casts run K8a/K8b, on a wide one K2/K1; under BVH_SWEEP
every cast goes through the raycaster that is not tpt's primary one, so
each closest hit is the unsorted sweep_cast (scan, bin sort, sweep,
tail, unsort), as tpt's megakernel casts.

tpt casts every lane's NEE shadow ray with t_max = the distance to its
light sample (megakernel.py:160) and reads the result only on the lanes
that do NEE. A lane whose path escaped carries a point near 3.4e38 along
its ray: its shadow ray has a zero direction and an infinite t_max, which
passes every slab test, so a per-ray walk visits the whole tree. The
port casts the shadow rays of the NEE lanes only (the others with
t_max = -1), as its wavefront does; the occlusion of every NEE lane, and
so the image, is the same.

An enabled environment map lights escaping paths and, with cfg.env_nee,
adds one alias-table light sample a bounce with its shadow ray, and
`heavy_shading_iters` scales each BSDF sample by tpt's synthetic load,
as in tpt's megakernel (which ignores `nearfield_frac` and
`debug_no_shadow`, and so does the port's).

tpt dispatches a frame in tiles of `cfg.megakernel_tile` paths so that
no TPU program outlives the device watchdog. The port runs the frame in
one pass: a pixel's path does not depend on the other lanes of its cast
(the kernels walk each ray on its own), so the image is the tiled one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..core import rng
from ..core.camera import Camera, generate_camera_rays
from ..core.mathutil import DELTA_THRESHOLD, EPSILON, power_heuristic
from ..core.vec import Vec3, where as vwhere
from ..materials import bsdf
from ..scene import envmap as envmod
from ..scene.lights import sample_light
from ..scene.structs import SceneData
from . import wavefront
from .common import (Raycaster, apply_russian_roulette, compute_env_nee,
                     fetch_hit_surface, heavy_shading_factor, make_raycaster)


def trace_sample(scene: SceneData, raycaster: Raycaster, cam: Camera,
                 cfg: RenderConfig, iteration: int,
                 pix: Optional[torch.Tensor] = None) -> Vec3:
    """One sample per pixel (or per pixel of the int64 indices `pix`):
    the radiance Vec3 after cfg.trace_depth bounces, non-finite values
    zeroed."""
    dev = scene.device
    ori, direction, state = generate_camera_rays(
        cam, iteration, cfg.jitter, pix=pix, device=dev)
    n = ori.shape[0]
    zero3 = Vec3.zeros((n,), dev)
    radiance = Vec3.zeros((n,), dev)
    throughput = Vec3.ones((n,), dev)
    last_pdf = torch.zeros((n,), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    has_lights = scene.lights.num_lights > 0

    for depth in range(cfg.trace_depth):
        # dead lanes get t_max = -1 and fail the root box
        hit = raycaster.closest_hit(ori, direction,
                                    torch.where(alive, 3.4e38, -1.0))
        hit_mask = alive & hit.hit_mask
        first = depth == 0

        # miss: environment (MIS weighted against env NEE when it runs)
        if scene.env.enabled:
            env_l = envmod.env_radiance(scene.env, direction)
            if cfg.env_nee:
                pdf_env = envmod.env_pdf(scene.env, direction)
                w_mis = torch.where((last_pdf > DELTA_THRESHOLD) | first, 1.0,
                                    power_heuristic(last_pdf, pdf_env))
            else:
                w_mis = 1.0
            radiance = radiance + vwhere(alive & ~hit.hit_mask,
                                         throughput * env_l * w_mis, zero3)
        alive = alive & hit.hit_mask

        wo = -1.0 * direction
        mats, n_sh, _, ng, _, _, _ = fetch_hit_surface(
            scene, hit.tri, hit.u, hit.v, wo)
        point = ori + direction * hit.t

        # emissive hit: MIS against NEE, then the path ends
        emissive = hit_mask & (mats.emittance > 0.0)
        cos_light = torch.clamp_min(n_sh.dot(wo), 0.0)
        pdf_light_area = 1.0 / torch.clamp_min(scene.lights.total_area, 1e-20)
        pdf_light_sa = pdf_light_area * (hit.t * hit.t) / torch.clamp_min(
            cos_light, 1e-20)
        no_mis = (last_pdf > 0.9 * 1e10) | first | (not has_lights)
        w_emis = torch.where(
            no_mis, 1.0,
            torch.where(cos_light > EPSILON,
                        power_heuristic(last_pdf, pdf_light_sa), 0.0))
        radiance = radiance + vwhere(
            emissive, throughput * mats.basecolor * (mats.emittance * w_emis),
            zero3)
        alive = alive & ~emissive

        # NEE; lanes that do no NEE cast no shadow ray (see above)
        if has_lights:
            state, lp, ln, pdf_area, ltri, le = sample_light(
                scene.mesh, scene.lights, state)
            shadow_ori = point + ng * EPSILON
            to_l = lp - shadow_ori
            dist = to_l.length()
            wi_l = to_l * (1.0 / torch.clamp_min(dist, 1e-20))
            dist_sq = torch.clamp_min(dist * dist, 1e-6)
            cos_surf = torch.clamp_min(n_sh.dot(wi_l), 0.0)
            cos_l = torch.clamp_min(ln.dot(-1.0 * wi_l), 0.0)
            front = ng.dot(wi_l) > 0.0
            if le is None:
                lmat = bsdf.gather_materials(
                    scene.materials, scene.mesh.material_ids[ltri])
                le = lmat.basecolor * lmat.emittance
            f = bsdf.eval_bsdf(wo, wi_l, n_sh, mats)
            pdf_b = bsdf.pdf_bsdf(wo, wi_l, n_sh, mats)
            pdf_l_sa = pdf_area * dist_sq / torch.clamp_min(cos_l, 1e-20)
            w_nee = power_heuristic(pdf_l_sa, pdf_b)
            contrib = throughput * le * f * (
                cos_surf * cos_l / dist_sq * w_nee / pdf_area)
            is_delta = (mats.mtype == 2) | (mats.mtype == 3)
            nee_mask = (alive & front & ~is_delta & (cos_surf > 0.0)
                        & (cos_l > 0.0) & (contrib.length_sq() > 0.0))
            occluded = raycaster.any_hit(shadow_ori, wi_l,
                                         torch.where(nee_mask, dist, -1.0))
            radiance = radiance + vwhere(nee_mask & ~occluded, contrib, zero3)
        else:
            # the light sample's three draws, so the stream stays aligned
            state, _ = rng.rand_float(state)
            state, _ = rng.rand_float(state)
            state, _ = rng.rand_float(state)

        if scene.env.enabled and cfg.env_nee:
            state, env_contrib = compute_env_nee(scene, cfg, raycaster, state,
                                                 point, n_sh, ng, wo, mats,
                                                 throughput, alive)
            radiance = radiance + env_contrib

        # BSDF sample and path update
        state, smp = bsdf.sample_bsdf(wo, n_sh, mats, state)
        if cfg.heavy_shading_iters:
            smp = bsdf.BSDFSample(
                wi=smp.wi, pdf=smp.pdf,
                attenuation=smp.attenuation * heavy_shading_factor(
                    hit.u, cfg.heavy_shading_iters),
                is_transmission=smp.is_transmission)
        valid = (smp.pdf > 0.0) & (smp.attenuation.length_sq() > 0.0)
        exiting = smp.wi.dot(ng) > 0.0
        valid = valid & (exiting | smp.is_transmission)
        bias_n = vwhere(exiting, ng, -1.0 * ng)
        upd = alive & valid
        throughput = vwhere(upd, throughput * smp.attenuation, throughput)
        ori = vwhere(upd, point + bias_n * EPSILON, ori)
        direction = vwhere(upd, smp.wi, direction)
        last_pdf = torch.where(upd, smp.pdf, last_pdf)
        alive = upd

        throughput, alive, state = apply_russian_roulette(
            cfg, depth, throughput, alive, state)

    # NaN guard before accumulation, as tpt's (megakernel.py:177-179)
    return radiance.map(lambda c: torch.where(torch.isfinite(c), c, 0.0))


def make_sample_fn(scene: SceneData, cam: Camera, cfg: RenderConfig,
                   raycaster: Optional[Raycaster] = None):
    """fn(iteration, accum, cam=cam) -> accum + one sample of every pixel
    of `cam`, in one pass (cfg.megakernel_tile, tpt's dispatch size,
    selects nothing here). Pass `raycaster` to read its `capped` count
    afterwards."""
    reason = wavefront._unsupported(cfg)
    if reason:
        raise NotImplementedError(f"{reason} is not ported yet")
    if raycaster is None:
        raycaster = make_raycaster(scene, cfg)
    cam0 = cam

    def step(iteration: int, accum: Vec3, cam: Camera = cam0) -> Vec3:
        return accum + trace_sample(scene, raycaster, cam, cfg, iteration)

    return step


def render(scene: SceneData, cam: Camera, cfg: RenderConfig,
           iterations: Optional[int] = None, start_iter: int = 1,
           raycaster: Optional[Raycaster] = None) -> np.ndarray:
    """Host loop over samples on the scene's device: returns the mean
    radiance as an [H, W, 3] float32 image."""
    iters = iterations if iterations is not None else cfg.iterations
    w, h = cam.resolution
    if iters <= 0:
        return np.zeros((h, w, 3), np.float32)
    step = make_sample_fn(scene, cam, cfg, raycaster)
    accum = Vec3.zeros((cam.num_pixels,), scene.device)
    for it in range(start_iter, start_iter + iters):
        accum = step(it, accum)
    img = (accum * (1.0 / iters)).stacked().reshape(h, w, 3)
    return img.cpu().numpy()
