"""Wavefront integrator: RayGen -> per bounce [TraceExtension -> Logic ->
Shade -> TraceShadow] over one path pool.

Counterpart of `tpt/integrators/wavefront.py` for the BRUTE_FORCE,
BVH_PALLAS, BVH_TREELET and BVH_SWEEP backends, with the same carry
tuple, the same per-lane RNG stream and the same stage arithmetic, so one
bounce fed the same carry gives the same result in both packages
(tests).

The frame is one loop over bounces in eager PyTorch. What the JAX
package adds around it to work around the TPU — split per-bounce
dispatch for the device watchdog, adaptive-pool compile rungs, buffer
donation — is not ported; the adaptive pool is bit-equal to the fixed
pool, so the results are the same. With a packet backend the pool is
re-sorted by ray-coherence key before every extension cast after the
first (dead lanes last), which on the GPU keeps a warp's rays on
similar traversal paths; pixel order is restored once per frame. Under
BVH_SWEEP that sort is the sweep's bin sort instead: the dense treelet
scan (K3) runs on the unsorted pool and the pool sorts once by the bin
key, carrying the scan's slot planes to the sweep cast (tpt's "wide"
seed mode; its packed and lean modes give the same hits), which runs
tpt's two-phase cascade where tpt does (`_cascade_on`). Its camera rays
go through K2, or with cfg.sweep_primary through K3 and the sweep in
raster order; without sort_bounce_rays every later cast is the unsorted
sweep_cast (scan, bin sort, sweep, unsort) inside the cast. Under
BVH_TREELET the camera rays go unsorted through K10 with the primary
packets, and every later bounce runs the treelet scan K9 on the unsorted
pool, splits easy from hard rays, and sorts once by (treelet key,
coherence key), carrying K9's seed planes to the cast (tpt's split-mode
seeding). With `nearfield_frac` on BVH_PALLAS the extension cast runs
twice, as tpt's: a cast bounded at that fraction of the scene diagonal,
then an unbounded cast of its misses.

An enabled environment map adds its radiance to escaping paths (MIS
weighted against env NEE when cfg.env_nee is on) and, with cfg.env_nee,
one alias-table light sample a bounce with its own shadow ray, after the
light NEE; `heavy_shading_iters` scales each BSDF sample by tpt's
synthetic shading load, and `debug_no_shadow` skips the light NEE's
shadow cast (every sample unoccluded), as tpt's timing diagnostic does.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..bvh.sweep import MAX_SLOTS
from ..bvh.treelet_traverse import MAX_SLOTS as TREELET_MAX_SLOTS
from ..config import RayCastBackend, RenderConfig
from ..core import rng
from ..core.camera import Camera, generate_camera_rays
from ..core.mathutil import (DELTA_THRESHOLD, EPSILON, PDF_DIRAC_DELTA,
                             perspective_look_at, power_heuristic,
                             project_to_screen_uv)
from ..core.vec import Vec3, where as vwhere
from ..materials import bsdf
from ..scene import envmap as envmod
from ..scene.lights import sample_light
from ..scene.structs import SceneData
from .common import (Raycaster, apply_russian_roulette, compute_env_nee,
                     fetch_hit_surface, heavy_shading_factor, make_raycaster)
from .intersect import HitRecord


@dataclass(frozen=True)
class GBuffers:
    """First-bounce buffers (per pixel)."""

    depth: torch.Tensor      # [N] f32, -1000 = sky
    normal: Vec3             # [N] geometric normal
    mat_id: torch.Tensor     # [N] int32, -1 = sky
    albedo: Vec3             # [N] basecolor
    motion_u: torch.Tensor   # [N] pixel-space motion vector
    motion_v: torch.Tensor

    @staticmethod
    def zeros(n: int, device) -> "GBuffers":
        return GBuffers(
            depth=torch.full((n,), -1000.0, device=device),
            normal=Vec3.zeros((n,), device),
            mat_id=torch.full((n,), -1, dtype=torch.int32, device=device),
            albedo=Vec3.ones((n,), device),
            motion_u=torch.zeros((n,), device=device),
            motion_v=torch.zeros((n,), device=device),
        )


@dataclass(frozen=True)
class FrameOutput:
    direct: Vec3     # [N] NEE radiance
    indirect: Vec3   # [N] BSDF/emissive/env radiance
    gbuf: GBuffers
    rays_traced: torch.Tensor  # 0-dim int64 (extension + shadow rays)


# the BVH_SWEEP knobs this port implements, each with the values that
# give tpt's results (seed mode and tail compaction change how tpt moves
# data on the TPU, never a hit)
_SWEEP_KNOBS = {
    "sweep_slots": range(1, MAX_SLOTS + 1),
    "sweep_key_slots": (2, 3),
    "sweep_unroll": range(1, 1 << 10),
    "sweep_seed_mode": ("packed", "lean", "wide"),
    "sweep_tail_compact": ("scatter", "sort"),
    "sweep_kernel": ("sublane", "lane"),
    "sweep_groups": (False, True),
    "sweep_shadow": (False, True),
    "sweep_primary": (False, True),
    "sweep_cascade": (False, True),
}
# the BVH_TREELET knobs this port implements
_INT32 = range(-2**31, 2**31)
_TREELET_KNOBS = {
    "treelet_slots": range(1, TREELET_MAX_SLOTS + 1),
    "treelet_max_rounds": range(1, 2**31),
    "treelet_hybrid": (False, True),
    "treelet_hard_count": _INT32,
}
# RenderConfig knobs of the TPU kernels and their dispatch (packet shape
# and pops, sort cadence): the port keeps
# their defaults (the treelet kernels walk tpt's default packets), so a
# value other than the default is refused rather than ignored
_TPU_KNOBS = tuple(f.name for f in fields(RenderConfig)
                   if f.name.startswith(("trav_", "sweep_", "treelet_"))
                   and f.name not in _SWEEP_KNOBS
                   and f.name not in _TREELET_KNOBS
                   # sizes a TPU prefix only: every value gives tpt's hits
                   and f.name != "sweep_cascade_frac") + ("sort_every",)


def _unsupported(cfg: RenderConfig) -> Optional[str]:
    """The RenderConfig options the port does not implement."""
    default = RenderConfig()
    for name in _TPU_KNOBS:
        if getattr(cfg, name) != getattr(default, name):
            return name
    for name, ok in list(_SWEEP_KNOBS.items()) + list(_TREELET_KNOBS.items()):
        if getattr(cfg, name) not in ok:
            return f"{name}={getattr(cfg, name)!r}"
    return None


def _sort_pool(scene: SceneData, cfg: RenderConfig, carry_slice):
    """Re-sort the live path pool by ray-coherence key (stable; dead lanes
    get the max key and gather at the tail)."""
    from . import raysort

    world_lo, world_inv = raysort.world_bounds(scene.mesh)
    (ori, direction, throughput, last_pdf, state, alive, direct,
     indirect, pixel_idx) = carry_slice
    key = raysort.coherence_key(ori, direction, world_lo, world_inv,
                                mode=cfg.sort_key)
    key = torch.where(alive, key, 1 << 30)
    perm = torch.sort(key, stable=True).indices
    g = lambda a: a[perm]
    gv = lambda v: Vec3(v.x[perm], v.y[perm], v.z[perm])
    return (gv(ori), gv(direction), gv(throughput), g(last_pdf), g(state),
            g(alive), gv(direct), gv(indirect), g(pixel_idx))


def _cascade_on(cfg: RenderConfig) -> bool:
    """Do the bounces after the first run tpt's two-phase cascade
    (tpt/integrators/wavefront.py:989-991)? Otherwise the one-shot sweep."""
    return (cfg.sort_bounce_rays and cfg.sweep_cascade and cfg.sweep_slots > 2
            and cfg.sweep_seed_mode == "packed"
            and cfg.sweep_kernel == "sublane")


def _sweep_scan_keys(scene: SceneData, cfg: RenderConfig, carry_slice):
    """BVH_SWEEP seed stage 1: the dense treelet scan (K3) on the unsorted
    pool and the bin-sort keys (dead lanes keyed last)."""
    from ..bvh.sweep import dense_scan
    from ..bvh.sweepcast import bin_key, bin_key2

    ori, direction, alive = carry_slice[0], carry_slice[1], carry_slice[5]
    S = cfg.sweep_slots
    T = scene.sweep.num_treelets
    pre_tmax = torch.where(alive, 3.4e38, -1.0)
    s_t, s_o, thr = dense_scan(scene.sweep, ori, direction, pre_tmax, slots=S)
    two_key = cfg.sweep_key_slots >= 3 and S > 2
    dead_last = lambda k: torch.where(alive, k, 1 << 30)
    keys = [dead_last(bin_key(s_o, direction, T, S, with_octant=not two_key))]
    if two_key:
        keys.append(dead_last(bin_key2(s_o, direction, T, S)))
    return keys, (s_t, s_o, thr)


def _sweep_bin_sort(cfg: RenderConfig, carry_slice, keys, slots_raw):
    """BVH_SWEEP seed stage 2: one stable pool sort by the bin key(s),
    carrying the pool slice and the scan's slot planes. Returns (sorted
    slice, (s_o, s_t, thr) in pool order)."""
    from ..bvh.sweepcast import bin_sort_perm

    (ori, direction, throughput, last_pdf, state, alive, direct,
     indirect, pixel_idx) = carry_slice
    s_t, s_o, thr = slots_raw
    perm = bin_sort_perm(keys)
    g = lambda a: a[perm]
    gv = lambda v: Vec3(v.x[perm], v.y[perm], v.z[perm])
    return ((gv(ori), gv(direction), gv(throughput), g(last_pdf), g(state),
             g(alive), gv(direct), gv(indirect), g(pixel_idx)),
            (s_o[:, perm], s_t[:, perm], g(thr)))


def _treelet_seed_sort(scene: SceneData, cfg: RenderConfig, carry_slice):
    """BVH_TREELET seeding (tpt/integrators/wavefront.py:314-359): the
    treelet scan K9 on the unsorted pool, the hybrid easy/hard split (a
    live lane with cnt >= treelet_hard_count is hard), and one stable sort
    by (treelet key, coherence key): easy lanes grouped by their nearest
    treelet's ordinal, then hard lanes, then lanes with no candidate, dead
    lanes last. Returns (sorted slice, seed (entry t, code, overflow), hard
    in pool order, K9's capped count)."""
    from ..bvh.treelet_traverse import NONE_CODE, treelet_scan
    from . import raysort

    (ori, direction, throughput, last_pdf, state, alive, direct,
     indirect, pixel_idx) = carry_slice
    pre_tmax = torch.where(alive, 3.4e38, -1.0)
    st, sc, so, ovf, cnt, capped = treelet_scan(
        scene.pack, ori, direction, pre_tmax, group=cfg.trav_group)
    world_lo, world_inv = raysort.world_bounds(scene.mesh)
    dir_key = raysort.coherence_key(ori, direction, world_lo, world_inv,
                                    mode=cfg.sort_key)
    hard = (alive & (cnt >= cfg.treelet_hard_count) if cfg.treelet_hybrid
            else torch.zeros_like(alive))
    key1 = torch.where(
        alive & hard, 1 << 29,
        torch.where(alive & (sc != NONE_CODE), so.long(),
                    torch.where(alive, (1 << 30) - 1, 1 << 30)))
    # both keys are non-negative and below 2**31: one int64 key sorts by
    # key1, then by the coherence key, as tpt's two-key lax.sort does
    perm = torch.sort((key1 << 32) | dir_key, stable=True).indices
    g = lambda a: a[perm]
    gv = lambda v: Vec3(v.x[perm], v.y[perm], v.z[perm])
    return ((gv(ori), gv(direction), gv(throughput), g(last_pdf), g(state),
             g(alive), gv(direct), gv(indirect), g(pixel_idx)),
            (g(st), g(sc), g(ovf)), g(hard), capped)


def unsort_by_pixel(pixel_idx, direct: Vec3, indirect: Vec3):
    """Restore pixel order (pixel_idx is a permutation of each sample
    batch; the stable sort keeps a pixel's samples in pool order)."""
    perm = torch.sort(pixel_idx, stable=True).indices
    gv = lambda v: Vec3(v.x[perm], v.y[perm], v.z[perm])
    return gv(direct), gv(indirect)


def _bounce_body(scene: SceneData, raycaster: Raycaster, cam: Camera,
                 cfg: RenderConfig, view_proj, prev_view_proj, depth: int,
                 carry):
    """One wavefront bounce over the full path pool (`depth` is the bounce
    number, 0 for camera rays)."""
    w, h = cam.resolution
    has_lights = scene.lights.num_lights > 0
    do_sort = cfg.sort_bounce_rays and cfg.backend.is_packet

    (ori, direction, throughput, last_pdf, state, alive,
     direct, indirect, pixel_idx, gbuf, rays) = carry
    n = ori.shape[0]
    dev = ori.device
    first = depth == 0

    cast_kw = {}
    if do_sort and not first:
        pool = (ori, direction, throughput, last_pdf, state, alive, direct,
                indirect, pixel_idx)
        if cfg.backend == RayCastBackend.BVH_SWEEP:
            keys, slots_raw = _sweep_scan_keys(scene, cfg, pool)
            pool, cast_kw["sweep_slots"] = _sweep_bin_sort(cfg, pool, keys,
                                                           slots_raw)
            cast_kw["cascade"] = _cascade_on(cfg)
        elif cfg.backend == RayCastBackend.BVH_TREELET:
            pool, cast_kw["seed"], hard, capped = _treelet_seed_sort(
                scene, cfg, pool)
            raycaster.capped.add_(capped)
            if cfg.treelet_hybrid:
                cast_kw["hard"] = hard
        else:
            pool = _sort_pool(scene, cfg, pool)
        (ori, direction, throughput, last_pdf, state, alive, direct,
         indirect, pixel_idx) = pool

    if first and cfg.backend in (RayCastBackend.BVH_TREELET,
                                 RayCastBackend.BVH_SWEEP):
        cast_kw["primary"] = True   # tpt's primary raycaster
        if cfg.backend == RayCastBackend.BVH_SWEEP and cfg.sweep_primary:
            # the camera rays through the sweep: K3 on the raster-order
            # pool, no bin sort (G-buffers need pixel order)
            from ..bvh.sweep import dense_scan

            s_t, s_o, thr = dense_scan(scene.sweep, ori, direction,
                                       torch.where(alive, 3.4e38, -1.0),
                                       slots=cfg.sweep_slots)
            cast_kw["sweep_slots"] = (s_o, s_t, thr)

    # ---- TraceExtensionRay stage: dead lanes get t_max = -1 -------------
    if cfg.nearfield_frac > 0.0 and cfg.backend == RayCastBackend.BVH_PALLAS:
        hit = _nearfield_cast(scene, raycaster, cfg, ori, direction, alive)
    else:
        ext_tmax = torch.where(alive, 3.4e38, -1.0)
        hit = raycaster.closest_hit(ori, direction, ext_tmax, **cast_kw)
    rays = rays + alive.sum()

    # ---- Logic stage ------------------------------------------------------
    wo = -1.0 * direction
    (mats, n_sh, ng_raw, ng, hit_matid, uu, vv) = fetch_hit_surface(
        scene, hit.tri, hit.u, hit.v, wo)
    point = ori + direction * hit.t
    miss = alive & ~hit.hit_mask
    zero3 = Vec3.zeros((n,), dev)

    # miss -> environment into indirect; BSDF-sampled env hits are MIS
    # weighted only when the env NEE estimator runs beside them
    if scene.env.enabled:
        env_l = envmod.env_radiance(scene.env, direction)
        if cfg.env_nee:
            pdf_env = envmod.env_pdf(scene.env, direction)
            w_mis = torch.where((last_pdf > DELTA_THRESHOLD) | first, 1.0,
                                power_heuristic(last_pdf, pdf_env))
        else:
            w_mis = 1.0
        indirect = indirect + vwhere(miss, throughput * env_l * w_mis, zero3)

    if first:
        # G-buffers are per pixel: sample batch 0 is the raster-order
        # prefix of the (not yet sorted) pool
        npx = gbuf.depth.shape[0]
        pre = lambda a: a[:npx]
        vpre = lambda v: v.map(lambda c: c[:npx])
        sky = pre(miss)
        u_c, v_c, ok_c = project_to_screen_uv(vpre(point), view_proj)
        u_p, v_p, ok_p = project_to_screen_uv(vpre(point), prev_view_proj)
        moving = ~sky & ok_c & ok_p
        gbuf = GBuffers(
            depth=torch.where(sky, -1000.0, pre(hit.t)),
            normal=vwhere(sky, Vec3.zeros((npx,), dev), vpre(ng_raw)),
            mat_id=torch.where(sky, -1, pre(hit_matid)),
            albedo=vwhere(sky, Vec3.ones((npx,), dev), vpre(mats.basecolor)),
            motion_u=torch.where(moving, (u_c - u_p) * w, 0.0),
            motion_v=torch.where(moving, (v_c - v_p) * h, 0.0))
    alive = alive & hit.hit_mask

    # emissive hit -> MIS -> indirect, kill
    emissive = alive & (mats.emittance > 0.0)
    cos_light = torch.clamp_min(n_sh.dot(wo), 0.0)
    pdf_la = 1.0 / torch.clamp_min(scene.lights.total_area, 1e-20)
    pdf_lsa = pdf_la * (hit.t * hit.t) / torch.clamp_min(cos_light, 1e-20)
    no_mis = (last_pdf > 0.9 * PDF_DIRAC_DELTA) | first | (not has_lights)
    w_emis = torch.where(
        no_mis, 1.0,
        torch.where(cos_light > EPSILON, power_heuristic(last_pdf, pdf_lsa), 0.0))
    indirect = indirect + vwhere(
        emissive, throughput * mats.basecolor * (mats.emittance * w_emis), zero3)
    alive = alive & ~emissive

    # ---- Shade stage: NEE -> TraceShadowRay --------------------------------
    if has_lights:
        state, lp, ln, pdf_area, ltri, le = sample_light(
            scene.mesh, scene.lights, state)
        # geometry measured from the OFFSET shadow origin (a shorter
        # segment would let the light occlude its own shadow ray)
        shadow_ori = point + ng * EPSILON
        to_l = lp - shadow_ori
        dist = to_l.length()
        wi_l = to_l * (1.0 / torch.clamp_min(dist, 1e-20))
        dist_sq = torch.clamp_min(dist * dist, 1e-6)
        cos_surf = torch.clamp_min(n_sh.dot(wi_l), 0.0)
        cos_l = torch.clamp_min(ln.dot(-1.0 * wi_l), 0.0)
        front = ng.dot(wi_l) > 0.0
        if le is None:
            lmat = bsdf.gather_materials(scene.materials,
                                         scene.mesh.material_ids[ltri])
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
        shadow_t = torch.where(nee_mask, dist, -1.0)  # dead shadow lanes
        if cfg.debug_no_shadow:
            # tpt's timing diagnostic: no shadow cast, nothing occluded
            occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
        else:
            occluded = raycaster.any_hit(shadow_ori, wi_l, shadow_t)
        rays = rays + nee_mask.sum()
        direct = direct + vwhere(nee_mask & ~occluded, contrib, zero3)
    else:
        state, _ = rng.rand_float(state)
        state, _ = rng.rand_float(state)
        state, _ = rng.rand_float(state)

    # direct environment sampling through the alias table
    if scene.env.enabled and cfg.env_nee:
        state, env_contrib = compute_env_nee(scene, cfg, raycaster, state,
                                             point, n_sh, ng, wo, mats,
                                             throughput, alive)
        direct = direct + env_contrib
        rays = rays + alive.sum()

    # ---- BSDF sample + path update -----------------------------------------
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

    return (ori, direction, throughput, last_pdf, state, alive,
            direct, indirect, pixel_idx, gbuf, rays)


def _nearfield_cast(scene: SceneData, raycaster: Raycaster,
                    cfg: RenderConfig, ori: Vec3, direction: Vec3,
                    alive) -> HitRecord:
    """tpt's two-pass BVH_PALLAS extension cast
    (tpt/integrators/wavefront.py:376-395): a cast bounded at
    cfg.nearfield_frac of the scene diagonal, then an unbounded cast of
    the lanes it missed. A hit at exactly the bound falls through to the
    second pass (the first accepts only t < its limit), so no hit is
    lost."""
    from . import raysort

    _, inv = raysort.world_bounds(scene.mesh)
    diag = torch.sqrt((1.0 / inv.x) ** 2 + (1.0 / inv.y) ** 2
                      + (1.0 / inv.z) ** 2)
    r1 = cfg.nearfield_frac * diag
    hit1 = raycaster.closest_hit(ori, direction, torch.where(alive, r1, -1.0))
    miss1 = alive & ~hit1.hit_mask
    hit2 = raycaster.closest_hit(ori, direction,
                                 torch.where(miss1, 3.4e38, -1.0))
    near = hit1.hit_mask
    return HitRecord(t=torch.where(near, hit1.t, hit2.t),
                     tri=torch.where(near, hit1.tri, hit2.tri),
                     u=torch.where(near, hit1.u, hit2.u),
                     v=torch.where(near, hit1.v, hit2.v))


def init_carry(cfg: RenderConfig, ori: Vec3, direction: Vec3, state,
               pixel_idx=None):
    """The path-pool carry: (ori, direction, throughput, last_pdf, state,
    alive, direct, indirect, pixel_idx, gbuf, rays) — tpt's layout."""
    n = ori.shape[0]
    dev = ori.device
    if pixel_idx is None:
        pixel_idx = torch.arange(n, dtype=torch.int64, device=dev)
    return (ori, direction, Vec3.ones((n,), dev), torch.zeros((n,), device=dev),
            state, torch.ones((n,), dtype=torch.bool, device=dev),
            Vec3.zeros((n,), dev), Vec3.zeros((n,), dev), pixel_idx,
            GBuffers.zeros(n // max(1, cfg.spp_batch), dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def finish_carry(cfg: RenderConfig, carry) -> FrameOutput:
    """Unsort radiance back to pixel order (when the pool was sorted), sum
    an spp batch per pixel, and zero non-finite values."""
    direct, indirect, pixel_idx, gbuf, rays = (
        carry[6], carry[7], carry[8], carry[9], carry[10])
    spp = cfg.spp_batch
    nan_guard = lambda v: v.map(lambda c: torch.where(torch.isfinite(c), c, 0.0))
    if cfg.sort_bounce_rays and cfg.backend.is_packet:
        direct, indirect = unsort_by_pixel(pixel_idx, direct, indirect)
        if spp > 1:
            batch_sum = lambda v: v.map(lambda c: c.reshape(-1, spp).sum(dim=1))
            direct, indirect = batch_sum(direct), batch_sum(indirect)
    elif spp > 1:
        batch_sum = lambda v: v.map(lambda c: c.reshape(spp, -1).sum(dim=0))
        direct, indirect = batch_sum(direct), batch_sum(indirect)
    return FrameOutput(direct=nan_guard(direct), indirect=nan_guard(indirect),
                       gbuf=gbuf, rays_traced=rays)


def batched_raygen(cam: Camera, cfg: RenderConfig, iteration: int, device):
    """RayGen for one frame: cfg.spp_batch jittered samples of every pixel
    in one pool (sample s uses iteration + s)."""
    spp = cfg.spp_batch
    if spp == 1:
        ori, direction, state = generate_camera_rays(cam, iteration,
                                                     cfg.jitter, device=device)
        return init_carry(cfg, ori, direction, state)
    parts = [generate_camera_rays(cam, iteration + s, cfg.jitter, device=device)
             for s in range(spp)]
    cat3 = lambda vs: Vec3(*(torch.cat([getattr(v, ax) for v in vs])
                             for ax in ("x", "y", "z")))
    ori = cat3([p[0] for p in parts])
    direction = cat3([p[1] for p in parts])
    state = torch.cat([p[2] for p in parts])
    pix = torch.arange(cam.num_pixels, dtype=torch.int64,
                       device=device).repeat(spp)
    return init_carry(cfg, ori, direction, state, pixel_idx=pix)


def camera_view_proj(cam: Camera) -> np.ndarray:
    w, h = cam.resolution
    return perspective_look_at(cam.position, cam.look_at, cam.up,
                               cam.fovy_deg, w / h)


def trace_frame(scene: SceneData, raycaster: Raycaster, cam: Camera,
                cfg: RenderConfig, iteration: int, view_proj=None,
                prev_view_proj=None) -> FrameOutput:
    """One wavefront frame (cfg.spp_batch samples per pixel): raygen, then
    cfg.trace_depth bounces, then the pixel-order finish."""
    reason = _unsupported(cfg)
    if reason:
        raise NotImplementedError(f"{reason} is not ported yet")
    vp = camera_view_proj(cam) if view_proj is None else view_proj
    prev = vp if prev_view_proj is None else prev_view_proj
    carry = batched_raygen(cam, cfg, iteration, scene.device)
    for depth in range(cfg.trace_depth):
        carry = _bounce_body(scene, raycaster, cam, cfg, vp, prev, depth, carry)
    return finish_carry(cfg, carry)


def render(scene: SceneData, cam: Camera, cfg: RenderConfig,
           iterations: Optional[int] = None, start_iter: int = 1,
           raycaster: Optional[Raycaster] = None) -> np.ndarray:
    """Headless accumulate-and-average on the scene's device: returns the
    [H, W, 3] float32 image. Pass `raycaster` to read its `capped` count
    afterwards."""
    iters = iterations if iterations is not None else cfg.iterations
    w, h = cam.resolution
    if iters <= 0:
        return np.zeros((h, w, 3), np.float32)
    if raycaster is None:
        raycaster = make_raycaster(scene, cfg)
    dev = scene.device
    acc_d = Vec3.zeros((cam.num_pixels,), dev)
    acc_i = Vec3.zeros((cam.num_pixels,), dev)
    spp = cfg.spp_batch
    total = 0
    for it in range(start_iter, start_iter + iters, spp):
        out = trace_frame(scene, raycaster, cam, cfg, it)
        acc_d = acc_d + out.direct
        acc_i = acc_i + out.indirect
        total += spp
    img = ((acc_d + acc_i) * (1.0 / total)).stacked().reshape(h, w, 3)
    return img.cpu().numpy()
