"""The plain reference path tracer: the renderer's wavefront frame
computed lane by lane, with no sort, no kernel and no table of the
program. Its arithmetic is a frozen copy of tpt_torch/integrators/
wavefront.py's bounce (camera jitter, light NEE with its shadow ray and
MIS, the BSDF sample, emissive hits with MIS) for scenes without
textures, environment map or Russian roulette, cast by `walk` over the
reference's own LBVH.

A lane is one path: a pixel index and an iteration number, whose RNG
stream seeds from both, as the program's. So any subset of the paths of
a frame, in any order, is the same as in the whole frame."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import bsdf, rng, walk
from .consts import EPSILON, PDF_DIRAC_DELTA, power_heuristic
from .scene import RefScene
from .vec import Vec3, where as vwhere


@dataclass(frozen=True)
class Cam:
    """A pinhole camera: resolution (w, h), position and the derived unit
    view, right and true-up vectors and pixel lengths (the program's
    Camera.build arithmetic, in float64 on the host)."""

    resolution: tuple
    position: tuple
    view: tuple
    right: tuple
    true_up: tuple
    pixel_length: tuple

    @staticmethod
    def build(resolution, position, look_at, up, fovy_deg) -> "Cam":
        import math

        w, h = int(resolution[0]), int(resolution[1])
        pos = np.asarray(position, np.float64)
        yscaled = math.tan(math.radians(fovy_deg * 0.5))
        xscaled = yscaled * w / h
        view = np.asarray(look_at, np.float64) - pos
        view /= np.linalg.norm(view)
        right = np.cross(view, np.asarray(up, np.float64))
        right /= np.linalg.norm(right)
        true_up = np.cross(right, view)
        true_up /= np.linalg.norm(true_up)
        t = lambda a: tuple(float(v) for v in a)
        return Cam((w, h), t(pos), t(view), t(right), t(true_up),
                   (2.0 * xscaled / w, 2.0 * yscaled / h))


def _f32(v: float) -> float:
    return float(np.float32(v))


@dataclass
class Paths:
    """Per-lane results: radiance split as the program's carry, and the
    first hit's G-buffer (depth -1000, normal 0, mat -1, albedo 1 on
    sky)."""

    direct: Vec3
    indirect: Vec3
    depth: torch.Tensor
    normal: Vec3
    mat_id: torch.Tensor
    albedo: Vec3


def camera_rays(cam: Cam, pix: torch.Tensor, iteration: torch.Tensor):
    """Jittered primary rays of pixel indices `pix` at per-lane iteration
    numbers: (origin, direction, rng state)."""
    w, h = cam.resolution
    n = pix.shape[0]
    x = (pix % w).to(torch.float32)
    y = (pix // w).to(torch.float32)
    seed = rng.wang_hash((rng.as_u32(pix) * 19990303
                          + rng.as_u32(iteration) * 719393) & rng.MASK32)
    seed = torch.where(seed == 0, torch.ones_like(seed), seed)
    s1 = rng.wang_hash(seed)
    s2 = rng.wang_hash(s1)
    jx = rng.hash_to_unit_float(s1) - 0.5
    jy = rng.hash_to_unit_float(s2) - 0.5
    view = [_f32(c) for c in cam.view]
    right = [_f32(c) for c in cam.right]
    up = [_f32(c) for c in cam.true_up]
    plx, ply = _f32(cam.pixel_length[0]), _f32(cam.pixel_length[1])
    half_w, half_h = _f32(0.5 * w), _f32(0.5 * h)
    sx = plx * (x + jx - half_w)
    sy = ply * (y + jy - half_h)
    d = Vec3(view[0] + right[0] * sx - up[0] * sy,
             view[1] + right[1] * sx - up[1] * sy,
             view[2] + right[2] * sx - up[2] * sy).normalize()
    origin = Vec3.splat(cam.position, (n,), pix.device)
    return origin, d, seed


def trace(scn: RefScene, cam: Cam, pix: torch.Tensor, iteration: torch.Tensor,
          depth: int, quantize: Optional[Callable] = None) -> Paths:
    """Trace one path per lane for `depth` bounces. `quantize`, if given,
    rounds the rays and the path's carried values after every stage (the
    precision control)."""
    q = quantize or (lambda a: a)
    qv = lambda v: v.map(q)
    n = pix.shape[0]
    dev = pix.device
    ori, direction, state = camera_rays(cam, pix, iteration)
    ori, direction = qv(ori), qv(direction)
    throughput = Vec3.ones((n,), dev)
    last_pdf = torch.zeros((n,), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    direct = Vec3.zeros((n,), dev)
    indirect = Vec3.zeros((n,), dev)
    zero3 = Vec3.zeros((n,), dev)
    gb = None
    for bounce in range(depth):
        first = bounce == 0
        t, tri, bu, bv = walk.closest_hit(scn.tables, ori, direction,
                                          torch.where(alive, 3.4e38, -1.0))
        hit_mask = tri >= 0
        wo = -1.0 * direction
        tric = tri.clamp(0, scn.p0.shape[0] - 1)
        w = 1.0 - bu - bv
        vn = scn.vn[tric]
        n_sh = Vec3(vn[:, 0] * w + vn[:, 3] * bu + vn[:, 6] * bv,
                    vn[:, 1] * w + vn[:, 4] * bu + vn[:, 7] * bv,
                    vn[:, 2] * w + vn[:, 5] * bu + vn[:, 8] * bv).normalize()
        g = scn.geo_n[tric]
        ng_raw = Vec3(g[:, 0], g[:, 1], g[:, 2])
        ng = vwhere(ng_raw.dot(wo) < 0.0, -1.0 * ng_raw, ng_raw)
        hit_matid = scn.mat_id[tric]
        mats = bsdf.gather_materials(scn.mat_rows, hit_matid)
        point = qv(ori + direction * t)
        miss = alive & ~hit_mask
        if first:
            gb = (torch.where(miss, -1000.0, t),
                  vwhere(miss, zero3, ng_raw),
                  torch.where(miss, -1, hit_matid),
                  vwhere(miss, Vec3.ones((n,), dev), mats.basecolor))
        alive = alive & hit_mask

        emissive = alive & (mats.emittance > 0.0)
        cos_light = torch.clamp_min(n_sh.dot(wo), 0.0)
        pdf_la = 1.0 / torch.clamp_min(scn.light_total_area, 1e-20)
        pdf_lsa = pdf_la * (t * t) / torch.clamp_min(cos_light, 1e-20)
        no_mis = (last_pdf > 0.9 * PDF_DIRAC_DELTA) | first
        w_emis = torch.where(
            no_mis, 1.0,
            torch.where(cos_light > EPSILON, power_heuristic(last_pdf, pdf_lsa),
                        0.0))
        indirect = qv(indirect + vwhere(
            emissive, throughput * mats.basecolor * (mats.emittance * w_emis),
            zero3))
        alive = alive & ~emissive

        # light NEE and its shadow ray
        state, r1 = rng.rand_float(state)
        state, r2 = rng.rand_float(state)
        state, r3 = rng.rand_float(state)
        cdf_idx = torch.searchsorted(scn.light_cdf, r1, side="left").clamp(
            0, scn.num_lights - 1)
        sqrt_r2 = torch.sqrt(r2)
        b_u = 1.0 - sqrt_r2
        b_v = r3 * sqrt_r2
        b_w = 1.0 - b_u - b_v
        row = scn.light_rows[cdf_idx]
        col = lambda k: Vec3(row[:, k], row[:, k + 1], row[:, k + 2])
        lp = col(0) * b_u + col(3) * b_v + col(6) * b_w
        ln, le = col(9), col(12)
        pdf_area = torch.ones_like(r1) / torch.clamp_min(scn.light_total_area,
                                                         1e-20)
        shadow_ori = qv(point + ng * EPSILON)
        to_l = lp - shadow_ori
        dist = to_l.length()
        wi_l = qv(to_l * (1.0 / torch.clamp_min(dist, 1e-20)))
        dist_sq = torch.clamp_min(dist * dist, 1e-6)
        cos_surf = torch.clamp_min(n_sh.dot(wi_l), 0.0)
        cos_l = torch.clamp_min(ln.dot(-1.0 * wi_l), 0.0)
        front = ng.dot(wi_l) > 0.0
        f = bsdf.eval_bsdf(wo, wi_l, n_sh, mats)
        pdf_b = bsdf.pdf_bsdf(wo, wi_l, n_sh, mats)
        pdf_l_sa = pdf_area * dist_sq / torch.clamp_min(cos_l, 1e-20)
        w_nee = power_heuristic(pdf_l_sa, pdf_b)
        contrib = throughput * le * f * (
            cos_surf * cos_l / dist_sq * w_nee / pdf_area)
        is_delta = (mats.mtype == 2) | (mats.mtype == 3)
        nee_mask = (alive & front & ~is_delta & (cos_surf > 0.0)
                    & (cos_l > 0.0) & (contrib.length_sq() > 0.0))
        shadow_t = torch.where(nee_mask, dist, -1.0)
        occluded = walk.any_hit(scn.tables, shadow_ori, wi_l, shadow_t)
        direct = qv(direct + vwhere(nee_mask & ~occluded, contrib, zero3))

        # BSDF sample and path update
        state, smp = bsdf.sample_bsdf(wo, n_sh, mats, state)
        valid = (smp.pdf > 0.0) & (smp.attenuation.length_sq() > 0.0)
        exiting = smp.wi.dot(ng) > 0.0
        valid = valid & (exiting | smp.is_transmission)
        bias_n = vwhere(exiting, ng, -1.0 * ng)
        upd = alive & valid
        throughput = qv(vwhere(upd, throughput * smp.attenuation, throughput))
        ori = qv(vwhere(upd, point + bias_n * EPSILON, ori))
        direction = qv(vwhere(upd, smp.wi, direction))
        last_pdf = q(torch.where(upd, smp.pdf, last_pdf))
        alive = upd
    return Paths(direct=direct, indirect=indirect, depth=gb[0], normal=gb[1],
                 mat_id=gb[2], albedo=gb[3])


def _nan_guard(v: Vec3) -> Vec3:
    return v.map(lambda c: torch.where(torch.isfinite(c), c, 0.0))


def accumulated(scn: RefScene, cam: Cam, pix: torch.Tensor, spp: int,
                frames: int, depth: int, quantize: Optional[Callable] = None,
                max_lanes: int = 1 << 21) -> torch.Tensor:
    """The progressive image at pixels `pix` after `frames` frames of
    `spp` samples each, iterations 1, 2, ...: each frame's samples summed
    per pixel (non-finite sums zeroed), the sums added frame by frame,
    the total divided by the samples taken, as the program's renderer
    does. Returns [P, 3]."""
    p = pix.shape[0]
    acc_d = Vec3.zeros((p,), pix.device)
    acc_i = Vec3.zeros((p,), pix.device)
    per = max(1, max_lanes // (p * spp))
    for f0 in range(0, frames, per):
        fc = min(per, frames - f0)
        # lane order [frame, pixel, sample]: a pixel's samples adjacent, as
        # the program's pool after its unsort
        it = (1 + (f0 + torch.arange(fc, device=pix.device)) * spp)
        it = (it[:, None, None]
              + torch.arange(spp, device=pix.device)[None, None, :])
        it = it.expand(fc, p, spp).reshape(-1)
        lanes = pix[None, :, None].expand(fc, p, spp).reshape(-1)
        out = trace(scn, cam, lanes, it, depth, quantize)
        fsum = lambda c: c.reshape(fc * p, spp).sum(dim=1).reshape(fc, p)
        d = _nan_guard(out.direct.map(fsum))
        i = _nan_guard(out.indirect.map(fsum))
        for k in range(fc):
            acc_d = acc_d + d.map(lambda c: c[k])
            acc_i = acc_i + i.map(lambda c: c[k])
    return ((acc_d + acc_i) * (1.0 / (frames * spp))).stacked()


def denoised(scn: RefScene, cam: Cam, svgf_cfg, frames: int, spp: int,
             depth: int, quantize: Optional[Callable] = None) -> torch.Tensor:
    """The real-time image after `frames` frames from one view since a
    camera move: frame k (1-based) traces `spp` samples a pixel at
    iterations (k - 1) * spp + 1, ... (their sum per pixel, non-finite
    sums zeroed; the G-buffer from the first), and SVGF denoises it with
    the history the frames before it left, cleared at the move. The view
    does not change between those frames, so every motion vector is 0.
    Returns [H, W, 3]."""
    from .svgf import denoise

    w, h = cam.resolution
    dev = scn.p0.device
    pix = torch.arange(w * h, dtype=torch.int64, device=dev)
    plane = lambda a: a.reshape(h, w)
    p3 = lambda v: v.map(plane)
    zero = torch.zeros((h, w), device=dev)
    state = None
    for k in range(frames):
        first = 1 + k * spp
        sums = None
        for s in range(spp):
            out = trace(scn, cam, pix, torch.full_like(pix, first + s), depth,
                        quantize)
            if s == 0:
                gb = out
                sums = (out.direct, out.indirect)
            else:
                sums = (sums[0] + out.direct, sums[1] + out.indirect)
        rgb, state = denoise(
            svgf_cfg, state, p3(_nan_guard(sums[0])), p3(_nan_guard(sums[1])),
            p3(gb.albedo), plane(gb.depth), p3(gb.normal),
            plane(gb.mat_id).to(torch.int32), zero, zero)
    return rgb.stacked()
