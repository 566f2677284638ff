"""Shared integrator machinery: the ray-cast backend seam, the hit-surface
fetch and Russian roulette. Counterpart of `tpt/integrators/common.py`
for the ported slices: the BRUTE_FORCE, BVH_PALLAS, BVH_TREELET and
BVH_SWEEP backends and untextured materials."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..config import RayCastBackend, RenderConfig
from ..core.vec import Vec3, where as vwhere
from ..materials.bsdf import MaterialLanes
from ..scene.structs import MeshData, SceneData
from .intersect import HitRecord, brute_force_any_hit, brute_force_closest_hit


@dataclass(frozen=True)
class Raycaster:
    """Pluggable ray-cast backend behind one stage interface.

    `capped` accumulates, on the device, the rays whose traversal was not
    exact (stack overflow or step cap); it stays 0 for brute force."""

    closest_hit: Callable[..., HitRecord]
    any_hit: Callable[..., torch.Tensor]
    name: str
    capped: torch.Tensor


def make_raycaster(scene: SceneData, cfg: RenderConfig) -> Raycaster:
    """The backend `cfg.backend` names. The TPU packet-kernel knobs
    (trav_group, pops) keep their defaults: the per-thread K1/K2 and
    K8a/K8b have no packets, and the treelet kernels K9/K10 walk tpt's default packets;
    wavefront refuses other values. A BVH_SWEEP raycaster serves both the
    camera rays (K2) and the bin-sorted bounce pools (sweep pipeline),
    told apart by `sweep_slots`; a BVH_TREELET raycaster serves the camera
    rays (`primary=True`) and the seeded bounce pools."""
    dev = scene.device
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.backend == RayCastBackend.BRUTE_FORCE:
        return Raycaster(
            closest_hit=lambda o, d, t_max=None: brute_force_closest_hit(
                scene.mesh, o, d, t_max),
            any_hit=lambda o, d, t_max: brute_force_any_hit(
                scene.mesh, o, d, t_max),
            name="brute_force", capped=capped)
    if cfg.backend == RayCastBackend.BVH_PALLAS:
        from ..bvh import packet_traverse as pt
        from .intersect import FLT_MAX

        pack = scene.pack
        if pack is None:
            raise ValueError("BVH_PALLAS needs a packet BVH "
                             "(HostScene.build(with_bvh=True))")
        # the binary pack goes to K8a/K8b, a wide one to K2/K1, as tpt's
        # pallas_closest_hit/pallas_any_hit route them
        binary = pack.arity == 2

        def closest(o, d, t_max=None):
            if t_max is None:
                t_max = torch.full((o.shape[0],), FLT_MAX, device=o.device)
            cast = (pt.packet_closest_hit if binary
                    else pt.packet_closest_hit_wide)
            hit, c = cast(pack, o, d, t_max)
            capped.add_(c)
            return hit

        def any_hit(o, d, t_max):
            cast = pt.packet_any_hit if binary else pt.packet_any_hit_wide
            occ, c = cast(pack, o, d, t_max)
            capped.add_(c)
            return occ

        return Raycaster(closest_hit=closest, any_hit=any_hit,
                         name="bvh_pallas", capped=capped)
    if cfg.backend == RayCastBackend.BVH_TREELET:
        from ..bvh.packet_traverse import (packet_any_hit_wide,
                                           packet_closest_hit_wide)
        from ..bvh.treelet_traverse import treelet_closest_hit
        from .intersect import FLT_MAX

        pack = scene.pack
        if pack is not None and pack.arity == 2:
            raise ValueError("BVH_TREELET needs a wide pack with treelet "
                             "tables, not the binary (arity-2) pack")
        if pack is None or pack.top_f32 is None:
            raise ValueError("BVH_TREELET needs treelet tables "
                             "(HostScene.build(with_bvh=True) attaches them "
                             "to wide packs)")
        knobs = dict(slots=cfg.treelet_slots,
                     max_rounds=cfg.treelet_max_rounds)

        def closest(o, d, t_max=None, seed=None, hard=None, primary=False):
            """K10 over super-packets of trav_group_primary * 1024 lanes
            for the camera rays (`primary`), trav_group * 1024 for bounce
            pools, started from the wavefront's K9 `seed` when given.
            With `hard` (the hybrid split), K10 sees the hard lanes as dead
            (t_max -1) and K2 casts them over the whole pool; each lane
            takes its own kernel's hit (tpt/integrators/common.py:87-101)."""
            if t_max is None:
                t_max = torch.full((o.shape[0],), FLT_MAX, device=o.device)
            group = cfg.trav_group_primary if primary else cfg.trav_group
            if hard is None:
                hit, c = treelet_closest_hit(pack, o, d, t_max, group=group,
                                             seed=seed, **knobs)
                capped.add_(c)
                return hit
            hit_e, c_e = treelet_closest_hit(
                pack, o, d, torch.where(hard, -1.0, t_max), group=group,
                seed=seed, **knobs)
            hit_h, c_h = packet_closest_hit_wide(
                pack, o, d, torch.where(hard, t_max, -1.0))
            capped.add_(c_e + c_h)
            pick = lambda a, b: torch.where(hard, a, b)
            return HitRecord(t=pick(hit_h.t, hit_e.t),
                             tri=pick(hit_h.tri, hit_e.tri),
                             u=pick(hit_h.u, hit_e.u),
                             v=pick(hit_h.v, hit_e.v))

        def any_hit(o, d, t_max):
            # shadow rays stay on K1, as tpt's do
            occ, c = packet_any_hit_wide(pack, o, d, t_max)
            capped.add_(c)
            return occ

        return Raycaster(closest_hit=closest, any_hit=any_hit,
                         name="bvh_treelet", capped=capped)
    if cfg.backend == RayCastBackend.BVH_SWEEP:
        from ..bvh.packet_traverse import (packet_any_hit_wide,
                                           packet_closest_hit_wide)
        from ..bvh.sweepcast import sweep_cast_sorted
        from .intersect import FLT_MAX

        pack, sweep = scene.pack, scene.sweep
        if pack is not None and pack.arity == 2:
            raise ValueError("BVH_SWEEP needs a wide pack with sweep "
                             "tables, not the binary (arity-2) pack")
        if pack is None or sweep is None or pack.num_treelets == 0:
            raise ValueError("BVH_SWEEP needs sweep tables "
                             "(HostScene.build(with_bvh=True) attaches them "
                             "to wide packs)")

        def closest(o, d, t_max=None, sweep_slots=None):
            """With sweep_slots = (s_o, s_t, thr) of a bin-sorted pool
            (the wavefront's bounces after the first): the sweep pipeline.
            Without: K2, as tpt's primary raycaster casts raster-order
            camera rays (cfg.sweep_primary off)."""
            if t_max is None:
                t_max = torch.full((o.shape[0],), FLT_MAX, device=o.device)
            if sweep_slots is None:
                hit, c = packet_closest_hit_wide(pack, o, d, t_max)
            else:
                s_o, s_t, thr = sweep_slots
                hit, c = sweep_cast_sorted(pack, sweep, o, d, t_max, s_o,
                                           s_t, thr, unroll=cfg.sweep_unroll)
            capped.add_(c)
            return hit

        def any_hit(o, d, t_max):
            # shadow rays stay on K1 (cfg.sweep_shadow off)
            occ, c = packet_any_hit_wide(pack, o, d, t_max)
            capped.add_(c)
            return occ

        return Raycaster(closest_hit=closest, any_hit=any_hit,
                         name="bvh_sweep", capped=capped)
    raise NotImplementedError(
        f"backend {cfg.backend.name} is not ported yet "
        "(BRUTE_FORCE, BVH_PALLAS, BVH_TREELET, BVH_SWEEP)")


def interpolate_surface(mesh: MeshData, tri: torch.Tensor, bu: torch.Tensor,
                        bv: torch.Tensor):
    """Barycentric interpolation of shading normal, tangent and UV at hits
    (w = 1-u-v on v0, u on v1, v on v2)."""
    tri_c = tri.clamp(0, mesh.num_triangles - 1).to(torch.int64)
    i0, i1, i2 = mesh.i0[tri_c], mesh.i1[tri_c], mesh.i2[tri_c]
    w = 1.0 - bu - bv
    n = (mesh.normals.take(i0) * w + mesh.normals.take(i1) * bu
         + mesh.normals.take(i2) * bv).normalize()
    tang = (mesh.tangents.take(i0) * w + mesh.tangents.take(i1) * bu
            + mesh.tangents.take(i2) * bv)
    uu = mesh.uv_u[i0] * w + mesh.uv_u[i1] * bu + mesh.uv_u[i2] * bv
    vv = mesh.uv_v[i0] * w + mesh.uv_v[i1] * bu + mesh.uv_v[i2] * bv
    return n, tang, uu, vv


def fetch_hit_surface(scene: SceneData, tri, bu, bv, wo: Vec3):
    """Hit-surface fetch through ONE row gather of the de-normalized
    `shade_hit [T, 40]` rows (mesh.shade_rows): material, geometric normal
    and the three vertices' attributes.

    Returns (mats, n_shading, ng_raw, ng_oriented, mat_id, uu, vv), as
    the JAX package's untextured path does."""
    mesh = scene.mesh
    if (scene.materials.any_tex_diffuse or scene.materials.any_tex_mr
            or scene.materials.any_tex_normal):
        raise NotImplementedError("textured materials are not ported yet")
    if mesh.shade_hit is None:
        raise ValueError("fetch_hit_surface needs MeshData.shade_hit")
    tric = tri.clamp(0, mesh.num_triangles - 1).to(torch.int64)
    w = 1.0 - bu - bv
    row = mesh.shade_hit[tric]
    mat_id = row[:, 0].contiguous().view(torch.int32)
    ng_raw = Vec3(row[:, 1], row[:, 2], row[:, 3])

    def lerp(c):
        return row[:, 4 + c] * w + row[:, 12 + c] * bu + row[:, 20 + c] * bv

    mats = MaterialLanes(
        basecolor=Vec3(row[:, 28], row[:, 29], row[:, 30]),
        metallic=row[:, 31], roughness=row[:, 32],
        emittance=row[:, 33], ior=row[:, 34],
        mtype=row[:, 35].to(torch.int32),
        tex_diffuse=row[:, 36].to(torch.int32),
        tex_metallic_roughness=row[:, 37].to(torch.int32),
        tex_normal=row[:, 38].to(torch.int32),
    )
    flip = ng_raw.dot(wo) < 0.0
    ng = vwhere(flip, -1.0 * ng_raw, ng_raw)
    n_shading = Vec3(lerp(0), lerp(1), lerp(2)).normalize()
    uu = lerp(6)
    vv = lerp(7)
    return mats, n_shading, ng_raw, ng, mat_id, uu, vv


def apply_russian_roulette(cfg: RenderConfig, depth: int, throughput: Vec3,
                           alive, state):
    """Throughput-proportional termination after cfg.rr_start_bounce
    (off by default; enabling it changes the RNG stream)."""
    if not cfg.russian_roulette:
        return throughput, alive, state
    from ..core import rng as rng_mod

    state, u = rng_mod.rand_float(state)
    p = torch.clamp(throughput.max_component(), 0.05, 1.0)
    active = alive & (depth >= cfg.rr_start_bounce)
    kill = active & (u > p)
    boost = torch.where(active & ~kill, 1.0 / p, 1.0)
    return throughput * boost, alive & ~kill, state


def oriented_geom_normal(mesh: MeshData, tri, wo: Vec3) -> Vec3:
    """Face normal flipped into the viewer hemisphere."""
    ng = mesh.geom_normals.take(tri.clamp_min(0).to(torch.int64))
    flip = ng.dot(wo) < 0.0
    return vwhere(flip, -1.0 * ng, ng)
