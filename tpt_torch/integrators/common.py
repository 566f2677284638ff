"""Shared integrator machinery: the ray-cast backend seam, the hit-surface
fetch (UV interpolation, normal mapping, texture application), the
synthetic shading load, Russian roulette and environment NEE.
Counterpart of `tpt/integrators/common.py` for every backend:
BRUTE_FORCE, BVH_XLA, BVH_PALLAS, BVH_TREELET and BVH_SWEEP."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..config import RayCastBackend, RenderConfig
from ..core.vec import Vec3, where as vwhere
from ..materials.bsdf import MaterialLanes
from ..scene.structs import MeshData, SceneData, TextureAtlas
from ..scene.texture import sample_atlas
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
    K8a/K8b have no packets, and the treelet kernels K9/K10 walk tpt's
    default packets; wavefront refuses other values. tpt builds a
    primary raycaster for camera rays and another for every later cast;
    here one Raycaster holds both, its closest_hit taking `primary`, so
    that both count into one `capped`. Under BVH_SWEEP a primary cast is
    K2 (unless cfg.sweep_primary) and any other cast without
    `sweep_slots` is the unsorted sweep_cast; under BVH_TREELET
    `primary` picks the camera rays' packets. BVH_XLA on a scene built
    without a BVH casts by brute force, as tpt's make_raycaster does."""
    dev = scene.device
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.backend == RayCastBackend.BRUTE_FORCE or (
            cfg.backend == RayCastBackend.BVH_XLA and scene.bvh is None):
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

        def closest(o, d, t_max=None, seed=None, hard=None,
                    primary=False):
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
        from ..bvh.sweepcast import sweep_any_hit, sweep_cast, sweep_cast_sorted
        from .intersect import FLT_MAX

        pack, sweep = scene.pack, scene.sweep
        if pack is not None and pack.arity == 2:
            raise ValueError("BVH_SWEEP needs a wide pack with sweep "
                             "tables, not the binary (arity-2) pack")
        if pack is None or sweep is None or pack.num_treelets == 0:
            raise ValueError("BVH_SWEEP needs sweep tables "
                             "(HostScene.build(with_bvh=True) attaches them "
                             "to wide packs)")
        knobs = dict(kernel=cfg.sweep_kernel, unroll=cfg.sweep_unroll,
                     groups=cfg.sweep_groups)

        def closest(o, d, t_max=None, sweep_slots=None, cascade=False,
                    primary=False):
            """With sweep_slots = (s_o, s_t, thr) of a pool sorted by the
            bin key (the wavefront's bounces after the first) or of the
            raster-order camera rays (cfg.sweep_primary): the sweep
            pipeline, with `cascade` the two-phase cascade. Without: K2
            for camera rays (`primary`, cfg.sweep_primary off), else the
            unsorted sweep_cast (tpt/integrators/common.py:117-149)."""
            if t_max is None:
                t_max = torch.full((o.shape[0],), FLT_MAX, device=o.device)
            if sweep_slots is not None:
                s_o, s_t, thr = sweep_slots
                hit, c = sweep_cast_sorted(pack, sweep, o, d, t_max, s_o, s_t,
                                           thr, cascade=cascade, **knobs)
            elif primary and not cfg.sweep_primary:
                hit, c = packet_closest_hit_wide(pack, o, d, t_max)
            else:
                hit, c = sweep_cast(pack, sweep, o, d, t_max,
                                    slots=cfg.sweep_slots,
                                    key_slots=cfg.sweep_key_slots, **knobs)
            capped.add_(c)
            return hit

        def any_hit(o, d, t_max):
            # cfg.sweep_shadow: the sweep's any-hit pipeline, else K1
            if cfg.sweep_shadow:
                occ, c = sweep_any_hit(pack, sweep, o, d, t_max,
                                       slots=cfg.sweep_slots, **knobs)
            else:
                occ, c = packet_any_hit_wide(pack, o, d, t_max)
            capped.add_(c)
            return occ

        return Raycaster(closest_hit=closest, any_hit=any_hit,
                         name="bvh_sweep", capped=capped)
    if cfg.backend == RayCastBackend.BVH_XLA:
        from ..bvh import traverse

        tables = traverse.walk_tables(scene.mesh, scene.bvh)

        def closest(o, d, t_max=None):
            hit, c = traverse.bvh_closest_hit(
                scene.mesh, scene.bvh, o, d, t_max,
                stack_depth=cfg.bvh_stack_depth, tables=tables)
            capped.add_(c)
            return hit

        def any_hit(o, d, t_max):
            occ, _ = traverse.bvh_any_hit(scene.mesh, scene.bvh, o, d, t_max,
                                          tables=tables)
            return occ

        return Raycaster(closest_hit=closest, any_hit=any_hit,
                         name="bvh_xla", capped=capped)
    raise ValueError(f"unknown backend {cfg.backend!r}")


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


def get_surface_properties(mesh: MeshData, atlas: TextureAtlas,
                           mats: MaterialLanes, tri, bu, bv):
    """Shading normal (normal-mapped when the material has a normal map)
    and UV at the hits."""
    n_shading, tang, uu, vv = interpolate_surface(mesh, tri, bu, bv)
    return _normal_map(atlas, mats, n_shading, tang, uu, vv), uu, vv


def _normal_map(atlas: TextureAtlas, mats: MaterialLanes, n_shading: Vec3,
                tang: Vec3, uu, vv) -> Vec3:
    """TBN normal mapping: B = normalize(N x T), T' = B x N, the map's
    rgb * 2 - 1 in that frame, on the lanes whose material has a map."""
    has_nm = mats.tex_normal >= 0
    b = n_shading.cross(tang).normalize()
    t = b.cross(n_shading)
    nm_rgb, _ = sample_atlas(atlas, mats.tex_normal, uu, vv)
    mapped = Vec3(nm_rgb.x * 2.0 - 1.0, nm_rgb.y * 2.0 - 1.0,
                  nm_rgb.z * 2.0 - 1.0)
    n_mapped = (t * mapped.x + b * mapped.y + n_shading * mapped.z).normalize()
    return vwhere(has_nm, n_mapped, n_shading)


def apply_material_textures(mats: MaterialLanes, atlas: TextureAtlas, uu, vv
                            ) -> MaterialLanes:
    """basecolor *= degamma(diffuse texture); roughness *= rm.g; metallic
    *= rm.b. A lane without a texture samples (1, 1, 1, 1), which leaves
    its values as they are, bit for bit."""
    diff_rgb, _ = sample_atlas(atlas, mats.tex_diffuse, uu, vv)
    degamma = Vec3(diff_rgb.x ** 2.2, diff_rgb.y ** 2.2, diff_rgb.z ** 2.2)
    basecolor = vwhere(mats.tex_diffuse >= 0, mats.basecolor * degamma,
                       mats.basecolor)
    rm_rgb, _ = sample_atlas(atlas, mats.tex_metallic_roughness, uu, vv)
    has_rm = mats.tex_metallic_roughness >= 0
    return MaterialLanes(
        basecolor=basecolor,
        metallic=torch.where(has_rm, mats.metallic * rm_rgb.z, mats.metallic),
        roughness=torch.where(has_rm, mats.roughness * rm_rgb.y,
                              mats.roughness),
        emittance=mats.emittance, ior=mats.ior, mtype=mats.mtype,
        tex_diffuse=mats.tex_diffuse,
        tex_metallic_roughness=mats.tex_metallic_roughness,
        tex_normal=mats.tex_normal)


def fetch_hit_surface(scene: SceneData, tri, bu, bv, wo: Vec3):
    """Hit-surface fetch through ONE row gather of the de-normalized
    `shade_hit [T, 40]` rows (mesh.shade_rows): material, geometric normal
    and the three vertices' attributes; then normal mapping and the
    material textures, only if some material carries such a texture
    (MaterialTable.any_tex_*, tpt's static gates).

    Returns (mats with textures applied, n_shading, ng_raw, ng_oriented,
    mat_id, uu, vv), as tpt's."""
    mesh = scene.mesh
    table = scene.materials
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
    if table.any_tex_normal:
        tang = Vec3(lerp(3), lerp(4), lerp(5))
        n_shading = _normal_map(scene.atlas, mats, n_shading, tang, uu, vv)
    if table.any_tex_diffuse or table.any_tex_mr:
        mats = apply_material_textures(mats, scene.atlas, uu, vv)
    return mats, n_shading, ng_raw, ng, mat_id, uu, vv


def heavy_shading_factor(u: torch.Tensor, iters: int) -> torch.Tensor:
    """Synthetic shading load: an `iters`-long sin^2 + cos^2 chain that
    multiplies to ~1.0 (the reference's shading stress experiment)."""
    m = torch.ones_like(u)
    for i in range(iters):
        # float32(i) * 1e-3 in float32, as tpt's i.astype(float32) * 1e-3
        off = torch.full((), i, dtype=torch.float32, device=u.device) * 1e-3
        s = torch.sin(m * 12.9898 + u + off)
        c = torch.cos(m * 12.9898 + u + off)
        m = m * (s * s + c * c)
    return m


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


def compute_env_nee(scene: SceneData, cfg: RenderConfig, raycaster: Raycaster,
                    state, point: Vec3, n_sh: Vec3, ng: Vec3, wo: Vec3,
                    mats: MaterialLanes, throughput: Vec3, alive):
    """Direct environment sampling through the alias table (cfg.env_nee):
    two draws, one env direction a lane, MIS against the BSDF, and a
    shadow ray of t_max 1e7 on the lanes that contribute. Returns
    (state, contribution masked by visibility)."""
    from ..core import rng as rng_mod
    from ..core.mathutil import EPSILON, power_heuristic
    from ..materials import bsdf as bsdf_mod
    from ..scene import envmap as envmod

    n = point.shape[0]
    state, u1 = rng_mod.rand_float(state)
    state, u2 = rng_mod.rand_float(state)
    wi, radiance, pdf_env = envmod.sample_env(scene.env, u1, u2)
    cos_surf = torch.clamp_min(n_sh.dot(wi), 0.0)
    front = ng.dot(wi) > 0.0
    f = bsdf_mod.eval_bsdf(wo, wi, n_sh, mats)
    pdf_b = bsdf_mod.pdf_bsdf(wo, wi, n_sh, mats)
    w_mis = power_heuristic(pdf_env, pdf_b)
    contrib = throughput * radiance * f * (
        cos_surf / torch.clamp_min(pdf_env, 1e-8) * w_mis)
    is_delta = (mats.mtype == 2) | (mats.mtype == 3)
    mask = (alive & front & ~is_delta & (cos_surf > 0.0)
            & (pdf_env > 0.0) & (contrib.length_sq() > 0.0))
    shadow_ori = point + ng * EPSILON
    t_far = torch.where(mask, 1e7, -1.0)
    occluded = raycaster.any_hit(shadow_ori, wi, t_far)
    return state, vwhere(mask & ~occluded, contrib,
                         Vec3.zeros((n,), point.device))
