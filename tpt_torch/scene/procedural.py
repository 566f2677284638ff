"""Procedural scenes: quads, boxes, UV spheres, the Cornell box, the Veach
MIS scene, and the benchmark interiors `fireplace_like` and
`stress_interior`.

Counterpart of `tpt/scene/procedural.py`: the same numpy construction
(same seeds, same float arithmetic), so a scene built here has the same
host mesh, bit for bit, as the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..core.camera import Camera
from .host import HostMaterial, HostScene
from .mesh import HostMesh, compute_smooth_normals, merge_meshes
from .structs import MaterialType


def make_quad(p0, p1, p2, p3, material_id: int) -> HostMesh:
    """Two triangles (p0,p1,p2) and (p0,p2,p3); CCW winding defines normal."""
    pos = np.array([p0, p1, p2, p3], np.float32)
    n = np.cross(pos[1] - pos[0], pos[2] - pos[0])
    n = n / max(np.linalg.norm(n), 1e-20)
    return HostMesh(
        positions=pos,
        normals=np.tile(n.astype(np.float32), (4, 1)),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        tangents=np.zeros((4, 3), np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        material_ids=np.full((2,), material_id, np.int32),
    )


def make_box(bmin, bmax, material_id: int, flip=False) -> HostMesh:
    """Axis-aligned box; outward normals (inward when flip=True)."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    quads = [
        # +X, -X, +Y, -Y, +Z, -Z (CCW seen from outside)
        ((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)),
        ((x0, y0, z1), (x0, y1, z1), (x0, y1, z0), (x0, y0, z0)),
        ((x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)),
        ((x0, y0, z1), (x0, y0, z0), (x1, y0, z0), (x1, y0, z1)),
        ((x1, y0, z1), (x1, y1, z1), (x0, y1, z1), (x0, y0, z1)),
        ((x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0)),
    ]
    meshes = []
    for q in quads:
        if flip:
            q = tuple(reversed(q))
        meshes.append(make_quad(*q, material_id=material_id))
    return merge_meshes(meshes)


def make_uv_sphere(center, radius, material_id: int, n_theta=24, n_phi=48) -> HostMesh:
    cx, cy, cz = center
    thetas = np.linspace(0.0, math.pi, n_theta + 1)
    phis = np.linspace(0.0, 2 * math.pi, n_phi + 1)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    pos = normals * radius + np.array([cx, cy, cz], np.float32)
    uvs = np.stack([pp / (2 * math.pi), tt / math.pi], -1).reshape(-1, 2).astype(np.float32)

    idx = []
    stride = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            if i > 0:
                idx.append([a, b, c])
            if i < n_theta - 1:
                idx.append([b, d, c])
    indices = np.array(idx, np.int32)
    return HostMesh(
        positions=pos.astype(np.float32),
        normals=normals,
        uvs=uvs,
        tangents=np.zeros_like(pos, dtype=np.float32),
        indices=indices,
        material_ids=np.full((indices.shape[0],), material_id, np.int32),
    )


def cornell_box(resolution=(800, 800), spheres=True,
                sphere_materials: Optional[Tuple[MaterialType, MaterialType]] = None
                ) -> HostScene:
    """The classic five-wall Cornell box with an area light; optionally two
    spheres whose material types are configurable (BASELINE configs #1/#2)."""
    s = HostScene()
    white = s.add_material(HostMaterial("white", (0.73, 0.73, 0.73)))
    red = s.add_material(HostMaterial("red", (0.65, 0.05, 0.05)))
    green = s.add_material(HostMaterial("green", (0.12, 0.45, 0.15)))
    light = s.add_material(HostMaterial("light", (1.0, 1.0, 1.0), emittance=15.0))

    L = 552.8  # classic cornell dims
    parts = [
        make_quad((L, 0, 0), (0, 0, 0), (0, 0, 559.2), (L, 0, 559.2), white),        # floor
        make_quad((L, 548.8, 0), (L, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0), white),  # ceiling
        make_quad((L, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (L, 548.8, 559.2), white),  # back
        make_quad((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2), green),  # left
        make_quad((L, 0, 0), (L, 0, 559.2), (L, 548.8, 559.2), (L, 548.8, 0), red),   # right
        make_quad((343, 548.0, 227), (343, 548.0, 332), (213, 548.0, 332), (213, 548.0, 227), light),
    ]
    if spheres:
        mt_a, mt_b = sphere_materials or (MaterialType.DIFFUSE, MaterialType.DIFFUSE)
        metallic_a = {MaterialType.MICROFACET_PBR: 0.8,
                      MaterialType.SPECULAR_REFLECTION: 1.0}.get(mt_a, 0.0)
        mat_a = s.add_material(HostMaterial(
            "sphere_a", (0.85, 0.85, 0.85), mtype=mt_a,
            roughness=0.2, metallic=metallic_a, ior=1.5))
        mat_b = s.add_material(HostMaterial(
            "sphere_b", (0.98, 0.98, 0.98), mtype=mt_b, ior=1.5))
        parts.append(make_uv_sphere((185, 110, 170), 110, mat_a))
        parts.append(make_uv_sphere((370, 90, 350), 90, mat_b))

    s.mesh = merge_meshes(parts)
    s.camera = Camera.build(
        resolution=resolution,
        position=(278.0, 273.0, -800.0),
        look_at=(278.0, 273.0, 0.0),
        up=(0.0, 1.0, 0.0),
        fovy_deg=39.3,
    )
    s.iterations = 8
    s.trace_depth = 8
    s.image_name = "cornell"
    return s


def veach_mis(resolution=(512, 384)) -> HostScene:
    """The classic Veach MIS demonstration scene (reference README §3.4 +
    img/mis.png — the asset itself is a git-lfs pointer, so this is a
    reconstruction of the canonical composition): four metallic plates of
    increasing roughness, lit by a row of spherical emitters whose radii
    span ~30x at equal power (radiance ~ 1/r^2). BSDF sampling alone fails
    on the small bright sphere; light sampling alone fails on the large
    dim sphere reflected in the smooth plate; the power-heuristic MIS
    combination resolves all plate/light pairs."""
    s = HostScene()
    gray = s.add_material(HostMaterial("backdrop", (0.35, 0.35, 0.35)))
    plate_rough = (0.012, 0.04, 0.1, 0.25)
    plate_mats = [
        s.add_material(HostMaterial(
            f"plate{i}", (0.85, 0.82, 0.78),
            mtype=MaterialType.MICROFACET_PBR, metallic=1.0, roughness=r))
        for i, r in enumerate(plate_rough)]
    radii = (0.035, 0.11, 0.33, 0.9)
    # equal power: L = P / (4 pi^2 r^2); pick P so the big sphere reads ~1.2
    light_mats = [
        s.add_material(HostMaterial(
            f"light{i}", (1.0, 0.95, 0.85), emittance=1.2 * (0.9 / r) ** 2))
        for i, r in enumerate(radii)]

    parts = [
        make_quad((-14, 0, 14), (14, 0, 14), (14, 0, -6), (-14, 0, -6),
                  gray),                                          # floor
        make_quad((-14, 0, -6), (14, 0, -6), (14, 16, -6), (-14, 16, -6),
                  gray),                                          # back wall
    ]
    # sphere lights in a row high on the back wall
    light_y, light_z = 7.2, -3.4
    light_x = (-5.0, -1.7, 1.7, 5.0)
    for x, r, m in zip(light_x, radii, light_mats):
        parts.append(make_uv_sphere((x, light_y, light_z), r, m,
                                    n_theta=10, n_phi=20))
    # plates: long thin quads tilted so each reflects the light row toward
    # the camera (normal = half vector between to-lights and to-camera)
    cam_pos = np.array([0.0, 5.0, 14.0])
    l_cen = np.array([0.0, light_y, light_z])
    plate_y = (3.7, 2.8, 2.0, 1.3)
    plate_z = (-2.4, -0.9, 0.6, 2.1)
    half_w, half_d = 6.0, 0.7
    for (y, z, m) in zip(plate_y, plate_z, plate_mats):
        c = np.array([0.0, y, z])
        wl = (l_cen - c) / np.linalg.norm(l_cen - c)
        wc = (cam_pos - c) / np.linalg.norm(cam_pos - c)
        nrm = (wl + wc) / np.linalg.norm(wl + wc)
        # plate axes: u along x, v = n x u (depth direction)
        u = np.array([1.0, 0.0, 0.0])
        v = np.cross(nrm, u)
        v /= np.linalg.norm(v)
        p = [c - u * half_w - v * half_d, c + u * half_w - v * half_d,
             c + u * half_w + v * half_d, c - u * half_w + v * half_d]
        parts.append(make_quad(*[tuple(q) for q in p], material_id=m))

    s.mesh = merge_meshes(parts)
    s.camera = Camera.build(
        resolution=resolution,
        position=tuple(cam_pos),
        look_at=(0.0, 3.4, 0.0),
        up=(0.0, 1.0, 0.0),
        fovy_deg=42.0,
    )
    s.iterations = 64
    s.trace_depth = 4
    s.image_name = "veach_mis"
    return s


def make_displaced_wall(p0, pu, pv, material_id: int, nu: int, nv: int,
                        amplitude: float, seed: int = 0) -> HostMesh:
    """A (nu x nv)-subdivided quad with smooth pseudo-random displacement
    along its normal — surface-detail geometry like scanned/authored walls."""
    rng = np.random.default_rng(seed)
    p0 = np.asarray(p0, np.float32)
    pu = np.asarray(pu, np.float32)
    pv = np.asarray(pv, np.float32)
    normal = np.cross(pu, pv)
    normal /= max(np.linalg.norm(normal), 1e-20)

    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    # smooth displacement: sum of a few random sinusoids
    disp = np.zeros_like(uu)
    for _ in range(5):
        fu, fv = rng.uniform(1, 6, 2)
        ph_u, ph_v = rng.uniform(0, 2 * np.pi, 2)
        disp += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * fu * uu + ph_u) \
            * np.sin(2 * np.pi * fv * vv + ph_v)
    disp = disp / np.abs(disp).max() * amplitude

    pos = (p0[None, None] + uu[..., None] * pu[None, None]
           + vv[..., None] * pv[None, None]
           + disp[..., None] * normal[None, None]).reshape(-1, 3)
    uvs = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    stride = nv + 1
    for i in range(nu):
        for j in range(nv):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            idx.append([a, c, b])
            idx.append([b, c, d])
    indices = np.array(idx, np.int32)
    normals = compute_smooth_normals(pos.astype(np.float32), indices)
    return HostMesh(
        positions=pos.astype(np.float32), normals=normals, uvs=uvs,
        tangents=np.zeros_like(pos, dtype=np.float32), indices=indices,
        material_ids=np.full((indices.shape[0],), material_id, np.int32),
    )


def fireplace_like(num_triangles: int = 143_000, resolution=(1920, 1080),
                   seed: int = 11, windowed: bool = False) -> HostScene:
    """Benchmark interior with the reference scene's *character*: ~143k
    triangles concentrated on surfaces (displaced walls/floor/ceiling,
    furniture blocks, a few detailed props), one area light, the reference
    material-class mix (README.md:34: mostly diffuse, ~17% PBR, ~8%
    refractive, a mirror). Unlike stress_interior (volume-filling spheres —
    an adversarial worst case for any coherence scheme), geometry lives on
    surfaces, so bounce rays cross open space like they do in Fireplace
    Room."""
    rng = np.random.default_rng(seed)
    s = HostScene()
    wall = s.add_material(HostMaterial("wall", (0.68, 0.62, 0.55)))
    floor_m = s.add_material(HostMaterial(
        "floor", (0.45, 0.32, 0.22), mtype=MaterialType.MICROFACET_PBR,
        roughness=0.45, metallic=0.05))
    wood = s.add_material(HostMaterial(
        "wood", (0.5, 0.34, 0.2), mtype=MaterialType.MICROFACET_PBR,
        roughness=0.6, metallic=0.0))
    metal = s.add_material(HostMaterial(
        "metal", (0.9, 0.88, 0.82), mtype=MaterialType.MICROFACET_PBR,
        roughness=0.25, metallic=0.9))
    mirror = s.add_material(HostMaterial(
        "mirror", (0.95, 0.95, 0.95), metallic=1.0,
        mtype=MaterialType.SPECULAR_REFLECTION))
    glass = s.add_material(HostMaterial(
        "glass", (0.98, 0.98, 0.98), ior=1.5,
        mtype=MaterialType.SPECULAR_REFRACTION))
    light = s.add_material(HostMaterial("lamp", (1.0, 0.85, 0.6),
                                        emittance=30.0))

    W, H, D = 1200.0, 400.0, 900.0  # room extents
    # wall subdivision budget: ~70% of triangles on the 6 shell surfaces
    shell_budget = int(num_triangles * 0.62)
    per_wall = shell_budget // 6
    nu = max(8, int(np.sqrt(per_wall / 2)))
    # orientations chosen so cross(pu, pv) (the displacement/shading normal)
    # points INTO the room
    parts = [
        make_displaced_wall((0, 0, 0), (0, 0, D), (W, 0, 0), floor_m,
                            nu, nu, 1.5, seed=1),                        # floor +y
        make_displaced_wall((0, H, 0), (W, 0, 0), (0, 0, D), wall,
                            nu, nu, 2.0, seed=2),                        # ceiling -y
        make_displaced_wall((0, 0, D), (0, H, 0), (W, 0, 0), wall,
                            nu, nu, 3.0, seed=3),                        # back -z
        make_displaced_wall((0, 0, 0), (W, 0, 0), (0, H, 0), wall,
                            nu, nu, 3.0, seed=4),                        # front +z
        make_displaced_wall((W, 0, 0), (0, 0, D), (0, H, 0), wall,
                            nu, nu, 3.0, seed=6),                        # right -x
    ]
    if windowed:
        # left wall with a rectangular window cut (y 120-280, z 0.3D-0.7D):
        # four displaced border panels; escaping rays see the sun/sky env
        # (the env-NEE benchmark configuration — benchmarks/envnee.py)
        y0, y1 = 120.0, 280.0
        z0, z1 = 0.3 * D, 0.7 * D
        nf = lambda f: max(4, int(nu * f))
        parts.extend([
            make_displaced_wall((0, 0, 0), (0, y0, 0), (0, 0, D), wall,
                                nf(y0 / H), nu, 3.0, seed=5),
            make_displaced_wall((0, y1, 0), (0, H - y1, 0), (0, 0, D), wall,
                                nf((H - y1) / H), nu, 3.0, seed=15),
            make_displaced_wall((0, y0, 0), (0, y1 - y0, 0), (0, 0, z0),
                                wall, nf((y1 - y0) / H), nf(z0 / D),
                                3.0, seed=25),
            make_displaced_wall((0, y0, z1), (0, y1 - y0, 0), (0, 0, D - z1),
                                wall, nf((y1 - y0) / H), nf((D - z1) / D),
                                3.0, seed=35),
        ])
    else:
        parts.append(
            make_displaced_wall((0, 0, 0), (0, H, 0), (0, 0, D), wall,
                                nu, nu, 3.0, seed=5))                    # left +x
    # ceiling lamp (faces down)
    parts.append(make_quad(
        (W * 0.35, H - 2, D * 0.35), (W * 0.65, H - 2, D * 0.35),
        (W * 0.65, H - 2, D * 0.65), (W * 0.35, H - 2, D * 0.65), light))

    # furniture: boxes (table, benches, hearth) + detailed props
    parts.append(make_box((W * 0.3, 0, D * 0.4), (W * 0.7, 55, D * 0.6), wood))
    parts.append(make_box((W * 0.1, 0, D * 0.7), (W * 0.25, 40, D * 0.95), wood))
    parts.append(make_box((W * 0.05, 0, D * 0.05), (W * 0.3, 140, D * 0.12), wall))
    parts.append(make_box((W * 0.88, 0, D * 0.15), (W * 0.98, 170, D * 0.5), wood))
    # mirror panel on a wall
    parts.append(make_quad((W - 1, 60, D * 0.55), (W - 1, 60, D * 0.85),
                           (W - 1, 200, D * 0.85), (W - 1, 200, D * 0.55),
                           mirror))
    # props: spheres on the table with remaining triangle budget
    used = sum(p.num_triangles for p in parts)
    remaining = max(0, num_triangles - used)
    n_props = 14
    tris_each = max(60, remaining // n_props)
    n_theta = max(6, int(np.sqrt(tris_each / 4)))
    prop_mats = [glass, metal, wood, mirror] + [
        s.add_material(HostMaterial(
            f"prop{i}", tuple(rng.uniform(0.25, 0.9, 3)),
            mtype=MaterialType.MICROFACET_PBR,
            roughness=float(rng.uniform(0.15, 0.8)),
            metallic=float(rng.uniform(0.0, 1.0)))) for i in range(6)]
    for i in range(n_props):
        r = rng.uniform(8, 20)
        cx = rng.uniform(W * 0.32, W * 0.68)
        cz = rng.uniform(D * 0.42, D * 0.58)
        parts.append(make_uv_sphere(
            (cx, 55 + r, cz), r, prop_mats[i % len(prop_mats)],
            n_theta=n_theta, n_phi=2 * n_theta))

    s.mesh = merge_meshes(parts)
    s.camera = Camera.build(
        resolution=resolution,
        position=(W * 0.5, H * 0.45, D * 0.06),
        look_at=(W * 0.5, H * 0.32, D * 0.7),
        up=(0.0, 1.0, 0.0),
        fovy_deg=50.0,
    )
    s.iterations = 16
    s.trace_depth = 8
    s.image_name = "fireplace_like"
    return s


def stress_interior(num_triangles: int = 143_000, resolution=(1920, 1080),
                    seed: int = 7) -> HostScene:
    """Benchmark stand-in for Fireplace Room: an enclosed room densely
    filled with random-material spheres and boxes totalling ~`num_triangles`
    triangles, one area light, mixed PBR/diffuse/reflect/refract materials
    in roughly the reference's proportions (README.md:34 — PBR 24421,
    diffuse 107572, reflection 10, refraction 11170)."""
    rng = np.random.default_rng(seed)
    s = HostScene()
    white = s.add_material(HostMaterial("walls", (0.7, 0.7, 0.7)))
    light = s.add_material(HostMaterial("lamp", (1.0, 0.9, 0.7), emittance=25.0))

    room = 1000.0
    parts = [make_box((0, 0, 0), (room, room * 0.6, room), white, flip=True)]
    # lamp normal must face down (-Y) toward the room
    parts.append(make_quad(
        (room * 0.4, room * 0.6 - 1, room * 0.4),
        (room * 0.6, room * 0.6 - 1, room * 0.4),
        (room * 0.6, room * 0.6 - 1, room * 0.6),
        (room * 0.4, room * 0.6 - 1, room * 0.6),
        light,
    ))

    # material pool with reference-like class mix
    pool = []
    for i in range(24):
        col = tuple(rng.uniform(0.2, 0.95, 3))
        r = float(rng.uniform(0.05, 0.9))
        met = float(rng.uniform(0.0, 1.0))
        pool.append(s.add_material(HostMaterial(
            f"pbr{i}", col, metallic=met, roughness=r, mtype=MaterialType.MICROFACET_PBR)))
    for i in range(96):
        col = tuple(rng.uniform(0.1, 0.95, 3))
        pool.append(s.add_material(HostMaterial(f"diff{i}", col)))
    pool.append(s.add_material(HostMaterial(
        "mirror", (0.95, 0.95, 0.95), mtype=MaterialType.SPECULAR_REFLECTION)))
    for i in range(12):
        pool.append(s.add_material(HostMaterial(
            f"glass{i}", (0.98, 0.98, 0.98), ior=1.5, mtype=MaterialType.SPECULAR_REFRACTION)))
    # class weights ~ reference proportions
    weights = [0.17 / 24] * 24 + [0.75 / 96] * 96 + [0.0001] + [0.078 / 12] * 12
    weights = np.array(weights) / np.sum(weights)

    tris_per_sphere = make_uv_sphere((0, 0, 0), 1.0, 0, n_theta=12, n_phi=18).num_triangles
    budget = num_triangles - sum(p.num_triangles for p in parts)
    n_spheres = max(1, budget // tris_per_sphere)
    for _ in range(n_spheres):
        c = rng.uniform(80, room - 80, 3)
        c[1] = rng.uniform(30, room * 0.6 - 60)
        rad = rng.uniform(12, 42)
        mat = int(rng.choice(pool, p=weights))
        parts.append(make_uv_sphere(tuple(c), rad, mat, n_theta=12, n_phi=18))

    s.mesh = merge_meshes(parts)
    s.camera = Camera.build(
        resolution=resolution,
        position=(room * 0.5, room * 0.3, room * 0.04),
        look_at=(room * 0.5, room * 0.26, room * 0.9),
        up=(0.0, 1.0, 0.0),
        fovy_deg=45.0,
    )
    s.iterations = 16
    s.trace_depth = 8
    s.image_name = "stress"
    return s
