"""Wavefront OBJ + MTL loader (numpy host code).

Counterpart of `tpt/scene/obj.py`: triangulated faces with negative
indices, per-object TRS transforms with inverse-transpose normals, the
MTL -> PBR conversion heuristics (emission -> area light, shininess ->
roughness, specular average -> metallic, illum 6/7 or ior + dissolve ->
refraction, texture presence -> MicrofacetPBR), textures into the atlas,
vertex dedup and tangents. The native parser of native/tpt_native.cpp
and the Python parser give the same mesh.

Textures are read by the port's PNG reader (`io.image.read_png`), where
tpt reads them with PIL: a missing or corrupt file gives texture id -1
as in tpt, and a valid image the reader does not decode raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.image import UnsupportedImage, read_png
from .host import HostMaterial, HostScene
from .mesh import (HostMesh, apply_transform, compute_smooth_normals,
                   compute_tangents, dedup_vertices)
from .structs import MaterialType
from .texture import AtlasBuilder


@dataclass
class MTLMaterial:
    name: str
    kd: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ke: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ns: float = 0.0          # shininess
    ni: float = 1.0          # ior
    d: float = 1.0           # dissolve (opacity)
    illum: int = 2
    map_kd: Optional[str] = None
    map_bump: Optional[str] = None
    map_pr: Optional[str] = None  # roughness/metallic map


def parse_mtl(path: str) -> Dict[str, MTLMaterial]:
    mats: Dict[str, MTLMaterial] = {}
    cur: Optional[MTLMaterial] = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = MTLMaterial(name=" ".join(parts[1:]))
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                cur.kd = tuple(float(x) for x in parts[1:4])
            elif key == "ks" and len(parts) >= 4:
                cur.ks = tuple(float(x) for x in parts[1:4])
            elif key == "ke" and len(parts) >= 4:
                cur.ke = tuple(float(x) for x in parts[1:4])
            elif key == "ns":
                cur.ns = float(parts[1])
            elif key == "ni":
                cur.ni = float(parts[1])
            elif key == "d":
                cur.d = float(parts[1])
            elif key == "tr":
                cur.d = 1.0 - float(parts[1])
            elif key == "illum":
                cur.illum = int(float(parts[1]))
            elif key == "map_kd":
                cur.map_kd = parts[-1]
            elif key in ("map_bump", "bump", "norm", "map_kn"):
                cur.map_bump = parts[-1]
            elif key in ("map_pr", "map_ns"):
                cur.map_pr = parts[-1]
    return mats


def mtl_to_pbr(m: MTLMaterial) -> HostMaterial:
    """MTL -> PBR conversion with the reference's heuristics."""
    out = HostMaterial(name=m.name)
    emission = max(m.ke)
    if emission > 0.0:
        # emissive: basecolor = normalized Ke, emittance = max component
        out.basecolor = tuple(c / emission for c in m.ke)
        out.emittance = emission
        out.mtype = MaterialType.DIFFUSE
        return out

    out.basecolor = m.kd
    out.ior = m.ni

    # shininess -> roughness
    rough = 1.0 - min(1.0, (m.ns / 1000.0) ** 0.5) if m.ns > 0 else 1.0
    out.roughness = max(0.01, rough)
    # specular average -> metallic proxy
    out.metallic = min(1.0, sum(m.ks) / 3.0)

    is_refractive = (m.illum in (6, 7)) or (m.ni > 1.01 and m.d < 1.0)
    has_texture = m.map_kd is not None or m.map_bump is not None

    if is_refractive:
        out.mtype = MaterialType.SPECULAR_REFRACTION
        out.basecolor = (0.98, 0.98, 0.98) if max(m.kd) < 0.05 else m.kd
    elif has_texture or out.metallic > 0.05 or out.roughness < 0.95:
        out.mtype = MaterialType.MICROFACET_PBR
    else:
        out.mtype = MaterialType.DIFFUSE
    # perfect mirror: high specular, tiny roughness, opaque
    if out.metallic > 0.95 and out.roughness <= 0.02 and not is_refractive:
        out.mtype = MaterialType.SPECULAR_REFLECTION
    return out


def _resolve_index(idx: int, count: int) -> int:
    return idx - 1 if idx > 0 else count + idx


def _register_mtl_files(mtl_files, obj_dir: str, scene: HostScene,
                        load_textures: bool) -> dict:
    """Parse MTL files, convert to PBR, register on the scene; returns
    {material name -> scene material id}."""
    lookup = {}
    for fname in mtl_files:
        mtl_path = os.path.join(obj_dir, fname)
        if not os.path.exists(mtl_path):
            continue
        for name, mtl in parse_mtl(mtl_path).items():
            hm = mtl_to_pbr(mtl)
            if load_textures:
                for attr, field_name in ((mtl.map_kd, "tex_diffuse"),
                                         (mtl.map_bump, "tex_normal"),
                                         (mtl.map_pr, "tex_metallic_roughness")):
                    if attr:
                        tid = load_texture_into_atlas(
                            scene.atlas, os.path.join(obj_dir, attr))
                        if tid >= 0:
                            setattr(hm, field_name, tid)
                            if field_name == "tex_diffuse":
                                hm.mtype = MaterialType.MICROFACET_PBR
            lookup[name] = scene.add_material(hm)
    return lookup


def load_obj(path: str, scene: HostScene, trs: Optional[np.ndarray] = None,
             material_override: Optional[int] = None,
             load_textures: bool = True, use_native: bool = True) -> HostMesh:
    """Parse an OBJ file into a HostMesh, registering materials and
    textures on `scene`; returns the mesh (the caller merges). The native
    parser runs unless `use_native` is False."""
    if use_native:
        from . import native as native_mod

        return _finish_native(native_mod.parse_obj_native(path), path, scene,
                              trs, material_override, load_textures)
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    tri_pos: List[Tuple[int, int, int]] = []
    tri_uv: List[Tuple[int, int, int]] = []
    tri_nrm: List[Tuple[int, int, int]] = []
    tri_mat: List[int] = []

    mtl_lookup: Dict[str, int] = {}
    current_mat = material_override if material_override is not None else -1
    obj_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                uvs.append((float(parts[1]),
                            float(parts[2]) if len(parts) > 2 else 0.0))
            elif key == "mtllib":
                mtl_lookup.update(_register_mtl_files(
                    [" ".join(parts[1:])], obj_dir, scene, load_textures))
            elif key == "usemtl":
                name = " ".join(parts[1:])
                if material_override is None:
                    current_mat = mtl_lookup.get(name, -1)
            elif key == "f":
                verts = []
                for spec in parts[1:]:
                    comps = spec.split("/")
                    vi = _resolve_index(int(comps[0]), len(positions))
                    ti = _resolve_index(int(comps[1]), len(uvs)) \
                        if len(comps) > 1 and comps[1] else -1
                    ni = _resolve_index(int(comps[2]), len(normals)) \
                        if len(comps) > 2 and comps[2] else -1
                    verts.append((vi, ti, ni))
                # triangulate fan
                for k in range(1, len(verts) - 1):
                    a, b, c = verts[0], verts[k], verts[k + 1]
                    tri_pos.append((a[0], b[0], c[0]))
                    tri_uv.append((a[1], b[1], c[1]))
                    tri_nrm.append((a[2], b[2], c[2]))
                    tri_mat.append(current_mat)

    if not tri_pos:
        return HostMesh.empty()

    pos_arr = np.asarray(positions, np.float32)
    nrm_arr = (np.asarray(normals, np.float32) if normals
               else np.zeros((0, 3), np.float32))
    uv_arr = np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32)

    # flatten corner attributes, then dedup
    t_pos = np.asarray(tri_pos, np.int64)
    t_uv = np.asarray(tri_uv, np.int64)
    t_nrm = np.asarray(tri_nrm, np.int64)
    nv = t_pos.size
    flat_pos = pos_arr[t_pos.ravel()]
    flat_uv = np.where(
        (t_uv.ravel() >= 0)[:, None],
        uv_arr[np.clip(t_uv.ravel(), 0, max(len(uvs) - 1, 0))] if len(uvs)
        else np.zeros((nv, 2), np.float32),
        0.0,
    ).astype(np.float32)
    have_nrm = (t_nrm.ravel() >= 0) & (len(normals) > 0)
    flat_nrm = np.where(
        have_nrm[:, None],
        nrm_arr[np.clip(t_nrm.ravel(), 0, max(len(normals) - 1, 0))]
        if len(normals) else np.zeros((nv, 3), np.float32),
        0.0,
    ).astype(np.float32)

    indices = np.arange(nv, dtype=np.int32).reshape(-1, 3)
    # fill missing normals with smooth normals
    if not have_nrm.all():
        smooth = compute_smooth_normals(flat_pos, indices)
        flat_nrm = np.where(have_nrm[:, None], flat_nrm, smooth)

    p2, n2, uv2, idx2 = dedup_vertices(flat_pos, flat_nrm, flat_uv, indices)

    if trs is not None:
        p2, n2 = apply_transform(p2, n2, trs)

    tangents = compute_tangents(p2, n2, uv2, idx2)

    mat_ids = np.asarray(tri_mat, np.int32)
    mat_ids = np.where(mat_ids < 0,
                       material_override if material_override is not None else 0,
                       mat_ids)
    return HostMesh(
        positions=p2, normals=n2, uvs=uv2, tangents=tangents,
        indices=idx2, material_ids=mat_ids,
    )


def _finish_native(parsed, path: str, scene: HostScene, trs,
                   material_override, load_textures) -> HostMesh:
    """Post-processing of the native parser's output."""
    pos, nrm, uv, idx, mat_local, names, mtl_files = parsed
    if idx.shape[0] == 0:
        return HostMesh.empty()
    obj_dir = os.path.dirname(os.path.abspath(path))
    lookup = _register_mtl_files(mtl_files, obj_dir, scene, load_textures)

    if material_override is not None:
        mat_ids = np.full((idx.shape[0],), material_override, np.int32)
    else:
        remap = np.array(
            [lookup.get(n, 0) for n in names] or [0], np.int32)
        mat_ids = np.where(mat_local >= 0,
                           remap[np.clip(mat_local, 0, len(remap) - 1)],
                           0).astype(np.int32)

    # fill missing normals (zero vectors) with smooth normals
    missing = ~np.any(nrm != 0.0, axis=-1)
    if missing.any():
        smooth = compute_smooth_normals(pos, idx)
        nrm = np.where(missing[:, None], smooth, nrm)

    if trs is not None:
        pos, nrm = apply_transform(pos, nrm, trs)
    tangents = compute_tangents(pos, nrm, uv, idx)
    return HostMesh(positions=pos, normals=nrm, uvs=uv, tangents=tangents,
                    indices=idx, material_ids=mat_ids)


def load_texture_into_atlas(atlas: AtlasBuilder, path: str) -> int:
    """Load a PNG texture into the atlas; -1 if the file is missing or
    unreadable (as in tpt). A valid image the port's reader does not
    decode raises `io.image.UnsupportedImage`."""
    if not os.path.exists(path):
        return -1
    try:
        img = read_png(path).astype(np.float32) / 255.0
    except UnsupportedImage:
        raise
    except (OSError, ValueError):
        return -1
    return atlas.add(img, path=os.path.abspath(path))
