"""Host-side (numpy) mesh assembly and the upload to `MeshData`.

Counterpart of `tpt/scene/mesh.py`: TRS transforms with
inverse-transpose normals, per-vertex tangents from UVs, exact-bits
vertex dedup and mesh merging, in the same numpy arithmetic (so the
tables equal the JAX package's bit for bit), then tensors on the
requested device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.vec import Vec3
from .structs import MeshData


@dataclass
class HostMesh:
    """Mutable numpy triangle mesh being assembled on the host."""

    positions: np.ndarray  # [V, 3] f32
    normals: np.ndarray    # [V, 3] f32
    uvs: np.ndarray        # [V, 2] f32
    tangents: np.ndarray   # [V, 3] f32
    indices: np.ndarray    # [T, 3] int32
    material_ids: np.ndarray  # [T] int32

    @staticmethod
    def empty() -> "HostMesh":
        return HostMesh(
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32),
            np.zeros((0, 2), np.float32),
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0,), np.int32),
        )

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])


def apply_transform(positions: np.ndarray, normals: np.ndarray, trs: np.ndarray):
    """Apply 4x4 TRS to positions and inverse-transpose to normals."""
    p = positions @ trs[:3, :3].T + trs[:3, 3]
    inv_t = np.linalg.inv(trs[:3, :3]).T
    n = normals @ inv_t.T
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(lens, 1e-20)
    return p.astype(np.float32), n.astype(np.float32)


def compute_geometric_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(lens, 1e-20)).astype(np.float32)


def compute_smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for meshes without authored normals."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(lens, 1e-20)).astype(np.float32)


def compute_tangents(positions, normals, uvs, indices) -> np.ndarray:
    """Per-vertex tangents from UV derivatives, accumulated over faces and
    Gram-Schmidt orthogonalized against the normal."""
    if uvs.size == 0 or not np.any(uvs):
        return np.zeros_like(positions)
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    w0, w1, w2 = (uvs[indices[:, k]] for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    du1, dv1 = w1[:, 0] - w0[:, 0], w1[:, 1] - w0[:, 1]
    du2, dv2 = w2[:, 0] - w0[:, 0], w2[:, 1] - w0[:, 1]
    det = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    t = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    tangents = np.zeros_like(positions)
    for k in range(3):
        np.add.at(tangents, indices[:, k], t)
    # orthogonalize
    d = np.sum(tangents * normals, axis=-1, keepdims=True)
    tangents = tangents - normals * d
    lens = np.linalg.norm(tangents, axis=-1, keepdims=True)
    return np.where(lens > 1e-12, tangents / np.maximum(lens, 1e-20),
                    0.0).astype(np.float32)


def dedup_vertices(positions, normals, uvs, indices):
    """Merge identical (position, normal, uv) vertices, compared as exact
    bits, through one np.unique over the rows (vertices in the order of
    their rows' bytes, as tpt's)."""
    rows = np.concatenate([positions, normals, uvs], axis=-1)
    view = np.ascontiguousarray(rows).view(
        np.dtype((np.void, rows.dtype.itemsize * rows.shape[1]))
    ).ravel()
    _, first_idx, inverse = np.unique(view, return_index=True,
                                      return_inverse=True)
    new_positions = positions[first_idx]
    new_normals = normals[first_idx]
    new_uvs = uvs[first_idx]
    new_indices = inverse[indices].astype(np.int32)
    return new_positions, new_normals, new_uvs, new_indices


def merge_meshes(meshes: List[HostMesh]) -> HostMesh:
    if not meshes:
        return HostMesh.empty()
    offset = 0
    pos, nor, uv, tan, idx, mid = [], [], [], [], [], []
    for m in meshes:
        pos.append(m.positions)
        nor.append(m.normals)
        uv.append(m.uvs)
        tan.append(m.tangents)
        idx.append(m.indices + offset)
        mid.append(m.material_ids)
        offset += m.positions.shape[0]
    return HostMesh(
        positions=np.concatenate(pos).astype(np.float32),
        normals=np.concatenate(nor).astype(np.float32),
        uvs=np.concatenate(uv).astype(np.float32),
        tangents=np.concatenate(tan).astype(np.float32),
        indices=np.concatenate(idx).astype(np.int32),
        material_ids=np.concatenate(mid).astype(np.int32),
    )


def shade_rows(m: HostMesh, mat_packed: np.ndarray = None):
    """The packed shading rows of `tpt.scene.mesh.finalize_mesh`, in
    numpy: (geom normals [T,3], shade_tri [T,8], shade_vtx [V,8],
    shade_hit [T,40] or None). shade_hit is the fully de-normalized hit
    row: matid (int32 bit-cast) | geom normal | the three vertices'
    normal, tangent, uv | material fields 0:11 of mat_packed | pad."""
    geo_n = compute_geometric_normals(m.positions, m.indices)
    t = m.indices.shape[0]
    v = m.positions.shape[0]
    shade_tri = np.zeros((t, 8), np.float32)
    shade_tri[:, 0:3] = m.indices.astype(np.int32).view(np.float32)
    shade_tri[:, 3] = m.material_ids.astype(np.int32).view(np.float32)
    shade_tri[:, 4:7] = geo_n
    shade_vtx = np.zeros((v, 8), np.float32)
    shade_vtx[:, 0:3] = m.normals
    shade_vtx[:, 3:6] = m.tangents
    shade_vtx[:, 6] = m.uvs[:, 0]
    shade_vtx[:, 7] = m.uvs[:, 1]

    shade_hit = None
    if mat_packed is not None:
        shade_hit = np.zeros((t, 40), np.float32)
        shade_hit[:, 0] = m.material_ids.astype(np.int32).view(np.float32)
        shade_hit[:, 1:4] = geo_n
        if t:
            shade_hit[:, 4:12] = shade_vtx[m.indices[:, 0]]
            shade_hit[:, 12:20] = shade_vtx[m.indices[:, 1]]
            shade_hit[:, 20:28] = shade_vtx[m.indices[:, 2]]
            mid = np.clip(m.material_ids, 0, mat_packed.shape[0] - 1)
            shade_hit[:, 28:39] = mat_packed[mid, 0:11]
    return geo_n, shade_tri, shade_vtx, shade_hit


def mesh_from_arrays(positions, normals, tangents, uv_u, uv_v, indices,
                     material_ids, geom_normals, shade_tri=None,
                     shade_vtx=None, shade_hit=None, *, device) -> MeshData:
    """MeshData on `device` from numpy arrays (shared by finalize_mesh and
    scene.convert.from_numpy_scene)."""
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32),
                                    device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64),
                                    device=device)
    opt = lambda a: None if a is None else f32(a)
    idx = np.asarray(indices).reshape(-1, 3)
    return MeshData(
        positions=Vec3.from_stacked(f32(positions)),
        normals=Vec3.from_stacked(f32(normals)),
        tangents=Vec3.from_stacked(f32(tangents)),
        uv_u=f32(uv_u),
        uv_v=f32(uv_v),
        i0=i64(idx[:, 0]),
        i1=i64(idx[:, 1]),
        i2=i64(idx[:, 2]),
        material_ids=i64(material_ids),
        geom_normals=Vec3.from_stacked(f32(geom_normals)),
        shade_tri=opt(shade_tri),
        shade_vtx=opt(shade_vtx),
        shade_hit=opt(shade_hit),
    )


def finalize_mesh(m: HostMesh, mat_packed: np.ndarray = None, *,
                  device) -> MeshData:
    """Upload a HostMesh to `device`; with `mat_packed` (the scene's
    [M, 16] material rows) also build `shade_hit`, so the per-bounce
    shade fetch is one row gather."""
    geo_n, shade_tri, shade_vtx, shade_hit = shade_rows(m, mat_packed)
    return mesh_from_arrays(
        m.positions, m.normals, m.tangents, m.uvs[:, 0], m.uvs[:, 1],
        m.indices, m.material_ids, geo_n, shade_tri, shade_vtx, shade_hit,
        device=device)
