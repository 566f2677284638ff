"""Emissive-triangle light table: area CDF build (host) and lane-parallel
sampling (device). Counterpart of `tpt/scene/lights.py`: uniform-area
pick via a CDF search, sqrt-uniform barycentrics, pdf_area = 1/area."""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.vec import Vec3
from .mesh import HostMesh
from .structs import LightData, MeshData


def light_cdf_arrays(mesh: HostMesh, emittance_per_material: np.ndarray):
    """Host: (tri_idx int32, cdf f32, areas f32, total_area f32) over the
    emissive triangles; one dummy entry with zero area when none."""
    emissive_mask = emittance_per_material[mesh.material_ids] > 0.0
    tri_idx = np.nonzero(emissive_mask)[0].astype(np.int32)
    if tri_idx.size == 0:
        return (np.zeros((1,), np.int32), np.ones((1,), np.float32),
                np.zeros((1,), np.float32), np.float32(0.0))
    idx = mesh.indices[tri_idx]
    v0 = mesh.positions[idx[:, 0]]
    v1 = mesh.positions[idx[:, 1]]
    v2 = mesh.positions[idx[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = float(areas.sum())
    cdf = np.cumsum(areas) / max(total, 1e-20)
    cdf[-1] = 1.0
    return (tri_idx, cdf.astype(np.float32), areas.astype(np.float32),
            np.float32(total))


def build_light_cdf(mesh: HostMesh, emittance_per_material: np.ndarray, *,
                    device) -> LightData:
    tri_idx, cdf, areas, total = light_cdf_arrays(mesh, emittance_per_material)
    return LightData(
        tri_idx=torch.as_tensor(tri_idx.astype(np.int64), device=device),
        cdf=torch.as_tensor(cdf, device=device),
        areas=torch.as_tensor(areas, device=device),
        total_area=torch.tensor(float(total), dtype=torch.float32,
                                device=device))


def sample_light(mesh: MeshData, lights: LightData, state: torch.Tensor):
    """Per-lane area sampling of the light set.

    Returns (state, point, normal, pdf_area, light_tri, Le or None)."""
    state, r1 = rng.rand_float(state)
    state, r2 = rng.rand_float(state)
    state, r3 = rng.rand_float(state)

    num_lights = lights.cdf.shape[0]
    cdf_idx = torch.searchsorted(lights.cdf, r1, side="left").clamp(
        0, num_lights - 1)
    tri = lights.tri_idx[cdf_idx]

    sqrt_r2 = torch.sqrt(r2)
    b_u = 1.0 - sqrt_r2
    b_v = r3 * sqrt_r2
    b_w = 1.0 - b_u - b_v

    if lights.packed is not None:
        row = lights.packed[cdf_idx]
        v0 = Vec3(row[:, 0], row[:, 1], row[:, 2])
        v1 = Vec3(row[:, 3], row[:, 4], row[:, 5])
        v2 = Vec3(row[:, 6], row[:, 7], row[:, 8])
        normal = Vec3(row[:, 9], row[:, 10], row[:, 11])
        le = Vec3(row[:, 12], row[:, 13], row[:, 14])
    else:
        v0, v1, v2 = mesh.tri_vertices(tri)
        normal = (v1 - v0).cross(v2 - v0).normalize()
        le = None

    point = v0 * b_u + v1 * b_v + v2 * b_w
    pdf_area = torch.ones_like(r1) / torch.clamp_min(lights.total_area, 1e-20)
    return state, point, normal, pdf_area, tri, le
