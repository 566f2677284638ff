"""The reference's scene: every table the renderer needs, worked out
again from the raw triangle mesh and material list (positions, vertex
normals, indices, material ids, material fields) with the same float32
numpy arithmetic as the program's host build, so both sides shade with
equal numbers. Nothing here comes from the program's device scene."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import lbvh, walk


@dataclass
class RefScene:
    p0: torch.Tensor          # [T, 3] corners
    p1: torch.Tensor
    p2: torch.Tensor
    geo_n: torch.Tensor       # [T, 3] unit face normals
    vn: torch.Tensor          # [T, 9] the three corners' vertex normals
    mat_id: torch.Tensor      # [T] int64
    mat_rows: torch.Tensor    # [M, 16] packed material rows
    light_cdf: torch.Tensor   # [L]
    light_rows: torch.Tensor  # [L, 16]: v0, v1, v2, normal, Le
    light_total_area: torch.Tensor
    tables: walk.Tables

    @property
    def num_lights(self) -> int:
        return int(self.light_rows.shape[0])


def material_rows(materials) -> np.ndarray:
    """[M, 16] f32: basecolor xyz, metallic, roughness, emittance, ior,
    material class, texture ids (-1: none)."""
    rows = np.zeros((len(materials), 16), np.float32)
    for i, m in enumerate(materials):
        rows[i, 0:3] = m["basecolor"]
        rows[i, 3:8] = (m["metallic"], m["roughness"], m["emittance"],
                        m["ior"], float(m["mtype"]))
        rows[i, 8:11] = (-1.0, -1.0, -1.0)
    return rows


def build(raw: dict, device, quantize=None) -> RefScene:
    """`raw`: positions [V, 3] f32, normals [V, 3] f32, indices [T, 3],
    material_ids [T], materials (dicts of basecolor, metallic, roughness,
    emittance, ior, mtype). `quantize`, if given, rounds every float
    table the casts and the shading read (the precision control)."""
    q = quantize or (lambda a: a)
    pos = np.asarray(raw["positions"], np.float32)
    nrm = np.asarray(raw["normals"], np.float32)
    idx = np.asarray(raw["indices"]).astype(np.int64)
    mid = np.asarray(raw["material_ids"]).astype(np.int64)
    mats = raw["materials"]
    if len(mats) == 0:
        raise ValueError("the reference needs the scene's materials")
    rows = material_rows(mats)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    geo_n = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                            1e-20)).astype(np.float32)

    # emissive triangles: uniform-area CDF, as the program's light table
    emit = np.array([m["emittance"] for m in mats], np.float32)
    ltri = np.nonzero(emit[mid] > 0.0)[0]
    if ltri.size == 0:
        raise ValueError("the reference renders scenes with area lights")
    areas = 0.5 * np.linalg.norm(np.cross(v1[ltri] - v0[ltri],
                                          v2[ltri] - v0[ltri]), axis=-1)
    total = float(areas.sum())
    cdf = np.cumsum(areas) / max(total, 1e-20)
    cdf[-1] = 1.0
    ln = np.cross(v1[ltri] - v0[ltri], v2[ltri] - v0[ltri])
    ln /= np.maximum(np.linalg.norm(ln, axis=-1, keepdims=True), 1e-20)
    le = np.array([np.float32(mats[i]["basecolor"])
                   * np.float32(mats[i]["emittance"]) for i in mid[ltri]],
                  np.float32)
    lrows = np.zeros((ltri.size, 16), np.float32)
    lrows[:, 0:3], lrows[:, 3:6], lrows[:, 6:9] = v0[ltri], v1[ltri], v2[ltri]
    lrows[:, 9:12], lrows[:, 12:15] = ln, le

    f32 = lambda a: q(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                      device=device))
    p0, p1, p2 = f32(v0), f32(v1), f32(v2)
    bvh = lbvh.build_lbvh(p0, p1, p2)
    return RefScene(
        p0=p0, p1=p1, p2=p2, geo_n=f32(geo_n),
        vn=f32(np.concatenate([nrm[idx[:, 0]], nrm[idx[:, 1]],
                               nrm[idx[:, 2]]], 1)),
        mat_id=torch.as_tensor(mid, device=device),
        mat_rows=torch.as_tensor(rows, device=device),
        light_cdf=torch.as_tensor(cdf.astype(np.float32), device=device),
        light_rows=f32(lrows),
        light_total_area=torch.tensor(float(np.float32(total)),
                                      dtype=torch.float32, device=device),
        tables=walk.tables(bvh, p0, p1, p2))
