"""Host-side scene container and the upload to the device `SceneData`.

Counterpart of `tpt/scene/host.py` for this slice: materials, mesh,
camera, and `build(with_bvh=True)` with the native binned-SAH builder,
the arity-4 wide packet pack and, on a wide pack, the treelet cut and the
dense-sweep tables of BVH_SWEEP. The port has no triangle streaming (the
triangle table lives in GPU memory at any size) and no prep cache yet."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import List, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..device import DeviceLike, resolve_device
from .lights import build_light_cdf
from .mesh import HostMesh, finalize_mesh
from .structs import (EnvMap, LightData, MaterialTable, MaterialType,
                      SceneData, TextureAtlas)


@dataclass
class HostMaterial:
    name: str = ""
    basecolor: tuple = (1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 1.0
    emittance: float = 0.0
    ior: float = 1.5
    mtype: MaterialType = MaterialType.DIFFUSE
    tex_diffuse: int = -1
    tex_metallic_roughness: int = -1
    tex_normal: int = -1


def material_rows(mats: List[HostMaterial]) -> np.ndarray:
    """[M, 16] f32 packed material rows: basecolor xyz, metallic,
    roughness, emittance, ior, mtype, tex ids (as floats), pad."""
    mat_packed = np.zeros((len(mats), 16), np.float32)
    for i, m in enumerate(mats):
        mat_packed[i, 0:3] = m.basecolor
        mat_packed[i, 3:8] = (m.metallic, m.roughness, m.emittance,
                              m.ior, float(int(m.mtype)))
        mat_packed[i, 8:11] = (float(m.tex_diffuse),
                               float(m.tex_metallic_roughness),
                               float(m.tex_normal))
    return mat_packed


def light_rows(mesh: HostMesh, mats: List[HostMaterial],
               tri_idx: np.ndarray) -> np.ndarray:
    """[L, 16] f32 packed light rows: v0, v1, v2, face normal, Le."""
    idx = mesh.indices[tri_idx]
    vp = mesh.positions
    v0, v1, v2 = vp[idx[:, 0]], vp[idx[:, 1]], vp[idx[:, 2]]
    ln = np.cross(v1 - v0, v2 - v0)
    ln /= np.maximum(np.linalg.norm(ln, axis=-1, keepdims=True), 1e-20)
    lmid = mesh.material_ids[tri_idx]
    le = np.array([np.float32(mats[i].basecolor) * np.float32(mats[i].emittance)
                   for i in lmid], np.float32)
    lpacked = np.zeros((tri_idx.shape[0], 16), np.float32)
    lpacked[:, 0:3] = v0
    lpacked[:, 3:6] = v1
    lpacked[:, 6:9] = v2
    lpacked[:, 9:12] = ln
    lpacked[:, 12:15] = le
    return lpacked


@dataclass
class HostScene:
    mesh: HostMesh = dfield(default_factory=HostMesh.empty)
    materials: List[HostMaterial] = dfield(default_factory=list)
    camera: Optional[Camera] = None
    iterations: int = 120
    trace_depth: int = 8
    image_name: str = "render"

    def add_material(self, m: HostMaterial) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def material_id(self, name: str) -> int:
        for i, m in enumerate(self.materials):
            if m.name == name:
                return i
        raise KeyError(f"unknown material {name!r}")

    def emittances(self) -> np.ndarray:
        return np.array([m.emittance for m in self.materials] or [0.0], np.float32)

    def build(self, with_bvh: bool = False, max_cluster: int = 16,
              packet_arity: int = 4, treelet_max_tris: int = 256,
              sweep_chunk_align: int = 4,
              device: DeviceLike = None) -> SceneData:
        """Upload everything to `device` (the CUDA card unless the caller
        asks for another); with_bvh builds the binned-SAH BVH with the
        native builder and collapses it into the packet pack (arity 4/8
        wide, or 2 for the binary layout). A wide pack also gets the
        treelet cut (treelets of <= treelet_max_tris triangles) and the
        sweep tables (chunk counts rounded to sweep_chunk_align)."""
        dev = resolve_device(device)
        mats = self.materials or [HostMaterial()]
        mat_packed = material_rows(mats)
        table = MaterialTable.from_packed(torch.as_tensor(mat_packed, device=dev))
        lights = build_light_cdf(self.mesh, self.emittances(), device=dev)
        if lights.num_lights > 0:
            ltri = lights.tri_idx.cpu().numpy()
            lights = LightData(
                tri_idx=lights.tri_idx, cdf=lights.cdf, areas=lights.areas,
                total_area=lights.total_area,
                packed=torch.as_tensor(light_rows(self.mesh, mats, ltri),
                                       device=dev))
        mesh = finalize_mesh(self.mesh, mat_packed=mat_packed, device=dev)
        pack = sweep = None
        if with_bvh:
            from ..bvh.pack import build_packet_bvh, build_packet_bvh_wide
            from ..bvh.sah import build_sah_bvh

            bvh = build_sah_bvh(self.mesh)
            if packet_arity > 2:
                from ..bvh.treelet import attach_treelets, sweep_tables

                pack = attach_treelets(
                    build_packet_bvh_wide(self.mesh, bvh,
                                          max_cluster=max_cluster,
                                          arity=packet_arity),
                    max_tris=treelet_max_tris)
                sweep = sweep_tables(pack, chunk_align=sweep_chunk_align).to(dev)
            else:
                pack = build_packet_bvh(self.mesh, bvh, max_cluster=max_cluster)
            pack = pack.to(dev)
        return SceneData(mesh=mesh, materials=table, lights=lights,
                         atlas=TextureAtlas.empty(), env=EnvMap.disabled(),
                         pack=pack, sweep=sweep)
