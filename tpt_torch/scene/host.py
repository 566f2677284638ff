"""Host-side scene container and the upload to the device `SceneData`.

Counterpart of `tpt/scene/host.py`: materials, mesh, camera, the texture
atlas and the environment map (the output of the JSON/OBJ loaders or the
procedural builders), and `build(with_bvh=True)` with the native
binned-SAH builder or the LBVH builder on the device, the arity-4 wide
packet pack and, on a wide pack, the treelet cut and the dense-sweep
tables of BVH_SWEEP, through the disk cache of `scene/prepcache.py`. The
port has no triangle streaming (the triangle table lives in GPU memory
at any size)."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import List, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..device import DeviceLike, resolve_device
from .lights import build_light_cdf
from .mesh import HostMesh, finalize_mesh
from .structs import EnvMap, LightData, MaterialTable, MaterialType, SceneData
from .texture import AtlasBuilder


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
    atlas: AtlasBuilder = dfield(default_factory=AtlasBuilder)
    env_map: Optional[EnvMap] = None  # envmap.load_envmap, any device
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

    # below this many triangles a build is faster than a disk round trip
    # (and tests make many small scenes): no cache
    PREP_CACHE_MIN_TRIS = 10_000

    def build(self, with_bvh: bool = False, bvh_builder: str = "auto",
              max_cluster: int = 16, packet_arity: int = 4,
              treelet_max_tris: int = 256, sweep_chunk_align: int = 4,
              prep_cache: bool = True,
              device: DeviceLike = None) -> SceneData:
        """Upload everything to `device` (the CUDA card unless the caller
        asks for another). with_bvh builds the binary BVH, "sah" by the
        native binned-SAH builder, "lbvh" by the morton/Karras builder on
        the device, "auto" SAH when the native library loads, and
        collapses it into the packet pack (arity 4/8 wide, or 2 for the
        binary layout). A wide pack also gets the treelet cut (treelets
        of <= treelet_max_tris triangles) and the sweep tables (chunk
        counts rounded to sweep_chunk_align). With prep_cache, scenes of
        PREP_CACHE_MIN_TRIS triangles or more keep their tables in the
        disk cache of `scene/prepcache.py`."""
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
        bvh = pack = sweep = None
        if with_bvh:
            bvh, pack, sweep = self._tables(
                mesh, dev, bvh_builder, prep_cache, dict(
                    max_cluster=max_cluster, packet_arity=packet_arity,
                    treelet_max_tris=treelet_max_tris,
                    sweep_chunk_align=sweep_chunk_align))
        env = (self.env_map.to(dev) if self.env_map is not None
               else EnvMap.disabled(dev))
        return SceneData(mesh=mesh, materials=table, lights=lights,
                         atlas=self.atlas.build(dev), env=env, bvh=bvh,
                         pack=pack, sweep=sweep)

    def _tables(self, mesh, dev, bvh_builder: str, prep_cache: bool,
                params: dict) -> tuple:
        """(bvh, pack, sweep) on `dev`, from the disk cache or built."""
        from . import native, prepcache

        if bvh_builder not in ("auto", "sah", "lbvh"):
            raise ValueError(f"bvh_builder must be auto, sah or lbvh, got "
                             f"{bvh_builder!r}")
        builder = bvh_builder
        if builder == "auto":
            builder = "sah" if native.available() else "lbvh"
        key = None
        if prep_cache and self.mesh.num_triangles >= self.PREP_CACHE_MIN_TRIS:
            key = prepcache.fingerprint(self.mesh, builder=builder, **params)
            cached = prepcache.load(key, dev)
            if cached is None and bvh_builder == "auto" and builder != "sah":
                # cached SAH tables need no native library to load
                sah_key = prepcache.fingerprint(self.mesh, builder="sah",
                                                **params)
                cached = prepcache.load(sah_key, dev)
            if cached is not None:
                return cached
        tables = self._build_tables(mesh, dev, builder, **params)
        if key is not None:
            prepcache.store(key, tables)
        return tables

    def _build_tables(self, mesh, dev, builder: str, max_cluster: int,
                      packet_arity: int, treelet_max_tris: int,
                      sweep_chunk_align: int) -> tuple:
        from ..bvh.pack import build_packet_bvh, build_packet_bvh_wide

        if builder == "sah":
            from ..bvh.sah import build_sah_bvh

            bvh = build_sah_bvh(self.mesh, device=dev)
        else:
            from ..bvh.build import build_lbvh

            bvh = build_lbvh(mesh)
        sweep = None
        if packet_arity > 2:
            from ..bvh.treelet import attach_treelets, sweep_tables

            pack = attach_treelets(
                build_packet_bvh_wide(self.mesh, bvh, max_cluster=max_cluster,
                                      arity=packet_arity),
                max_tris=treelet_max_tris)
            sweep = sweep_tables(pack, chunk_align=sweep_chunk_align).to(dev)
        else:
            pack = build_packet_bvh(self.mesh, bvh, max_cluster=max_cluster)
        return bvh, pack.to(dev), sweep
