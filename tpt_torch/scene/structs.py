"""Device-side scene data as torch tensors.

Counterpart of `tpt/scene/structs.py`: the same fields and the same
packed row layouts (`MeshData.shade_hit [T,40]`, `MaterialTable.packed
[M,16]`, `LightData.packed [L,16]`), with every vec3 an SoA `Vec3`. The
tables of this slice live on one device; `SceneData.device` names it.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

import torch

from ..core.vec import Vec3


class MaterialType(IntEnum):
    # same ordering as tpt.scene.structs.MaterialType
    MICROFACET_PBR = 0
    DIFFUSE = 1
    SPECULAR_REFLECTION = 2
    SPECULAR_REFRACTION = 3


@dataclass(frozen=True)
class MeshData:
    """Triangle soup for the whole scene, SoA over vertices/triangles."""

    positions: Vec3        # [V]
    normals: Vec3          # [V] shading normals
    tangents: Vec3         # [V]
    uv_u: torch.Tensor     # [V] f32
    uv_v: torch.Tensor     # [V] f32
    i0: torch.Tensor       # [T] int64 triangle vertex indices
    i1: torch.Tensor
    i2: torch.Tensor
    material_ids: torch.Tensor  # [T] int64
    geom_normals: Vec3          # [T] face normals
    shade_tri: torch.Tensor = None  # [T, 8] f32 (ints bit-cast)
    shade_vtx: torch.Tensor = None  # [V, 8] f32
    shade_hit: torch.Tensor = None  # [T, 40] f32 de-normalized hit row

    @property
    def num_triangles(self) -> int:
        return int(self.i0.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.uv_u.shape[0])

    def tri_vertices(self, tri_idx: torch.Tensor):
        """Gather the three corner positions of triangles `tri_idx`."""
        t = tri_idx.clamp(0, self.num_triangles - 1)
        return (self.positions.take(self.i0[t]), self.positions.take(self.i1[t]),
                self.positions.take(self.i2[t]))


@dataclass(frozen=True)
class MaterialTable:
    """SoA over materials plus the packed [M, 16] row table."""

    basecolor: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    emittance: torch.Tensor
    ior: torch.Tensor
    mtype: torch.Tensor          # int64 (MaterialType)
    tex_diffuse: torch.Tensor    # int64, -1 = none
    tex_metallic_roughness: torch.Tensor
    tex_normal: torch.Tensor
    packed: torch.Tensor = None
    any_tex_diffuse: bool = False
    any_tex_mr: bool = False
    any_tex_normal: bool = False

    @property
    def num_materials(self) -> int:
        return int(self.metallic.shape[0])

    @staticmethod
    def from_packed(packed: torch.Tensor) -> "MaterialTable":
        """Per-field columns from the packed rows (the same float
        encodings host.build writes)."""
        col = lambda c: packed[:, c].contiguous()
        ints = lambda c: packed[:, c].to(torch.int64)
        tex_d, tex_mr, tex_n = ints(8), ints(9), ints(10)
        return MaterialTable(
            basecolor=Vec3(col(0), col(1), col(2)),
            metallic=col(3), roughness=col(4), emittance=col(5), ior=col(6),
            mtype=ints(7), tex_diffuse=tex_d, tex_metallic_roughness=tex_mr,
            tex_normal=tex_n, packed=packed.contiguous(),
            any_tex_diffuse=bool((tex_d >= 0).any()),
            any_tex_mr=bool((tex_mr >= 0).any()),
            any_tex_normal=bool((tex_n >= 0).any()))


@dataclass(frozen=True)
class LightData:
    """Emissive-triangle table + area CDF for NEE."""

    tri_idx: torch.Tensor    # [L] int64
    cdf: torch.Tensor        # [L] f32 normalized area CDF (last = 1)
    areas: torch.Tensor      # [L] f32
    total_area: torch.Tensor  # 0-dim f32
    # [L, 16] f32: v0, v1, v2, face normal, emitted radiance Le
    packed: torch.Tensor = None

    @property
    def num_lights(self) -> int:
        return int(self.tri_idx.shape[0])


@dataclass(frozen=True)
class TextureAtlas:
    """Texture atlas placeholder: this slice of the port renders
    untextured scenes, so the atlas is always empty."""

    num_textures: int = 0

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas()


@dataclass(frozen=True)
class EnvMap:
    """Environment map placeholder: this slice renders scenes without an
    environment (escaping paths carry no radiance)."""

    enabled: bool = False

    @staticmethod
    def disabled() -> "EnvMap":
        return EnvMap(enabled=False)


@dataclass(frozen=True)
class SceneData:
    """Everything the integrators need."""

    mesh: MeshData
    materials: MaterialTable
    lights: LightData
    atlas: TextureAtlas
    env: EnvMap
    pack: Optional["object"] = None  # bvh.pack.PacketBVH, BVH_PALLAS
    sweep: Optional["object"] = None  # bvh.treelet.SweepTables, BVH_SWEEP

    @property
    def device(self) -> torch.device:
        return self.mesh.i0.device
