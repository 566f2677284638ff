"""Minimal OBJ/MTL writer: procedural geometry written as an on-disk
scene for the CLI and the loader. Counterpart of `tpt/io/objwriter.py`
(the same text, line for line)."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..scene.host import HostMaterial
from ..scene.mesh import HostMesh
from ..scene.structs import MaterialType


def write_obj(path: str, mesh: HostMesh, materials: List[HostMaterial],
              mtl_name: Optional[str] = None) -> str:
    """Write mesh + per-triangle materials as OBJ + MTL pair."""
    base = os.path.splitext(path)[0]
    mtl_path = base + ".mtl"
    mtl_file = os.path.basename(mtl_path)

    with open(mtl_path, "w") as f:
        for m in materials:
            f.write(f"newmtl {m.name}\n")
            f.write(f"Kd {m.basecolor[0]:.6f} {m.basecolor[1]:.6f} {m.basecolor[2]:.6f}\n")
            if m.emittance > 0:
                ke = tuple(c * m.emittance for c in m.basecolor)
                f.write(f"Ke {ke[0]:.6f} {ke[1]:.6f} {ke[2]:.6f}\n")
            if m.mtype == MaterialType.MICROFACET_PBR:
                ns = max(0.0, (1.0 - m.roughness) ** 2 * 1000.0)
                f.write(f"Ns {ns:.2f}\n")
                f.write(f"Ks {m.metallic:.4f} {m.metallic:.4f} {m.metallic:.4f}\n")
            if m.mtype == MaterialType.SPECULAR_REFLECTION:
                f.write("Ks 1 1 1\nNs 10000\n")
            if m.mtype == MaterialType.SPECULAR_REFRACTION:
                f.write(f"Ni {m.ior:.4f}\nillum 7\nd 0.1\n")
            f.write("\n")

    with open(path, "w") as f:
        f.write(f"mtllib {mtl_file}\n")
        for p in mesh.positions:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for n in mesh.normals:
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for uv in mesh.uvs:
            f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
        # group faces by material for usemtl blocks
        order = np.argsort(mesh.material_ids, kind="stable")
        last_mat = None
        for t in order:
            mat = int(mesh.material_ids[t])
            if mat != last_mat:
                f.write(f"usemtl {materials[mat].name}\n")
                last_mat = mat
            i, j, k = (int(v) + 1 for v in mesh.indices[t])
            f.write(f"f {i}/{i}/{i} {j}/{j}/{j} {k}/{k}/{k}\n")
    return path
