"""JSON scene loader, the reference's schema:

{
  "Camera":   {RES, FOVY, ITERATIONS, DEPTH, FILE, EYE, LOOKAT, UP},
  "Materials": {name: {basecolor, metallic, roughness, emittance, ior, Type,
                       diffuse_texture?, normal_texture?,
                       metallic_roughness_texture?}},
  "Environment Texture": {FILE},
  "Objects": [{TRANS, ROTAT, SCALE, FILE, MATERIAL?}]
}

Counterpart of `tpt/scene/loader.py`. `load_scene` returns a host scene:
the mesh, materials and atlas in numpy, the environment map in host
memory; `HostScene.build(device=...)` uploads them.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

from ..core.camera import Camera
from ..core.mathutil import build_trs_matrix
from .host import HostMaterial, HostScene
from .mesh import merge_meshes
from .obj import load_obj, load_texture_into_atlas
from .structs import MaterialType

_TYPE_NAMES = {
    "microfacetpbr": MaterialType.MICROFACET_PBR,
    "pbr": MaterialType.MICROFACET_PBR,
    "diffuse": MaterialType.DIFFUSE,
    "specular_reflection": MaterialType.SPECULAR_REFLECTION,
    "mirror": MaterialType.SPECULAR_REFLECTION,
    "specular_refraction": MaterialType.SPECULAR_REFRACTION,
    "refraction": MaterialType.SPECULAR_REFRACTION,
    "glass": MaterialType.SPECULAR_REFRACTION,
}


def peek_resolution(path: str) -> Tuple[int, int]:
    """Read just the camera resolution."""
    with open(path) as f:
        doc = json.load(f)
    res = doc["Camera"]["RES"]
    return int(res[0]), int(res[1])


def load_scene(path: str, load_meshes: bool = True) -> HostScene:
    """The host scene of the JSON file at `path`: meshes, materials and
    textures, and the environment map in host memory."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        doc = json.load(f)

    scene = HostScene()

    # ---- camera -----------------------------------------------------------
    cam = doc["Camera"]
    scene.camera = Camera.build(
        resolution=(int(cam["RES"][0]), int(cam["RES"][1])),
        position=tuple(cam["EYE"]),
        look_at=tuple(cam["LOOKAT"]),
        up=tuple(cam["UP"]),
        fovy_deg=float(cam["FOVY"]),
    )
    scene.iterations = int(cam.get("ITERATIONS", 120))
    scene.trace_depth = int(cam.get("DEPTH", 8))
    scene.image_name = str(cam.get("FILE", "render"))

    # ---- materials --------------------------------------------------------
    name_to_id = {}
    for name, spec in doc.get("Materials", {}).items():
        m = HostMaterial(name=name)
        if "basecolor" in spec:
            m.basecolor = tuple(spec["basecolor"])
        elif "RGB" in spec:
            m.basecolor = tuple(spec["RGB"])
        m.metallic = float(spec.get("metallic", 0.0))
        m.roughness = float(spec.get("roughness", 1.0))
        m.emittance = float(spec.get("emittance", spec.get("EMITTANCE", 0.0)))
        m.ior = float(spec.get("ior", 1.5))
        tname = str(spec.get("Type", spec.get("TYPE", "diffuse"))).lower()
        m.mtype = _TYPE_NAMES.get(tname, MaterialType.DIFFUSE)
        for json_key, attr in (("diffuse_texture", "tex_diffuse"),
                               ("normal_texture", "tex_normal"),
                               ("metallic_roughness_texture",
                                "tex_metallic_roughness")):
            if json_key in spec:
                tid = load_texture_into_atlas(
                    scene.atlas, os.path.join(base_dir, spec[json_key]))
                setattr(m, attr, tid)
        name_to_id[name] = scene.add_material(m)

    # ---- environment ------------------------------------------------------
    env_spec = doc.get("Environment Texture")
    if env_spec and load_meshes:
        env_path = os.path.join(base_dir, env_spec["FILE"])
        if os.path.exists(env_path):
            from .envmap import load_envmap

            scene.env_map = load_envmap(env_path, device="cpu")

    # ---- objects ----------------------------------------------------------
    meshes = []
    for obj in doc.get("Objects", []):
        trs = build_trs_matrix(
            obj.get("TRANS", [0, 0, 0]),
            obj.get("ROTAT", [0, 0, 0]),
            obj.get("SCALE", [1, 1, 1]),
        )
        override = None
        if "MATERIAL" in obj and obj["MATERIAL"] in name_to_id:
            override = name_to_id[obj["MATERIAL"]]
        fname = obj.get("FILE")
        if not fname or not load_meshes:
            continue
        obj_path = os.path.join(base_dir, fname)
        if not os.path.exists(obj_path):
            raise FileNotFoundError(f"scene object not found: {obj_path}")
        meshes.append(load_obj(obj_path, scene, trs=trs,
                               material_override=override))

    if meshes:
        scene.mesh = merge_meshes(meshes)
    if not scene.materials:
        scene.add_material(HostMaterial("default"))
    return scene
