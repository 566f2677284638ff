"""Scene tables carried across from numpy arrays.

`from_numpy_scene` builds the port's `SceneData` from the numpy leaves of
a scene the JAX package built (mesh, material rows, light table, the
texture atlas, the environment map, the binary BVH of BVH_XLA, the
packet-BVH tables — wide with their treelet top tree, or binary — and
the dense-sweep tables), so
tests can hand both packages the very same tables. It takes plain arrays under the JAX package's field names, never
objects of that package, and imports nothing of it."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..bvh.pack import PacketBVH
from ..device import DeviceLike, resolve_device
from .mesh import mesh_from_arrays
from .envmap import envmap_from_arrays
from ..core.vec import Vec3
from .structs import (EnvMap, LBVHData, LightData, MaterialTable, SceneData,
                      TextureAtlas)
from .texture import atlas_from_arrays

MESH_KEYS = ("positions", "normals", "tangents", "uv_u", "uv_v", "i0", "i1",
             "i2", "material_ids", "geom_normals", "shade_tri", "shade_vtx",
             "shade_hit")
LIGHT_KEYS = ("tri_idx", "cdf", "areas", "total_area", "packed")
PACK_KEYS = ("node_f32", "node_child", "tri_f32", "num_nodes",
             "num_triangles", "max_cluster", "arity")
# optional: present when the pack carries the treelet cut
TOP_KEYS = ("top_f32", "top_child", "top_tref", "top_tord", "num_top",
            "num_treelets", "treelet_max")
ATLAS_KEYS = ("r", "g", "b", "a", "x0", "y0", "width", "height")
ENV_KEYS = ("r", "g", "b", "pdf", "alias", "prob", "enabled")
BVH_KEYS = ("aabb_min", "aabb_max", "left", "right", "parent", "escape",
            "prim_index", "num_triangles")
SWEEP_KEYS = ("tri_f32", "ranges", "boxes", "group_boxes", "num_treelets",
              "max_chunks", "unroll", "chunk_align")


def _need(d: Mapping, keys, what: str):
    missing = [k for k in keys if k not in d]
    if missing:
        raise KeyError(f"{what} arrays missing: {missing}")


def from_numpy_scene(mesh: Mapping[str, np.ndarray],
                     material_rows: np.ndarray,
                     lights: Mapping[str, np.ndarray],
                     pack: Optional[Mapping] = None,
                     sweep: Optional[Mapping] = None,
                     atlas: Optional[Mapping] = None,
                     env: Optional[Mapping] = None,
                     bvh: Optional[Mapping] = None,
                     device: DeviceLike = None) -> SceneData:
    """SceneData on `device` from numpy arrays.

    mesh: MESH_KEYS, vec3 fields as [N, 3] arrays (shade_* may be None);
    material_rows: the packed [M, 16] material table;
    lights: LIGHT_KEYS (packed may be None);
    pack: PACK_KEYS of a PacketBVH, or None: a wide pack (arity 4/8,
    node_child [Nt, 16]) plus TOP_KEYS when it carries the treelet cut
    (top_f32 None or absent: no cut), or the binary pack (arity 2,
    node_f32 [Nt, 16], node_child [Nt, 2]), which has no cut;
    sweep: SWEEP_KEYS of the dense-sweep tables, or None;
    atlas: ATLAS_KEYS of the texture atlas (planes [AH, AW], placements
    [Ntex]), or None for the empty atlas;
    env: ENV_KEYS of the environment map (planes [H, W], alias and prob
    [H*W]), or None for no environment;
    bvh: BVH_KEYS of the binary BVH (bounds [2T-1, 3], the int arrays
    [2T-1]), or None for none."""
    dev = resolve_device(device)
    _need(mesh, MESH_KEYS, "mesh")
    _need(lights, LIGHT_KEYS, "light")
    idx = np.stack([np.asarray(mesh["i0"]), np.asarray(mesh["i1"]),
                    np.asarray(mesh["i2"])], axis=-1)
    mesh_data = mesh_from_arrays(
        mesh["positions"], mesh["normals"], mesh["tangents"], mesh["uv_u"],
        mesh["uv_v"], idx, mesh["material_ids"], mesh["geom_normals"],
        mesh["shade_tri"], mesh["shade_vtx"], mesh["shade_hit"], device=dev)
    table = MaterialTable.from_packed(
        torch.as_tensor(np.array(material_rows, np.float32),
                        device=dev))
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32),
                                    device=dev)
    light_data = LightData(
        tri_idx=torch.as_tensor(np.asarray(lights["tri_idx"]).astype(np.int64),
                                device=dev),
        cdf=f32(lights["cdf"]), areas=f32(lights["areas"]),
        total_area=f32(lights["total_area"]).reshape(()),
        packed=None if lights["packed"] is None else f32(lights["packed"]))
    i32 = lambda a: torch.as_tensor(np.array(a, np.int32), device=dev)
    packet = None
    if pack is not None:
        _need(pack, PACK_KEYS, "pack")
        top = {}
        want = 2 if int(pack["arity"]) == 2 else 16
        if np.shape(pack["node_child"])[1:] != (want,):
            raise ValueError(f"an arity-{int(pack['arity'])} pack has "
                             f"node_child [Nt, {want}], got "
                             f"{np.shape(pack['node_child'])}")
        if pack.get("top_f32") is not None:
            _need(pack, TOP_KEYS, "pack top-tree")
            top = dict(top_f32=f32(pack["top_f32"]),
                       top_child=i32(pack["top_child"]),
                       top_tref=i32(pack["top_tref"]),
                       top_tord=i32(pack["top_tord"]),
                       num_top=int(pack["num_top"]),
                       num_treelets=int(pack["num_treelets"]),
                       treelet_max=int(pack["treelet_max"]))
        packet = PacketBVH(
            node_f32=f32(pack["node_f32"]),
            node_child=i32(pack["node_child"]),
            tri_f32=f32(pack["tri_f32"]),
            num_nodes=int(pack["num_nodes"]),
            num_triangles=int(pack["num_triangles"]),
            max_cluster=int(pack["max_cluster"]),
            arity=int(pack["arity"]), **top)
    tables = None
    if sweep is not None:
        from ..bvh.treelet import SweepTables

        _need(sweep, SWEEP_KEYS, "sweep")
        tables = SweepTables(
            tri_f32=f32(sweep["tri_f32"]), ranges=i32(sweep["ranges"]),
            boxes=f32(sweep["boxes"]),
            group_boxes=(None if sweep["group_boxes"] is None
                         else f32(sweep["group_boxes"])),
            num_treelets=int(sweep["num_treelets"]),
            max_chunks=int(sweep["max_chunks"]), unroll=int(sweep["unroll"]),
            chunk_align=int(sweep["chunk_align"]))
    tex = TextureAtlas.empty(dev)
    if atlas is not None:
        _need(atlas, ATLAS_KEYS, "atlas")
        tex = atlas_from_arrays(
            np.stack([np.asarray(atlas[c]) for c in "rgba"], axis=-1),
            atlas["x0"], atlas["y0"], atlas["width"], atlas["height"],
            device=dev)
    env_map = EnvMap.disabled(dev)
    if env is not None:
        _need(env, ENV_KEYS, "env")
        env_map = envmap_from_arrays(
            env["r"], env["g"], env["b"], env["pdf"], env["alias"],
            env["prob"], device=dev, enabled=bool(env["enabled"]))
    tree = None
    if bvh is not None:
        _need(bvh, BVH_KEYS, "bvh")
        tree = LBVHData(
            aabb_min=Vec3.from_stacked(f32(bvh["aabb_min"])),
            aabb_max=Vec3.from_stacked(f32(bvh["aabb_max"])),
            left=i32(bvh["left"]), right=i32(bvh["right"]),
            parent=i32(bvh["parent"]), escape=i32(bvh["escape"]),
            prim_index=i32(bvh["prim_index"]),
            num_triangles=int(bvh["num_triangles"]))
    return SceneData(mesh=mesh_data, materials=table, lights=light_data,
                     atlas=tex, env=env_map, bvh=tree, pack=packet,
                     sweep=tables)
