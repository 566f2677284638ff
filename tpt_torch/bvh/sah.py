"""Binned-SAH binary BVH from the native builder (host, numpy).

Counterpart of `tpt/bvh/sah.py`: the same corner table goes to the same
C++ builder, so the binary tree is the JAX package's. Only the arrays
the packet pack reads are kept (the port has no LBVH traversal)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..scene.mesh import HostMesh


@dataclass(frozen=True)
class BinaryBVH:
    """Binary BVH arrays: internal nodes [0, T-2], single-triangle leaves
    [T-1, 2T-2] with contiguous subtree leaf ranges."""

    left: np.ndarray        # [2T-1] int32 child node id (-1 for leaf)
    right: np.ndarray
    parent: np.ndarray
    prim_index: np.ndarray  # leaf -> triangle id
    aabb_min: np.ndarray    # [2T-1, 3] f32
    aabb_max: np.ndarray
    num_triangles: int


def build_sah_bvh(mesh: HostMesh) -> BinaryBVH:
    """Build a SAH BVH over `mesh` with the native builder (a mesh of one
    triangle is padded to two leaves, as the reference does)."""
    from ..scene.native import build_sah_native

    t = mesh.num_triangles
    tri_ids = np.arange(max(t, 2), dtype=np.int64) % max(t, 1)
    p = mesh.positions.astype(np.float32)
    idx = mesh.indices[tri_ids]
    v012 = np.concatenate([p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]],
                          axis=-1).astype(np.float32)
    left, right, parent, prim, amin, amax = build_sah_native(v012)
    return BinaryBVH(left=left, right=right, parent=parent, prim_index=prim,
                     aabb_min=amin, aabb_max=amax, num_triangles=max(t, 2))
