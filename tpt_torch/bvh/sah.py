"""Binned-SAH binary BVH from the native builder.

Counterpart of `tpt/bvh/sah.py`: the same corner table goes to the same
C++ builder, so the tree is the JAX package's, in the LBVH builder's
layout (internal nodes [0, T-2], single-triangle leaves [T-1, 2T-2] with
contiguous subtree leaf ranges), with the same escape links. The BVH_XLA
walk, the validator, the heatmap and the packet packs all read it."""

from __future__ import annotations

import numpy as np
import torch

from ..core.vec import Vec3
from ..device import DeviceLike, resolve_device
from ..scene.mesh import HostMesh
from ..scene.structs import LBVHData


def _escape_links(left: np.ndarray, right: np.ndarray, parent: np.ndarray
                  ) -> np.ndarray:
    """escape[left child] = right sibling; escape[right child] =
    escape[parent]; root = -1. Downward propagation to the fixed point."""
    total = left.shape[0]
    ids = np.arange(total)
    par = np.maximum(parent, 0)
    par_right = right[par]
    is_left = left[par] == ids
    has_parent = parent >= 0
    escape = np.full(total, -1, np.int32)
    for _ in range(total.bit_length() * 4 + 8):
        new = np.where(is_left, par_right, escape[par]).astype(np.int32)
        new = np.where(has_parent, new, -1)
        if np.array_equal(new, escape):
            break
        escape = new
    return escape


def build_sah_bvh(mesh: HostMesh, device: DeviceLike = None) -> LBVHData:
    """The SAH BVH of `mesh` from the native builder, on `device` (the
    card unless the caller asks for another). A mesh of one triangle is
    padded to two leaves, as the reference does."""
    from ..scene.native import build_sah_native

    dev = resolve_device(device)
    t = mesh.num_triangles
    tri_ids = np.arange(max(t, 2), dtype=np.int64) % max(t, 1)
    p = mesh.positions.astype(np.float32)
    idx = mesh.indices[tri_ids]
    v012 = np.concatenate([p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]],
                          axis=-1).astype(np.float32)
    left, right, parent, prim, amin, amax = build_sah_native(v012)
    escape = _escape_links(left, right, parent)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return LBVHData(aabb_min=Vec3.from_stacked(up(amin)),
                    aabb_max=Vec3.from_stacked(up(amax)),
                    left=up(left), right=up(right), parent=up(parent),
                    escape=up(escape), prim_index=up(prim),
                    num_triangles=max(t, 2))
