"""Packet-BVH pack: collapse the binary BVH into the tables the traversal
kernels read. Counterpart of `tpt/bvh/pack.py`, with the same numpy
arithmetic, so for the same host mesh the tables equal the JAX
package's exactly (tests check it).

Tables:
- node_f32 [Nt, ceil(6*arity/8)*8] f32: child s box at cols [6s, 6s+6);
  empty slots hold a point box at +3e38 that no slab test passes
- node_child [Nt, 16] int32 (wide): cols [0, arity) child codes — >= 0 a
  wide-node id, < -1 a cluster -(start*256 + count) - 1, -1 empty — and
  cols [8, 16) one packed slot order per direction octant (4 bits per
  slot, nearest first); binary packs have node_child [Nt, 2]
- tri_f32 [Tp, 16] f32: v0 (3), e1 (3), e2 (3), original triangle id (1),
  in cluster order, padded so any cluster slice stays in bounds
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..scene.mesh import HostMesh
from .sah import BinaryBVH


@dataclass(frozen=True)
class PacketBVH:
    node_f32: torch.Tensor    # [Nt, width] f32
    node_child: torch.Tensor  # [Nt, arity] or [Nt, 16] int32
    tri_f32: torch.Tensor     # [Tp, 16] f32
    num_nodes: int = 0
    num_triangles: int = 0
    max_cluster: int = 8
    arity: int = 2
    # treelet top-tree tables (bvh/treelet.py:attach_treelets); None = not
    # attached
    top_f32: Optional[torch.Tensor] = None    # [Ntop, width] child boxes
    top_child: Optional[torch.Tensor] = None  # [Ntop, 16] top ids + order words
    top_tref: Optional[torch.Tensor] = None   # [Ntop, 8] treelet root codes
    top_tord: Optional[torch.Tensor] = None   # [Ntop, 8] treelet ordinals
    num_top: int = 0
    num_treelets: int = 0
    treelet_max: int = 0

    def to(self, device) -> "PacketBVH":
        mv = lambda a: None if a is None else a.to(device)
        return replace(self, node_f32=mv(self.node_f32),
                       node_child=mv(self.node_child),
                       tri_f32=mv(self.tri_f32), top_f32=mv(self.top_f32),
                       top_child=mv(self.top_child),
                       top_tref=mv(self.top_tref),
                       top_tord=mv(self.top_tord))

    @property
    def device(self) -> torch.device:
        return self.node_f32.device


def encode_cluster(start: int, count: int) -> int:
    return -(start * 256 + count) - 1


def decode_cluster(code):
    v = -(code + 1)
    return v // 256, v % 256


def _binary_tables(mesh: HostMesh, bvh: BinaryBVH, k: int):
    """numpy (node_f32 [Nt,16], node_child [Nt,2], tri_f32, n leaves)."""
    left = bvh.left
    right = bvh.right
    prim = bvh.prim_index
    amin = bvh.aabb_min
    amax = bvh.aabb_max
    total = left.shape[0]
    n = (total + 1) // 2          # leaves
    num_internal = n - 1
    leaf_base = num_internal

    # subtree sorted-prim ranges (bottom-up level propagation)
    lo = np.full(total, -1, np.int64)
    hi = np.full(total, -1, np.int64)
    lo[leaf_base:] = np.arange(n)
    hi[leaf_base:] = np.arange(n)
    lc = np.maximum(left, 0)
    rc = np.maximum(right, 0)
    for _ in range(72):
        new_lo = np.where(np.arange(total) < num_internal,
                          np.minimum(lo[lc], lo[rc]), lo)
        new_hi = np.where(np.arange(total) < num_internal,
                          np.maximum(hi[lc], hi[rc]), hi)
        if np.array_equal(new_lo, lo) and np.array_equal(new_hi, hi):
            break
        lo, hi = new_lo, new_hi
    if not (lo[0] == 0 and hi[0] == n - 1):
        raise ValueError("BVH leaf-range propagation did not converge")
    size = hi - lo + 1

    # top-tree internals: subtrees larger than one cluster
    is_top = (np.arange(total) < num_internal) & (size > k)
    top_ids = np.nonzero(is_top)[0]
    remap = np.full(total, -1, np.int64)
    remap[top_ids] = np.arange(top_ids.size)

    def child_code(c: int) -> int:
        if c < num_internal and is_top[c]:
            return int(remap[c])
        return encode_cluster(int(lo[c]), int(size[c]))

    if top_ids.size == 0:
        # tiny scene: one root splitting the prims into two clusters
        half = max(1, n // 2)
        nodes_f32 = np.zeros((1, 16), np.float32)
        nodes_f32[0, 0:3] = amin[0] - 1e-3
        nodes_f32[0, 3:6] = amax[0] + 1e-3
        nodes_f32[0, 6:9] = amin[0] - 1e-3
        nodes_f32[0, 9:12] = amax[0] + 1e-3
        node_child = np.array(
            [[encode_cluster(0, half), encode_cluster(half, n - half)]],
            np.int32)
    else:
        nt = top_ids.size
        nodes_f32 = np.zeros((nt, 16), np.float32)
        node_child = np.zeros((nt, 2), np.int32)
        l_of = left[top_ids]
        r_of = right[top_ids]
        nodes_f32[:, 0:3] = amin[l_of]
        nodes_f32[:, 3:6] = amax[l_of]
        nodes_f32[:, 6:9] = amin[r_of]
        nodes_f32[:, 9:12] = amax[r_of]
        for t_i, (lc_i, rc_i) in enumerate(zip(l_of, r_of)):
            node_child[t_i, 0] = child_code(int(lc_i))
            node_child[t_i, 1] = child_code(int(rc_i))

    if not np.all(size[~is_top & (np.arange(total) < num_internal)] <= 255):
        raise ValueError("cluster too large for the 8-bit count")

    # sorted triangle table
    sorted_prims = prim[leaf_base:]
    if bvh.num_triangles < mesh.num_triangles:
        raise ValueError("bvh does not cover mesh")
    t = mesh.num_triangles
    p0 = mesh.positions.astype(np.float32)
    i0 = mesh.indices[:, 0][sorted_prims % t]
    i1 = mesh.indices[:, 1][sorted_prims % t]
    i2 = mesh.indices[:, 2][sorted_prims % t]
    v0 = p0[i0]
    e1 = p0[i1] - v0
    e2 = p0[i2] - v0
    tp = int(np.ceil((n + k) / 8) * 8)
    tri_f32 = np.zeros((tp, 16), np.float32)
    tri_f32[:n, 0:3] = v0
    tri_f32[:n, 3:6] = e1
    tri_f32[:n, 6:9] = e2
    tri_f32[:n, 9] = (sorted_prims % t).astype(np.float32)
    # padding rows are degenerate (e1 = e2 = 0): never hit
    return nodes_f32, node_child, tri_f32, n


def build_packet_bvh(mesh: HostMesh, bvh: BinaryBVH, max_cluster: int = 8
                     ) -> PacketBVH:
    """Binary (arity-2) packet pack, CPU tensors."""
    nodes_f32, node_child, tri_f32, n = _binary_tables(mesh, bvh, max_cluster)
    return PacketBVH(
        node_f32=torch.from_numpy(nodes_f32),
        node_child=torch.from_numpy(node_child),
        tri_f32=torch.from_numpy(tri_f32),
        num_nodes=int(nodes_f32.shape[0]),
        num_triangles=int(n),
        max_cluster=max_cluster,
        arity=2,
    )


def build_packet_bvh_wide(mesh: HostMesh, bvh: BinaryBVH,
                          max_cluster: int = 16, arity: int = 4
                          ) -> PacketBVH:
    """Collapse the binary top tree into an `arity`-wide pack with
    per-octant child orders (CPU tensors): starting at a kept binary
    node, greedily expand the internal slot of largest surface area
    until `arity` slots (or only clusters) remain."""
    if arity not in (4, 8):
        raise ValueError(f"wide arity must be 4 or 8, got {arity}")
    b_f32, b_child, tri_f32, n = _binary_tables(mesh, bvh, max_cluster)

    def child_box(i, side):
        return b_f32[i, 6 * side:6 * side + 6]

    def area(box):
        d = np.maximum(box[3:6] - box[0:3], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    remap = {}
    order = []
    queue = deque([0])
    rows = []
    while queue:
        i = queue.popleft()
        if i in remap:
            continue
        remap[i] = len(order)
        order.append(i)
        slots = [(("node", int(b_child[i, s])) if b_child[i, s] >= 0
                  else ("cluster", int(b_child[i, s])), child_box(i, s))
                 for s in (0, 1)]
        while len(slots) < arity:
            best, best_a = -1, -1.0
            for si, ((kind, c), box) in enumerate(slots):
                if kind == "node":
                    a = area(box)
                    if a > best_a:
                        best, best_a = si, a
            if best < 0:
                break
            (kind, c), _ = slots.pop(best)
            for s in (0, 1):
                cc = int(b_child[c, s])
                slots.insert(best + s,
                             (("node", cc) if cc >= 0 else ("cluster", cc),
                              child_box(c, s)))
        for (kind, c), _ in slots:
            if kind == "node":
                queue.append(c)
        rows.append(slots)

    nt = len(order)
    width = ((6 * arity + 7) // 8) * 8
    node_f32 = np.full((nt, width), 3e38, np.float32)
    node_child = np.full((nt, 16), -1, np.int32)

    oct_dirs = np.array([[1.0 if o & 4 else -1.0,
                          1.0 if o & 2 else -1.0,
                          1.0 if o & 1 else -1.0] for o in range(8)])

    for row, slots in enumerate(rows):
        centers = []
        for s, ((kind, c), box) in enumerate(slots):
            node_f32[row, 6 * s:6 * s + 6] = box
            node_child[row, s] = remap[c] if kind == "node" else c
            centers.append(0.5 * (box[0:3] + box[3:6]))
        cen = np.asarray(centers)
        for o in range(8):
            # ascending entry distance along the octant direction
            proj = cen @ oct_dirs[o]
            ordr = list(np.argsort(proj, kind="stable"))
            ordr += [s for s in range(arity) if s >= len(slots)]
            packed = 0
            for pos, s in enumerate(ordr):
                packed |= (int(s) & 15) << (4 * pos)
            node_child[row, 8 + o] = np.int32(np.uint32(packed).view(np.int32))

    return PacketBVH(
        node_f32=torch.from_numpy(node_f32),
        node_child=torch.from_numpy(node_child),
        tri_f32=torch.from_numpy(tri_f32),
        num_nodes=nt,
        num_triangles=int(n),
        max_cluster=max_cluster,
        arity=arity,
    )
