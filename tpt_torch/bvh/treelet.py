"""Treelet cut of the wide packet BVH and the dense-sweep tables built on
it. Counterpart of `tpt/bvh/treelet.py`, with the same numpy walk, so for
the same pack the tables equal the JAX package's field for field (tests).

The cut produces a TOP TREE over the wide-node table:
- top nodes = wide nodes whose subtree holds > max_tris triangles (re-
  indexed in BFS order, so the top root is row 0);
- a top node's child slot is either another top node or a treelet
  reference whose code is the wide-table child code itself (>= 0 a wide
  node id, < 0 a cluster code), numbered by a dense ordinal.

`sweep_tables` then repacks each treelet's contiguous triangle range into
whole `chunk_align`-chunk spans of 8-row chunks, in ascending ordinal
order, for the sweep kernel K4 (`bvh/sweep.py`), and keeps each
treelet's AABB for the dense scan K3. Everything here runs once at scene
build, in numpy on the host; the tables then move to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from .pack import PacketBVH, decode_cluster


def _np(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def subtree_sizes(pack: PacketBVH) -> np.ndarray:
    """Triangles under each wide node. Children have larger BFS ids than
    their parent, so one reverse sweep suffices."""
    child = _np(pack.node_child)
    nt = child.shape[0]
    size = np.zeros(nt, np.int64)
    for i in range(nt - 1, -1, -1):
        s = 0
        for c in child[i, :pack.arity]:
            c = int(c)
            if c == -1:
                continue
            s += size[c] if c >= 0 else decode_cluster(c)[1]
        size[i] = s
    return size


def attach_treelets(pack: PacketBVH, max_tris: int = 1024) -> PacketBVH:
    """Return `pack` with the top-tree tables attached (PacketBVH.top_*),
    on the pack's device."""
    if pack.arity <= 2:
        raise ValueError("the treelet cut is a wide-pack feature")
    child = _np(pack.node_child)
    nodes = _np(pack.node_f32)
    arity = pack.arity
    size = subtree_sizes(pack)
    dev = pack.device
    tens = lambda a: torch.from_numpy(a).to(dev)

    if size[0] <= max_tris:
        # the whole scene is one treelet: a single pseudo top node whose
        # only slot references the wide root, boxed by the union of the
        # root's child boxes
        top_f32 = np.full((1, nodes.shape[1]), 3.0e38, np.float32)
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)
        for s in range(arity):
            if int(child[0, s]) == -1:
                continue
            box = nodes[0, 6 * s:6 * s + 6]
            lo = np.minimum(lo, box[0:3])
            hi = np.maximum(hi, box[3:6])
        top_f32[0, 0:3] = lo
        top_f32[0, 3:6] = hi
        top_child = np.full((1, 16), -1, np.int32)
        top_child[0, 8:16] = 0x76543210  # identity order words
        top_tref = np.zeros((1, 8), np.int32)
        top_tord = np.zeros((1, 8), np.int32)
        return replace(pack, top_f32=tens(top_f32), top_child=tens(top_child),
                       top_tref=tens(top_tref), top_tord=tens(top_tord),
                       num_top=1, num_treelets=1, treelet_max=int(max_tris))

    is_top = size > max_tris
    top_ids = np.nonzero(is_top)[0]
    remap = np.full(child.shape[0], -1, np.int64)
    remap[top_ids] = np.arange(top_ids.size)
    assert remap[0] == 0, "the wide root must stay top row 0"

    ntop = top_ids.size
    top_f32 = nodes[top_ids].copy()
    top_child = np.full((ntop, 16), -1, np.int32)
    top_child[:, 8:16] = child[top_ids, 8:16]  # octant order words
    top_tref = np.zeros((ntop, 8), np.int32)
    # treelet ordinals: BFS emission order, which follows the wide tree's
    # spatial layout
    top_tord = np.zeros((ntop, 8), np.int32)
    n_treelets = 0
    for r, i in enumerate(top_ids):
        for s in range(arity):
            c = int(child[i, s])
            if c == -1:
                continue  # empty slot: its box never hits
            if c >= 0 and is_top[c]:
                top_child[r, s] = remap[c]
            else:
                top_tref[r, s] = c
                top_tord[r, s] = n_treelets
                n_treelets += 1
    return replace(pack, top_f32=tens(top_f32), top_child=tens(top_child),
                   top_tref=tens(top_tref), top_tord=tens(top_tord),
                   num_top=int(ntop), num_treelets=int(n_treelets),
                   treelet_max=int(max_tris))


# pad-box sentinel: lo = hi = +3e38 fails the slab test for every ray
# with |d_i| <= 1 in each component
_GINF = 3.0e38


@dataclass(frozen=True)
class SweepTables:
    """Per-treelet triangle ranges, repacked so that every treelet starts
    on an `unroll`-row boundary and spans a whole number of
    `chunk_align`-aligned `unroll`-row chunks (pad rows are all-zero
    triangles, det = 0, that never hit). ranges[t] = (row_start,
    num_chunks)."""

    tri_f32: torch.Tensor        # [rows_padded, 16] f32
    ranges: torch.Tensor         # [num_treelets, 2] int32
    boxes: torch.Tensor          # [num_treelets, 8] f32 lo3, hi3, pad
    # 8 sub-AABBs per treelet, one per `chunk_align` chunks (tpt's group
    # culling, which the port does not run; kept so the tables equal tpt's)
    group_boxes: Optional[torch.Tensor] = None  # [num_treelets*8, 8] f32
    num_treelets: int = 0
    max_chunks: int = 0
    unroll: int = 8
    chunk_align: int = 4

    def to(self, device) -> "SweepTables":
        mv = lambda a: None if a is None else a.to(device)
        return replace(self, tri_f32=mv(self.tri_f32), ranges=mv(self.ranges),
                       boxes=mv(self.boxes), group_boxes=mv(self.group_boxes))

    @property
    def device(self) -> torch.device:
        return self.tri_f32.device


def _treelet_ranges(pack: PacketBVH):
    """Per-treelet (aabb[6], tri_start, tri_count) in packed-table rows.
    Every treelet subtree covers one contiguous range of the packed
    triangle table (the pack emits leaves depth first); asserted here."""
    top_child = _np(pack.top_child)
    top_tref = _np(pack.top_tref)
    top_tord = _np(pack.top_tord)
    top_f32 = _np(pack.top_f32)
    child = _np(pack.node_child)
    arity = pack.arity

    def subtree_range(code):
        ranges = []
        stack = [int(code)]
        while stack:
            c = stack.pop()
            if c < 0:
                ranges.append(decode_cluster(c))
            else:
                stack.extend(int(cc) for cc in child[c, :arity] if int(cc) != -1)
        ranges.sort()
        for i in range(len(ranges) - 1):
            assert ranges[i][0] + ranges[i][1] == ranges[i + 1][0], \
                "treelet subtree is not a contiguous triangle range"
        return ranges[0][0], sum(n for _, n in ranges)

    T = pack.num_treelets
    boxes = np.zeros((T, 6), np.float32)
    start = np.zeros(T, np.int64)
    count = np.zeros(T, np.int64)
    for r in range(top_child.shape[0]):
        for s in range(arity):
            if top_child[r, s] != -1:
                continue
            code = int(top_tref[r, s])
            if code == 0:  # empty slot (wide node 0 is always top)
                continue
            t = int(top_tord[r, s])
            boxes[t] = top_f32[r, 6 * s:6 * s + 6]
            start[t], count[t] = subtree_range(code)
    return boxes, start, count


def sweep_tables(pack: PacketBVH, unroll: int = 8,
                 chunk_align: int = 4) -> SweepTables:
    """The dense-sweep tables of an attach_treelets() pack, on the pack's
    device. Per-treelet chunk counts are rounded up to `chunk_align`, so
    a sweep that takes `k | chunk_align` chunks at a time never runs over
    into the next treelet."""
    if pack.num_treelets <= 0:
        raise ValueError("run attach_treelets() first")
    boxes, start, count = _treelet_ranges(pack)
    tri = _np(pack.tri_f32)
    T = pack.num_treelets
    chunks = (count + unroll - 1) // unroll
    chunks = (chunks + chunk_align - 1) // chunk_align * chunk_align
    row_start = np.zeros(T, np.int64)
    total = 0
    for t in range(T):
        row_start[t] = total
        total += chunks[t] * unroll
    out = np.zeros((max(total, unroll), tri.shape[1]), np.float32)
    for t in range(T):
        out[row_start[t]:row_start[t] + count[t]] = tri[start[t]:start[t] + count[t]]
    ranges = np.stack([row_start, chunks], -1).astype(np.int32)
    boxes8 = np.zeros((T, 8), np.float32)
    boxes8[:, :6] = boxes

    # group sub-AABBs: slot g covers chunks [g*chunk_align, (g+1)*chunk_align)
    # of the real rows, inflated by 1e-6 relative; empty groups keep +3e38
    G = 8
    gbox = np.zeros((T * G, 8), np.float32)
    gbox[:, :6] = _GINF
    rows_per_group = chunk_align * unroll
    for t in range(T):
        for g in range(min(G, int(chunks[t]) // chunk_align)):
            r0 = int(row_start[t]) + g * rows_per_group
            r1 = min(r0 + rows_per_group, int(row_start[t]) + int(count[t]))
            if r1 <= r0:
                continue
            rows = out[r0:r1]
            v0 = rows[:, 0:3]
            verts = np.concatenate([v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]],
                                   axis=0)
            lo, hi = verts.min(0), verts.max(0)
            pad = 1e-6 * np.maximum(np.abs(lo), np.abs(hi)) + 1e-30
            gbox[t * G + g, :3] = lo - pad
            gbox[t * G + g, 3:6] = hi + pad

    dev = pack.device
    tens = lambda a: torch.from_numpy(a).to(dev)
    return SweepTables(tri_f32=tens(out), ranges=tens(ranges),
                       boxes=tens(boxes8), group_boxes=tens(gbox),
                       num_treelets=T, max_chunks=int(chunks.max()),
                       unroll=unroll, chunk_align=chunk_align)
