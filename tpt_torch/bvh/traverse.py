"""BVH_XLA: the binary-BVH walk in plain PyTorch.

Counterpart of `tpt/bvh/traverse.py`, which is plain XLA there (no
Pallas kernel): every ray advances one traversal step per loop
iteration with dead lanes masked. Closest hit keeps a per-lane short
stack and visits the near child first (the reference's ray_cast.cu
closest-hit walk); any hit and `traversal_cost` walk the escape links
without a stack. The arithmetic is tpt's, step for step.

A lane that has finished takes no further step, so two things change
nothing in the results: the host looks at the live lanes only every
`STEP_CHECK` steps (on the card each look is a sync), and once fewer
than half the lanes of the walk are live it gathers them and goes on
with those alone. `STATS` counts the walks and their loop iterations.

tpt drops the far child when a lane's stack is full; so does the port,
and it also counts those lanes, which the caller adds to
`Raycaster.capped` as every other backend's capped rays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.vec import Vec3
from ..integrators.intersect import FLT_MAX, HitRecord, moller_trumbore
from ..scene.structs import LBVHData, MeshData

STEP_CHECK = 8
STATS = {"walks": 0, "steps": 0}


@dataclass(frozen=True)
class WalkTables:
    """Per-node gathers of one (mesh, BVH) pair, so that a step gathers
    each row once: `link` [N, 4] int64 (left and right clamped to >= 0,
    the leaf's triangle clamped to >= 0, the escape link), `corners`
    [N, 9] f32 (v0, v1, v2 of that triangle), `child_box` [N, 12] f32
    (the clamped left child's min and max, then the right child's) and
    `node_box` [N, 6] f32 (the node's own min and max)."""

    link: torch.Tensor
    corners: torch.Tensor
    child_box: torch.Tensor
    node_box: torch.Tensor
    num_internal: int
    total: int


def walk_tables(mesh: MeshData, bvh: LBVHData) -> WalkTables:
    total = int(bvh.left.shape[0])
    left = bvh.left.to(torch.int64).clamp_min(0)
    right = bvh.right.to(torch.int64).clamp_min(0)
    tri = bvh.prim_index.to(torch.int64).clamp_min(0)
    v0, v1, v2 = mesh.tri_vertices(tri)
    box = torch.cat([bvh.aabb_min.stacked(), bvh.aabb_max.stacked()], dim=1)
    return WalkTables(
        link=torch.stack([left, right, tri, bvh.escape.to(torch.int64)], 1),
        corners=torch.cat([v0.stacked(), v1.stacked(), v2.stacked()], 1),
        child_box=torch.cat([box[left], box[right]], 1).contiguous(),
        node_box=box.contiguous(), num_internal=bvh.num_triangles - 1,
        total=total)


def _signed_inv(c: torch.Tensor) -> torch.Tensor:
    small = torch.where(c >= 0, 1e-12, -1e-12)
    return 1.0 / torch.where(torch.abs(c) > 1e-12, c, small)


def _slab(box: torch.Tensor, ori: torch.Tensor, inv: torch.Tensor,
          t_best: torch.Tensor):
    """Slab tests of boxes [n, ..., 6] against rays [n, 3]: (hit, t_near),
    each [n, ...], as tpt's `_child_aabb_hit`."""
    shape = box.shape[:-1] + (2, 3)
    b = box.reshape(shape)
    extra = (slice(None),) + (None,) * (box.dim() - 2)
    o, iv = ori[extra], inv[extra]
    t0 = (b[..., 0, :] - o) * iv
    t1 = (b[..., 1, :] - o) * iv
    t_near = torch.clamp_min(torch.minimum(t0, t1).amax(-1), 0.0)
    tb = t_best.reshape(t_best.shape + (1,) * (box.dim() - 2))
    t_far = torch.minimum(torch.maximum(t0, t1).amin(-1), tb)
    return t_near <= t_far, t_near


def _mt(ori: torch.Tensor, d: torch.Tensor, corners: torch.Tensor):
    c = lambda k: Vec3(corners[:, k], corners[:, k + 1], corners[:, k + 2])
    v = lambda a: Vec3(a[:, 0], a[:, 1], a[:, 2])
    return moller_trumbore(v(ori), v(d), c(0), c(3), c(6))


class _Walk:
    """The live-lane bookkeeping shared by the three walks: `state` is a
    dict of per-lane tensors over the current lanes, `lane` their global
    lane ids; `out` holds every lane's final value of the `keep` keys."""

    def __init__(self, n: int, state: dict, keep: tuple):
        self.state = state
        self.lane = torch.arange(n, device=state[keep[0]].device)
        self.out = {k: state[k].clone() for k in keep}
        self.steps = 0

    def run(self, step, live_key: str, live_fn) -> dict:
        STATS["walks"] += 1
        while True:
            for _ in range(STEP_CHECK):
                step(self.state)
                self.steps += 1
            live = live_fn(self.state[live_key])
            idx = torch.nonzero(live).squeeze(1)
            m = int(idx.shape[0])
            if m == 0:
                break
            if 2 * m <= int(self.lane.shape[0]):
                self._store()
                self.state = {k: v[idx] for k, v in self.state.items()}
                self.lane = self.lane[idx]
        self._store()
        STATS["steps"] += self.steps
        return self.out

    def _store(self):
        for k, v in self.out.items():
            v[self.lane] = self.state[k]


def bvh_closest_hit(mesh: MeshData, bvh: LBVHData, ori: Vec3, d: Vec3,
                    t_max: Optional[torch.Tensor] = None, stack_depth: int = 32,
                    tables: Optional[WalkTables] = None):
    """Closest hit: (HitRecord, lanes whose stack overflowed, int32)."""
    n = ori.shape[0]
    dev = ori.device
    tb = tables if tables is not None else walk_tables(mesh, bvh)
    if t_max is None:
        t_max = torch.full((n,), FLT_MAX, device=dev)
    o3, d3 = ori.stacked(), d.stacked()
    inv3 = torch.stack([_signed_inv(c) for c in (d.x, d.y, d.z)], 1)
    i64 = dict(dtype=torch.int64, device=dev)
    state = dict(
        o=o3, d=d3, inv=inv3,
        stack=torch.zeros((n, stack_depth), dtype=torch.int32, device=dev),
        sp=torch.zeros((n,), **i64), node=torch.zeros((n,), **i64),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        best_t=torch.minimum(torch.full((n,), FLT_MAX, device=dev), t_max),
        best_tri=torch.full((n,), -1, **i64),
        best_u=torch.zeros((n,), device=dev),
        best_v=torch.zeros((n,), device=dev),
        dropped=torch.zeros((n,), dtype=torch.bool, device=dev))
    ni = tb.num_internal

    def step(s):
        node, active, sp, stack = s["node"], s["active"], s["sp"], s["stack"]
        is_leaf = node >= ni
        lk = tb.link[node]
        t, u, v, hit = _mt(s["o"], s["d"], tb.corners[node])
        leaf_hit = active & is_leaf & hit & (t < s["best_t"])
        best_t = torch.where(leaf_hit, t, s["best_t"])
        s["best_t"] = best_t
        s["best_tri"] = torch.where(leaf_hit, lk[:, 2], s["best_tri"])
        s["best_u"] = torch.where(leaf_hit, u, s["best_u"])
        s["best_v"] = torch.where(leaf_hit, v, s["best_v"])

        chit, tn = _slab(tb.child_box[node].reshape(-1, 2, 6), s["o"],
                         s["inv"], best_t)
        internal = active & ~is_leaf
        lhit = internal & chit[:, 0]
        rhit = internal & chit[:, 1]
        lc, rc = lk[:, 0], lk[:, 1]
        both = lhit & rhit
        near_is_left = tn[:, 0] <= tn[:, 1]
        near = torch.where(near_is_left, lc, rc)
        far = torch.where(near_is_left, rc, lc)
        only = torch.where(lhit, lc, rc)

        # push the far child when both hit; a full stack drops it
        room = sp < stack_depth
        push = both & room
        s["dropped"] = s["dropped"] | (both & ~room)
        sp_idx = sp.clamp(0, stack_depth - 1)[:, None]
        cur = stack.gather(1, sp_idx)[:, 0]
        stack.scatter_(1, sp_idx,
                       torch.where(push, far.to(torch.int32), cur)[:, None])
        sp = sp + push.to(torch.int64)

        descend = both | (lhit ^ rhit)
        nxt = torch.where(both, near, only)
        # pop for leaves and for internals with no child hit
        can_pop = active & ~descend & (sp > 0)
        popped = stack.gather(
            1, (sp - 1).clamp(0, stack_depth - 1)[:, None])[:, 0].to(torch.int64)
        s["node"] = torch.where(descend, nxt, torch.where(can_pop, popped, node))
        s["sp"] = sp - can_pop.to(torch.int64)
        s["active"] = active & (descend | can_pop)

    keep = ("best_t", "best_tri", "best_u", "best_v", "dropped")
    out = _Walk(n, state, keep).run(step, "active", lambda a: a)
    tri = out["best_tri"].to(torch.int32)
    best_t = torch.where(tri >= 0, out["best_t"], FLT_MAX)
    capped = out["dropped"].sum().to(torch.int32)
    return HitRecord(t=best_t, tri=tri, u=out["best_u"], v=out["best_v"]), capped


def bvh_any_hit(mesh: MeshData, bvh: LBVHData, ori: Vec3, d: Vec3,
                t_max: torch.Tensor, tables: Optional[WalkTables] = None):
    """Occlusion by the stackless escape-link walk (shadow rays):
    (occluded, 0 capped). A hit counts below t_max - 1e-3, the
    reference's shadow-segment shrink."""
    n = ori.shape[0]
    dev = ori.device
    tb = tables if tables is not None else walk_tables(mesh, bvh)
    state = dict(
        o=ori.stacked(), d=d.stacked(),
        inv=torch.stack([_signed_inv(c) for c in (d.x, d.y, d.z)], 1),
        limit=t_max - 1e-3,
        node=torch.zeros((n,), dtype=torch.int64, device=dev),
        occluded=torch.zeros((n,), dtype=torch.bool, device=dev))
    ni, last = tb.num_internal, tb.total - 1

    def step(s):
        node = s["node"]
        live = node >= 0
        node_c = node.clamp(0, last)
        is_leaf = node_c >= ni
        lk = tb.link[node_c]
        t, _, _, hit = _mt(s["o"], s["d"], tb.corners[node_c])
        occluded = s["occluded"] | (live & is_leaf & hit & (t < s["limit"]))
        s["occluded"] = occluded
        bhit, _ = _slab(tb.node_box[node_c], s["o"], s["inv"], s["limit"])
        descend = live & ~is_leaf & bhit
        nxt = torch.where(descend, lk[:, 0], lk[:, 3])
        s["node"] = torch.where(live & ~occluded, nxt, -1)

    out = _Walk(n, state, ("occluded",)).run(step, "node", lambda a: a >= 0)
    return out["occluded"], torch.zeros((), dtype=torch.int32, device=dev)


def traversal_cost(mesh: MeshData, bvh: LBVHData, ori: Vec3, d: Vec3,
                   tables: Optional[WalkTables] = None) -> torch.Tensor:
    """Per-ray traversal step counts (int32), the data behind the
    reference's BVH heatmap view: the escape-link walk with no t limit,
    counting the steps of each lane. Its reciprocal directions clamp
    |d| <= 1e-12 to +1e-12 whatever the sign, as tpt's do."""
    n = ori.shape[0]
    dev = ori.device
    tb = tables if tables is not None else walk_tables(mesh, bvh)
    inv = lambda c: 1.0 / torch.where(torch.abs(c) > 1e-12, c, 1e-12)
    state = dict(
        o=ori.stacked(), inv=torch.stack([inv(d.x), inv(d.y), inv(d.z)], 1),
        node=torch.zeros((n,), dtype=torch.int64, device=dev),
        count=torch.zeros((n,), dtype=torch.int32, device=dev))
    ni, last = tb.num_internal, tb.total - 1
    t_max = torch.full((), FLT_MAX, device=dev)

    def step(s):
        node = s["node"]
        live = node >= 0
        node_c = node.clamp(0, last)
        s["count"] = s["count"] + live.to(torch.int32)
        bhit, _ = _slab(tb.node_box[node_c], s["o"], s["inv"], t_max)
        descend = live & (node_c < ni) & bhit
        lk = tb.link[node_c]
        s["node"] = torch.where(live, torch.where(descend, lk[:, 0], lk[:, 3]),
                                -1)

    return _Walk(n, state, ("count",)).run(step, "node", lambda a: a >= 0)["count"]
