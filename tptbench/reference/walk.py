"""Exact ray casts over the reference's LBVH in plain PyTorch: a frozen
copy of the BVH_XLA walk of tpt_torch/bvh/traverse.py (closest hit with
a per-lane stack, near child first; any hit by the stackless escape
links) and of the Moller-Trumbore test of tpt_torch/integrators/
intersect.py. A lane whose stack would overflow raises: the reference
never drops a subtree."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .consts import FLT_MAX
from .vec import Vec3

STEP_CHECK = 8
STACK_DEPTH = 128


@dataclass(frozen=True)
class Tables:
    """Per-node rows: `link` [N, 4] (left, right, leaf triangle, escape;
    each clamped to >= 0 but the escape), `corners` [N, 9] (the leaf
    triangle's v0, v1, v2), `child_box` [N, 12], `node_box` [N, 6]."""

    link: torch.Tensor
    corners: torch.Tensor
    child_box: torch.Tensor
    node_box: torch.Tensor
    num_internal: int
    total: int


def tables(bvh: dict, p0: torch.Tensor, p1: torch.Tensor,
           p2: torch.Tensor) -> Tables:
    total = int(bvh["left"].shape[0])
    left = bvh["left"].clamp_min(0)
    right = bvh["right"].clamp_min(0)
    tri = bvh["prim_index"].clamp_min(0)
    box = torch.cat([bvh["amin"], bvh["amax"]], dim=1)
    return Tables(
        link=torch.stack([left, right, tri, bvh["escape"]], 1),
        corners=torch.cat([p0[tri], p1[tri], p2[tri]], 1),
        child_box=torch.cat([box[left], box[right]], 1).contiguous(),
        node_box=box.contiguous(), num_internal=(total + 1) // 2 - 1,
        total=total)


def moller_trumbore(ori: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3,
                    eps: float = 1e-9):
    """Returns (t, u, v, hit) with t > 1e-4 on hit."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    ok = torch.abs(det) > eps
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = ori - v0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    return t, u, v, hit


def _signed_inv(c: torch.Tensor) -> torch.Tensor:
    small = torch.where(c >= 0, 1e-12, -1e-12)
    return 1.0 / torch.where(torch.abs(c) > 1e-12, c, small)


def _slab(box, ori, inv, t_best):
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


def _mt(ori, d, corners):
    c = lambda k: Vec3(corners[:, k], corners[:, k + 1], corners[:, k + 2])
    v = lambda a: Vec3(a[:, 0], a[:, 1], a[:, 2])
    return moller_trumbore(v(ori), v(d), c(0), c(3), c(6))


def _run(n: int, state: dict, keep: tuple, step, live_fn) -> dict:
    """Step every live lane until none is left; once at most half the
    lanes are live, go on with those alone."""
    lane = torch.arange(n, device=state[keep[0]].device)
    out = {k: state[k].clone() for k in keep}

    def store():
        for k, v in out.items():
            v[lane] = state[k]

    while True:
        for _ in range(STEP_CHECK):
            step(state)
        idx = torch.nonzero(live_fn(state)).squeeze(1)
        m = int(idx.shape[0])
        if m == 0:
            break
        if 2 * m <= int(lane.shape[0]):
            store()
            state = {k: v[idx] for k, v in state.items()}
            lane = lane[idx]
    store()
    return out


def closest_hit(tb: Tables, ori: Vec3, d: Vec3, t_max: torch.Tensor):
    """(t, tri, u, v): t FLT_MAX and tri -1 on a miss."""
    n = ori.shape[0]
    dev = ori.x.device
    i64 = dict(dtype=torch.int64, device=dev)
    state = dict(
        o=ori.stacked(), d=d.stacked(),
        inv=torch.stack([_signed_inv(c) for c in (d.x, d.y, d.z)], 1),
        stack=torch.zeros((n, STACK_DEPTH), **i64),
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

        room = sp < STACK_DEPTH
        push = both & room
        s["dropped"] = s["dropped"] | (both & ~room)
        sp_idx = sp.clamp(0, STACK_DEPTH - 1)[:, None]
        cur = stack.gather(1, sp_idx)[:, 0]
        stack.scatter_(1, sp_idx, torch.where(push, far, cur)[:, None])
        sp = sp + push.to(torch.int64)

        descend = both | (lhit ^ rhit)
        nxt = torch.where(both, near, only)
        can_pop = active & ~descend & (sp > 0)
        popped = stack.gather(
            1, (sp - 1).clamp(0, STACK_DEPTH - 1)[:, None])[:, 0]
        s["node"] = torch.where(descend, nxt, torch.where(can_pop, popped, node))
        s["sp"] = sp - can_pop.to(torch.int64)
        s["active"] = active & (descend | can_pop)

    out = _run(n, state, ("best_t", "best_tri", "best_u", "best_v", "dropped"),
               step, lambda s: s["active"])
    if bool(out["dropped"].any()):
        raise RuntimeError(f"reference walk overflowed its {STACK_DEPTH}-deep "
                           f"stack on {int(out['dropped'].sum())} lanes")
    tri = out["best_tri"]
    t = torch.where(tri >= 0, out["best_t"], FLT_MAX)
    return t, tri, out["best_u"], out["best_v"]


def any_hit(tb: Tables, ori: Vec3, d: Vec3, t_max: torch.Tensor):
    """Occluded below t_max - 1e-3 (the shadow segment's shrink)."""
    n = ori.shape[0]
    dev = ori.x.device
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

    return _run(n, state, ("occluded",), step,
                lambda s: s["node"] >= 0)["occluded"]
