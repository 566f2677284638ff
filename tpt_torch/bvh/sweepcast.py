"""Sweep cast: scan -> bin sort -> demand sweep -> resolution -> tail, the
closest-hit pipeline of BVH_SWEEP, its two-phase cascade and its any-hit
pipeline. Counterpart of `tpt/bvh/sweepcast.py`.

1. SCAN (K3 `sweep.dense_scan`): each ray's S nearest treelet candidates
   (entry t, ordinal) and thr, the exact lower bound on every candidate
   the slots could not hold.
2. BIN SORT: one stable sort of the pool by the bin key (slot1, slot0,
   direction octant), so the lanes of a block agree on their candidates.
   The wavefront folds it into its pool sort (`wavefront._sweep_bin_sort`);
   `sweep_cast` does it itself.
3. SWEEP, demand mode: K4 `sweep.sweep8_closest_hit` over 128-lane
   blocks (kernel "sublane"; with `groups`, tpt's group-window mode), or
   K7 `sweep.sweep_closest_hit` over 1024-lane blocks (kernel "lane").
4. RESOLUTION: a lane is exact iff its best t <= thr (no uncaptured
   candidate can beat it) or thr is 3e38 (the slots held every
   candidate).
5. TAIL: the unresolved lanes, exactly those, go through the wide-BVH K2
   with t_max = min(best, t_max) and the winners are scattered back.

The cascade (`cascade_phase1`, `cascade_sort`, `cascade_phase2`) sweeps
only slots 0-1 first, the slots the bin key makes a block agree on; the
lanes that this leaves unresolved are compacted, sorted by the bin key of
their other slots and swept on those, then resolved and finished by the
tail. `sweep_any_hit` answers occlusion through K3 and the sweep's
any-hit mode in the caller's lane order, and sends exactly the lanes it
cannot resolve to the wide any-hit K1.

What tpt does around this to suit the TPU is not ported, since it
changes no hit: the bf16-packed sort operands (truncated entry t only
makes tpt sweep a superset of slots), the static prefixes of the tail,
of the cascade's phase 2 and of the any-hit tail with their overflow
fallbacks (cfg.sweep_cascade_frac sizes tpt's phase-2 prefix; here every
unresolved lane goes to phase 2, so it has no counterpart), and K2's t_cull
(the port's K2 culls each ray by its own running best anyway).

The stages call the kernels' wrappers through their modules
(`sweep.dense_scan`, `sweep.sweep8_closest_hit`, `sweep.sweep_closest_hit`,
`packet_traverse.packet_closest_hit_wide`,
`packet_traverse.packet_any_hit_wide`), so a measurement can wrap them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import trace
from ..core.vec import Vec3
from ..integrators.intersect import FLT_MAX, HitRecord
from . import packet_traverse, sweep
from .pack import PacketBVH
from .sweep import _INF
from .treelet import SweepTables


def _octant(d: Vec3) -> torch.Tensor:
    return ((d.x >= 0).to(torch.int32) * 4 + (d.y >= 0).to(torch.int32) * 2
            + (d.z >= 0).to(torch.int32))


def bin_key(s_o, d: Vec3, T: int, slots: int,
            with_octant: bool = True) -> torch.Tensor:
    """(slot1, slot0, direction octant) composite int32 sort key; ordinals
    capped at T ("none"). with_octant=False leaves the octant to bin_key2
    (the 2-key sort)."""
    assert (T + 1) * (T + 1) * 8 < 2 ** 31
    o_cap = [torch.clamp_max(s_o[i], T).to(torch.int32) for i in range(slots)]
    key = o_cap[1] * (T + 1) + o_cap[0] if slots > 1 else o_cap[0]
    return key * 8 + _octant(d) if with_octant else key


def bin_key2(s_o, d: Vec3, T: int, slots: int) -> torch.Tensor:
    """Secondary key (slot2, direction octant) of the 2-key bin sort
    (cfg.sweep_key_slots = 3)."""
    o2 = (torch.clamp_max(s_o[2], T).to(torch.int32) if slots > 2
          else torch.zeros_like(s_o[0], dtype=torch.int32))
    return o2 * 8 + _octant(d)


def bin_sort_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation of a stable lexicographic sort by `keys` (first key
    major), as tpt's lax.sort(num_keys=len(keys)) orders the lanes."""
    perm = torch.sort(keys[-1], stable=True).indices
    for key in reversed(keys[:-1]):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def resolved_lanes(hit: HitRecord, thr: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(resolved mask, best t): a lane is exact when no candidate the
    slots missed can hold a nearer hit."""
    best = torch.where(hit.tri >= 0, hit.t, FLT_MAX)
    return (thr >= _INF) | (best <= thr), best


def _tail_compact_cast(pack: PacketBVH, ori: Vec3, d: Vec3, hit: HitRecord,
                       resolved: torch.Tensor, tail_tm: torch.Tensor
                       ) -> Tuple[HitRecord, torch.Tensor]:
    """K2 over exactly the unresolved lanes, winners scattered back into
    the caller's lane order. Returns (HitRecord, capped int32 count)."""
    with trace.span("cast.tail"):
        with trace.wait("tail"):
            idx = torch.nonzero(~resolved).squeeze(1)
            m = idx.numel()
        if m == 0:
            return hit, torch.zeros((), dtype=torch.int32,
                                    device=ori.x.device)
        g = lambda a: a[idx]
        th, capped = packet_traverse.packet_closest_hit_wide(
            pack, Vec3(g(ori.x), g(ori.y), g(ori.z)),
            Vec3(g(d.x), g(d.y), g(d.z)), g(tail_tm))
        win = th.tri >= 0
        # each boolean-mask gather waits for its count on the host
        with trace.wait("merge"):
            w = idx[win]

        def merge(cur, new):
            out = cur.clone()
            with trace.wait("merge"):
                out[w] = new[win]
            return out

        return HitRecord(t=merge(hit.t, th.t), tri=merge(hit.tri, th.tri),
                         u=merge(hit.u, th.u), v=merge(hit.v, th.v)), capped


def _sweep(tables: SweepTables, ori: Vec3, d: Vec3, t_max: torch.Tensor,
           s_o, s_t, kernel: str, unroll: int, groups: bool,
           any_hit: bool = False) -> HitRecord:
    """The demand sweep of `kernel`: "sublane" K4, "lane" K7 (which has
    no group mode and no unroll, as tpt's)."""
    if kernel == "sublane":
        return sweep.sweep8_closest_hit(tables, ori, d, t_max, s_o, s_t,
                                        unroll=unroll, any_hit=any_hit,
                                        use_groups=groups)
    if kernel == "lane":
        return sweep.sweep_closest_hit(tables, ori, d, t_max, s_o, s_t,
                                       any_hit=any_hit)
    raise ValueError(f"unknown sweep kernel {kernel!r} (sublane, lane)")


def cascade_phase1(tables: SweepTables, ori: Vec3, d: Vec3,
                   t_max: torch.Tensor, s_o, s_t, thr: torch.Tensor,
                   unroll: int = 4, groups: bool = False):
    """Phase 1: demand-sweep slots 0-1 (K4), then compact the lanes it
    leaves unresolved, in pool order. A lane resolves iff its best hit
    precedes every candidate the sweep did not cover: slots >= 2 (entry
    >= s_t[2]) and thr. Returns (hit1, resolved1, bundle), the bundle
    being (key2, ox, oy, oz, dx, dy, dz, tm2, rest ordinals [S-2, m],
    rest entries [S-2, m], pool index [m]) of the m unresolved lanes, with
    key2 the bin key of their slots 2.. and tm2 = min(best, t_max)."""
    S = len(s_o)
    if S <= 2:
        raise ValueError("the cascade needs more than 2 candidate slots")
    hit1 = sweep.sweep8_closest_hit(tables, ori, d, t_max, s_o[:2], s_t[:2],
                                    unroll=unroll, use_groups=groups)
    best1 = torch.where(hit1.tri >= 0, hit1.t, FLT_MAX)
    bound = torch.minimum(s_t[2], thr)
    resolved1 = (bound >= _INF) | (best1 <= bound)
    with trace.wait("cascade"):
        ti = torch.nonzero(~resolved1).squeeze(1)
    g = lambda a: a[..., ti].contiguous()
    d2 = Vec3(g(d.x), g(d.y), g(d.z))
    so2, st2 = g(torch.stack(list(s_o[2:]))), g(torch.stack(list(s_t[2:])))
    key2 = bin_key(so2, d2, tables.num_treelets, S - 2)
    bundle = (key2, g(ori.x), g(ori.y), g(ori.z), d2.x, d2.y, d2.z,
              g(torch.minimum(best1, t_max)), so2, st2, ti)
    return hit1, resolved1, bundle


def cascade_sort(bundle):
    """Phase 2's bin sort: the bundle in stable (slot3, slot2, octant)
    order."""
    perm = bin_sort_perm([bundle[0]])
    return tuple(a[..., perm].contiguous() for a in bundle)


def cascade_phase2(pack: PacketBVH, tables: SweepTables, ori: Vec3, d: Vec3,
                   t_max: torch.Tensor, thr: torch.Tensor, hit1: HitRecord,
                   resolved1: torch.Tensor, sorted_bundle, unroll: int = 4,
                   groups: bool = False) -> Tuple[HitRecord, torch.Tensor]:
    """Phase 2: demand-sweep the sorted bundle's lanes on their other
    slots (K4), scatter the winners back, resolve every lane of the
    bundle against thr, and finish the rest with the tail. ori/d/t_max/thr
    are the whole pool's planes; returns (hits in pool order, capped)."""
    (_, ox, oy, oz, dx, dy, dz, tm2, so2, st2, ti) = sorted_bundle
    hit2 = sweep.sweep8_closest_hit(tables, Vec3(ox, oy, oz),
                                    Vec3(dx, dy, dz), tm2, so2, st2,
                                    unroll=unroll, use_groups=groups)
    win = hit2.tri >= 0
    with trace.wait("merge"):
        w = ti[win]

    def merge(cur, new):
        out = cur.clone()
        with trace.wait("merge"):
            out[w] = new[win]
        return out

    hit = HitRecord(t=merge(hit1.t, hit2.t), tri=merge(hit1.tri, hit2.tri),
                    u=merge(hit1.u, hit2.u), v=merge(hit1.v, hit2.v))
    # every lane of the bundle has now swept all its slots
    completed = torch.zeros_like(resolved1)
    with trace.wait("cascade"):
        completed[ti[tm2 > 0]] = True
    r, best = resolved_lanes(hit, thr)
    resolved = resolved1 | (completed & r)
    tail_tm = torch.where(resolved, 0.0, torch.minimum(best, t_max))
    return _tail_compact_cast(pack, ori, d, hit, resolved, tail_tm)


def sweep_cast_sorted(pack: PacketBVH, tables: SweepTables, ori: Vec3,
                      d: Vec3, t_max: torch.Tensor, s_o, s_t,
                      thr: torch.Tensor, kernel: str = "sublane",
                      unroll: int = 4, groups: bool = False,
                      cascade: bool = False
                      ) -> Tuple[HitRecord, torch.Tensor]:
    """Demand sweep + resolution + tail over a pool that is ALREADY sorted
    by the bin key (needed for speed, not for correctness); s_o/s_t/thr
    are the scan's planes in pool order. `cascade` runs the two-phase
    cascade where tpt does (more than 2 slots, kernel "sublane").
    Returns (hits in pool order, capped count of the tail's K2); dead
    lanes (t_max <= 0) miss."""
    if cascade and len(s_o) > 2 and kernel == "sublane":
        hit1, resolved1, bundle = cascade_phase1(
            tables, ori, d, t_max, s_o, s_t, thr, unroll=unroll, groups=groups)
        return cascade_phase2(pack, tables, ori, d, t_max, thr, hit1,
                              resolved1, cascade_sort(bundle), unroll=unroll,
                              groups=groups)
    hit = _sweep(tables, ori, d, t_max, s_o, s_t, kernel, unroll, groups)
    resolved, best = resolved_lanes(hit, thr)
    tail_tm = torch.where(resolved, 0.0, torch.minimum(best, t_max))
    return _tail_compact_cast(pack, ori, d, hit, resolved, tail_tm)


def sweep_any_hit(pack: PacketBVH, tables: SweepTables, ori: Vec3, d: Vec3,
                  t_max: torch.Tensor, slots: int = 4,
                  kernel: str = "sublane", unroll: int = 4,
                  groups: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occlusion through the sweep: True where a triangle blocks [1e-4,
    t_max - 1e-3), False on dead lanes (t_max <= 0). K3 and the sweep's
    any-hit mode run in the caller's lane order (no bin sort); a lane is
    exact when it is occluded or when thr >= t_max - 1e-3 (no uncaptured
    candidate lies before the endpoint margin), and the others, exactly
    those, go through K1. Returns (occluded, capped count of K1)."""
    s_t, s_o, thr = sweep.dense_scan(tables, ori, d, t_max, slots=slots)
    hit = _sweep(tables, ori, d, t_max, s_o, s_t, kernel, unroll, groups,
                 any_hit=True)
    live = t_max > 0
    occ = live & (hit.tri >= 0) & (hit.t < t_max - 1e-3)
    resolved = occ | (thr >= t_max - 1e-3) | ~live
    with trace.span("cast.tail"):
        with trace.wait("tail"):
            idx = torch.nonzero(~resolved).squeeze(1)
            m = idx.numel()
        if m == 0:
            return occ, torch.zeros((), dtype=torch.int32,
                                    device=ori.x.device)
        g = lambda a: a[idx]
        to, capped = packet_traverse.packet_any_hit_wide(
            pack, Vec3(g(ori.x), g(ori.y), g(ori.z)),
            Vec3(g(d.x), g(d.y), g(d.z)), g(t_max))
        occ[idx] = to
        return occ, capped


def sweep_cast(pack: PacketBVH, tables: SweepTables, ori: Vec3, d: Vec3,
               t_max: torch.Tensor, slots: int = 4, kernel: str = "sublane",
               unroll: int = 4, key_slots: int = 2, groups: bool = False,
               cascade: bool = False) -> Tuple[HitRecord, torch.Tensor]:
    """Exact closest hit (equal to brute force up to equal-t ties) for an
    unsorted pool: scan, bin sort, sweep_cast_sorted, unsort. key_slots=3
    sorts by ((slot1, slot0), (slot2, octant)). Returns (HitRecord,
    capped count)."""
    s_t, s_o, thr = sweep.dense_scan(tables, ori, d, t_max, slots=slots)
    T = tables.num_treelets
    two_key = key_slots >= 3 and slots > 2
    keys = [bin_key(s_o, d, T, slots, with_octant=not two_key)]
    if two_key:
        keys.append(bin_key2(s_o, d, T, slots))
    perm = bin_sort_perm(keys)
    g = lambda a: a[perm]
    gv = lambda v: Vec3(g(v.x), g(v.y), g(v.z))
    hit, capped = sweep_cast_sorted(
        pack, tables, gv(ori), gv(d), g(t_max), s_o[:, perm], s_t[:, perm],
        g(thr), kernel=kernel, unroll=unroll, groups=groups, cascade=cascade)

    def unsort(a):
        out = torch.empty_like(a)
        out[perm] = a
        return out

    return HitRecord(t=unsort(hit.t), tri=unsort(hit.tri), u=unsort(hit.u),
                     v=unsort(hit.v)), capped
