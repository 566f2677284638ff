"""Sweep cast: scan -> bin sort -> demand sweep -> resolution -> tail, the
closest-hit pipeline of BVH_SWEEP for bounce rays. Counterpart of
`tpt/bvh/sweepcast.py` (the one-shot demand sweep; tpt's cascade, any-hit
and 1024-lane variants are not ported).

1. SCAN (K3 `sweep.dense_scan`): each ray's S nearest treelet candidates
   (entry t, ordinal) and thr, the exact lower bound on every candidate
   the slots could not hold.
2. BIN SORT: one stable sort of the pool by the bin key (slot1, slot0,
   direction octant), so the lanes of a 128-lane block agree on their
   candidates. The wavefront folds it into its pool sort
   (`wavefront._sweep_bin_sort`); `sweep_cast` does it itself.
3. SWEEP (K4 `sweep.sweep8_closest_hit`, demand mode).
4. RESOLUTION: a lane is exact iff its best t <= thr (no uncaptured
   candidate can beat it) or thr is 3e38 (the slots held every
   candidate).
5. TAIL: the unresolved lanes, exactly those, go through the wide-BVH K2
   with t_max = min(best, t_max) and the winners are scattered back.

What tpt does around this to suit the TPU is not ported, since it
changes no hit: the bf16-packed sort operands (truncated entry t only
makes tpt sweep a superset of slots), the tail's static prefix and its
overflow fallback, and K2's t_cull (the port's K2 culls each ray by its
own running best anyway).

The stages call the kernels' wrappers through their modules
(`sweep.dense_scan`, `sweep.sweep8_closest_hit`,
`packet_traverse.packet_closest_hit_wide`), so a measurement can wrap
them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

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
    idx = torch.nonzero(~resolved).squeeze(1)
    if idx.numel() == 0:
        return hit, torch.zeros((), dtype=torch.int32, device=ori.x.device)
    g = lambda a: a[idx]
    th, capped = packet_traverse.packet_closest_hit_wide(
        pack, Vec3(g(ori.x), g(ori.y), g(ori.z)), Vec3(g(d.x), g(d.y), g(d.z)),
        g(tail_tm))
    win = th.tri >= 0
    w = idx[win]

    def merge(cur, new):
        out = cur.clone()
        out[w] = new[win]
        return out

    return HitRecord(t=merge(hit.t, th.t), tri=merge(hit.tri, th.tri),
                     u=merge(hit.u, th.u), v=merge(hit.v, th.v)), capped


def sweep_cast_sorted(pack: PacketBVH, tables: SweepTables, ori: Vec3,
                      d: Vec3, t_max: torch.Tensor, s_o, s_t,
                      thr: torch.Tensor, unroll: int = 4
                      ) -> Tuple[HitRecord, torch.Tensor]:
    """Demand sweep + resolution + tail over a pool that is ALREADY sorted
    by the bin key (needed for speed, not for correctness); s_o/s_t/thr
    are the scan's planes in pool order. Returns (hits in pool order,
    capped count of the tail's K2); dead lanes (t_max <= 0) miss."""
    hit = sweep.sweep8_closest_hit(tables, ori, d, t_max, s_o, s_t,
                                   unroll=unroll)
    resolved, best = resolved_lanes(hit, thr)
    tail_tm = torch.where(resolved, 0.0, torch.minimum(best, t_max))
    return _tail_compact_cast(pack, ori, d, hit, resolved, tail_tm)


def sweep_cast(pack: PacketBVH, tables: SweepTables, ori: Vec3, d: Vec3,
               t_max: torch.Tensor, slots: int = 4, unroll: int = 4,
               key_slots: int = 2) -> Tuple[HitRecord, torch.Tensor]:
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
    hit, capped = sweep_cast_sorted(pack, tables, gv(ori), gv(d), g(t_max),
                                    s_o[:, perm], s_t[:, perm], g(thr),
                                    unroll=unroll)

    def unsort(a):
        out = torch.empty_like(a)
        out[perm] = a
        return out

    return HitRecord(t=unsort(hit.t), tri=unsort(hit.tri), u=unsort(hit.u),
                     v=unsort(hit.v)), capped
