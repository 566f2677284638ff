"""Flat groups at coordinate 0 and grazing rays, on the CPU: why the
sweeps K4/K7 cull no row by group boxes, and that `sweep.sweep_need`
counts the rows they test.

The input (`torch_flatgroup`): two triangles A (id 0) and B (id 1) in the
plane y = 0 that share an edge, each alone in a treelet of 8 rows, and
one live lane of a 32-lane warp aimed near the shared edge. The plain
sweeps take B; the lane's slab test of either group box at A's t fails,
so a sweep that skipped the groups a warp misses at its best t kept A.
"""

import numpy as np
import torch

import torch_flatgroup as fg
from tpt_torch.bvh import sweep as sw
from tpt_torch.bvh.packet_traverse import _mt_rows, _slab
from tpt_torch.integrators.intersect import safe_inv

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def test_plain_sweeps_take_the_nearer_triangle():
    tables = fg.flat_tables("cpu")
    o, d, t_max, s_o, s_t = fg.flat_warp("cpu")
    for hits in (sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o, s_t,
                                             unroll=1),
                 sw.sweep_closest_hit_plain(tables, o, d, t_max, s_o, s_t),
                 sw.sweep_closest_hit_plain(tables, o, d, t_max, s_o, None)):
        assert hits.t[0] == _f32(fg.PLAIN_T) and int(hits.tri[0]) == 1
        assert bool((hits.tri[1:] == -1).all())
    # any-hit: occluded after treelet 0, the lane demands nothing more
    for hits in (sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o, s_t,
                                             unroll=1, any_hit=True),
                 sw.sweep_closest_hit_plain(tables, o, d, t_max, s_o, s_t,
                                            any_hit=True)):
        assert hits.t[0] == _f32(fg.CULLED_T) and int(hits.tri[0]) == 0
    # A alone gives the t a culling sweep kept: 2 ulp above B's
    a_only = sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o[:1],
                                         s_t[:1], unroll=1)
    assert a_only.t[0] == _f32(fg.CULLED_T) and int(a_only.tri[0]) == 0


def test_group_boxes_are_missed_at_the_hit():
    """The slab test of both group boxes fails at A's t and at B's: the
    entry t rounds above Möller–Trumbore's t on a flat group."""
    tables = fg.flat_tables("cpu")
    o, d, _, _, _ = fg.flat_warp("cpu")
    oo = [c[:1] for c in (o.x, o.y, o.z)]
    inv = [safe_inv(c[:1]) for c in (d.x, d.y, d.z)]
    gb = tables.group_boxes.reshape(2, 8, 8)[:, 0, :6]
    assert float(gb[1, 4] - gb[1, 1]) < 1e-29           # flat in y
    for t in (fg.PLAIN_T, fg.CULLED_T):
        for g in range(2):
            hit, tn = _slab(gb[g][None], oo, inv, _f32([t]), entry=True)
            assert not bool(hit[0]) and float(tn[0]) > t


def test_need_counts_every_row_of_the_union():
    """sweep_need counts B's rows for the live lane at A's t (and at
    B's): 8 rows of each treelet, no group slab test."""
    tables = fg.flat_tables("cpu")
    o, d, t_max, s_o, s_t = fg.flat_warp("cpu")
    plain = sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o, s_t,
                                        unroll=1)
    culled = sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o[:1],
                                         s_t[:1], unroll=1)
    for hits in (plain, culled):
        for lanes in (sw.LANES, sw.LANES_K7):
            assert sw.sweep_need(tables, o, d, t_max, s_o, s_t, hits,
                                 lanes=lanes) == (16, 0, 2)


def test_mt_takes_a_grazing_triangle_far_outside_its_box():
    """No slack on the limit of a group box's slab test bounds
    Möller–Trumbore's t: on a grazing ray it takes the triangle at a t
    where the ray is still far from the triangle's padded box."""
    row, gbox, o, d = fg.grazing_case()
    rows = torch.from_numpy(row)[None]                  # [1, 1, 16]
    oo = [torch.from_numpy(o[k:k + 1])[:, None] for k in range(3)]
    dd = [torch.from_numpy(d[k:k + 1])[:, None] for k in range(3)]
    t, u, v, hit = _mt_rows(rows, oo, dd)
    assert bool(hit[0, 0])
    t = float(t[0, 0])
    assert 0.06 < t < 0.07
    inv = [safe_inv(torch.from_numpy(d[k:k + 1])) for k in range(3)]
    enter, tn = _slab(torch.from_numpy(gbox[None, :6]),
                      [torch.from_numpy(o[k:k + 1]) for k in range(3)], inv,
                      _f32([2.0 * t]), entry=True)
    assert not bool(enter[0]) and float(tn[0]) > 3.5 * t


def test_stress_window_is_tpts():
    """On the flat grids, K4's plain group mode (tpt's window) and the
    full sweep agree, and sweep_need's window is below the full need."""
    for axis in range(3):
        tables, p, q = fg.stress_tables(axis, 5, "cpu")
        pool = fg.stress_pool(axis, (p, q), 512, 6, "cpu")
        full = sw.sweep8_closest_hit_plain(tables, *pool, unroll=1)
        win = sw.sweep8_closest_hit_plain(tables, *pool, unroll=1,
                                          use_groups=True)
        for f in ("t", "tri", "u", "v"):
            assert torch.equal(getattr(full, f), getattr(win, f))
        assert float((full.tri >= 0).float().mean()) > 0.8
        need = sw.sweep_need(tables, *pool, full)
        need_w = sw.sweep_need(tables, *pool, win, galign=1)
        assert need_w[0] <= need[0] and need_w[1] > 0 == need[1]
