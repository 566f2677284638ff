"""The frozen need counts of tptbench/roofline/ against the arithmetic
they copy: `tpt_torch.bvh.sweep.sweep_need` and chip_smoke.py's K3 and
K4 bounds, on a bin-sorted pool of a small fireplace."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpt_torch.bvh import sweep as sw
from tpt_torch.bvh import sweepcast as tsc
from tpt_torch.core.vec import Vec3
from tpt_torch.scene import procedural
from tptbench.roofline import need

S = 4
N = 900


@pytest.fixture(scope="module")
def pool():
    host = procedural.fireplace_like(num_triangles=3000, resolution=(32, 18))
    scene = host.build(with_bvh=True, sweep_chunk_align=8, device="cpu")
    tables = scene.sweep
    rs = np.random.default_rng(5)
    o = rs.uniform([50, 20, 50], [1150, 380, 850], (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(N, 3.4e38, np.float32)
    tm[::7] = -1.0                       # dead lanes
    v = lambda a: Vec3.from_stacked(torch.from_numpy(a))
    ori, dd, t_max = v(o), v(d), torch.from_numpy(tm)
    s_t, s_o, thr = sw.dense_scan_plain(tables, ori, dd, t_max, slots=S)
    key = tsc.bin_key(s_o, dd, tables.num_treelets, S)
    perm = tsc.bin_sort_perm([torch.where(t_max > 0, key, 1 << 30)])
    g = lambda a: a[..., perm].contiguous()
    ori = Vec3(g(ori.x), g(ori.y), g(ori.z))
    dd = Vec3(g(dd.x), g(dd.y), g(dd.z))
    t_max, s_o, s_t, thr = g(t_max), g(s_o), g(s_t), g(thr)
    hit, capped = tsc.sweep_cast_sorted(scene.pack, tables, ori, dd, t_max,
                                        s_o, s_t, thr, unroll=8)
    assert int(capped) == 0
    return tables, ori, dd, t_max, s_o, s_t, hit


def test_sweep_need_equals_the_program(pool):
    tables, ori, dd, t_max, s_o, s_t, hit = pool
    want = sw.sweep_need(tables, ori, dd, t_max, s_o, s_t, hit, lanes=sw.LANES)
    got = need.sweep_need(tables.tri_f32, tables.ranges, tables.unroll,
                          tables.num_treelets, t_max, s_o, s_t, hit.t,
                          hit.tri)
    assert want[0] > 0 and got == (want[0], want[2])


def test_bounds_equal_chip_smoke(pool):
    tables, ori, dd, t_max, s_o, s_t, hit = pool
    n = int(t_max.shape[0])
    assert (need.OPS_PER_SLAB, need.OPS_PER_TRI) == (
        chip_smoke.OPS_PER_SLAB, chip_smoke.OPS_PER_TRI)
    # K3: live lanes x treelet boxes slab tests
    alive = t_max > 0
    ops, nbytes = need.k3_need(alive, tables.num_treelets, S,
                               tables.boxes.numel())
    assert ops == 25 * int(alive.sum()) * tables.num_treelets
    k3_ms, _ = chip_smoke.sweep_bound(n, 28, 8 * S + 4,
                                      tables.boxes.numel() * 4, ops)
    assert need.least_seconds(ops, nbytes) * 1e3 == pytest.approx(k3_ms)
    # K4: chip_smoke.need_bound on sweep_need's counts
    want = sw.sweep_need(tables, ori, dd, t_max, s_o, s_t, hit, lanes=sw.LANES)
    k4_ms, _ = chip_smoke.need_bound(n, S, tables, want)
    ops, nbytes = need.k4_need(tables.tri_f32, tables.ranges,
                               tables.group_boxes, tables.unroll,
                               tables.num_treelets, t_max, s_o, s_t, hit.t,
                               hit.tri)
    assert need.least_seconds(ops, nbytes) * 1e3 == pytest.approx(k4_ms)
