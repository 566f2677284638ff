"""`tpt_torch.bvh.sweep.sweep_need`, the least work a demand sweep's raw
result needs (the bound chip_smoke.py holds K4 and K7 to), on the CPU.

The pool: rays in and around the 32x32 Cornell box, scanned (plain K3),
bin-sorted as the wavefront sorts a bounce pool and swept (plain K4/K7),
with dead lanes and a NaN origin. The need is held exactly against a
brute-force numpy count, at most the triangle tests of a sweep that
tests every row of each block's walked union
(`torch_sweep_walk.union_tests`), well below it in K4's group mode, and
unchanged when lanes are permuted within a warp (the need is per lane and
per block union)."""

import numpy as np
import pytest
import torch

from tpt_torch.bvh import sweep as sw
from tpt_torch.bvh import sweepcast as tsc
from tpt_torch.core.vec import Vec3
from tpt_torch.scene import procedural

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)
from torch_sweep_walk import union_tests

S = 4
N = 700                   # 6 K4 blocks, the last one short; one K7 block


@pytest.fixture(scope="module")
def pool():
    host = procedural.cornell_box(resolution=(32, 32))
    tables = host.build(with_bvh=True, device="cpu").sweep
    rs = np.random.default_rng(7)
    o = rs.uniform([20, 20, -20], [536, 528, 540], (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[5] = (0.0, -0.0, 1.0)
    o[6] = (np.nan, 100.0, 100.0)
    tm = np.full(N, 3.4e38, np.float32)
    tm[::13] = -1.0
    tm[40:60] = 150.0                    # short segments, as shadow rays
    v = lambda a: Vec3.from_stacked(torch.from_numpy(a))
    ori, dd, t_max = v(o), v(d), torch.from_numpy(tm)
    s_t, s_o, _ = sw.dense_scan_plain(tables, ori, dd, t_max, slots=S)
    key = tsc.bin_key(s_o, dd, tables.num_treelets, S)
    perm = tsc.bin_sort_perm([torch.where(t_max > 0, key, 1 << 30)])
    g = lambda a: a[..., perm].contiguous()
    return (tables, Vec3(g(ori.x), g(ori.y), g(ori.z)),
            Vec3(g(dd.x), g(dd.y), g(dd.z)), g(t_max), g(s_o), g(s_t))


# (lanes, any-hit, entry planes, group mode)
CASES = {"K4": (sw.LANES, False, True, False),
         "K4 any-hit": (sw.LANES, True, True, False),
         "K7 every slot": (sw.LANES_K7, False, False, False),
         "K4 groups": (sw.LANES, False, True, True)}


def _sweep(tables, ori, d, t_max, s_o, s_t, lanes, any_hit, galign=0):
    rpc = tables.unroll if lanes == sw.LANES else sw.K7_ROWS
    return sw._sweep_plain(tables, ori, d, t_max, s_o, s_t, lanes, rpc,
                           any_hit, galign)


def _need_case(pool, name):
    tables, ori, d, t_max, s_o, s_t = pool
    lanes, any_hit, demand, groups = CASES[name]
    e = s_t if demand else None
    galign = tables.chunk_align if groups else 0
    hits = _sweep(tables, ori, d, t_max, s_o, e, lanes, any_hit, galign)
    need = sw.sweep_need(tables, ori, d, t_max, s_o, e, hits, lanes=lanes,
                         any_hit=any_hit, galign=galign)
    return hits, e, need


def _brute_force(tables, ori, d, t_max, s_o, e, hits, lanes, any_hit,
                 groups):
    """The need lane by lane in numpy: every real row of each block's
    needed treelets for each live lane, or in the group mode the rows of
    the window of groups some lane (padded lanes too) enters, by float32
    slab tests with NaN-propagating min/max; rows counted from the
    table."""
    f32 = np.float32
    n = t_max.numel()
    tri = tables.tri_f32.numpy()
    ranges = tables.ranges.numpy()
    gbox = tables.group_boxes.numpy().reshape(-1, 8, 8)
    G = tables.chunk_align * tables.unroll
    o = np.stack([ori.x.numpy(), ori.y.numpy(), ori.z.numpy()], 1)
    dd = np.stack([d.x.numpy(), d.y.numpy(), d.z.numpy()], 1)
    inv = np.where(np.abs(dd) > f32(1e-12), dd,
                   np.where(dd >= 0, f32(1e-12), f32(-1e-12)))
    inv = (f32(1.0) / inv).astype(f32)
    tm = t_max.numpy()
    alive = tm > 0
    tmz = np.where(alive, tm, f32(0.0))
    found = hits.tri.numpy() >= 0
    bt = np.where(found, hits.t.numpy(), np.minimum(tmz, f32(3.4028235e38)))
    budget = bt.copy()
    if any_hit:
        budget[bt < (tmz - f32(1e-3)).astype(f32)] = -np.inf
    so = s_o.numpy()
    tri_tests = slab_tests = pairs = 0
    for b0 in range(0, n, lanes):
        ids = range(b0, min(n, b0 + lanes))
        U = set()
        for i in ids:
            for k in range(so.shape[0]):
                if alive[i] and so[k, i] != sw.NONE_ORD and (
                        e is None or e[k, i].item() < budget[i]):
                    U.add(int(so[k, i]))
        pairs += len(U)
        nlive = int(alive[b0:b0 + lanes].sum())
        # tpt's padding past n: zero rays with t_max 0
        npad = lanes - len(ids)
        oo = np.concatenate([o[b0:b0 + lanes], np.zeros((npad, 3), f32)])
        ii = np.concatenate([inv[b0:b0 + lanes],
                             np.full((npad, 3), f32(1e12))])
        bb = np.concatenate([bt[b0:b0 + lanes], np.zeros(npad, f32)])
        for t in sorted(U):
            start, nrows = int(ranges[t, 0]), int(ranges[t, 1]) * tables.unroll
            counts = [int((tri[start + min(g * G, nrows):
                              start + min((g + 1) * G, nrows), :9] != 0)
                           .any(1).sum()) for g in range(8)]
            assert nrows <= 8 * G          # no rows past the groups here
            if not groups:
                tri_tests += nlive * sum(counts)
                continue
            slab_tests += 8 * lanes
            b = gbox[t, :, :6]
            entered = np.zeros(8, bool)
            for j in range(lanes):
                t0 = (b[:, 0:3] - oo[j]) * ii[j]
                t1 = (b[:, 3:6] - oo[j]) * ii[j]
                tn = np.maximum(np.maximum(np.minimum(t0[:, 0], t1[:, 0]),
                                           np.minimum(t0[:, 1], t1[:, 1])),
                                np.maximum(np.minimum(t0[:, 2], t1[:, 2]),
                                           f32(0.0)))
                tf = np.minimum(np.minimum(np.maximum(t0[:, 0], t1[:, 0]),
                                           np.maximum(t0[:, 1], t1[:, 1])),
                                np.minimum(np.maximum(t0[:, 2], t1[:, 2]),
                                           bb[j]))
                entered |= tn <= tf
            if entered.any():
                g0, g1 = np.flatnonzero(entered)[[0, -1]]
                tri_tests += nlive * sum(counts[g0:g1 + 1])
    return tri_tests, slab_tests, pairs


@pytest.mark.parametrize("name", list(CASES))
def test_need_equals_brute_force(pool, name):
    tables, ori, d, t_max, s_o, s_t = pool
    hits, e, need = _need_case(pool, name)
    lanes, any_hit, _, groups = CASES[name]
    with np.errstate(over="ignore", invalid="ignore"):  # (box - o) * 1e12
        want = _brute_force(tables, ori, d, t_max, s_o, e, hits, lanes,
                            any_hit, groups)
    assert need == want
    assert need[0] > 0 and need[2] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_need_below_union_tests(pool, name):
    """The need is at most what a sweep of each block's whole walked
    union tests; K4's group mode windows cut it well below that here."""
    tables, ori, d, t_max, s_o, s_t = pool
    _, e, need = _need_case(pool, name)
    lanes, any_hit, _, groups = CASES[name]
    rpc = tables.unroll if lanes == sw.LANES else sw.K7_ROWS
    union = union_tests(tables, ori, d, t_max, s_o, e, lanes, rpc, any_hit)
    assert 0 < need[0] <= union
    if groups:
        assert need[0] < 0.8 * union


def test_need_ignores_lane_order_within_a_warp(pool):
    tables, ori, d, t_max, s_o, s_t = pool
    _, _, need = _need_case(pool, "K4")
    rs = np.random.default_rng(3)
    perm = np.arange(N)
    for w in range(0, N, 32):
        perm[w:w + 32] = w + rs.permutation(len(perm[w:w + 32]))
    perm = torch.from_numpy(perm)
    g = lambda a: a[..., perm].contiguous()
    shuffled = (tables, Vec3(g(ori.x), g(ori.y), g(ori.z)),
                Vec3(g(d.x), g(d.y), g(d.z)), g(t_max), g(s_o), g(s_t))
    assert _need_case(shuffled, "K4")[2] == need
