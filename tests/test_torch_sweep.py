"""The port's BVH_SWEEP pipeline (treelet and sweep tables, K3 dense scan,
K4 demand sweep, bin keys, sweep cast) against tpt on the CPU.

tpt's Pallas kernels run in interpret mode, as tests/test_sweep.py runs
them; the port's wrappers run their plain PyTorch versions. Both get the
same tables (tpt's, carried across with from_numpy_scene) and the same
numpy rays. Tolerances:
- tables, K3's outputs, the bin keys and K4's triangles are held exactly;
- K4's t to rtol 1e-5 and u, v to atol 1e-4: XLA's CPU backend contracts
  the Moller-Trumbore multiply-adds into FMAs (measured on these rays: up
  to 15 ulp in t, 1.6e-5 in u), while the port rounds every product and
  sum in float32 as the card's kernel does (built -fmad=false). K3 has no
  multiply-add (a difference, then a product), so it matches exactly.
The port's sweep casts are also held against its own wide-BVH walk (K2,
the same float32 arithmetic): t exactly, triangles up to equal-t ties.
The CUDA kernels are held against the plain versions by
tests/test_torch_gpu.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.bvh import pallas_sweep as jps
from tpt.bvh import sweepcast as jsc
from tpt.bvh.treelet import SweepTables as JSweepTables
from tpt.core.camera import generate_camera_rays as jcamera_rays
from tpt.scene import procedural as jproc
from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.bvh import sweep as ts
from tpt_torch.bvh import sweepcast as tsc
from tpt_torch.bvh import treelet as tt
from tpt_torch.bvh.treelet import SweepTables
from tpt_torch.scene import procedural as tproc
from tpt_torch.scene.convert import from_numpy_scene

from torch_port_helpers import np3, random_rays, scene_leaves, to_jax3, to_torch3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

N_POOL = 1024
NONE = ts.NONE_ORD


def _scene(name, align):
    if name == "fireplace":
        jhost = jproc.fireplace_like(num_triangles=2000, resolution=(64, 32))
        thost = tproc.fireplace_like(num_triangles=2000, resolution=(64, 32))
    else:
        jhost = jproc.cornell_box(resolution=(24, 24))
        thost = tproc.cornell_box(resolution=(24, 24))
    jd = jhost.build(with_bvh=True, treelet_max_tris=256,
                     sweep_chunk_align=align, prep_cache=False)
    return jhost, thost, jd


@pytest.fixture(scope="module")
def fire():
    """The fireplace of tests/test_sweep.py:24-33 (2000 triangles,
    treelets of <= 256), tables at chunk_align 4 and 8, and the port's
    scene on tpt's tables."""
    jhost, _, jd4 = _scene("fireplace", 4)
    jd8 = _scene("fireplace", 8)[2]
    td4 = from_numpy_scene(**scene_leaves(jd4), device="cpu")
    td8 = from_numpy_scene(**scene_leaves(jd8), device="cpu")
    return jhost, {4: (jd4, td4), 8: (jd8, td8)}


@pytest.fixture(scope="module")
def pool(fire):
    """An adversarial bounce-like pool: camera rays, random rays inside
    the room, dead lanes, a NaN origin, a NaN direction, an infinite
    origin and direction components of +0 and -0."""
    jhost = fire[0]
    _, d_cam, _ = jcamera_rays(jhost.camera, jnp.uint32(3))
    o_cam = np.broadcast_to(np.asarray(jhost.camera.position, np.float32),
                            (jhost.camera.num_pixels, 3))
    k = N_POOL // 2
    sel = np.linspace(0, jhost.camera.num_pixels - 1, k).astype(int)
    pos = np3(fire[1][4][0].mesh.positions)
    o_r, d_r = random_rays(N_POOL - k, pos.min(0), pos.max(0), 5)
    o = np.concatenate([o_cam[sel], o_r]).astype(np.float32)
    d = np.concatenate([np3(d_cam)[sel], d_r]).astype(np.float32)
    d[10] = (0.0, -0.0, 1.0)
    d[11] = (-0.0, 1.0, 0.0)
    d[600] = (0.0, 0.0, -1.0)
    d[601] = (-0.0, -0.0, -1.0)
    o[700] = (np.nan, 0.0, 0.0)
    d[701] = (np.nan, 0.5, 0.5)
    o[702] = (np.inf, 1.0, 1.0)
    tm = np.full(N_POOL, 3.4e38, np.float32)
    tm[::9] = -1.0
    tm[13] = 0.0
    tm[14] = np.nan
    return o, d, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def _tpt_scan(jd, o, d, tm, S):
    s_t, s_o, thr = jps.dense_scan(jd.sweep, to_jax3(o), to_jax3(d),
                                   jnp.asarray(tm), slots=S)
    return np.asarray(s_t), np.asarray(s_o), np.asarray(thr)


@pytest.mark.parametrize("name", ["fireplace", "cornell"])
@pytest.mark.parametrize("align", [4, 8])
def test_tables_equal_tpt(name, align):
    """The port's own build (SAH, wide pack, treelet cut, sweep tables)
    equals tpt's, array for array."""
    _, thost, jd = _scene(name, align)
    td = thost.build(with_bvh=True, treelet_max_tris=256,
                     sweep_chunk_align=align, device="cpu")
    for f in ("top_f32", "top_child", "top_tref", "top_tord"):
        np.testing.assert_array_equal(getattr(td.pack, f).numpy(),
                                      np.asarray(getattr(jd.pack, f)), err_msg=f)
    for f in ("num_top", "num_treelets", "treelet_max"):
        assert getattr(td.pack, f) == getattr(jd.pack, f), f
    for f in ("tri_f32", "ranges", "boxes", "group_boxes"):
        np.testing.assert_array_equal(getattr(td.sweep, f).numpy(),
                                      np.asarray(getattr(jd.sweep, f)),
                                      err_msg=f)
    for f in ("num_treelets", "max_chunks", "unroll", "chunk_align"):
        assert getattr(td.sweep, f) == getattr(jd.sweep, f), f


def test_treelet_cut_of_carried_pack(fire):
    """attach_treelets + sweep_tables on tpt's pack (carried across
    without its top tree) reproduce tpt's tables, also in the one-treelet
    case of a scene that fits a single treelet."""
    from tpt.bvh import treelet as jt

    jd, td = fire[1][4]
    strip = dict(top_f32=None, top_child=None, top_tref=None, top_tord=None,
                 num_top=0, num_treelets=0, treelet_max=0)
    bare = dataclasses.replace(td.pack, **strip)
    jbare = dataclasses.replace(jd.pack, **strip)
    for max_tris, align in ((256, 4), (10 ** 6, 8)):
        cut = tt.attach_treelets(bare, max_tris=max_tris)
        jcut = jt.attach_treelets(jbare, max_tris=max_tris)
        sw = tt.sweep_tables(cut, chunk_align=align)
        jsw = jt.sweep_tables(jcut, chunk_align=align)
        for f in ("top_f32", "top_child", "top_tref", "top_tord"):
            np.testing.assert_array_equal(getattr(cut, f).numpy(),
                                          np.asarray(getattr(jcut, f)))
        for f in ("tri_f32", "ranges", "boxes", "group_boxes"):
            np.testing.assert_array_equal(getattr(sw, f).numpy(),
                                          np.asarray(getattr(jsw, f)))
        assert (sw.num_treelets, sw.max_chunks) == (jsw.num_treelets,
                                                    jsw.max_chunks)
    assert cut.num_treelets == 1 and cut.num_top == 1


@pytest.mark.parametrize("S", [2, 4])
def test_dense_scan_matches_tpt(fire, pool, S):
    """K3 plain equals tpt's dense_scan exactly on s_t, s_o and thr."""
    jd, td = fire[1][4]
    o, d, tm = pool
    want = _tpt_scan(jd, o, d, tm, S)
    got = ts.dense_scan(td.sweep, to_torch3(o), to_torch3(d), _t(tm), slots=S)
    for g, w, what in zip(got, want, ("s_t", "s_o", "thr")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    s_o, thr = got[1].numpy(), got[2].numpy()
    dead = ~(tm > 0)
    assert (s_o[:, dead] == NONE).all() and (thr[dead] == 3.0e38).all()
    assert (s_o[:, 700] == NONE).all()              # NaN origin: no candidate
    assert (s_o[0, ~dead] != NONE).mean() > 0.5
    assert (thr < 3.0e38).any()


def _bin_sorted(jd, o, d, tm, S=4):
    """The pool sorted by tpt's bin key, with tpt's scan planes."""
    s_t, s_o, thr = _tpt_scan(jd, o, d, tm, S)
    key = np.asarray(jsc.bin_key(jnp.asarray(s_o), to_jax3(d),
                                 jd.sweep.num_treelets, S))
    perm = np.argsort(key, kind="stable")
    return o[perm], d[perm], tm[perm], s_o[:, perm], s_t[:, perm], thr[perm]


def _close_hits(got, want):
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize("unroll", [4, 8])
def test_sweep8_matches_tpt(fire, pool, unroll):
    """K4 plain equals tpt's sweep8_closest_hit on the bin-sorted pool
    (triangles exactly; t, u, v to the FMA tolerance above)."""
    jd, td = fire[1][unroll]
    o, d, tm, s_o, s_t, thr = _bin_sorted(jd, *pool)
    want = jps.sweep8_closest_hit(
        jd.sweep, to_jax3(o), to_jax3(d), jnp.asarray(tm),
        tuple(jnp.asarray(p) for p in s_o), tuple(jnp.asarray(p) for p in s_t),
        unroll_chunks=unroll)
    got = ts.sweep8_closest_hit(td.sweep, to_torch3(o), to_torch3(d), _t(tm),
                                _t(s_o), _t(s_t), unroll=unroll)
    _close_hits(got, want)
    assert (got.tri.numpy()[~(tm > 0)] == -1).all()
    assert (got.tri.numpy() >= 0).mean() > 0.3


def test_sweep8_cyclic_ordinals_equal_brute_force(fire):
    """Cyclic ordinals make every block sweep every treelet, so K4 equals
    the global closest hit (tests/test_sweep.py:37): against tpt's brute
    force, and the unroll contract is kept."""
    from tpt.integrators.intersect import brute_force_closest_hit

    jhost, scenes = fire
    jd, td = scenes[4]
    o, d, _ = jcamera_rays(jhost.camera, jnp.uint32(1))
    n = jhost.camera.num_pixels
    t_max = np.full(n, 3.4e38, np.float32)
    ordinal = (np.arange(n) % td.sweep.num_treelets).astype(np.int32)[None]
    entry = np.zeros((1, n), np.float32)
    got = ts.sweep8_closest_hit(td.sweep, to_torch3(np3(o)), to_torch3(np3(d)),
                                _t(t_max), _t(ordinal), _t(entry))
    want = brute_force_closest_hit(jd.mesh, o, d, jnp.asarray(t_max))
    _close_hits(got, want)
    with pytest.raises(AssertionError, match="chunk_align"):
        ts.sweep8_closest_hit(td.sweep, to_torch3(np3(o)), to_torch3(np3(d)),
                              _t(t_max), _t(ordinal), _t(entry), unroll=8)


def _tie_tables(tables_cls, arr):
    """Two treelets of one 8-row chunk each; treelet 0 row 0 and treelet 1
    row 8 hold the same triangle (ids 5 and 9)."""
    tri = np.zeros((16, 16), np.float32)
    for row, tid in ((0, 5.0), (8, 9.0)):
        tri[row, 0:3] = (-1.0, -1.0, 2.0)     # v0
        tri[row, 3:6] = (3.0, 0.0, 0.0)       # e1
        tri[row, 6:9] = (0.0, 3.0, 0.0)       # e2
        tri[row, 9] = tid
    boxes = np.zeros((2, 8), np.float32)
    boxes[:, 0:6] = (-1.0, -1.0, 2.0, 2.0, 2.0, 2.0)
    ranges = np.array([[0, 1], [8, 1]], np.int32)
    return tables_cls(tri_f32=arr(tri), ranges=arr(ranges), boxes=arr(boxes),
                      group_boxes=None, num_treelets=2, max_chunks=1,
                      unroll=8, chunk_align=1)


def test_equal_t_ties_take_the_smallest_row():
    """Identical triangles in two treelets: every lane of a block whose
    union holds both gets the smaller packed row, whichever treelet the
    lane asked for, in both packages."""
    n = 256
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.linspace(-0.5, 0.5, n)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    tm = np.full(n, 3.4e38, np.float32)
    ordinal = np.where(np.arange(n) % 2 == 0, 1, 0).astype(np.int32)[None]
    ordinal[0, 128:] = 1                      # block 2 asks for treelet 1 only
    entry = np.zeros((1, n), np.float32)
    got = ts.sweep8_closest_hit(_tie_tables(SweepTables, _t), to_torch3(o),
                                to_torch3(d), _t(tm), _t(ordinal), _t(entry),
                                unroll=1)
    want = jps.sweep8_closest_hit(
        _tie_tables(JSweepTables, jnp.asarray), to_jax3(o), to_jax3(d),
        jnp.asarray(tm), (jnp.asarray(ordinal[0]),), (jnp.asarray(entry[0]),),
        unroll_chunks=1)
    _close_hits(got, want)
    tri = got.tri.numpy()
    assert (tri[:128] == 5).all() and (tri[128:] == 9).all()


def test_bin_keys_exact(fire, pool):
    jd, td = fire[1][4]
    o, d, tm = pool
    T = jd.sweep.num_treelets
    for S in (1, 2, 3, 4):
        # the port's scan: equal to tpt's (test_dense_scan_matches_tpt)
        s_o = ts.dense_scan(td.sweep, to_torch3(o), to_torch3(d), _t(tm),
                            slots=S)[1].numpy()
        for octant in (True, False):
            np.testing.assert_array_equal(
                tsc.bin_key(_t(s_o), to_torch3(d), T, S,
                            with_octant=octant).numpy(),
                np.asarray(jsc.bin_key(jnp.asarray(s_o), to_jax3(d), T, S,
                                       with_octant=octant)))
        np.testing.assert_array_equal(
            tsc.bin_key2(_t(s_o), to_torch3(d), T, S).numpy(),
            np.asarray(jsc.bin_key2(jnp.asarray(s_o), to_jax3(d), T, S)))
    keys = [_t(np.array([2, 1, 2, 1, 0], np.int32)),
            _t(np.array([0, 1, 0, 0, 9], np.int32))]
    assert tsc.bin_sort_perm(keys).tolist() == [4, 3, 1, 0, 2]


def _k2(td, o, d, tm):
    hit, capped = pt.packet_closest_hit_wide(td.pack, to_torch3(o), to_torch3(d),
                                             _t(tm))
    assert int(capped) == 0
    return hit


def _equal_to_k2(got, want):
    """t exactly; triangles, u and v wherever t is not an equal-t tie."""
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())
    same = got.tri.numpy() == want.tri.numpy()
    assert (~same).mean() <= 1e-3, (~same).sum()
    for f in ("u", "v"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[same],
                                      getattr(want, f).numpy()[same])


def _live_tm(tm):
    return np.where(tm > 0, tm, -1.0).astype(np.float32)


@pytest.mark.parametrize("slots,key_slots,unroll,align", [
    (4, 2, 4, 4), (4, 3, 8, 8), (1, 2, 4, 4)])
def test_sweep_cast_exact(fire, pool, slots, key_slots, unroll, align):
    """The whole unsorted-pool pipeline equals the port's K2 walk (t
    exactly); slots=1 forces a large tail."""
    jd, td = fire[1][align]
    o, d, tm = pool
    live_tm = _live_tm(tm)
    got, capped = tsc.sweep_cast(td.pack, td.sweep, to_torch3(o), to_torch3(d),
                                 _t(live_tm), slots=slots, unroll=unroll,
                                 key_slots=key_slots)
    assert int(capped) == 0
    _equal_to_k2(got, _k2(td, o, d, live_tm))
    if slots == 1:
        s_t, s_o, thr = ts.dense_scan(td.sweep, to_torch3(o), to_torch3(d),
                                      _t(live_tm), slots=1)
        raw = ts.sweep8_closest_hit(td.sweep, to_torch3(o), to_torch3(d),
                                    _t(live_tm), s_o, s_t)
        resolved, _ = tsc.resolved_lanes(raw, thr)
        assert (~resolved).float().mean() > 0.05   # the tail really ran


def test_sweep_cast_sorted_exact(fire, pool):
    """On a pool already in bin order, with the scan's planes."""
    jd, td = fire[1][4]
    o, d, tm, s_o, s_t, thr = _bin_sorted(jd, *pool)
    got, capped = tsc.sweep_cast_sorted(td.pack, td.sweep, to_torch3(o),
                                        to_torch3(d), _t(tm), _t(s_o),
                                        _t(s_t), _t(thr))
    assert int(capped) == 0
    _equal_to_k2(got, _k2(td, o, d, tm))
    assert (got.tri.numpy()[~(tm > 0)] == -1).all()
