"""The port's BVH_SWEEP variants against tpt on the CPU: the lane sweep K7
(demand, non-demand, any-hit), K4's any-hit and group modes, the sweep's
any-hit pipeline, the two-phase cascade, the unsorted sweep cast, the two
raycasters, renders of each variant and the megakernel on BVH_SWEEP.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
CUDA kernels are held against those by tests/test_torch_gpu.py. tpt's
Pallas K4 and K7 are slow in interpret mode (its sweep frame alone takes
20-35 s to compile), so every tpt output here is stored in
tests/golden_sweepvar_tpt.npz (its inputs are made here from fixed
seeds); `python tests/test_torch_sweepvar.py` regenerates it (and the K11
outputs of tests/test_torch_scanmulti.py). Both packages get the same tables
(tpt's, carried across) and the same numpy rays. Tolerances:
- triangle ids, occlusion flags and `resolved` masks exactly;
- t to rtol 1e-5 and u, v to atol 1e-4: XLA's CPU backend contracts the
  Moller-Trumbore multiply-adds into FMAs, the port rounds each product
  and sum (as tests/test_torch_sweep.py holds K4);
- renders at tests/test_golden.py's tolerance (>97% of pixels within
  atol 5e-3 / rtol 1e-3, mean within 2%), against tpt's renders of the
  configurations of tests/test_sweep.py's test_render_shadow_parity,
  test_render_groups_parity and test_render_cascade_parity, and of the
  lane kernel, sweep_primary, the unsorted sweep and the megakernel."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.core.camera import generate_camera_rays as jcamera_rays
from tpt.scene import procedural as jproc
from tpt_torch.bvh import sweep as ts
from tpt_torch.bvh import sweepcast as tsc
from tpt_torch.config import RayCastBackend, RenderConfig
from tpt_torch.integrators import common, megakernel, wavefront
from tpt_torch.scene import procedural as tproc
from tpt_torch.scene.convert import from_numpy_scene

from torch_port_helpers import np3, random_rays, scene_leaves, to_jax3, to_torch3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_sweepvar_tpt.npz")
SWEEP = RayCastBackend.BVH_SWEEP
N_POOL = 2500        # two whole 1024-lane K7 blocks and a partial one
SLOTS = 4
# K7 and K4 cases: name -> (kernel, table chunk_align, unroll, any-hit,
# groups, demand, slots); any-hit cases run on the shadow segments in
# their own order, the others on the bin-sorted pool
SWEEP_CASES = {
    "k7_demand": ("lane", 4, 4, False, False, True, SLOTS),
    "k7_all": ("lane", 4, 4, False, False, False, 2),
    "k7_any": ("lane", 4, 4, True, False, True, SLOTS),
    "k4_any": ("sublane", 4, 4, True, False, True, SLOTS),
    "k4_groups": ("sublane", 8, 4, False, True, True, SLOTS),
    "k4_groups_any": ("sublane", 8, 4, True, True, True, SLOTS),
}
# sweep_any_hit cases: name -> (kernel, chunk_align, unroll, groups, slots)
ANY_CASES = {
    "sublane": ("sublane", 4, 4, False, SLOTS),
    "lane": ("lane", 4, 4, False, SLOTS),
    "groups": ("sublane", 8, 4, True, SLOTS),
    "one_slot": ("sublane", 4, 4, False, 1),
}
# renders of tests/test_sweep.py's Cornell (24x24 with spheres, treelets
# of <= 256, depth 3, 2 iterations): name -> RenderConfig knobs
RENDERS = {
    "shadow": dict(sweep_shadow=True),
    "groups": dict(sweep_groups=True),
    "cascade": dict(sweep_cascade=True),
    "lane": dict(sweep_kernel="lane", sweep_shadow=True),
    "primary": dict(sweep_primary=True, sweep_groups=True),
    "unsorted": dict(sort_bounce_rays=False),
}


def _fire(align):
    """tests/test_sweep.py:24-33's fireplace (2000 triangles, treelets of
    <= 256) with tables at `align`: tpt's scene and its host."""
    host = jproc.fireplace_like(num_triangles=2000, resolution=(64, 32))
    return host, host.build(with_bvh=True, treelet_max_tris=256,
                            sweep_chunk_align=align, prep_cache=False)


def _pool(host, jd):
    """A bounce-like pool: camera rays, random rays inside the room, dead
    lanes, a NaN origin and direction and +-0 direction components."""
    _, d_cam, _ = jcamera_rays(host.camera, jnp.uint32(3))
    o_cam = np.broadcast_to(np.asarray(host.camera.position, np.float32),
                            (host.camera.num_pixels, 3))
    k = 1000
    sel = np.linspace(0, host.camera.num_pixels - 1, k).astype(int)
    pos = np3(jd.mesh.positions)
    o_r, d_r = random_rays(N_POOL - k, pos.min(0), pos.max(0), 5)
    o = np.concatenate([o_cam[sel], o_r]).astype(np.float32)
    d = np.concatenate([np3(d_cam)[sel], d_r]).astype(np.float32)
    d[10] = (0.0, -0.0, 1.0)
    d[1100] = (-0.0, -0.0, -1.0)
    o[1200] = (np.nan, 0.0, 0.0)
    d[1201] = (np.nan, 0.5, 0.5)
    tm = np.full(N_POOL, 3.4e38, np.float32)
    tm[::9] = -1.0
    tm[13] = 0.0
    return o, d, tm


def _shadows(jd, o):
    """Shadow segments from the pool's origins to a point near the room's
    ceiling (t_max the distance), with dead, zero and very short ones."""
    boxes = np.asarray(jd.sweep.boxes)[:, :6]
    lo, hi = boxes[:, :3].min(0), boxes[:, 3:].max(0)
    lp = np.array([(lo[0] + hi[0]) / 2, lo[1] + 0.9 * (hi[1] - lo[1]),
                   (lo[2] + hi[2]) / 2], np.float32)
    to = lp[None] - o
    dist = np.sqrt((to * to).sum(1)).astype(np.float32)
    wi = (to / np.maximum(dist, 1e-20)[:, None]).astype(np.float32)
    tm = dist.copy()
    tm[::7] = -1.0
    tm[20] = 0.0
    tm[21] = 5e-4
    return o, wi, tm


def _case_inputs(name, jd, host, pkg):
    """(o, d, t_max, ordinal planes, entry planes or None) of a K7/K4
    case, through `pkg`'s scan ("tpt" or "port")."""
    kernel, align, unroll, any_hit, groups, demand, S = SWEEP_CASES[name]
    o, d, tm = _pool(host, jd)
    if any_hit:
        o, d, tm = _shadows(jd, o)
        s_t, s_o, _ = _scan(pkg, jd, o, d, tm, S)
    else:
        perm, s_o, s_t, _ = _sorted(pkg, jd, o, d, tm, S)
        o, d, tm = o[perm], d[perm], tm[perm]
    return o, d, tm, s_o, (s_t if demand else None)


def _scan(pkg, jd, o, d, tm, S):
    if pkg == "tpt":
        from tpt.bvh import pallas_sweep as jps

        return [np.asarray(a) for a in jps.dense_scan(
            jd.sweep, to_jax3(o), to_jax3(d), jnp.asarray(tm), slots=S)]
    td = _port(jd)
    return [a.numpy() for a in ts.dense_scan(td.sweep, to_torch3(o),
                                             to_torch3(d), _t(tm), slots=S)]


def _sorted(pkg, jd, o, d, tm, S):
    s_t, s_o, thr = _scan(pkg, jd, o, d, tm, S)
    if pkg == "tpt":
        from tpt.bvh import sweepcast as jsc

        key = np.asarray(jsc.bin_key(jnp.asarray(s_o), to_jax3(d),
                                     jd.sweep.num_treelets, S))
    else:
        key = tsc.bin_key(_t(s_o), to_torch3(d), jd.sweep.num_treelets,
                          S).numpy()
    perm = np.argsort(np.where(tm > 0, key, 1 << 30), kind="stable")
    return perm, s_o[:, perm], s_t[:, perm], thr[perm]


_PORT = {}


def _port(jd):
    """The port's scene on tpt's tables (cached per tpt scene)."""
    if id(jd) not in _PORT:
        _PORT[id(jd)] = from_numpy_scene(**scene_leaves(jd), device="cpu")
    return _PORT[id(jd)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cornell():
    host = jproc.cornell_box(resolution=(24, 24), spheres=True)
    return host, host.build(with_bvh=True, treelet_max_tris=256,
                            prep_cache=False)


def _camera_rays(host):
    """tpt's camera rays of iteration 2 as numpy (both packages get the
    same rays: XLA's rsqrt differs from the port's by up to 2 ulp)."""
    o, d, _ = jcamera_rays(host.camera, jnp.uint32(2))
    return np3(o), np3(d)


def tpt_outputs() -> dict:
    """What the golden stores, computed by tpt (minutes in interpret
    mode)."""
    import tpt
    from tpt.bvh import pallas_sweep as jps
    from tpt.bvh import sweepcast as jsc
    from tpt.integrators import common as jcommon
    from tpt.integrators import megakernel as jmk
    from tpt.integrators import wavefront as jwf

    out = {}
    fires = {a: _fire(a) for a in (4, 8)}
    tup = lambda p: tuple(jnp.asarray(x) for x in p)
    for name, (kernel, align, unroll, any_hit, groups, demand,
               S) in SWEEP_CASES.items():
        host, jd = fires[align]
        o, d, tm, s_o, s_t = _case_inputs(name, jd, host, "tpt")
        args = (jd.sweep, to_jax3(o), to_jax3(d), jnp.asarray(tm), tup(s_o))
        if kernel == "lane":
            hit = jps.sweep_closest_hit(
                *args, None if s_t is None else tup(s_t), any_hit=any_hit)
        else:
            hit = jps.sweep8_closest_hit(*args, tup(s_t), unroll_chunks=unroll,
                                         any_hit=any_hit, use_groups=groups)
        for f in ("t", "tri", "u", "v"):
            out[f"{name}_{f}"] = np.asarray(getattr(hit, f))
    for name, (kernel, align, unroll, groups, S) in ANY_CASES.items():
        host, jd = fires[align]
        o, d, tm = _shadows(jd, _pool(host, jd)[0])
        out[f"any_{name}"] = np.asarray(jsc.sweep_any_hit(
            jd.pack, jd.sweep, to_jax3(o), to_jax3(d), jnp.asarray(tm),
            slots=S, kernel=kernel, unroll=unroll, groups=groups))
    # the cascade on the bin-sorted pool (tables at 8, unroll 4, groups)
    host, jd = fires[8]
    o, d, tm = _pool(host, jd)
    perm, s_o, s_t, thr = _sorted("tpt", jd, o, d, tm, SLOTS)
    o, d, tm = to_jax3(o[perm]), to_jax3(d[perm]), jnp.asarray(tm[perm])
    hit1, res1, bundle, n_unres = jsc.cascade_phase1(
        jd.sweep, o, d, tm, tup(s_o), tup(s_t), jnp.asarray(thr),
        prefix=N_POOL, unroll=4, groups=True)
    out["casc_hit1_t"], out["casc_hit1_tri"] = (np.asarray(hit1.t),
                                                np.asarray(hit1.tri))
    out["casc_res1"] = np.asarray(res1)
    out["casc_ti"] = np.asarray(bundle[-1])[:int(n_unres)]
    fin = jsc.sweep_cast_sorted(jd.pack, jd.sweep, o, d, tm, tup(s_o),
                                tup(s_t), jnp.asarray(thr), unroll=4,
                                groups=True, cascade=True)
    out["casc_t"], out["casc_tri"] = np.asarray(fin.t), np.asarray(fin.tri)
    # the unsorted sweep cast, both kernels
    host, jd = fires[4]
    o, d, tm = _pool(host, jd)
    tm = np.where(tm > 0, tm, -1.0).astype(np.float32)
    for kernel in ("sublane", "lane"):
        hit = jsc.sweep_cast(jd.pack, jd.sweep, to_jax3(o), to_jax3(d),
                             jnp.asarray(tm), kernel=kernel)
        out[f"cast_{kernel}_t"] = np.asarray(hit.t)
        out[f"cast_{kernel}_tri"] = np.asarray(hit.tri)
    # the two raycasters on the Cornell's camera rays
    host, scene = _cornell()
    o, d = (to_jax3(a) for a in _camera_rays(host))
    for primary in (True, False):
        for knobs in (dict(), dict(sweep_primary=True)):
            cfg = tpt.RenderConfig(backend=tpt.RayCastBackend.BVH_SWEEP,
                                   **knobs)
            hit = jcommon.make_raycaster(scene, cfg, primary_rays=primary
                                         ).closest_hit(o, d)
            key = f"rc_{int(primary)}{int(bool(knobs))}"
            out[f"{key}_t"], out[f"{key}_tri"] = (np.asarray(hit.t),
                                                  np.asarray(hit.tri))
    for name, knobs in RENDERS.items():
        cfg = tpt.RenderConfig(backend=tpt.RayCastBackend.BVH_SWEEP,
                               trace_depth=3, **knobs)
        out[f"render_{name}"] = np.asarray(
            jwf.render(scene, host.camera, cfg, iterations=2))
    cfg = tpt.RenderConfig(backend=tpt.RayCastBackend.BVH_SWEEP,
                           trace_depth=3, sweep_shadow=True)
    out["render_mega"] = np.asarray(jmk.render(scene, host.camera, cfg,
                                               iterations=2))
    return out


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def fires():
    """chunk_align -> (tpt host, tpt scene, port scene on tpt's tables)."""
    out = {}
    for a in (4, 8):
        host, jd = _fire(a)
        out[a] = (host, jd, _port(jd))
    return out


def _close(got, golden, key):
    np.testing.assert_array_equal(got.tri.numpy(), golden[f"{key}_tri"])
    np.testing.assert_allclose(got.t.numpy(), golden[f"{key}_t"], rtol=1e-5)
    for f in ("u", "v"):
        if f"{key}_{f}" in golden:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       golden[f"{key}_{f}"], rtol=0,
                                       atol=1e-4, err_msg=f)


def _sweep_raw(td, name, o, d, tm, s_o, s_t, groups=None):
    kernel, _, unroll, any_hit, use_groups, _, _ = SWEEP_CASES[name]
    args = (td.sweep, to_torch3(o), to_torch3(d), _t(tm), _t(s_o))
    e = None if s_t is None else _t(s_t)
    if kernel == "lane":
        return ts.sweep_closest_hit(*args, e, any_hit=any_hit)
    return ts.sweep8_closest_hit(
        *args, e, unroll=unroll, any_hit=any_hit,
        use_groups=use_groups if groups is None else groups)


@pytest.mark.parametrize("name", list(SWEEP_CASES))
def test_sweep_kernels_match_tpt(fires, golden, name):
    """K7 (1024-lane blocks; demand, every requested slot, any-hit) and
    K4's any-hit and group modes: the raw hits of tpt's kernels. Group
    mode's raw hits are also the ungrouped kernel's."""
    kernel, align, *_ = SWEEP_CASES[name]
    host, jd, td = fires[align]
    o, d, tm, s_o, s_t = _case_inputs(name, jd, host, "port")
    got = _sweep_raw(td, name, o, d, tm, s_o, s_t)
    _close(got, golden, name)
    tri = got.tri.numpy()
    # shadow segments toward the ceiling: a few percent are occluded
    assert (tri[~(tm > 0)] == -1).all()
    assert (tri >= 0).mean() > (0.02 if SWEEP_CASES[name][3] else 0.5)
    if SWEEP_CASES[name][4]:
        flat = _sweep_raw(td, name, o, d, tm, s_o, s_t, groups=False)
        for f in ("t", "tri", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(flat, f)), f


def test_lane_sweep_needs_8_row_chunks(fires):
    """tpt's K7 sweeps ranges * 8 rows: a table of other chunks is
    refused. Group mode needs 8 groups to cover every treelet."""
    host, jd, td = fires[4]
    o, d, tm = _pool(host, jd)
    s_t, s_o, _ = ts.dense_scan(td.sweep, to_torch3(o), to_torch3(d), _t(tm))
    from dataclasses import replace

    odd = replace(td.sweep, unroll=4)
    with pytest.raises(ValueError, match="8-row"):
        ts.sweep_closest_hit(odd, to_torch3(o), to_torch3(d), _t(tm), s_o, s_t)
    narrow = replace(td.sweep, chunk_align=1)
    assert narrow.max_chunks > 8
    with pytest.raises(ValueError, match="max_chunks"):
        ts.sweep8_closest_hit(narrow, to_torch3(o), to_torch3(d), _t(tm), s_o,
                              s_t, unroll=1, use_groups=True)


@pytest.mark.parametrize("name", list(ANY_CASES))
def test_sweep_any_hit_matches_tpt(fires, golden, name):
    """The sweep's occlusion query (scan, any-hit sweep, K1 on the
    unresolved lanes) gives tpt's flags exactly; one slot forces a large
    K1 tail."""
    kernel, align, unroll, groups, S = ANY_CASES[name]
    host, jd, td = fires[align]
    o, d, tm = _shadows(jd, _pool(host, jd)[0])
    occ, capped = tsc.sweep_any_hit(td.pack, td.sweep, to_torch3(o),
                                    to_torch3(d), _t(tm), slots=S,
                                    kernel=kernel, unroll=unroll,
                                    groups=groups)
    assert int(capped) == 0
    np.testing.assert_array_equal(occ.numpy(), golden[f"any_{name}"])
    assert occ.any() and not occ.all() and not occ[~_t(tm > 0)].any()


def test_cascade_matches_tpt(fires, golden):
    """Phase 1's raw hits and resolved mask, the lanes it leaves to phase
    2 (tpt's prefix, unpadded), and the final hits after phase 2 and the
    tail, on the bin-sorted pool with group culling."""
    host, jd, td = fires[8]
    o, d, tm = _pool(host, jd)
    perm, s_o, s_t, thr = _sorted("port", jd, o, d, tm, SLOTS)
    o, d, tm = to_torch3(o[perm]), to_torch3(d[perm]), _t(tm[perm])
    hit1, res1, bundle = tsc.cascade_phase1(td.sweep, o, d, tm, _t(s_o),
                                            _t(s_t), _t(thr), unroll=4,
                                            groups=True)
    _close(hit1, golden, "casc_hit1")
    np.testing.assert_array_equal(res1.numpy(), golden["casc_res1"])
    np.testing.assert_array_equal(bundle[-1].numpy(), golden["casc_ti"])
    assert 0 < bundle[-1].numel() < N_POOL
    hit, capped = tsc.cascade_phase2(td.pack, td.sweep, o, d, tm, _t(thr),
                                     hit1, res1, tsc.cascade_sort(bundle),
                                     unroll=4, groups=True)
    assert int(capped) == 0
    _close(hit, golden, "casc")
    fused, _ = tsc.sweep_cast_sorted(td.pack, td.sweep, o, d, tm, _t(s_o),
                                     _t(s_t), _t(thr), unroll=4, groups=True,
                                     cascade=True)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(fused, f), getattr(hit, f)), f


@pytest.mark.parametrize("kernel", ["sublane", "lane"])
def test_unsorted_sweep_cast_matches_tpt(fires, golden, kernel):
    """sweep_cast on an unsorted pool (scan, bin sort, sweep, tail,
    unsort) gives tpt's final hits."""
    host, jd, td = fires[4]
    o, d, tm = _pool(host, jd)
    tm = np.where(tm > 0, tm, -1.0).astype(np.float32)
    hit, capped = tsc.sweep_cast(td.pack, td.sweep, to_torch3(o), to_torch3(d),
                                 _t(tm), kernel=kernel)
    assert int(capped) == 0
    _close(hit, golden, f"cast_{kernel}")


@pytest.fixture(scope="module")
def cornell():
    host, scene = _cornell()
    return host, scene, from_numpy_scene(**scene_leaves(scene), device="cpu")


@pytest.mark.parametrize("primary", [True, False])
@pytest.mark.parametrize("sweep_primary", [False, True])
def test_raycasters_match_tpt(cornell, golden, primary, sweep_primary):
    """tpt's two raycasters on camera rays: the primary one is K2 unless
    sweep_primary, the other one sends a cast without slots to the
    unsorted sweep_cast; the port's raycaster routes them alike by its
    `primary` argument."""
    host, _, data = cornell
    o, d = (to_torch3(a) for a in _camera_rays(host))
    cfg = RenderConfig(backend=SWEEP, sweep_primary=sweep_primary)
    rc = common.make_raycaster(data, cfg)
    hit = rc.closest_hit(o, d, primary=primary)
    key = f"rc_{int(primary)}{int(sweep_primary)}"
    _close(hit, golden, key)
    assert int(rc.capped) == 0


def _agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, atol=5e-3, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - ref).max()))
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.02)


@pytest.fixture(scope="module")
def port_cornell():
    s = tproc.cornell_box(resolution=(24, 24), spheres=True)
    return s, s.build(with_bvh=True, treelet_max_tris=256, device="cpu")


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_matches_tpt(port_cornell, golden, name):
    """The port's wavefront in each variant against tpt's render of the
    same configuration (stored)."""
    s, data = port_cornell
    cfg = RenderConfig(backend=SWEEP, trace_depth=3, **RENDERS[name])
    rc = common.make_raycaster(data, cfg)
    img = wavefront.render(data, s.camera, cfg, iterations=2, raycaster=rc)
    assert int(rc.capped) == 0
    _agree(img, golden[f"render_{name}"])


def test_megakernel_on_sweep_matches_tpt(port_cornell, golden):
    """The megakernel on BVH_SWEEP (every cast the unsorted sweep_cast,
    shadows through sweep_any_hit) against tpt's megakernel render."""
    s, data = port_cornell
    cfg = RenderConfig(backend=SWEEP, trace_depth=3, sweep_shadow=True)
    rc = common.make_raycaster(data, cfg)
    img = megakernel.render(data, s.camera, cfg, iterations=2, raycaster=rc)
    assert int(rc.capped) == 0
    _agree(img, golden["render_mega"])


def test_sweep_variants_are_admitted():
    """_unsupported admits the six sweep knobs, BVH_SWEEP without the
    pool sort and the three options ported since (nearfield_frac, which
    tpt applies on BVH_PALLAS only, heavy_shading_iters, debug_no_shadow),
    and still refuses the options the port lacks."""
    base = RenderConfig(backend=SWEEP)
    for knobs in (dict(sweep_kernel="lane"), dict(sweep_groups=True),
                  dict(sweep_shadow=True), dict(sweep_primary=True),
                  dict(sweep_cascade=True, sweep_cascade_frac=0.25),
                  dict(sort_bounce_rays=False), dict(nearfield_frac=0.5),
                  dict(heavy_shading_iters=2), dict(debug_no_shadow=True)):
        assert wavefront._unsupported(base.with_(**knobs)) is None, knobs
    for knobs, what in ((dict(sweep_kernel="warp"), "sweep_kernel"),
                        (dict(sweep_slots=9), "sweep_slots"),
                        (dict(trav_group=8), "trav_group")):
        assert what in wavefront._unsupported(base.with_(**knobs))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_sweepvar.py
    import test_torch_scanmulti

    np.savez_compressed(GOLDEN, **tpt_outputs(),
                        **test_torch_scanmulti.tpt_outputs())
