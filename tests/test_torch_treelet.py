"""The port's BVH_TREELET backend (K9 treelet scan, K10 self-rebinning
closest hit, the seeded treelet sort with the hybrid easy/hard split, the
raycaster and whole renders) against tpt on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
CUDA kernels are held against those by tests/test_torch_gpu.py. tpt's
Pallas kernels run in interpret mode, as tests/test_treelet.py runs
them, and are slow there (K10 takes 25-30 s a call on a CPU, a tpt
render several minutes), so tpt's K10 outputs and its BVH_TREELET renders are
stored in tests/golden_treelet_tpt.npz beside the seeds and shapes of
their inputs, as are tpt's K9 outputs on three of its four cuts;
`python tests/test_torch_treelet.py` regenerates it. K9 on the fourth,
the single-treelet cut, runs live (~4 s). Both packages get the same
tables (tpt's, carried across) and the same numpy rays. Tolerances:
- K9's five outputs, K10's triangles, the sort permutation, seed planes
  and hard flags are held exactly; K10's triangles also equal brute
  force's;
- K10's t to rtol 1e-5 and u, v to atol 1e-4, as tests/test_torch_sweep.py
  holds K4's: XLA's CPU backend contracts the Moller-Trumbore
  multiply-adds into FMAs, the port rounds each product and sum;
- renders at tests/test_golden.py's tolerance (>97% of pixels within
  atol 5e-3 / rtol 1e-3, mean within 2%): the port's K2 walks one ray at
  a time, tpt's a packet, so the hard rays' equal-t ties may differ."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.bvh import pallas_treelet as jpt
from tpt.bvh.build import build_lbvh
from tpt.bvh.pack import build_packet_bvh_wide
from tpt.bvh.treelet import attach_treelets as jattach
from tpt.integrators import raysort as jraysort
from tpt.integrators.intersect import brute_force_closest_hit as jbrute_force
from tpt.scene import procedural as jproc
from tpt.scene.mesh import finalize_mesh, merge_meshes
from tpt_torch import Renderer
from tpt_torch.bvh import treelet_traverse as tlt
from tpt_torch.bvh.pack import PacketBVH
from tpt_torch.config import RayCastBackend, RenderConfig
from tpt_torch.integrators import common, wavefront
from tpt_torch.scene import procedural as tproc
from tpt_torch.scene.convert import from_numpy_scene

from torch_port_helpers import (np3, random_rays, scene_leaves, to_jax3,
                                to_torch3)
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_treelet_tpt.npz")
TREELET = RayCastBackend.BVH_TREELET

# K10 cases: name -> (pack: a treelet cut (max_tris) of
# tests/test_treelet.py:25-37's cluttered scene, or "fire", a 2000-triangle
# fireplace_like cut at 256; rays, ray seed, packet group, dead-lane
# stride, seeded through K9 and the ordinal sort)
K10_CASES = {
    "u48": (48, 1024, 11, 2, 0, False),
    "u256": (256, 1024, 11, 2, 0, False),
    "dead64": (64, 1024, 5, 2, 3, False),
    "g4": (48, 5000, 12, 4, 5, False),
    "seeded64": (64, 1024, 21, 2, 5, True),
    "fire": ("fire", 3000, 13, 2, 7, True),
}
# K9 cases: pack key -> packet group. tpt's outputs are stored for all
# but the single-treelet cut, whose interpret-mode call stays live (~4 s)
K9_CASES = {48: 1, 256: 2, 10**9: 2, "fire": 2}
K9_LIVE = 10**9
# renders of tests/test_treelet.py:134,151's Cornell: name -> RenderConfig
# knobs (24x24 with spheres, treelets of <= 256, depth 3, 2 iterations)
RENDERS = {
    "hybrid": dict(treelet_hybrid=True, treelet_hard_count=2),
    "plain": dict(treelet_hybrid=False),
}


def _cluttered_mesh():
    rs = np.random.default_rng(3)
    parts = []
    for _ in range(10):
        c = rs.uniform(-5, 5, 3)
        parts.append(jproc.make_uv_sphere(
            tuple(c), rs.uniform(0.3, 1.2), 0, n_theta=6, n_phi=8))
    mesh = finalize_mesh(merge_meshes(parts))
    return mesh, build_packet_bvh_wide(mesh, build_lbvh(mesh), max_cluster=16,
                                       arity=4)


def tpt_packs() -> dict:
    """pack key -> (tpt mesh, tpt pack) of the K9/K10 cases."""
    mesh, pack = _cluttered_mesh()
    out = {mt: (mesh, jattach(pack, max_tris=mt))
           for mt in (48, 64, 256, 10**9)}
    host = jproc.fireplace_like(num_triangles=2000, resolution=(64, 32))
    fire = host.build(with_bvh=True, treelet_max_tris=256, prep_cache=False)
    out["fire"] = (fire.mesh, fire.pack)
    return out


def _port_pack(p) -> PacketBVH:
    g = lambda a: torch.from_numpy(np.array(a))
    return PacketBVH(
        node_f32=g(p.node_f32), node_child=g(p.node_child),
        tri_f32=g(p.tri_f32), num_nodes=p.num_nodes,
        num_triangles=p.num_triangles, max_cluster=p.max_cluster,
        arity=p.arity, top_f32=g(p.top_f32), top_child=g(p.top_child),
        top_tref=g(p.top_tref), top_tord=g(p.top_tord), num_top=p.num_top,
        num_treelets=p.num_treelets, treelet_max=p.treelet_max)


def _case_rays(mesh, key, n, seed, dead):
    """n rays in the cluttered scene's [-6, 6] box, or inside the
    fireplace's bounds; every dead-th lane dead."""
    pos = np3(mesh.positions)
    lo, hi = (pos.min(0), pos.max(0)) if key == "fire" else (-6, 6)
    ori, d = random_rays(n, lo, hi, seed)
    tm = np.full(n, 3.4e38, np.float32)
    if dead:
        tm[::dead] = -1.0
    return ori, d, tm


def tpt_scan(mesh, p, key, group):
    """tpt's K9 in interpret mode on the K9 case's rays: two packets, the
    last partial, every 5th lane dead."""
    ori, d, tm = _case_rays(mesh, key, 1024 * group + 300, 7, 5)
    return [np.asarray(a) for a in jpt.treelet_scan(
        p, to_jax3(ori), to_jax3(d), jnp.asarray(tm), group=group)]


def _ordinal_sort(sc, so, *planes):
    """tests/test_treelet.py:112-115: a stable sort by the K9 ordinal
    (no candidate last), numpy."""
    key = np.where(sc != jpt.NONE_CODE, so, 1 << 30)
    perm = np.argsort(key, kind="stable")
    return [np.asarray(a)[perm] for a in planes]


def _cornell():
    host = jproc.cornell_box(resolution=(24, 24), spheres=True)
    scene = host.build(with_bvh=True, treelet_max_tris=256, prep_cache=False)
    return host, scene


# the seed sort's bounce-like pool on the Cornell scene: rays, ray seed,
# dead-lane stride, treelet_hard_count
SORT_CASE = (3000, 17, 6, 2)


def _sort_pool(scene):
    """numpy origins, directions and alive flags of the seed-sort pool:
    random rays inside the scene's bounds."""
    n, seed, dead, _ = SORT_CASE
    pos = np3(scene.mesh.positions)
    ori, d = random_rays(n, pos.min(0), pos.max(0), seed)
    alive = np.ones(n, bool)
    alive[::dead] = False
    return ori, d, alive


def tpt_seed_sort(scene, hybrid: bool):
    """tpt's seeding stage (tpt/integrators/wavefront.py:318-359) from its
    pieces: (pool permutation, entry t, code, overflow, hard) in sorted
    order."""
    ori, d, alive = _sort_pool(scene)
    n = alive.shape[0]
    o, dd, al = to_jax3(ori), to_jax3(d), jnp.asarray(alive)
    st, sc, so, ovf, cnt = jpt.treelet_scan(
        scene.pack, o, dd, jnp.where(al, 3.4e38, -1.0), group=2)
    lo, inv = jraysort.world_bounds(scene.mesh)
    dir_key = jraysort.coherence_key(o, dd, lo, inv, mode="dir_major")
    hard = al & (cnt >= SORT_CASE[3]) if hybrid else jnp.zeros_like(al)
    key1 = jnp.where(
        al & hard, jnp.int32(1 << 29),
        jnp.where(al & (sc != jpt.NONE_CODE), so,
                  jnp.where(al, jnp.int32((1 << 30) - 1), jnp.int32(1 << 30))))
    out = jax.lax.sort((key1, dir_key, jnp.arange(n, dtype=jnp.int32), st, sc,
                        ovf, hard.astype(jnp.int32)), num_keys=2)
    return [np.asarray(a) for a in out[2:]]


def tpt_outputs() -> dict:
    """What the golden stores, computed by tpt (minutes in interpret
    mode)."""
    import tpt
    from tpt.integrators import common as jcommon
    from tpt.integrators import wavefront as jwf

    out = {}
    packs = tpt_packs()
    for key, group in K9_CASES.items():
        if key != K9_LIVE:
            for i, a in enumerate(tpt_scan(*packs[key], key, group)):
                out[f"k9_{key}_{i}"] = a
    for name, (key, n, seed, group, dead, seeded) in K10_CASES.items():
        mesh, p = packs[key]
        ori, d, tm = _case_rays(mesh, key, n, seed, dead)
        o, dd, t = to_jax3(ori), to_jax3(d), jnp.asarray(tm)
        seed_planes = None
        if seeded:
            st, sc, so, ovf, cnt = (np.asarray(a) for a in
                                    jpt.treelet_scan(p, o, dd, t))
            ori, d, tm, st, sc, ovf = _ordinal_sort(sc, so, ori, d, tm, st,
                                                    sc, ovf)
            o, dd, t = to_jax3(ori), to_jax3(d), jnp.asarray(tm)
            seed_planes = (jnp.asarray(st), jnp.asarray(sc), jnp.asarray(ovf))
        hit = jpt.treelet_closest_hit(p, o, dd, t, group=group,
                                      seed=seed_planes)
        out[f"{name}_case"] = np.array([n, seed, group, dead, seeded])
        for f in ("t", "tri", "u", "v"):
            out[f"{name}_{f}"] = np.asarray(getattr(hit, f))
    host, scene = _cornell()
    out["sort_case"] = np.array(SORT_CASE)
    for hybrid in (True, False):
        for key, a in zip(("perm", "st", "sc", "ovf", "hard"),
                          tpt_seed_sort(scene, hybrid)):
            out[f"sort_{int(hybrid)}_{key}"] = a
    # tpt's hybrid extension cast on the sorted pool
    ori, d, alive = _sort_pool(scene)
    perm = out["sort_1_perm"]
    cfg = tpt.RenderConfig(backend=tpt.RayCastBackend.BVH_TREELET,
                           treelet_hard_count=SORT_CASE[3])
    hit = jcommon.make_raycaster(scene, cfg).closest_hit(
        to_jax3(ori[perm]), to_jax3(d[perm]),
        jnp.where(jnp.asarray(alive[perm]), 3.4e38, -1.0),
        seed=tuple(jnp.asarray(out[f"sort_1_{k}"]) for k in ("st", "sc", "ovf")),
        hard=jnp.asarray(out["sort_1_hard"] != 0))
    out["cast_t"], out["cast_tri"] = np.asarray(hit.t), np.asarray(hit.tri)
    for name, knobs in RENDERS.items():
        cfg = tpt.RenderConfig(backend=tpt.RayCastBackend.BVH_TREELET,
                               trace_depth=3, **knobs)
        out[f"render_{name}"] = np.asarray(
            jwf.render(scene, host.camera, cfg, iterations=2))
    return out


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def packs():
    """pack key -> (tpt mesh, tpt pack, port pack)."""
    return {k: (mesh, p, _port_pack(p))
            for k, (mesh, p) in tpt_packs().items()}


def _exact(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", list(K9_CASES))
def test_scan_equals_tpt(packs, golden, key):
    """K9's five outputs bit for bit, over two packets (the last partial)
    with every 5th lane dead; 10**9 is the single-treelet cut (one top
    node whose only reference is the whole tree)."""
    mesh, p, tp = packs[key]
    group = K9_CASES[key]
    if key == 10**9:
        assert p.num_top == 1 and tp.num_top == 1
    ori, d, tm = _case_rays(mesh, key, 1024 * group + 300, 7, 5)
    want = (tpt_scan(mesh, p, key, group) if key == K9_LIVE
            else [golden[f"k9_{key}_{i}"] for i in range(5)])
    got = tlt.treelet_scan(tp, to_torch3(ori), to_torch3(d),
                           torch.from_numpy(tm), group=group)
    assert int(got[5]) == 0
    for a, b in zip(want, got[:5]):
        _exact(np.asarray(a), b.numpy())
    sc, cnt = got[1].numpy(), got[4].numpy()
    assert (cnt[sc != tlt.NONE_CODE] >= 1).all()
    assert (sc[::5] == tlt.NONE_CODE).all()


@pytest.mark.parametrize("name", list(K10_CASES))
def test_closest_hit_equals_tpt(packs, golden, name):
    """K10 unseeded (2048- and 4096-lane packets, dead lanes) and seeded
    (tpt's test_seeded_pipeline_matches_brute_force pipeline) against
    tpt's stored hits and brute force."""
    key, n, seed, group, dead, seeded = K10_CASES[name]
    np.testing.assert_array_equal(golden[f"{name}_case"],
                                  [n, seed, group, dead, seeded])
    mesh, _, tp = packs[key]
    ori, d, tm = _case_rays(mesh, key, n, seed, dead)
    seed_planes = None
    if seeded:
        st, sc, so, ovf, cnt, capped = tlt.treelet_scan(
            tp, to_torch3(ori), to_torch3(d), torch.from_numpy(tm))
        assert int(capped) == 0
        ori, d, tm, st, sc, ovf = _ordinal_sort(
            sc.numpy(), so.numpy(), ori, d, tm, st.numpy(), sc.numpy(),
            ovf.numpy())
        seed_planes = tuple(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (st, sc, ovf))
    hit, capped = tlt.treelet_closest_hit(
        tp, to_torch3(ori), to_torch3(d), torch.from_numpy(tm), group=group,
        seed=seed_planes)
    assert int(capped) == 0
    tri = hit.tri.numpy()
    np.testing.assert_array_equal(tri, golden[f"{name}_tri"])
    bf = jbrute_force(mesh, to_jax3(ori), to_jax3(d), jnp.asarray(tm))
    np.testing.assert_array_equal(tri, np.asarray(bf.tri))
    if dead:
        assert (tri[tm < 0] == -1).all()
    np.testing.assert_allclose(hit.t.numpy(), golden[f"{name}_t"], rtol=1e-5)
    m = tri >= 0
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(hit, f).numpy()[m],
                                   golden[f"{name}_{f}"][m], atol=1e-4)


@pytest.fixture(scope="module")
def cornell():
    """tests/test_treelet.py:134's Cornell (24x24 with spheres, treelets
    of <= 256): tpt's scene and the port's on tpt's tables."""
    host, scene = _cornell()
    return host, scene, from_numpy_scene(**scene_leaves(scene), device="cpu")


def _port_pool(scene):
    """The seed-sort pool as the port's carry slice (unit throughput,
    zero radiance, pixel order)."""
    ori, d, alive = _sort_pool(scene)
    n = alive.shape[0]
    return (to_torch3(ori), to_torch3(d), to_torch3(np.ones((n, 3))),
            torch.zeros(n), torch.zeros(n, dtype=torch.int64),
            torch.from_numpy(alive), to_torch3(np.zeros((n, 3))),
            to_torch3(np.zeros((n, 3))), torch.arange(n))


@pytest.mark.parametrize("hybrid", [True, False])
def test_seed_sort_equals_tpt(cornell, golden, hybrid):
    """_treelet_seed_sort against tpt's seeding on a bounce-like pool
    (stored: tpt_seed_sort): the permutation, the seed planes and the hard
    flags, exactly."""
    host, scene, data = cornell
    np.testing.assert_array_equal(golden["sort_case"], SORT_CASE)
    cfg = RenderConfig(backend=TREELET, treelet_hybrid=hybrid,
                       treelet_hard_count=SORT_CASE[3])
    alive = _sort_pool(scene)[2]
    sorted_pool, seed, hard, capped = wavefront._treelet_seed_sort(
        data, cfg, _port_pool(scene))
    assert int(capped) == 0
    want = lambda k: golden[f"sort_{int(hybrid)}_{k}"]
    np.testing.assert_array_equal(sorted_pool[8].numpy(), want("perm"))
    np.testing.assert_array_equal(sorted_pool[5].numpy(), alive[want("perm")])
    for k, b in zip(("st", "sc", "ovf"), seed):
        _exact(want(k), b.numpy())
    np.testing.assert_array_equal(hard.numpy(), want("hard") != 0)
    assert bool(hard.any()) == hybrid


def test_hybrid_cast_equals_tpt(cornell, golden):
    """The raycaster's hybrid extension cast on the sorted seed-sort pool
    (seeded K10 on the easy lanes, K2 on the hard ones, picked per lane)
    against tpt's (stored): the easy lanes' triangles exactly; the port's
    K2 walks one ray at a time and tpt's a packet, so a hard lane's
    triangle may differ on an equal-t tie (at most 1% of hard lanes); t
    to rtol 1e-5 (XLA's contracted multiply-adds)."""
    host, scene, data = cornell
    cfg = RenderConfig(backend=TREELET, treelet_hard_count=SORT_CASE[3])
    pool, seed, hard, _ = wavefront._treelet_seed_sort(data, cfg,
                                                       _port_pool(scene))
    rc = common.make_raycaster(data, cfg)
    hit = rc.closest_hit(pool[0], pool[1],
                         torch.where(pool[5], 3.4e38, -1.0), seed=seed,
                         hard=hard)
    assert int(rc.capped) == 0
    tri, want, h = hit.tri.numpy(), golden["cast_tri"], hard.numpy()
    assert h.any() and (~h).any()
    np.testing.assert_array_equal(tri[~h], want[~h])
    assert (tri[h] != want[h]).sum() <= 0.01 * h.sum()
    np.testing.assert_allclose(hit.t.numpy(), golden["cast_t"], rtol=1e-5)


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_equals_tpt(golden, name):
    """The port's BVH_TREELET render (K10 primaries at 4096 lanes, K9 seed
    sort, seeded K10 and, hybrid, K2 on the hard rays; K1 shadows) against
    tpt's split-mode render of the same scene (stored)."""
    s = tproc.cornell_box(resolution=(24, 24), spheres=True)
    data = s.build(with_bvh=True, treelet_max_tris=256, device="cpu")
    cfg = RenderConfig(backend=TREELET, trace_depth=3, **RENDERS[name])
    rc = common.make_raycaster(data, cfg)
    img = wavefront.render(data, s.camera, cfg, iterations=2, raycaster=rc)
    assert int(rc.capped) == 0 and np.isfinite(img).all()
    ref = golden[f"render_{name}"]
    assert img.shape == ref.shape
    close = np.isclose(img, ref, atol=5e-3, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - ref).max()))
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.02)


@pytest.fixture(scope="module")
def small():
    s = tproc.cornell_box(resolution=(16, 16), spheres=True)
    return s, s.build(with_bvh=True, device="cpu")


def test_unsorted_and_slot_knobs_agree_with_brute_force(small):
    """Without sort_bounce_rays (K10 unseeded at 2048 lanes) and with other
    slot counts the hits stay exact: the image equals brute force's."""
    s, data = small
    cfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=3)
    bf = wavefront.render(data, s.camera, cfg, iterations=1)
    for knobs in (dict(sort_bounce_rays=False), dict(treelet_slots=1),
                  dict(treelet_slots=8, treelet_hybrid=False)):
        img = wavefront.render(data, s.camera,
                               cfg.with_(backend=TREELET, **knobs),
                               iterations=1)
        np.testing.assert_allclose(img, bf, rtol=1e-5, atol=1e-6)


def test_unported_treelet_options_raise(small):
    s, data = small
    for cfg in (RenderConfig(backend=TREELET, trav_group=4),
                RenderConfig(backend=TREELET, trav_group_primary=2),
                RenderConfig(backend=TREELET, trav_node_pops=2),
                RenderConfig(backend=TREELET, treelet_slots=9),
                RenderConfig(backend=TREELET, treelet_max_rounds=0)):
        with pytest.raises(NotImplementedError):
            wavefront.render(data, s.camera, cfg, iterations=1)
    bvh_free = s.build(device="cpu")
    with pytest.raises(ValueError):
        common.make_raycaster(bvh_free, RenderConfig(backend=TREELET))


def test_denoised_renderer_on_treelet(small):
    """The engine's denoised frame over BVH_TREELET: the same frames as
    over BVH_PALLAS (both casts are exact; the hits may differ only on
    equal-t ties), at the golden tolerance."""
    s, data = small
    frames = {}
    for backend in (TREELET, RayCastBackend.BVH_PALLAS):
        r = Renderer(data, s.camera, RenderConfig(
            backend=backend, trace_depth=2, denoiser_on=True))
        frames[backend] = [r.frame() for _ in range(2)]
    for a, b in zip(frames[TREELET], frames[RayCastBackend.BVH_PALLAS]):
        assert np.isfinite(a).all() and a.mean() > 0.01
        assert np.isclose(a, b, atol=5e-3, rtol=1e-3).mean() > 0.97
        np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.02)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_treelet.py
    np.savez_compressed(GOLDEN, **tpt_outputs())
