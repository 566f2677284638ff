"""The port's binary-pack casts (K8a `packet_closest_hit`, K8b
`packet_any_hit`) and BVH_PALLAS on the arity-2 pack, against tpt.

On the CPU the wrappers run their plain PyTorch versions; they are held
against tpt's own Pallas kernels in interpret mode on the same tables
(carried across with `from_numpy_scene`), with tpt's brute force as the
dense oracle. tpt orders a node's two children by the smallest entry t
of its 1024-lane packet, the port by each ray's own, so the closest t is
the same but an equal-t tie on a shared edge may name another triangle:
the tests ask for equal hit masks, t within rtol 1e-4 (XLA's CPU backend
contracts multiply-adds, the port does not), every lane whose triangle
differs a genuine tie (both t within rtol 1e-4 of the dense minimum, the
audit of tests/test_bvh.py:147) and at most 1% of hit lanes differing.
The CUDA kernels are held against the plain versions by
tests/test_torch_gpu.py on a machine with a CUDA device."""

import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.integrators import intersect as jint
from tpt.scene import procedural as jproc
from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.config import RayCastBackend, RenderConfig
from tpt_torch.integrators import common, intersect as tint, wavefront
from tpt_torch.scene import procedural as tproc
from tpt_torch.scene.convert import from_numpy_scene
from tpt_torch.scene.structs import MaterialType

from torch_port_helpers import random_rays, scene_leaves, to_jax3, to_torch3
from torch_port_helpers import count_calls
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(__file__)
GOLDEN_PALLAS = os.path.join(HERE, "golden_cornell_pallas_64.npz")
BOX = ([0, 0, 0], [556, 548, 560])
N = 1024                  # one tpt packet
TIE_SHARE_MAX = 0.01      # of hit lanes whose triangle may differ
RTOL = 1e-4


@pytest.fixture(scope="module")
def cornell():
    """tpt's 32x32 Cornell with the binary pack, and the port's scene
    carried across from its numpy leaves."""
    jdata = jproc.cornell_box(resolution=(32, 32)).build(
        with_bvh=True, packet_arity=2, prep_cache=False)
    tdata = from_numpy_scene(**scene_leaves(jdata), device="cpu")
    return jdata, tdata


def _rays(seed):
    """N seeded rays inside the box: dead lanes (t_max -1), NaN origins
    and directions, NaN t_max, short t_max and unbounded ones."""
    ori, d = random_rays(N, BOX[0], BOX[1], seed)
    ori[3::97, 1] = np.nan
    d[5::89, 2] = np.nan
    rs = np.random.default_rng(seed + 100)
    t_max = np.where(rs.uniform(size=N) < 0.5, rs.uniform(1.0, 300.0, N),
                     3.4e38).astype(np.float32)
    t_max[::13] = -1.0
    t_max[7::101] = np.nan
    return ori, d, t_max


@pytest.fixture(scope="module")
def casts(cornell):
    """tpt's interpret-mode K8a/K8b (about 4 s) and the port's plain
    versions on the same rays."""
    from tpt.bvh.pallas_traverse import packet_any_hit, packet_closest_hit

    jdata, tdata = cornell
    ori, d, t_max = _rays(seed=21)
    jo, jd, to, td = to_jax3(ori), to_jax3(d), to_torch3(ori), to_torch3(d)
    want = packet_closest_hit(jdata.pack, jo, jd, jnp.asarray(t_max))
    dense = jint.brute_force_closest_hit(jdata.mesh, jo, jd, jnp.asarray(t_max))
    got, capped = pt.packet_closest_hit(tdata.pack, to, td,
                                        torch.from_numpy(t_max))
    assert int(capped) == 0
    s_max = np.random.default_rng(5).uniform(1.0, 500.0, N).astype(np.float32)
    s_max[::11] = -1.0
    s_max[9::103] = np.nan
    occ_w = np.asarray(packet_any_hit(jdata.pack, jo, jd, jnp.asarray(s_max)))
    occ_g, capped = pt.packet_any_hit(tdata.pack, to, td,
                                      torch.from_numpy(s_max))
    assert int(capped) == 0
    return dict(ori=ori, d=d, t_max=t_max, want=want, dense=dense, got=got,
                s_max=s_max, occ_w=occ_w, occ_g=occ_g.numpy())


def test_closest_hit_matches_tpt_kernel(casts):
    want, got, dense = casts["want"], casts["got"], casts["dense"]
    w_tri, g_tri = np.asarray(want.tri), got.tri.numpy()
    hit = w_tri >= 0
    np.testing.assert_array_equal(g_tri >= 0, hit)
    assert 200 < hit.sum() < N - 100         # hits, misses and dead lanes
    w_t, g_t, d_t = np.asarray(want.t), got.t.numpy(), np.asarray(dense.t)
    np.testing.assert_allclose(g_t[hit], w_t[hit], rtol=RTOL)
    assert np.all(g_t[~hit] == np.float32(tint.FLT_MAX))
    differ = hit & (g_tri != w_tri)
    assert differ.sum() <= TIE_SHARE_MAX * hit.sum(), differ.sum()
    # every differing triangle is a genuine equal-t tie
    np.testing.assert_allclose(g_t[differ], d_t[differ], rtol=RTOL)
    np.testing.assert_allclose(w_t[differ], d_t[differ], rtol=RTOL)
    same = hit & ~differ
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(want.u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(got.v.numpy()[same], np.asarray(want.v)[same],
                               atol=1e-4)


def test_closest_hit_matches_dense_oracle(casts):
    """Against tpt's brute force: the same hits and t (what the tie rule
    rests on), dead, NaN and short-t_max lanes included."""
    got, dense = casts["got"], casts["dense"]
    hit = np.asarray(dense.tri) >= 0
    np.testing.assert_array_equal(got.tri.numpy() >= 0, hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(dense.t)[hit],
                               rtol=RTOL)
    ori, d, t_max = casts["ori"], casts["d"], casts["t_max"]
    bad = (np.isnan(ori).any(1) | np.isnan(d).any(1) | np.isnan(t_max)
           | (t_max <= 0))
    assert bad.sum() > 80 and not hit[bad].any()
    assert np.all(np.asarray(casts["want"].tri)[bad] == -1)


def test_any_hit_matches_tpt_kernel(casts):
    occ_w, occ_g, s_max = casts["occ_w"], casts["occ_g"], casts["s_max"]
    np.testing.assert_array_equal(occ_g, occ_w)
    live = s_max - 1e-3 > 0
    assert occ_g[~np.isnan(s_max) & ~live].all()   # dead lanes occluded
    assert 0.1 < occ_g[live].mean() < 0.9


class TestBounds:
    def test_stack_overflow_is_counted(self, cornell, monkeypatch):
        _, tdata = cornell
        ori, d = random_rays(256, [50, 50, 50], [500, 500, 500], seed=5)
        monkeypatch.setattr(pt, "STACK_DEPTH", 2)
        _, capped = pt.packet_closest_hit(
            tdata.pack, to_torch3(ori), to_torch3(d),
            torch.full((256,), tint.FLT_MAX))
        assert 0 < int(capped) <= 256
        _, capped = pt.packet_any_hit(tdata.pack, to_torch3(ori),
                                      to_torch3(d), torch.full((256,), 900.0))
        assert 0 < int(capped) <= 256

    def test_step_cap_ends_a_cyclic_walk(self, cornell, monkeypatch):
        """A root that lists itself as both children loops; the step cap
        ends the walk and each ray is counted once (the cap is lowered
        here; tests/test_torch_gpu.py runs the kernels' real cap)."""
        _, tdata = cornell
        assert pt.max_steps(tdata.pack) == 8 * tdata.pack.num_nodes + 4096
        monkeypatch.setattr(pt, "max_steps", lambda pack: 200)
        child = tdata.pack.node_child.clone()
        child[0, :] = 0
        bad = replace(tdata.pack, node_child=child)
        ori, d = random_rays(2, [270, 270, 270], [280, 280, 280], seed=1)
        _, capped = pt.packet_closest_hit(
            bad, to_torch3(ori), to_torch3(d), torch.full((2,), tint.FLT_MAX))
        assert int(capped) == 2
        _, capped = pt.packet_any_hit(bad, to_torch3(ori), to_torch3(d),
                                      torch.full((2,), 1e4))
        assert int(capped) == 2

    def test_wrapper_checks_inputs(self, cornell):
        _, tdata = cornell
        ori, d = random_rays(4, [0, 0, 0], [1, 1, 1], seed=0)
        o, dd = to_torch3(ori), to_torch3(d)
        t = torch.ones(4)
        with pytest.raises(ValueError, match="float32"):
            pt.packet_closest_hit(tdata.pack, o, dd,
                                  torch.ones(4, dtype=torch.float64))
        with pytest.raises(ValueError, match="contiguous"):
            pt.packet_any_hit(tdata.pack, o, dd, torch.ones(8)[::2])
        with pytest.raises(ValueError, match="arity-4/8"):
            pt.packet_closest_hit_wide(tdata.pack, o, dd, t)
        wide = tproc.cornell_box(resolution=(8, 8)).build(with_bvh=True,
                                                          device="cpu")
        with pytest.raises(ValueError, match="arity-2"):
            pt.packet_any_hit(wide.pack, o, dd, t)
        flat = replace(tdata.pack, node_child=torch.zeros(
            (tdata.pack.num_nodes, 16), dtype=torch.int32))
        with pytest.raises(ValueError, match="binary layout"):
            pt.packet_closest_hit(flat, o, dd, t)
        small = replace(tdata.pack, tri_f32=tdata.pack.tri_f32[:8].contiguous())
        with pytest.raises(ValueError, match="binary layout"):
            pt.packet_any_hit(small, o, dd, t)


def test_from_numpy_scene_carries_binary_tables(cornell):
    """tpt's binary tables cross unchanged, equal to the port's own build
    of the same scene; a wide-shaped child table is refused."""
    jdata, tdata = cornell
    own = tproc.cornell_box(resolution=(32, 32)).build(
        with_bvh=True, packet_arity=2, device="cpu")
    for f in ("node_f32", "node_child", "tri_f32"):
        np.testing.assert_array_equal(getattr(tdata.pack, f).numpy(),
                                      np.asarray(getattr(jdata.pack, f)))
        assert torch.equal(getattr(tdata.pack, f), getattr(own.pack, f))
    for k in ("num_nodes", "num_triangles", "max_cluster", "arity"):
        assert getattr(tdata.pack, k) == getattr(jdata.pack, k)
    assert tdata.pack.arity == 2 and tdata.pack.top_f32 is None
    leaves = scene_leaves(jdata)
    leaves["pack"]["node_child"] = np.zeros((jdata.pack.num_nodes, 16),
                                            np.int32)
    with pytest.raises(ValueError, match="node_child"):
        from_numpy_scene(**leaves, device="cpu")


def test_binary_wavefront_matches_pallas_golden(monkeypatch):
    """tests/test_golden.py:63-76's configuration on the binary pack:
    every extension cast through K8a and every shadow cast through K8b
    (the plain versions here), none through K1/K2."""
    calls = count_calls(monkeypatch, pt, (
        "packet_closest_hit", "packet_any_hit", "packet_closest_hit_wide",
        "packet_any_hit_wide"))
    s = tproc.cornell_box(resolution=(64, 64), sphere_materials=(
        MaterialType.MICROFACET_PBR, MaterialType.SPECULAR_REFRACTION))
    data = s.build(with_bvh=True, packet_arity=2, device="cpu")
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3)
    rc = common.make_raycaster(data, cfg)
    img = wavefront.render(data, s.camera, cfg, iterations=2, raycaster=rc)
    assert int(rc.capped) == 0
    assert calls == {"packet_closest_hit": 6, "packet_any_hit": 6}
    golden = np.load(GOLDEN_PALLAS)["image"]
    assert img.shape == golden.shape
    close = np.isclose(img, golden, atol=5e-3, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - golden).max()))
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=0.02)


@pytest.mark.parametrize("backend", ["BVH_TREELET", "BVH_SWEEP"])
def test_other_backends_refuse_binary_pack(cornell, backend):
    _, tdata = cornell
    cfg = RenderConfig(backend=RayCastBackend[backend], trace_depth=2)
    with pytest.raises(ValueError, match="binary"):
        common.make_raycaster(tdata, cfg)
