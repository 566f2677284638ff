"""The port's wide-BVH casts (K2 closest hit, K1 any hit) against tpt.

On the CPU the wrappers run their plain PyTorch versions; they are held
against tpt's brute-force intersector (the independent oracle) with the
tolerances of tests/test_bvh.py:93-117 — equal hit masks, t to rtol 1e-4,
equal triangles — and once against tpt's Pallas kernel in interpret mode.
The CUDA kernels themselves are held against the plain versions by
tests/test_torch_gpu.py on a machine with a CUDA device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.integrators import intersect as jint
from tpt.scene import procedural as jproc
from tpt.scene.host import HostMaterial as JMaterial, HostScene as JHostScene
from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.integrators import intersect as tint
from tpt_torch.scene import procedural as tproc
from tpt_torch.scene.host import HostMaterial as TMaterial, HostScene as THostScene

from torch_port_helpers import random_rays, to_jax3, to_torch3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)


def _clutter(proc, host_cls, mat_cls):
    rs = np.random.default_rng(3)
    parts = [proc.make_uv_sphere(tuple(rs.uniform(-5, 5, 3)),
                                 rs.uniform(0.2, 0.8), 0, n_theta=6, n_phi=8)
             for _ in range(30)]
    s = host_cls()
    s.add_material(mat_cls("grey", (0.5, 0.5, 0.5)))
    s.mesh = proc.merge_meshes(parts)
    return s


SCENES = {
    "cornell": (lambda: jproc.cornell_box(resolution=(8, 8)),
                lambda: tproc.cornell_box(resolution=(8, 8)),
                ([0, 0, 0], [556, 548, 560]), 900.0),
    "clutter": (lambda: _clutter(jproc, JHostScene, JMaterial),
                lambda: _clutter(tproc, THostScene, TMaterial),
                (-6, 6), 4.0),
    "fireplace_10k": (
        lambda: jproc.fireplace_like(num_triangles=10_000, resolution=(8, 8)),
        lambda: tproc.fireplace_like(num_triangles=10_000, resolution=(8, 8)),
        ([0, 0, 0], [1200, 400, 900]), 600.0),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    jmake, tmake, box, reach = SCENES[request.param]
    jdata = jmake().build(with_bvh=True, prep_cache=False)
    tdata = tmake().build(with_bvh=True, device="cpu")
    return jdata, tdata, box, reach


def _rays(box, n, seed):
    ori, d = random_rays(n, box[0], box[1], seed)
    return ori, d, to_jax3(ori), to_jax3(d), to_torch3(ori), to_torch3(d)


def test_closest_hit_plain_matches_brute_force(scenes):
    jdata, tdata, box, _ = scenes
    _, _, jo, jd, to, td = _rays(box, 1024, seed=1)
    want = jint.brute_force_closest_hit(jdata.mesh, jo, jd)
    got, capped = pt.packet_closest_hit_wide(
        tdata.pack, to, td, torch.full((1024,), tint.FLT_MAX))
    assert int(capped) == 0
    hit_w = np.asarray(want.tri) >= 0
    np.testing.assert_array_equal(got.tri.numpy() >= 0, hit_w)
    np.testing.assert_allclose(got.t.numpy()[hit_w], np.asarray(want.t)[hit_w],
                               rtol=1e-4)
    np.testing.assert_array_equal(got.tri.numpy()[hit_w],
                                  np.asarray(want.tri)[hit_w])
    np.testing.assert_allclose(got.u.numpy()[hit_w], np.asarray(want.u)[hit_w],
                               atol=1e-4)
    assert np.all(got.t.numpy()[~hit_w] == np.float32(tint.FLT_MAX))


def test_any_hit_plain_matches_brute_force(scenes):
    jdata, tdata, box, reach = scenes
    _, _, jo, jd, to, td = _rays(box, 1024, seed=4)
    t_max = np.random.default_rng(9).uniform(0.05, 1.0, 1024).astype(np.float32) * reach
    t_max[:64] = -1.0                      # dead lanes
    want = np.asarray(jint.brute_force_any_hit(jdata.mesh, jo, jd,
                                               jnp.asarray(t_max)))
    got, capped = pt.packet_any_hit_wide(tdata.pack, to, td,
                                         torch.from_numpy(t_max))
    assert int(capped) == 0
    live = t_max - 1e-3 > 0
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    assert got.numpy()[~live].all()        # dead lanes report occluded
    assert 0 < want[live].mean() < 1


def test_closest_hit_respects_t_max(scenes):
    _, tdata, box, _ = scenes
    _, _, _, _, to, td = _rays(box, 512, seed=2)
    full, _ = pt.packet_closest_hit_wide(tdata.pack, to, td,
                                         torch.full((512,), tint.FLT_MAX))
    cut = torch.where(full.tri >= 0, full.t * 0.5, torch.full_like(full.t, 1.0))
    part, _ = pt.packet_closest_hit_wide(tdata.pack, to, td, cut)
    hit = part.tri >= 0
    assert bool((part.t[hit] < cut[hit]).all())


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_port_brute_force_matches_tpt(scenes, kind):
    jdata, tdata, box, reach = scenes
    _, _, jo, jd, to, td = _rays(box, 768, seed=6)
    if kind == "closest":
        want = jint.brute_force_closest_hit(jdata.mesh, jo, jd)
        got = tint.brute_force_closest_hit(tdata.mesh, to, td)
        hit = np.asarray(want.tri) >= 0
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                                   rtol=1e-4)
    else:
        t_max = np.full(768, reach * 0.5, np.float32)
        want = jint.brute_force_any_hit(jdata.mesh, jo, jd, jnp.asarray(t_max))
        got = tint.brute_force_any_hit(tdata.mesh, to, td,
                                       torch.from_numpy(t_max))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_matches_tpt_pallas_kernel_interpret():
    """Once against tpt's own Pallas kernels (interpret mode, 1024 rays):
    the per-ray walk and the 1024-ray packet walk find the same hits."""
    from tpt.bvh.pallas_traverse import (packet_any_hit_wide as jany,
                                         packet_closest_hit_wide as jclosest)

    jdata = jproc.cornell_box(resolution=(8, 8)).build(with_bvh=True,
                                                       prep_cache=False)
    tdata = tproc.cornell_box(resolution=(8, 8)).build(with_bvh=True,
                                                       device="cpu")
    _, _, jo, jd, to, td = _rays(([0, 0, 0], [556, 548, 560]), 1024, seed=8)
    knobs = dict(group=1, node_pops=1, cluster_pops=1)
    want = jclosest(jdata.pack, jo, jd, jnp.full((1024,), 3.4e38), **knobs)
    got, _ = pt.packet_closest_hit_wide(tdata.pack, to, td,
                                        torch.full((1024,), tint.FLT_MAX))
    hit = np.asarray(want.tri) >= 0
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-4)
    t_max = np.full(1024, 300.0, np.float32)
    t_max[::7] = -1.0
    occ_w = np.asarray(jany(jdata.pack, jo, jd, jnp.asarray(t_max), **knobs))
    occ_g, _ = pt.packet_any_hit_wide(tdata.pack, to, td,
                                      torch.from_numpy(t_max))
    np.testing.assert_array_equal(occ_g.numpy(), occ_w)


class TestBounds:
    @pytest.fixture(scope="class")
    def cornell(self):
        return tproc.cornell_box(resolution=(8, 8)).build(with_bvh=True,
                                                          device="cpu")

    def test_nan_and_dead_rays_miss(self, cornell):
        ori, d = random_rays(8, [100, 100, 100], [400, 400, 400], seed=3)
        d[0, 1] = np.nan
        ori[1, 2] = np.nan
        t_max = np.full(8, 1e4, np.float32)
        t_max[2] = -1.0
        t_max[3] = np.nan
        hit, capped = pt.packet_closest_hit_wide(
            cornell.pack, to_torch3(ori), to_torch3(d), torch.from_numpy(t_max))
        assert int(capped) == 0
        assert hit.tri[:4].tolist() == [-1, -1, -1, -1]
        assert bool((hit.tri[4:] >= 0).all())   # inside the box: walls
        occ, _ = pt.packet_any_hit_wide(
            cornell.pack, to_torch3(ori), to_torch3(d), torch.from_numpy(t_max))
        assert occ[:4].tolist() == [False, False, True, False]

    def test_stack_overflow_is_counted(self, cornell, monkeypatch):
        ori, d = random_rays(256, [50, 50, 50], [500, 500, 500], seed=5)
        monkeypatch.setattr(pt, "STACK_DEPTH", 2)
        _, capped = pt.packet_closest_hit_wide(
            cornell.pack, to_torch3(ori), to_torch3(d),
            torch.full((256,), tint.FLT_MAX))
        assert 0 < int(capped) <= 256

    def test_step_cap_ends_a_cyclic_walk(self, cornell, monkeypatch):
        """A table whose root lists itself as its children would loop
        forever; the step cap ends the walk and the ray is counted (the
        cap is lowered here to keep the test short; tests/test_torch_gpu.py
        runs the kernels' real cap)."""
        from dataclasses import replace

        monkeypatch.setattr(pt, "max_steps", lambda pack: 200)

        child = cornell.pack.node_child.clone()
        child[0, :4] = 0
        bad = replace(cornell.pack, node_child=child)
        ori, d = random_rays(2, [270, 270, 270], [280, 280, 280], seed=1)
        _, capped = pt.packet_closest_hit_wide(
            bad, to_torch3(ori), to_torch3(d), torch.full((2,), tint.FLT_MAX))
        assert int(capped) == 2

    def test_wrapper_checks_inputs(self, cornell):
        ori, d = random_rays(4, [0, 0, 0], [1, 1, 1], seed=0)
        o, dd = to_torch3(ori), to_torch3(d)
        with pytest.raises(ValueError, match="float32"):
            pt.packet_closest_hit_wide(cornell.pack, o, dd,
                                       torch.ones(4, dtype=torch.float64))
        with pytest.raises(ValueError, match="contiguous"):
            pt.packet_any_hit_wide(cornell.pack, o, dd, torch.ones(8)[::2])
