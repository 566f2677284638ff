"""BVH_XLA, the default backend, in tpt_torch (`bvh/traverse.py`, plain
PyTorch as tpt's is plain XLA) against tpt's, on the same trees.

- Closest hit and any hit on the same rays and the same tree (tpt's SAH
  tree and its LBVH, carried across by from_numpy_scene): hits and
  occlusion equal on all but at most 0.1% of lanes, t to rtol 1e-5 and
  u, v to atol 1e-4 where the triangles agree. The only differences
  allowed come from XLA's CPU backend contracting Möller–Trumbore's
  multiply-adds into FMAs, which the port rounds one by one (the
  allowance tests/test_torch_sweep.py states): on these rays no hit
  and no occlusion differs, and t differs on 239 of 4096 lanes.
- `traversal_cost` equal exactly (slab tests only, no multiply-add).
- A forced `stack_depth=2` drops the far children tpt drops (the same
  hits) and counts the lanes in `capped`.
- Renders: the default `RenderConfig()` wavefront render of the Cornell
  box with spheres against tpt's at tests/test_golden.py's tolerance
  (> 97% of values within atol 5e-3 / rtol 1e-3, means within 2%), and
  `Renderer.bvh_heatmap` equal to tpt's (camera directions may differ
  by 2 ulp, XLA's rsqrt, but no step count of this camera moves). tpt's
  renders are stored in
  tests/golden_bvhxla_tpt.npz, written by

      JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_bvhxla.py

  (about 15 s, most of it tpt compiling its BVH_XLA frame), time the
  suite need not spend.
"""

import os

import numpy as np
import pytest
import torch

from tpt_torch import Renderer
from tpt_torch.bvh import traverse
from tpt_torch.config import DisplayMode, RayCastBackend, RenderConfig
from tpt_torch.integrators import common, wavefront
from tpt_torch.scene import procedural as tproc
from tpt_torch.scene.convert import from_numpy_scene
from tpt_torch.scene.structs import MaterialType

from torch_port_helpers import random_rays, scene_leaves, to_jax3, to_torch3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
STORED = os.path.join(HERE, "golden_bvhxla_tpt.npz")
SPHERES = (MaterialType.MICROFACET_PBR, MaterialType.SPECULAR_REFRACTION)
# tpt's stored renders: RenderConfig() (BVH_XLA, depth 8) at 24x24, 2 spp,
# and the heatmap of the same camera
RES, ITERS = (24, 24), 2
N_RAYS = 4096
MISMATCH_MAX = 1e-3


def _cornell(pkg):
    return pkg.cornell_box(resolution=RES, sphere_materials=SPHERES)


@pytest.fixture(scope="module", params=["sah", "lbvh"])
def tables(request):
    """tpt's Cornell scene with a BVH from `builder`, and the port's scene
    carried across from its leaves (the same tree)."""
    from tpt.scene import procedural as jproc

    jd = _cornell(jproc).build(with_bvh=True, bvh_builder=request.param,
                               prep_cache=False)
    return jd, from_numpy_scene(**scene_leaves(jd), device="cpu")


@pytest.fixture(scope="module")
def rays():
    o, d = random_rays(N_RAYS, [0, 0, 0], [556, 548, 560], 31)
    t_max = np.random.default_rng(5).uniform(0, 700, N_RAYS).astype(np.float32)
    t_max[::11] = -1.0
    return o, d, t_max


def _closest(tables, rays, depth):
    from tpt.bvh.traverse import bvh_closest_hit as jch

    jd, td = tables
    o, d, _ = rays
    want = jch(jd.mesh, jd.bvh, to_jax3(o), to_jax3(d), stack_depth=depth)
    got, capped = traverse.bvh_closest_hit(td.mesh, td.bvh, to_torch3(o),
                                           to_torch3(d), stack_depth=depth)
    return got, int(capped), want


def _assert_hits_match(got, want):
    tri, jtri = got.tri.numpy(), np.asarray(want.tri)
    assert (tri != jtri).mean() <= MISMATCH_MAX
    same = tri == jtri
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same],
                               rtol=1e-5)
    hit = same & (tri >= 0)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=0, atol=1e-4, err_msg=f)
    assert got.tri.dtype == torch.int32


def test_closest_hit_matches_tpt(tables, rays):
    got, capped, want = _closest(tables, rays, 32)
    _assert_hits_match(got, want)
    assert capped == 0
    assert (got.tri.numpy() >= 0).mean() > 0.5
    assert (got.t.numpy()[got.tri.numpy() < 0] == np.float32(3.4e38)).all()


def test_short_stack_drops_what_tpt_drops(tables, rays):
    full, _, _ = _closest(tables, rays, 32)
    got, capped, want = _closest(tables, rays, 2)
    _assert_hits_match(got, want)
    lost = (got.tri.numpy() != full.tri.numpy()).sum()
    assert lost > 0 and capped >= lost
    assert capped <= N_RAYS


def test_any_hit_matches_tpt(tables, rays):
    import jax.numpy as jnp

    from tpt.bvh.traverse import bvh_any_hit as jah

    jd, td = tables
    o, d, t_max = rays
    want = np.asarray(jah(jd.mesh, jd.bvh, to_jax3(o), to_jax3(d),
                          jnp.asarray(t_max)))
    got, capped = traverse.bvh_any_hit(td.mesh, td.bvh, to_torch3(o),
                                       to_torch3(d), torch.from_numpy(t_max))
    assert (got.numpy() != want).mean() <= MISMATCH_MAX
    assert int(capped) == 0
    assert 0.1 < want.mean() < 0.9 and not got.numpy()[::11].any()


def test_traversal_cost_equals_tpt(tables, rays):
    from tpt.bvh.traverse import traversal_cost as jcost

    jd, td = tables
    o, d, _ = rays
    want = np.asarray(jcost(jd.mesh, jd.bvh, to_jax3(o), to_jax3(d)))
    got = traverse.traversal_cost(td.mesh, td.bvh, to_torch3(o), to_torch3(d))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and want.min() >= 1


def test_walk_compaction_changes_nothing(tables, rays, monkeypatch):
    """Looking at the live lanes after every step, with a gather each time
    half have finished, gives the same hits as the default cadence."""
    _, td = tables
    o, d, _ = rays
    base, _ = traverse.bvh_closest_hit(td.mesh, td.bvh, to_torch3(o),
                                       to_torch3(d))
    monkeypatch.setattr(traverse, "STEP_CHECK", 1)
    again, _ = traverse.bvh_closest_hit(td.mesh, td.bvh, to_torch3(o),
                                        to_torch3(d))
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(base, f), getattr(again, f)), f


@pytest.fixture(scope="module")
def stored():
    with np.load(STORED) as f:
        return dict(f)


@pytest.fixture(scope="module")
def port_scene():
    s = _cornell(tproc)
    return s, s.build(with_bvh=True, device="cpu")


def test_default_config_render_matches_tpt(port_scene, stored):
    """RenderConfig() is BVH_XLA; its wavefront render agrees with tpt's."""
    s, data = port_scene
    cfg = RenderConfig()
    assert cfg.backend == RayCastBackend.BVH_XLA
    rc = common.make_raycaster(data, cfg)
    assert rc.name == "bvh_xla"
    img = wavefront.render(data, s.camera, cfg, iterations=ITERS, raycaster=rc)
    assert int(rc.capped) == 0
    ref = stored["default_render"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, atol=5e-3, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - ref).max()))
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.02)


def test_renderer_default_config_renders(port_scene):
    """tpt_torch.Renderer(scene, cam, RenderConfig()) renders."""
    s, data = port_scene
    r = Renderer(data, s.camera, RenderConfig())
    img = r.frame()
    assert img.shape == (RES[1], RES[0], 3) and np.isfinite(img).all()
    assert img.mean() > 0.01 and int(r.raycaster.capped) == 0


def test_heatmap_matches_tpt(port_scene, stored):
    s, data = port_scene
    r = Renderer(data, s.camera, RenderConfig(trace_depth=2))
    heat = r.bvh_heatmap()
    ref = stored["heatmap"]
    assert heat.shape == ref.shape == (RES[1], RES[0], 3)
    assert heat.dtype == np.float32
    np.testing.assert_array_equal(heat, ref)


def test_heatmap_display_mode(port_scene):
    """DisplayMode.BVH_HEATMAP: frame() shows the heatmap (float, also
    with display_u8) and the accumulation goes on underneath."""
    s, data = port_scene
    cfg = RenderConfig(trace_depth=2, display=DisplayMode.BVH_HEATMAP)
    r = Renderer(data, s.camera, cfg)
    heat = r.bvh_heatmap()
    np.testing.assert_array_equal(r.frame(), heat)
    r.display_u8 = True
    np.testing.assert_array_equal(r.frame(), heat)
    assert r.iteration == 2


def test_heatmap_needs_a_bvh():
    s = tproc.cornell_box(resolution=(8, 8), spheres=False)
    r = Renderer(s.build(device="cpu"), s.camera, RenderConfig(trace_depth=1))
    with pytest.raises(ValueError, match="with_bvh"):
        r.bvh_heatmap()


def test_bvh_xla_without_a_bvh_casts_brute_force():
    """As tpt's make_raycaster: BVH_XLA on a scene built without a BVH."""
    s = tproc.cornell_box(resolution=(8, 8), spheres=False)
    data = s.build(device="cpu")
    assert data.bvh is None
    rc = common.make_raycaster(data, RenderConfig())
    assert rc.name == "brute_force"


def test_raycaster_counts_dropped_lanes(tables, rays):
    """bvh_stack_depth reaches the walk, and its dropped lanes reach the
    Raycaster's capped count."""
    _, td = tables
    o, d, _ = rays
    rc = common.make_raycaster(td, RenderConfig(bvh_stack_depth=2))
    rc.closest_hit(to_torch3(o), to_torch3(d))
    _, capped, _ = _closest(tables, rays, 2)
    assert int(rc.capped) == capped > 0


def _write_stored():  # pragma: no cover - regeneration path
    from tpt.config import RenderConfig as JConfig
    from tpt.engine import Renderer as JRenderer
    from tpt.integrators import wavefront as jwave
    from tpt.scene import procedural as jproc

    s = _cornell(jproc)
    data = s.build(with_bvh=True, prep_cache=False)
    img = jwave.render(data, s.camera, JConfig(), iterations=ITERS)
    heat = JRenderer(data, s.camera, JConfig(trace_depth=2)).bvh_heatmap()
    np.savez_compressed(STORED, default_render=np.asarray(img, np.float32),
                        heatmap=np.asarray(heat, np.float32))


if __name__ == "__main__":  # pragma: no cover
    _write_stored()
