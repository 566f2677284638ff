"""Whole renders of the port against the committed goldens (read only)
and against tpt's own render, with the tolerances of
tests/test_golden.py:33-39, plus the wavefront's frame-level contracts
(empty renders, determinism, spp batching)."""

import os

import numpy as np
import pytest

from tpt_torch.config import RayCastBackend, RenderConfig
from tpt_torch.integrators import common, wavefront
from tpt_torch.scene import procedural
from tpt_torch.scene.structs import MaterialType

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_cornell_128_4spp.npz")
GOLDEN_PALLAS = os.path.join(HERE, "golden_cornell_pallas_64.npz")
GOLDEN_SWEEP_TPT = os.path.join(HERE, "golden_cornell_sweep_24.npz")
SPHERES = (MaterialType.MICROFACET_PBR, MaterialType.SPECULAR_REFRACTION)


def _compare(path, img, atol=5e-3):
    """tests/test_golden.py:_compare_or_write without the write."""
    _agree(img, np.load(path)["image"], atol)


def _agree(img, golden, atol=5e-3):
    assert img.shape == golden.shape
    close = np.isclose(img, golden, atol=atol, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - golden).max()))
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=0.02)


def test_brute_force_matches_golden():
    """test_golden.render_current's config through the port."""
    s = procedural.cornell_box(resolution=(128, 128), sphere_materials=SPHERES)
    data = s.build(device="cpu")
    cfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=4)
    _compare(GOLDEN, wavefront.render(data, s.camera, cfg, iterations=4))


def test_wide_kernels_match_pallas_golden():
    """test_golden.py:63-76's config: the wavefront with the coherence sort
    on the wide BVH, through the plain K1/K2 on the CPU."""
    s = procedural.cornell_box(resolution=(64, 64), sphere_materials=SPHERES)
    data = s.build(with_bvh=True, device="cpu")
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3)
    rc = common.make_raycaster(data, cfg)
    img = wavefront.render(data, s.camera, cfg, iterations=2, raycaster=rc)
    assert int(rc.capped) == 0
    _compare(GOLDEN_PALLAS, img)


def test_sweep_render_matches_pallas_golden():
    """The BVH_SWEEP path (K2 primaries, then per bounce K3 scan, bin sort,
    K4 sweep and K2 tail; K1 shadows) at the golden's configuration."""
    s = procedural.cornell_box(resolution=(64, 64), sphere_materials=SPHERES)
    data = s.build(with_bvh=True, device="cpu")
    cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, trace_depth=3)
    rc = common.make_raycaster(data, cfg)
    img = wavefront.render(data, s.camera, cfg, iterations=2, raycaster=rc)
    assert int(rc.capped) == 0
    _compare(GOLDEN_PALLAS, img)


def tpt_sweep_render() -> np.ndarray:
    """tpt's BVH_SWEEP render of tests/test_treelet.py:172's scene (Cornell
    24x24 with spheres, depth 3, 2 iterations): its fused frame, one
    program, with iterations 1 and 2 as one spp_batch=2 pool (the same RNG
    streams as two frames)."""
    import jax.numpy as jnp
    import tpt
    from tpt.core.vec import Vec3 as JVec3
    from tpt.integrators import wavefront as jwf
    from tpt.scene import procedural as jproc

    host = jproc.cornell_box(resolution=(24, 24), spheres=True)
    jd = host.build(with_bvh=True, treelet_max_tris=256, prep_cache=False)
    cfg = tpt.RenderConfig(backend=tpt.RayCastBackend.BVH_SWEEP,
                           trace_depth=3, spp_batch=2)
    frame, vp = jwf.make_frame_fn(jd, host.camera, cfg, split_bounces=False)
    n = host.camera.num_pixels
    _, acc_d, acc_i = frame(jnp.uint32(1), vp, JVec3.zeros((n,)),
                            JVec3.zeros((n,)))
    return np.asarray(((acc_d + acc_i) * 0.5).stacked()).reshape(24, 24, 3)


def test_sweep_render_matches_tpt():
    """The port's BVH_SWEEP render against tpt's BVH_SWEEP render of the
    same scene (equal tables: tests/test_torch_sweep.py), stored in
    GOLDEN_SWEEP_TPT by `python tests/test_torch_render.py`: compiling
    tpt's sweep frame in interpret mode takes 20-35 s on this CPU, more
    than the suite can spend on one test."""
    s = procedural.cornell_box(resolution=(24, 24), spheres=True)
    data = s.build(with_bvh=True, treelet_max_tris=256, device="cpu")
    cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, trace_depth=3)
    rc = common.make_raycaster(data, cfg)
    img = wavefront.render(data, s.camera, cfg, iterations=2, raycaster=rc)
    assert int(rc.capped) == 0 and np.isfinite(img).all()
    _compare(GOLDEN_SWEEP_TPT, img)


@pytest.fixture(scope="module")
def small():
    s = procedural.cornell_box(resolution=(16, 16), sphere_materials=SPHERES)
    return s, s.build(with_bvh=True, device="cpu")


def test_zero_iterations_and_depth(small):
    s, data = small
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3)
    assert not wavefront.render(data, s.camera, cfg, iterations=0).any()
    black = wavefront.render(data, s.camera, cfg.with_(trace_depth=0),
                             iterations=1)
    assert black.shape == (16, 16, 3) and not black.any()


@pytest.mark.parametrize("backend", ["BRUTE_FORCE", "BVH_PALLAS", "BVH_SWEEP"])
def test_spp_batch_equals_separate_frames(small, backend):
    """spp_batch=2 traces iterations it and it+1 in one pool; per-path RNG
    streams are those of separate frames, so the image is identical."""
    s, data = small
    cfg = RenderConfig(backend=getattr(RayCastBackend, backend), trace_depth=3)
    one = wavefront.render(data, s.camera, cfg, iterations=2)
    two = wavefront.render(data, s.camera, cfg.with_(spp_batch=2), iterations=2)
    np.testing.assert_array_equal(two, one)
    np.testing.assert_array_equal(
        wavefront.render(data, s.camera, cfg, iterations=2), one)


def test_backends_agree(small):
    s, data = small
    cfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=3)
    bf = wavefront.render(data, s.camera, cfg, iterations=1)
    wide = wavefront.render(
        data, s.camera, cfg.with_(backend=RayCastBackend.BVH_PALLAS),
        iterations=1)
    np.testing.assert_allclose(wide, bf, rtol=1e-5, atol=1e-6)


def test_sweep_backend_agrees_with_brute_force(small):
    s, data = small
    cfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=3)
    bf = wavefront.render(data, s.camera, cfg, iterations=1)
    for knobs in (dict(), dict(sweep_slots=2, sweep_key_slots=3),
                  dict(sweep_slots=1, sweep_seed_mode="wide",
                       sweep_tail_compact="sort")):
        sw = wavefront.render(
            data, s.camera,
            cfg.with_(backend=RayCastBackend.BVH_SWEEP, **knobs), iterations=1)
        np.testing.assert_allclose(sw, bf, rtol=1e-5, atol=1e-6)


def test_frame_output(small):
    s, data = small
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3)
    rc = common.make_raycaster(data, cfg)
    out = wavefront.trace_frame(data, rc, s.camera, cfg, 1)
    assert float(out.direct.x.sum()) > 0 and float(out.indirect.x.sum()) > 0
    assert int(out.rays_traced) > s.camera.num_pixels
    hit = out.gbuf.depth > 0
    assert float(hit.float().mean()) > 0.9
    assert bool((out.gbuf.mat_id[hit] >= 0).all())
    assert float(out.gbuf.motion_u.abs().max()) < 1e-3


def test_unported_options_raise(small):
    s, data = small
    sweep = RayCastBackend.BVH_SWEEP
    for cfg in (RenderConfig(backend=sweep, sweep_kernel="lane"),
                RenderConfig(backend=sweep, sweep_cascade=True),
                RenderConfig(backend=sweep, sweep_primary=True),
                RenderConfig(backend=sweep, sweep_groups=True),
                RenderConfig(backend=sweep, sweep_shadow=True),
                RenderConfig(backend=sweep, sort_bounce_rays=False),
                RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                             nearfield_frac=0.5),
                RenderConfig(backend=RayCastBackend.BVH_PALLAS, trav_group=8),
                RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                             sweep_shadow=True),
                RenderConfig(backend=RayCastBackend.BVH_PALLAS, sort_every=2)):
        with pytest.raises(NotImplementedError):
            wavefront.render(data, s.camera, cfg, iterations=1)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_render.py
    np.savez_compressed(GOLDEN_SWEEP_TPT, image=tpt_sweep_render())
