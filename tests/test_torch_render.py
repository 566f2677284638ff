"""Whole renders of the port against the committed goldens (read only),
with the tolerances of tests/test_golden.py:33-39, plus the wavefront's
frame-level contracts (empty renders, determinism, spp batching)."""

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
SPHERES = (MaterialType.MICROFACET_PBR, MaterialType.SPECULAR_REFRACTION)


def _compare(path, img, atol=5e-3):
    """tests/test_golden.py:_compare_or_write without the write."""
    golden = np.load(path)["image"]
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


@pytest.mark.parametrize("backend", ["BRUTE_FORCE", "BVH_PALLAS"])
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
    for cfg in (RenderConfig(backend=RayCastBackend.BVH_SWEEP),
                RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                             nearfield_frac=0.5),
                RenderConfig(backend=RayCastBackend.BVH_PALLAS, trav_group=8),
                RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                             sweep_shadow=True),
                RenderConfig(backend=RayCastBackend.BVH_PALLAS, sort_every=2)):
        with pytest.raises(NotImplementedError):
            wavefront.render(data, s.camera, cfg, iterations=1)
