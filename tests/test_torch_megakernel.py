"""The port's megakernel integrator (`tpt_torch.integrators.megakernel`)
and the engine's RenderMode.MEGAKERNEL, against tpt.

Whole renders are held at tests/test_golden.py's tolerance (>97% of
pixels within atol 5e-3 / rtol 1e-3, means within 2%): against the
golden tpt's megakernel wrote, and against tpt's megakernel on
BVH_PALLAS with the binary and the wide pack. tpt's costly outputs (its
interpret-mode packet kernels inside the megakernel, its Renderer's
frames and checkpoint) are stored in tests/golden_megakernel_tpt.npz,
written by

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_megakernel.py

(the `__main__` block below; about a minute), because computed live
they would cost the suite tens of seconds."""

import os
import tempfile
from dataclasses import replace

import numpy as np
import pytest
import torch

from tpt_torch import Renderer
from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.config import RayCastBackend, RenderConfig, RenderMode
from tpt_torch.core import rng
from tpt_torch.integrators import common, megakernel
from tpt_torch.materials import bsdf
from tpt_torch.scene import procedural as tproc
from tpt_torch.scene.structs import EnvMap, MaterialType

from torch_port_helpers import count_calls
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_cornell_128_4spp.npz")
STORED = os.path.join(HERE, "golden_megakernel_tpt.npz")
SPHERES = (MaterialType.MICROFACET_PBR, MaterialType.SPECULAR_REFRACTION)
# tpt's megakernel on BVH_PALLAS: 32x32 (one 1024-lane packet), depth 3
PALLAS_RES, PALLAS_DEPTH, PALLAS_ITERS = (32, 32), 3, 2
# tpt's Renderer in MEGAKERNEL mode: 24x24 brute force, depth 3, two
# frames, a checkpoint, a third frame, a camera move, a fourth frame
ENGINE_RES, ENGINE_DEPTH = (24, 24), 3
# a scene whose light table is empty: 16x16 brute force, depth 3, 2 spp
NOLIGHT_RES = (16, 16)
NOLIGHT_CFG = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=3)
MOVED_TO = (278.0, 273.0, -700.0)


def _agree(img, ref):
    assert img.shape == ref.shape
    close = np.isclose(img, ref, atol=5e-3, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - ref).max()))
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.02)


@pytest.fixture(scope="module")
def stored():
    with np.load(STORED) as f:
        return dict(f)


def _pallas_scene(arity: int):
    s = tproc.cornell_box(resolution=PALLAS_RES, sphere_materials=SPHERES)
    return s, s.build(with_bvh=True, packet_arity=arity, device="cpu")


def _pallas_cfg():
    return RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                        trace_depth=PALLAS_DEPTH)


def test_brute_force_matches_golden():
    """tests/test_golden.py:53's configuration, which tpt's megakernel
    wrote."""
    s = tproc.cornell_box(resolution=(128, 128), sphere_materials=SPHERES)
    cfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=4)
    img = megakernel.render(s.build(device="cpu"), s.camera, cfg, iterations=4)
    _agree(img, np.load(GOLDEN)["image"])


@pytest.mark.parametrize("arity", [2, 4])
def test_pallas_matches_tpt(stored, arity, monkeypatch):
    """BVH_PALLAS on the binary pack (K8a/K8b) and on the wide one
    (K2/K1), against tpt's megakernel on the same configuration."""
    calls = count_calls(monkeypatch, pt, (
        "packet_closest_hit", "packet_any_hit", "packet_closest_hit_wide",
        "packet_any_hit_wide"))
    s, data = _pallas_scene(arity)
    rc = common.make_raycaster(data, _pallas_cfg())
    img = megakernel.render(data, s.camera, _pallas_cfg(),
                            iterations=PALLAS_ITERS, raycaster=rc)
    assert int(rc.capped) == 0
    casts = PALLAS_DEPTH * PALLAS_ITERS
    suffix = "" if arity == 2 else "_wide"
    assert calls == {"packet_closest_hit" + suffix: casts,
                     "packet_any_hit" + suffix: casts}
    _agree(img, stored[f"pallas_arity{arity}"])


def test_tiles_do_not_change_the_image():
    """A pixel's sample does not depend on the other pixels traced with
    it: tpt's tiling (1024 pixels in tiles of 300, the tail clipped to the
    last pixel and dropped, tpt/integrators/megakernel.py:217-221)
    rebuilds the port's one-pass sample bit for bit, so the one-pass image
    is the tiled one whatever megakernel_tile says (the port selects
    nothing by it); another seed gives another image."""
    s, data = _pallas_scene(2)
    cfg = _pallas_cfg().with_(trace_depth=2)
    n = s.camera.num_pixels
    rc = common.make_raycaster(data, cfg)
    whole = megakernel.trace_sample(data, rc, s.camera, cfg, 1)
    tiles = [megakernel.trace_sample(
        data, rc, s.camera, cfg, 1,
        pix=torch.arange(start, start + 300).clamp_max(n - 1))
        for start in range(0, n, 300)]
    for ax in ("x", "y", "z"):
        tiled = torch.cat([getattr(t, ax) for t in tiles])[:n]
        assert torch.equal(tiled, getattr(whole, ax))
    img = megakernel.render(data, s.camera, cfg, iterations=1)
    other = megakernel.render(data, s.camera, cfg, iterations=1, start_iter=7)
    assert not np.array_equal(other, img)
    assert np.isfinite(img).all() and img.mean() > 0


def _no_lights(lights_cls, zeros, data):
    """The scene with an empty light table: emitters still shine when a
    path hits them, but there is no NEE."""
    empty = lights_cls(tri_idx=zeros("int"), cdf=zeros("float"),
                       areas=zeros("float"), total_area=zeros("scalar"),
                       packed=None)
    return replace(data, lights=empty)


def _torch_zeros(kind):
    if kind == "scalar":
        return torch.zeros(())
    return torch.zeros(0, dtype=torch.int64 if kind == "int" else torch.float32)


def test_scene_without_lights_keeps_the_stream(stored, monkeypatch):
    """With no light, each bounce draws the light sample's three numbers
    anyway (tpt/integrators/megakernel.py:133-136), so the BSDF sample
    sees the stream where a lit scene's would be, and the image (emitters
    hit by BSDF paths) agrees with tpt's."""
    from tpt_torch.scene.structs import LightData

    s = tproc.cornell_box(resolution=NOLIGHT_RES, sphere_materials=SPHERES)
    data = _no_lights(LightData, _torch_zeros, s.build(device="cpu"))
    assert data.lights.num_lights == 0
    seen = []
    inner = bsdf.sample_bsdf

    def record(wo, n, mats, state):
        state_out, smp = inner(wo, n, mats, state)
        seen.append((state.clone(), state_out.clone()))
        return state_out, smp

    monkeypatch.setattr(bsdf, "sample_bsdf", record)
    img = megakernel.render(data, s.camera, NOLIGHT_CFG, iterations=2)
    _agree(img, stored["nolights"])
    assert img.mean() > 0
    from tpt_torch.core.camera import generate_camera_rays

    _, _, seed = generate_camera_rays(s.camera, 1, NOLIGHT_CFG.jitter,
                                      device="cpu")

    def three(st):
        for _ in range(3):
            st, _ = rng.rand_float(st)
        return st

    assert len(seen) == 2 * NOLIGHT_CFG.trace_depth
    assert torch.equal(seen[0][0], three(seed))
    assert torch.equal(seen[1][0], three(seen[0][1]))


def test_unported_options_raise():
    s, data = _pallas_scene(2)
    cfg = _pallas_cfg()
    with pytest.raises(NotImplementedError, match="environment"):
        megakernel.render(replace(data, env=EnvMap(enabled=True)), s.camera,
                          cfg, iterations=1)
    with pytest.raises(NotImplementedError, match="heavy_shading_iters"):
        megakernel.render(data, s.camera, cfg.with_(heavy_shading_iters=2),
                          iterations=1)
    with pytest.raises(NotImplementedError, match="BVH_SWEEP"):
        megakernel.make_sample_fn(data, s.camera,
                                  cfg.with_(backend=RayCastBackend.BVH_SWEEP))
    assert megakernel.render(data, s.camera, cfg, iterations=0).shape == \
        (PALLAS_RES[1], PALLAS_RES[0], 3)


def _engine_scene():
    s = tproc.cornell_box(resolution=ENGINE_RES, sphere_materials=SPHERES)
    return s, s.build(device="cpu")


ENGINE_CFG = RenderConfig(backend=RayCastBackend.BRUTE_FORCE,
                          trace_depth=ENGINE_DEPTH, mode=RenderMode.MEGAKERNEL)


def test_renderer_frames_move_and_checkpoint(stored):
    """The engine in MEGAKERNEL mode against tpt's: two frames, a
    checkpoint, a third frame, a camera move, a fourth frame; the
    checkpoint in tpt's leaf order; a round trip through the port's own
    checkpoint and a resume from tpt's."""
    s, data = _engine_scene()
    r = Renderer(data, s.camera, ENGINE_CFG)
    f1, f2 = r.frame(), r.frame()
    assert r.iteration == 2
    assert r.gui.traced_depth == ENGINE_DEPTH and r.gui.mrays_per_sec > 0
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "mega.npz")
        r.save_checkpoint(ck)
        f3 = r.frame()
        r.move_camera(s.camera.moved(position=MOVED_TO))
        assert r.iteration == 0
        f4 = r.frame()
        for i, f in enumerate((f1, f2, f3, f4), 1):
            _agree(f, stored[f"engine_frame{i}"])
        with np.load(ck) as mine:
            keys = sorted(mine.files)
            tpt_keys = sorted(k[3:] for k in stored if k.startswith("ck_"))
            assert keys == tpt_keys
            for k in ("acc_mega_0", "acc_mega_1", "acc_mega_2"):
                _agree(mine[k], stored["ck_" + k])
            assert int(mine["iteration"]) == 2
        back = Renderer(data, s.camera, ENGINE_CFG)
        back.load_checkpoint(ck)
        np.testing.assert_array_equal(back.frame(), f3)
        tpt_ck = os.path.join(tmp, "tpt.npz")
        np.savez(tpt_ck, **{k[3:]: v for k, v in stored.items()
                            if k.startswith("ck_")})
        resumed = Renderer(data, s.camera, ENGINE_CFG)
        resumed.load_checkpoint(tpt_ck)
        _agree(resumed.frame(), stored["engine_frame3"])


def _write_stored():  # pragma: no cover - regeneration path
    """tpt's outputs for the tests above (needs JAX and tpt)."""
    from tpt.engine import Renderer as JRenderer
    from tpt.config import (RayCastBackend as JB, RenderConfig as JCfg,
                            RenderMode as JMode)
    from tpt.integrators import megakernel as jmega
    from tpt.scene import procedural as jproc
    from tpt.scene.structs import MaterialType as JMat

    spheres = (JMat.MICROFACET_PBR, JMat.SPECULAR_REFRACTION)
    out = {}
    for arity in (2, 4):
        s = jproc.cornell_box(resolution=PALLAS_RES, sphere_materials=spheres)
        data = s.build(with_bvh=True, packet_arity=arity, prep_cache=False)
        cfg = JCfg(backend=JB.BVH_PALLAS, trace_depth=PALLAS_DEPTH)
        out[f"pallas_arity{arity}"] = np.asarray(jmega.render(
            data, s.camera, cfg, iterations=PALLAS_ITERS), np.float32)
    import jax.numpy as jnp
    from tpt.scene.structs import LightData as JLightData

    def jzeros(kind):
        if kind == "scalar":
            return jnp.float32(0.0)
        return jnp.zeros(0, jnp.int32 if kind == "int" else jnp.float32)

    s = jproc.cornell_box(resolution=NOLIGHT_RES, sphere_materials=spheres)
    data = _no_lights(JLightData, jzeros, s.build(prep_cache=False))
    out["nolights"] = np.asarray(jmega.render(
        data, s.camera, JCfg(backend=JB.BRUTE_FORCE,
                             trace_depth=NOLIGHT_CFG.trace_depth),
        iterations=2), np.float32)
    s = jproc.cornell_box(resolution=ENGINE_RES, sphere_materials=spheres)
    data = s.build(prep_cache=False)
    r = JRenderer(data, s.camera, JCfg(backend=JB.BRUTE_FORCE,
                                       trace_depth=ENGINE_DEPTH,
                                       mode=JMode.MEGAKERNEL))
    out["engine_frame1"] = r.frame()
    out["engine_frame2"] = r.frame()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "tpt.npz")
        r.save_checkpoint(ck)
        with np.load(ck) as f:
            out.update({"ck_" + k: f[k] for k in f.files})
    out["engine_frame3"] = r.frame()
    r.move_camera(s.camera.moved(position=MOVED_TO))
    out["engine_frame4"] = r.frame()
    np.savez_compressed(STORED, **out)
    print(f"wrote {STORED}: {sorted(out)}")


if __name__ == "__main__":  # pragma: no cover
    _write_stored()
