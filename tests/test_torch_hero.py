"""The hero scene through the port: textured, normal-mapped and env-lit
shading, environment NEE and the three wavefront options the port took
up last (`nearfield_frac`, `heavy_shading_iters`, `debug_no_shadow`),
against tpt and against the committed goldens.

- The hero at 120x68, 3 frames, depth 4, SVGF, env NEE, on BVH_PALLAS
  (the backend tpt's CLI picks for it by itself) through the port's
  Renderer and tpt/cli.py's save step (mirror x, tonemap): against
  tests/golden_hero_120x68.npz at tests/test_hero.py's tolerance (> 97%
  of values within 2/255, means within 2%). That golden is tpt's BVH_XLA
  render, whose hits equal BVH_PALLAS's but on equal-t ties.
- `veach_mis` against tests/golden_veach_128x96_8spp.npz at
  tests/test_golden.py's tolerance (> 97% within atol 5e-3 / rtol 1e-3,
  means within 2%), a BVH_XLA golden rendered here on BVH_PALLAS.
- The hit-surface fetch (textures, normal map), environment NEE and the
  synthetic shading load against tpt's, live, on the same tables.
- Whole renders against tpt's renders of the same configuration, at
  tests/test_golden.py's tolerance. tpt's renders are stored in
  tests/golden_hero_tpt.npz, written by

      JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_hero.py

  (about three minutes: tpt's BVH_PALLAS near-field render runs its
  packet kernel in interpret mode), because live they would cost the
  suite tens of seconds.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from tpt_torch import Renderer
from tpt_torch.config import RayCastBackend, RenderConfig
from tpt_torch.core.camera import Camera
from tpt_torch.integrators import common, megakernel, wavefront
from tpt_torch.io.image import tonemap
from tpt_torch.scene import hero_assets, loader, procedural
from tpt_torch.scene.structs import MaterialType

from torch_port_helpers import np3, to_jax3, to_torch3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_HERO = os.path.join(HERE, "golden_hero_120x68.npz")
GOLDEN_VEACH = os.path.join(HERE, "golden_veach_128x96_8spp.npz")
STORED = os.path.join(HERE, "golden_hero_tpt.npz")
SPHERES = (MaterialType.MICROFACET_PBR, MaterialType.SPECULAR_REFRACTION)
# tpt's stored renders: the hero at 32x18, brute force, depth 3, 2 spp;
# the Cornell box with spheres at 24x24 (no shadow) and at 16x16 on
# BVH_PALLAS (near field), depth 3 and 2
HERO_RES, HERO_DEPTH, HERO_ITERS = (32, 18), 3, 2
HEAVY_ITERS = 3
NOSHADOW_RES, NEARFIELD_RES, NEARFIELD_DEPTH = (24, 24), (16, 16), 2
NEARFIELD_FRAC = 0.3


def _agree(img, ref):
    """tests/test_golden.py's tolerance."""
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, atol=5e-3, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - ref).max()))
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.02)


def _hero_cfg(**kw):
    return RenderConfig(backend=RayCastBackend.BRUTE_FORCE,
                        trace_depth=HERO_DEPTH, env_nee=True).with_(**kw)


def _resized(cam, res):
    return Camera.build(res, cam.position, cam.look_at, cam.up, cam.fovy_deg)


@pytest.fixture(scope="module")
def hero_host():
    with tempfile.TemporaryDirectory() as d:
        yield loader.load_scene(hero_assets.write_hero_assets(d))


@pytest.fixture(scope="module")
def hero_data(hero_host):
    return hero_host.build(with_bvh=True, device="cpu")


@pytest.fixture(scope="module")
def stored():
    with np.load(STORED) as f:
        return dict(f)


def test_hero_matches_golden(hero_host, hero_data):
    """tests/test_hero.py's render through the port's API: the Renderer's
    denoised frame 3 of the scene's own camera at 120x68, saved as
    tpt/cli.py:154-157 saves it."""
    cam = _resized(hero_host.camera, (120, 68))
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=4,
                       iterations=3, denoiser_on=True, env_nee=True)
    r = Renderer(hero_data, cam, cfg)
    for _ in range(cfg.iterations):
        img = r.frame()
    assert int(r.raycaster.capped) == 0
    img = tonemap(img[:, ::-1], gamma=cfg.gamma).astype(np.float32) / 255.0
    golden = np.load(GOLDEN_HERO)["image"]
    assert img.shape == golden.shape == (68, 120, 3)
    close = np.isclose(img, golden, atol=2 / 255.0).mean()
    assert close > 0.97, (close, float(np.abs(img - golden).max()))
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=0.02)


def test_veach_mis_matches_golden():
    """tests/test_golden.py:79-88's configuration on BVH_PALLAS."""
    s = procedural.veach_mis(resolution=(128, 96))
    data = s.build(with_bvh=True, device="cpu")
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3)
    rc = common.make_raycaster(data, cfg)
    img = wavefront.render(data, s.camera, cfg, iterations=8, raycaster=rc)
    assert int(rc.capped) == 0
    _agree(img, np.load(GOLDEN_VEACH)["image"])


@pytest.fixture(scope="module")
def both_tables(hero_host):
    """tpt's hero SceneData and the port's SceneData carried across from
    its leaves (the same tables)."""
    from tpt.scene import loader as jloader
    from tpt_torch.scene.convert import from_numpy_scene
    from torch_port_helpers import scene_leaves

    with tempfile.TemporaryDirectory() as d:
        jd = jloader.load_scene(hero_assets.write_hero_assets(d)).build(
            prep_cache=False)
    return jd, from_numpy_scene(**scene_leaves(jd), device="cpu")


@pytest.fixture(scope="module")
def hit_lanes(both_tables):
    """Random hits on every triangle kind and random view directions."""
    jd, _ = both_tables
    rs = np.random.default_rng(31)
    n = 4096
    tri = rs.integers(0, jd.mesh.num_triangles, n).astype(np.int32)
    bu = rs.uniform(0, 1, n).astype(np.float32)
    bv = (rs.uniform(0, 1, n) * (1 - bu)).astype(np.float32)
    wo = rs.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    return tri, bu, bv, wo


def test_fetch_hit_surface_textured_matches_tpt(both_tables, hit_lanes):
    """Textured basecolor, roughness and metallic, the normal-mapped
    shading normal and the uvs: ints exact, floats within rtol 1e-5 /
    atol 1e-6 (the normalizations: XLA's rsqrt is not correctly
    rounded)."""
    import jax.numpy as jnp
    from tpt.integrators import common as jcommon

    jd, td = both_tables
    tri, bu, bv, wo = hit_lanes
    jo = jcommon.fetch_hit_surface(jd, jnp.asarray(tri), jnp.asarray(bu),
                                   jnp.asarray(bv), to_jax3(wo))
    to = common.fetch_hit_surface(td, torch.from_numpy(tri),
                                  torch.from_numpy(bu), torch.from_numpy(bv),
                                  to_torch3(wo))
    jm, tm = jo[0], to[0]
    for f in ("mtype", "tex_diffuse", "tex_metallic_roughness", "tex_normal"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    np.testing.assert_array_equal(to[4].numpy(), np.asarray(jo[4]))
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    close(np3(tm.basecolor), np3(jm.basecolor))
    for f in ("metallic", "roughness", "emittance", "ior"):
        close(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
    for k in (1, 2, 3):
        close(np3(to[k]), np3(jo[k]))
    for k in (5, 6):
        close(to[k].numpy(), np.asarray(jo[k]))
    textured = tm.tex_diffuse.numpy() >= 0
    mapped = tm.tex_normal.numpy() >= 0
    assert textured.mean() > 0.0001 and mapped.any()
    # the maps change what an untextured fetch would give
    assert not np.allclose(np3(tm.basecolor)[textured], 1.0)


def test_unfused_surface_chain_matches_fused(both_tables, hit_lanes):
    """gather_materials + get_surface_properties + apply_material_textures
    give the fused fetch's normal, uvs and textured material bit for bit,
    and tpt's unfused chain within rtol 1e-5 / atol 1e-6."""
    import jax.numpy as jnp
    from tpt.integrators import common as jcommon
    from tpt.materials import bsdf as jbsdf
    from tpt_torch.materials import bsdf

    jd, td = both_tables
    tri, bu, bv, wo = hit_lanes
    t = torch.from_numpy
    fused = common.fetch_hit_surface(td, t(tri), t(bu), t(bv), to_torch3(wo))
    mats = bsdf.gather_materials(td.materials, fused[4].to(torch.int64))
    n, uu, vv = common.get_surface_properties(td.mesh, td.atlas, mats, t(tri),
                                              t(bu), t(bv))
    tex = common.apply_material_textures(mats, td.atlas, uu, vv)
    for a, b in ((n.x, fused[1].x), (n.y, fused[1].y), (n.z, fused[1].z),
                 (uu, fused[5]), (vv, fused[6]),
                 (tex.basecolor.x, fused[0].basecolor.x),
                 (tex.roughness, fused[0].roughness),
                 (tex.metallic, fused[0].metallic)):
        assert torch.equal(a, b)
    jmats = jbsdf.gather_materials(jd.materials, jnp.asarray(fused[4].numpy()))
    jn, juu, jvv = jcommon.get_surface_properties(
        jd.mesh, jd.atlas, jmats, jnp.asarray(tri), jnp.asarray(bu),
        jnp.asarray(bv))
    jtex = jcommon.apply_material_textures(jmats, jd.atlas, juu, jvv)
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    close(np3(n), np3(jn))
    close(np3(tex.basecolor), np3(jtex.basecolor))
    close(tex.roughness.numpy(), np.asarray(jtex.roughness))


def test_compute_env_nee_matches_tpt(both_tables, hit_lanes):
    """Environment NEE on the same surface lanes with brute-force shadow
    rays in both packages: RNG states exact, contributions within rtol
    1e-4 / atol 1e-6 on at least 99.9% of values (a grazing shadow ray
    may flip between the packages' float orders)."""
    import jax.numpy as jnp
    from tpt.config import RayCastBackend as JBackend
    from tpt.config import RenderConfig as JConfig
    from tpt.integrators import common as jcommon

    jd, td = both_tables
    tri, bu, bv, wo = hit_lanes
    n = tri.shape[0]
    rs = np.random.default_rng(32)
    state = rs.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    thr = rs.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    alive = rs.uniform(size=n) < 0.9
    jo = jcommon.fetch_hit_surface(jd, jnp.asarray(tri), jnp.asarray(bu),
                                   jnp.asarray(bv), to_jax3(wo))
    to = common.fetch_hit_surface(td, torch.from_numpy(tri),
                                  torch.from_numpy(bu), torch.from_numpy(bv),
                                  to_torch3(wo))
    v0, v1, v2 = (np3(c) for c in (jd.mesh.positions.take(jd.mesh.i0[tri]),
                                   jd.mesh.positions.take(jd.mesh.i1[tri]),
                                   jd.mesh.positions.take(jd.mesh.i2[tri])))
    point = (v0 * (1 - bu - bv)[:, None] + v1 * bu[:, None]
             + v2 * bv[:, None]).astype(np.float32)
    jcfg = JConfig(backend=JBackend.BRUTE_FORCE, env_nee=True)
    tcfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, env_nee=True)
    js, jc = jcommon.compute_env_nee(
        jd, jcfg, jcommon.make_raycaster(jd, jcfg), jnp.asarray(state),
        to_jax3(point), jo[1], jo[3], to_jax3(wo), jo[0], to_jax3(thr),
        jnp.asarray(alive))
    ts, tc = common.compute_env_nee(
        td, tcfg, common.make_raycaster(td, tcfg),
        torch.from_numpy(state.astype(np.int64)), to_torch3(point), to[1],
        to[3], to_torch3(wo), to[0], to_torch3(thr), torch.from_numpy(alive))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.asarray(js).astype(np.uint32))
    a, b = np3(tc), np3(jc)
    assert (b > 0).any(axis=-1).mean() > 0.02
    assert np.isclose(a, b, rtol=1e-4, atol=1e-6).mean() >= 0.999


def test_heavy_shading_factor_matches_tpt():
    import jax.numpy as jnp
    from tpt.integrators import common as jcommon

    u = np.random.default_rng(33).uniform(0, 1, 4096).astype(np.float32)
    for iters in (0, 1, 7):
        np.testing.assert_allclose(
            common.heavy_shading_factor(torch.from_numpy(u), iters).numpy(),
            np.asarray(jcommon.heavy_shading_factor(jnp.asarray(u), iters)),
            rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def hero_small(hero_host):
    return _resized(hero_host.camera, HERO_RES), hero_host.build(device="cpu")


@pytest.mark.parametrize("name,integrator,knobs", [
    ("wave_env", "wavefront", {}),
    ("wave_nonee", "wavefront", dict(env_nee=False)),
    ("mega_env", "megakernel", {}),
    ("wave_heavy", "wavefront", dict(heavy_shading_iters=HEAVY_ITERS)),
    ("mega_heavy", "megakernel", dict(heavy_shading_iters=HEAVY_ITERS)),
])
def test_hero_render_matches_tpt(hero_small, stored, name, integrator, knobs):
    """Textured, env-lit hero renders of both integrators against tpt's
    (env NEE on and off, the synthetic shading load on)."""
    cam, data = hero_small
    engine = wavefront if integrator == "wavefront" else megakernel
    img = engine.render(data, cam, _hero_cfg(**knobs), iterations=HERO_ITERS)
    _agree(img, stored[name])


def _cornell(res):
    s = procedural.cornell_box(resolution=res, sphere_materials=SPHERES)
    return s, s.build(with_bvh=True, device="cpu")


def test_debug_no_shadow_matches_tpt(stored):
    s, data = _cornell(NOSHADOW_RES)
    cfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=3)
    img = wavefront.render(data, s.camera, cfg.with_(debug_no_shadow=True),
                           iterations=2)
    _agree(img, stored["cornell_noshadow"])
    # nothing occluded: brighter than the render with shadow rays
    lit = wavefront.render(data, s.camera, cfg, iterations=2)
    assert img.mean() > lit.mean() * 1.05


def test_nearfield_matches_tpt(stored, monkeypatch):
    """The two-pass BVH_PALLAS cast: twice the extension casts of the
    one-pass render, the same image as it (no hit is lost or changed),
    and tpt's near-field render."""
    from tpt_torch.bvh import packet_traverse as pt

    from torch_port_helpers import count_calls

    s, data = _cornell(NEARFIELD_RES)
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS,
                       trace_depth=NEARFIELD_DEPTH)
    one = wavefront.render(data, s.camera, cfg, iterations=1)
    calls = count_calls(monkeypatch, pt, ("packet_closest_hit_wide",))
    rc = common.make_raycaster(data, cfg)
    two = wavefront.render(data, s.camera,
                           cfg.with_(nearfield_frac=NEARFIELD_FRAC),
                           iterations=1, raycaster=rc)
    assert calls["packet_closest_hit_wide"] == 2 * NEARFIELD_DEPTH
    assert int(rc.capped) == 0
    np.testing.assert_array_equal(two, one)
    _agree(two, stored["cornell_nearfield"])


def test_former_refusals_are_admitted():
    """_unsupported no longer refuses the three options (they render
    above), nor BVH_XLA (tests/test_torch_bvhxla.py)."""
    for backend in (RayCastBackend.BVH_PALLAS, RayCastBackend.BVH_SWEEP,
                    RayCastBackend.BVH_TREELET):
        base = RenderConfig(backend=backend)
        for knobs in (dict(nearfield_frac=0.5), dict(heavy_shading_iters=2),
                      dict(debug_no_shadow=True)):
            assert wavefront._unsupported(base.with_(**knobs)) is None
    assert wavefront._unsupported(
        RenderConfig(backend=RayCastBackend.BVH_XLA)) is None


def tpt_outputs() -> dict:
    """tpt's renders that the tests above hold the port against."""
    import tpt
    from tpt.core.camera import Camera as JCamera
    from tpt.integrators import megakernel as jmk
    from tpt.integrators import wavefront as jwf
    from tpt.scene import loader as jloader
    from tpt.scene import procedural as jproc
    from tpt.scene.structs import MaterialType as JMat

    out = {}
    with tempfile.TemporaryDirectory() as d:
        host = jloader.load_scene(hero_assets.write_hero_assets(d))
    c = host.camera
    cam = JCamera.build(HERO_RES, c.position, c.look_at, c.up, c.fovy_deg)
    data = host.build(prep_cache=False)
    base = tpt.RenderConfig(backend=tpt.RayCastBackend.BRUTE_FORCE,
                            trace_depth=HERO_DEPTH, env_nee=True)
    for name, engine, knobs in (
            ("wave_env", jwf, {}), ("wave_nonee", jwf, dict(env_nee=False)),
            ("mega_env", jmk, {}),
            ("wave_heavy", jwf, dict(heavy_shading_iters=HEAVY_ITERS)),
            ("mega_heavy", jmk, dict(heavy_shading_iters=HEAVY_ITERS))):
        out[name] = np.asarray(engine.render(data, cam, base.with_(**knobs),
                                             iterations=HERO_ITERS))
    spheres = (JMat.MICROFACET_PBR, JMat.SPECULAR_REFRACTION)
    s = jproc.cornell_box(resolution=NOSHADOW_RES, sphere_materials=spheres)
    out["cornell_noshadow"] = np.asarray(jwf.render(
        s.build(prep_cache=False), s.camera,
        tpt.RenderConfig(backend=tpt.RayCastBackend.BRUTE_FORCE,
                         trace_depth=3, debug_no_shadow=True), iterations=2))
    s = jproc.cornell_box(resolution=NEARFIELD_RES, sphere_materials=spheres)
    out["cornell_nearfield"] = np.asarray(jwf.render(
        s.build(with_bvh=True, prep_cache=False), s.camera,
        tpt.RenderConfig(backend=tpt.RayCastBackend.BVH_PALLAS,
                         trace_depth=NEARFIELD_DEPTH,
                         nearfield_frac=NEARFIELD_FRAC), iterations=1))
    return {k: v.astype(np.float32) for k, v in out.items()}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_hero.py
    np.savez_compressed(STORED, **tpt_outputs())
