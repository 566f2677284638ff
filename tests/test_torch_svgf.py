"""The port's SVGF (tpt_torch/denoise) against tpt's on the CPU.

The port's wrappers run their plain PyTorch versions here; tpt's Pallas
kernels run in interpret mode, as tests/test_svgf.py runs them. Inputs are
made with numpy from a seed and handed to both packages. Tolerances:
- the plain K5 against `_atrous_once` and `atrous_pallas`: atol 1e-5, as
  tests/test_svgf.py:164 holds the two tpt versions. The port repeats
  tpt's float32 operations in order; exp and pow differ (PyTorch's CPU
  kernels against XLA's, about 1 ulp): measured up to 5.2e-6;
- the plain K6 against `_reproject_taps`: atol 1e-6 (no exp or pow; the
  weights are equal and the sums differ by 1 ulp, 1.2e-7 measured, where
  XLA's CPU backend fuses a multiply-add);
- the plain K6 against `reproject_pallas` where that is exact:
  tests/test_svgf.py:298-302's atol (1e-6 on the weights, 1e-5 on sums);
- run_svgf over 8 frames of carried state: history lengths exactly,
  every float leaf and the image to atol 2e-5 (the K5 differences above,
  carried through 5 passes and the history; measured up to 5.7e-6).
The CUDA kernels are held against the plain versions by
tests/test_torch_gpu.py.

tpt's `_atrous_once` and `_reproject_taps` run live. Its interpret-mode
Pallas kernels and its compiled `run_svgf` cost ~25 s here, more than the
suite can spend, so their outputs on these seeded inputs are stored in
tests/golden_svgf_tpt.npz, written by
`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_svgf.py`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.config import SVGFConfig as JSVGFConfig
from tpt.core.vec import Vec3 as JVec3
from tpt.denoise import svgf as jsvgf
from tpt.denoise.pallas_reproject import reproject_pallas
from tpt.denoise.pallas_stencil import atrous_pallas
from tpt_torch.config import SVGFConfig
from tpt_torch.core.vec import Vec3
from tpt_torch.denoise import reproject, stencil, svgf

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

CFG = SVGFConfig()
JCFG = JSVGFConfig(use_pallas_atrous=False, use_pallas_reproject=False)
H, W = 24, 40
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_svgf_tpt.npz")
LEAF_FRAMES = (3, 7)       # frames whose whole SVGFState is stored
INT_LEAVES = (12, 17)      # history_len, prev_matid


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


def jv(a):
    return JVec3(*(jnp.asarray(c) for c in a))


def tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def j1(a):
    return jnp.asarray(a)


def t1(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def unit_normals(rs, h, w):
    n = rs.normal(size=(3, h, w))
    return (n / np.linalg.norm(n, axis=0, keepdims=True)).astype(np.float32)


def atrous_inputs(seed=0, h=H, w=W):
    """Illumination, variance, a depth edge with sky, random unit normals
    (a patch of them shared, so some normal weights are not 0)."""
    rs = np.random.default_rng(seed)
    f = lambda *s: rs.random(s).astype(np.float32)
    depth = (f(h, w) * 3 + 10).astype(np.float32)
    depth[:, w // 2:] += 40.0                # an edge
    depth[2:6, 3:9] = -1000.0                # sky
    nrm = unit_normals(rs, h, w)
    nrm[:, 8:16, 10:30] = np.array([0.0, 0.6, 0.8], np.float32)[:, None, None]
    return dict(ill_d=f(3, h, w), var_d=f(h, w), ill_i=f(3, h, w) * 2,
                var_i=f(h, w), depth=depth, normal=nrm)


def jax_atrous(a, step, pallas=False):
    args = (jv(a["ill_d"]), j1(a["var_d"]), jv(a["ill_i"]), j1(a["var_i"]),
            j1(a["depth"]), jv(a["normal"]))
    if pallas:
        out = atrous_pallas(*args, step, CFG.sigma_z, CFG.sigma_n, CFG.sigma_l)
    else:
        out = jax.jit(jsvgf._atrous_once, static_argnums=(6, 7))(
            *args, step, JCFG)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]


def torch_atrous(a, step):
    out = stencil.atrous(tv(a["ill_d"]), t1(a["var_d"]), tv(a["ill_i"]),
                         t1(a["var_i"]), t1(a["depth"]), tv(a["normal"]),
                         step, CFG.sigma_z, CFG.sigma_n, CFG.sigma_l)
    d, vd, i, vi = out
    return [c.numpy() for c in (d.x, d.y, d.z, vd, i.x, i.y, i.z, vi)]


@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_plain_atrous_matches_tpt(step):
    a = atrous_inputs()
    got, want = torch_atrous(a, step), jax_atrous(a, step)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, atol=1e-5, rtol=0)
    # sky passes through untouched
    np.testing.assert_array_equal(got[0][2:6, 3:9], a["ill_d"][0][2:6, 3:9])


def test_plain_atrous_matches_pallas(golden):
    a = atrous_inputs(seed=1)
    for g, w_ in zip(torch_atrous(a, 2), golden["atrous_pallas"]):
        np.testing.assert_allclose(g, w_, atol=1e-5, rtol=0)


def history(rs, h, w):
    """A random SVGFState as numpy leaves in tpt's order: data planes of
    noise, and geometry in 6x6 blocks of one normal and material on a
    depth ramp (so that taps of a nearby current frame pass the test)."""
    f = lambda: rs.uniform(0, 1, (h, w)).astype(np.float32)
    blocks = lambda a: np.ascontiguousarray(
        np.repeat(np.repeat(a, 6, -2), 6, -1)[..., :h, :w])
    nrm = blocks(unit_normals(rs, -(-h // 6), -(-w // 6)))
    depth = (20.0 + 0.2 * np.arange(w)[None, :]
             + 0.1 * np.arange(h)[:, None]).astype(np.float32)
    matid = blocks(rs.integers(0, 3, (-(-h // 6), -(-w // 6)))).astype(np.int32)
    return [f(), f(), f(), f(), f(), f(), f(), f(), f(), f(), f(), f(),
            rs.integers(0, 9, (h, w)).astype(np.int32), depth,
            nrm[0], nrm[1], nrm[2], matid]


def jstate(leaves):
    _, treedef = jax.tree_util.tree_flatten(jsvgf.SVGFState.zeros(1, 1))
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in leaves])


def jax_reproject(leaves, mu, mv, normal, depth, matid, pallas=False):
    """tpt's reprojection: [11, H, W], the DATA_KEYS sums and the weights."""
    js = jstate(leaves)
    args = (j1(mu), j1(mv), jv(normal), j1(depth), j1(matid))
    if pallas:
        sums, wsum = reproject_pallas(js, *args, radius=24)
    else:
        sums, wsum = jax.jit(jsvgf._reproject_taps)(js, *args)
    return np.stack([np.asarray(sums[k]) for k in svgf.DATA_KEYS]
                    + [np.asarray(wsum)])


def port_reproject(leaves, mu, mv, normal, depth, matid):
    sums, wsum = reproject.reproject(svgf.svgf_state_from_numpy(leaves, "cpu"),
                                     t1(mu), t1(mv), tv(normal), t1(depth),
                                     t1(matid))
    return np.stack([sums[k].numpy() for k in svgf.DATA_KEYS] + [wsum.numpy()])


def test_state_leaves_in_tpt_order():
    rs = np.random.default_rng(3)
    leaves = history(rs, 5, 7)
    port = svgf.svgf_state_from_numpy(leaves, "cpu")
    want = jax.tree_util.tree_leaves(jstate(leaves))
    assert len(port.leaves()) == len(want) == 18
    for p, j in zip(port.leaves(), want):
        assert p.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[j.dtype]
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    zero = svgf.SVGFState.zeros(5, 7, "cpu")
    for p, j in zip(zero.leaves(), jax.tree_util.tree_leaves(
            jsvgf.SVGFState.zeros(5, 7))):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    with pytest.raises(ValueError):
        svgf.svgf_state_from_numpy(leaves[:17], "cpu")


def test_plain_reproject_matches_tpt():
    """Random history and current frame with motion that is sub-pixel,
    integral, out of the image, NaN and +-inf."""
    rs = np.random.default_rng(4)
    h, w = 20, 36
    leaves = history(rs, h, w)
    mu = rs.uniform(-3, 3, (h, w)).astype(np.float32)
    mv = rs.uniform(-3, 3, (h, w)).astype(np.float32)
    mu[0, :8] = np.round(mu[0, :8])            # integral: weights 0 and 1
    mu[1, :6] = [60.0, -60.0, 1e9, -1e9, 36.0, -0.5]
    mv[2, :6] = [40.0, -40.0, 20.0, -20.5, 1e9, 0.25]
    mu[3, :4] = [np.nan, np.inf, -np.inf, 0.0]
    mv[3, :4] = [0.0, 0.0, 0.0, np.nan]
    mv[4, :2] = [np.inf, -np.inf]
    # a current frame near the history: some normals, depths and
    # materials changed
    normal = np.stack(leaves[14:17])
    normal[:, ::4] = unit_normals(rs, h, w)[:, ::4]
    depth = leaves[13] + rs.uniform(-1.5, 2.5, (h, w)).astype(np.float32)
    matid = np.where(rs.random((h, w)) < 0.9, leaves[17], 5).astype(np.int32)
    case = (leaves, mu, mv, normal, depth, matid)
    port, tpt = port_reproject(*case), jax_reproject(*case)
    assert 0.2 < (tpt[-1] > 0).mean() < 0.9, (tpt[-1] > 0).mean()
    bad = ~np.isfinite(mu) | ~np.isfinite(mv)
    assert (port[-1][bad] == 0).all() and (tpt[-1][bad] == 0).all()
    assert np.isfinite(port).all() and (port[:, bad] == 0).all()
    # tpt's taps at a NaN index are undefined (masked to weight 0)
    np.testing.assert_allclose(port[:, ~bad], tpt[:, ~bad], atol=1e-6, rtol=0)


def ramp_motion(h, w, pan=(5.0, -4.0)):
    """tests/test_svgf.py:284-287's smooth in-range motion: a pan and a
    slow ramp."""
    ys = np.linspace(0, 1, h)[:, None]
    xs = np.linspace(0, 1, w)[None, :]
    return ((pan[0] + 3.0 * xs + 0.5 * ys).astype(np.float32),
            (pan[1] + 2.0 * ys - 0.5 * xs).astype(np.float32))


def moved_case(rng, h, w, mu, mv):
    """A current frame whose geometry is the history's moved by (mu, mv)
    (to the nearest pixel), so most taps pass the consistency test."""
    leaves = history(rng, h, w)
    sy = np.clip(np.round(np.arange(h)[:, None] - mv), 0, h - 1).astype(int)
    sx = np.clip(np.round(np.arange(w)[None, :] - mu), 0, w - 1).astype(int)
    moved = lambda a: np.ascontiguousarray(a[sy, sx])
    normal = np.stack([moved(c) for c in leaves[14:17]])
    depth = moved(leaves[13]) + rng.uniform(0, 0.5, (h, w)).astype(np.float32)
    return leaves, mu, mv, normal, depth, moved(leaves[17])


def assert_reprojections_agree(port, tpt, atol_sums):
    np.testing.assert_allclose(port[-1], tpt[-1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(port[:-1], tpt[:-1], atol=atol_sums, rtol=0)


def tpt_field_case():
    """tests/test_svgf.py:259-287's draws: per-pixel random history
    normals, depths and materials under the ramp motion."""
    h, w = 40, 72
    rng = np.random.default_rng(5)
    plane = lambda scale=1.0: rng.uniform(0, scale, (h, w)).astype(np.float32)
    nrm = rng.normal(size=(3, h, w)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    leaves = [plane() for _ in range(12)]
    leaves += [rng.integers(0, 9, (h, w)).astype(np.int32), plane(50.0),
               nrm[0], nrm[1], nrm[2],
               rng.integers(0, 3, (h, w)).astype(np.int32)]
    depth = leaves[13] + plane(3.0)
    return (leaves, *ramp_motion(h, w), nrm, depth, leaves[17])


def pan_case(pan, seed):
    """A pan over moved geometry, where most taps are consistent."""
    h, w = 40, 72
    mu = np.full((h, w), pan[0], np.float32)
    mv = np.full((h, w), pan[1], np.float32)
    return moved_case(np.random.default_rng(seed), h, w, mu, mv)


def sheared_case():
    h, w = 40, 72
    return moved_case(np.random.default_rng(9), h, w, *ramp_motion(h, w))


def test_plain_reproject_matches_pallas_on_smooth_motion(golden):
    """tests/test_svgf.py:250's case, and a pan over moved geometry:
    reproject_pallas is exact on both, and so equals the port."""
    assert_reprojections_agree(port_reproject(*tpt_field_case()),
                               golden["reproject_field_pallas"], 1e-5)
    tpt = golden["reproject_pan_pallas"]
    assert (tpt[-1] > 0).mean() > 0.5
    assert_reprojections_agree(port_reproject(*pan_case((5.25, -3.5), 10)),
                               tpt, 1e-5)


def test_pallas_reproject_differs_on_sheared_motion(golden):
    """The documented difference inside the radius: reproject_pallas picks
    a tap's row from the column `rx` over, which is wrong where floor(y -
    mv) changes along the row (here the ramp's vertical motion, -0.5 px
    across the image). Over consistent geometry that shows; the port
    computes tpt's `_reproject_taps` exactly."""
    case = sheared_case()
    port, tpt = port_reproject(*case), jax_reproject(*case)
    assert (tpt[-1] > 0).mean() > 0.5
    assert_reprojections_agree(port, tpt, 1e-6)
    differ = np.abs(port[-1] - golden["reproject_sheared_pallas_w"]) > 1e-3
    assert 0 < differ.mean() < 0.1, differ.mean()


def test_motion_beyond_radius_keeps_history(golden):
    """The documented difference beyond the radius: tpt's default
    reprojection drops history further than +-24 px (its TPU shift
    window); the port, like tpt's `_reproject_taps`, keeps it."""
    case = pan_case((30.25, -2.0), 6)
    port, tpt = port_reproject(*case), jax_reproject(*case)
    assert (golden["reproject_far_pallas_w"] == 0).all()
    assert (port[-1] > 0).mean() > 0.3
    assert_reprojections_agree(port, tpt, 1e-6)


def frame_inputs(rs, k, h, w):
    """Frame k of a synthetic sequence: a panning two-material scene with a
    depth edge and a sky band, noisy radiance, motion of about one pixel
    (a disocclusion strip at the edge and a patch whose material changes
    on frame 3 reset the history there)."""
    depth = np.full((h, w), 12.0, np.float32) + rs.uniform(0, 0.2, (h, w)).astype(np.float32)
    depth[:, w // 2:] += 30.0
    depth[:3] = -1000.0
    nrm = np.zeros((3, h, w), np.float32)
    nrm[2] = 1.0
    nrm[:, :, w // 2:] = np.array([0.6, 0.0, 0.8], np.float32)[:, None, None]
    matid = np.zeros((h, w), np.int32)
    matid[:, w // 2:] = 1
    if k == 3:
        matid[10:16, 4:10] = 2
    matid[:3] = -1
    sky = depth < 0
    nrm[:, sky] = 0.0
    albedo = np.where(matid[None] == 1, 0.3, 0.8).astype(np.float32) * np.ones((3, 1, 1), np.float32)
    albedo[:, sky] = 1.0
    raw_d = rs.exponential(0.5, (3, h, w)).astype(np.float32)
    raw_i = rs.exponential(0.2, (3, h, w)).astype(np.float32)
    mu = np.where(sky, 0.0, 0.75 + 0.1 * k).astype(np.float32)
    mv = np.where(sky, 0.0, -0.3).astype(np.float32)
    return raw_d, raw_i, albedo, depth, nrm, matid, mu, mv


def svgf_frames(seed, n, nonfinite=False):
    """n frames of frame_inputs; with `nonfinite`, NaN and +-inf motion
    in rows 5 and 6 from the second frame on."""
    h, w = 24, 32
    rs = np.random.default_rng(seed)
    frames = [list(frame_inputs(rs, k, h, w)) for k in range(n)]
    if nonfinite:
        for f in frames[1:]:
            mu, mv = f[6].copy(), f[7].copy()
            mu[5, :6] = [np.nan, np.inf, -np.inf, 0.0, 1e30, np.nan]
            mv[6, :4] = [np.inf, np.nan, -np.inf, -1e30]
            f[6], f[7] = mu, mv
    return frames


def split_leaves(leaves):
    """(the 16 float planes, the 2 int planes) of 18 SVGFState leaves."""
    return (np.stack([np.asarray(x) for i, x in enumerate(leaves)
                      if i not in INT_LEAVES]),
            np.stack([np.asarray(leaves[i]) for i in INT_LEAVES]))


def jax_sequence(frames, prefix):
    """tpt's run_svgf over the frames, carrying its state: the images of
    every frame and the state after LEAF_FRAMES (or the last frame)."""
    h, w = frames[0][3].shape
    run = jax.jit(jsvgf.run_svgf, static_argnums=(0,))
    # zeros without weak types, so one compiled program serves every frame
    js = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)),
                                jsvgf.SVGFState.zeros(h, w))
    out, rgbs = {}, []
    for k, (raw_d, raw_i, albedo, depth, nrm, matid, mu, mv) in \
            enumerate(frames):
        rgb, js = run(JCFG, js, jv(raw_d), jv(raw_i), jv(albedo), j1(depth),
                      jv(nrm), j1(matid), j1(mu), j1(mv))
        rgbs.append(np.stack([np.asarray(c) for c in (rgb.x, rgb.y, rgb.z)]))
        if k in LEAF_FRAMES or k == len(frames) - 1:
            out[f"{prefix}_f{k}"], out[f"{prefix}_i{k}"] = split_leaves(
                jax.tree_util.tree_leaves(js))
    out[f"{prefix}_rgb"] = np.stack(rgbs)
    return out


def assert_sequence_matches(frames, golden, prefix):
    """The port's run_svgf over the frames against tpt's stored outputs:
    history lengths and material ids exactly, the rest to atol 2e-5.
    Returns the port's last state leaves."""
    h, w = frames[0][3].shape
    st = svgf.SVGFState.zeros(h, w, "cpu")
    for k, (raw_d, raw_i, albedo, depth, nrm, matid, mu, mv) in \
            enumerate(frames):
        rgb, st = svgf.run_svgf(CFG, st, tv(raw_d), tv(raw_i), tv(albedo),
                                t1(depth), tv(nrm), t1(matid), t1(mu), t1(mv))
        got = np.stack([c.numpy() for c in (rgb.x, rgb.y, rgb.z)])
        np.testing.assert_allclose(got, golden[f"{prefix}_rgb"][k], atol=2e-5,
                                   rtol=0)
        if f"{prefix}_f{k}" in golden:
            f, i = split_leaves([x.numpy() for x in st.leaves()])
            np.testing.assert_allclose(f, golden[f"{prefix}_f{k}"], atol=2e-5,
                                       rtol=0)
            np.testing.assert_array_equal(i, golden[f"{prefix}_i{k}"])
    return [x.numpy() for x in st.leaves()]


def test_run_svgf_matches_tpt_over_frames(golden):
    frames = svgf_frames(7, 8)
    leaves = assert_sequence_matches(frames, golden, "seq")
    hist = leaves[12]
    # the EMA and the temporal variance (history >= 4) ran, and so did the
    # spatial fallback (a strip without history, and the changed patch)
    assert hist.max() >= 6 and (hist == 0).any() and ((hist > 0) & (hist < 4)).any()


def test_run_svgf_nonfinite_motion_matches_tpt(golden):
    """NaN and +-inf motion through run_svgf of both packages: the taps
    there get weight 0, so those pixels start their history anew."""
    leaves = assert_sequence_matches(svgf_frames(8, 3, nonfinite=True),
                                     golden, "nonfinite")
    hist = leaves[12]
    assert (hist[5, :3] == 0).all() and (hist[6, :4] == 0).all()


def test_wrappers_check_their_inputs():
    a = atrous_inputs(h=4, w=5)
    good = [tv(a["ill_d"]), t1(a["var_d"]), tv(a["ill_i"]), t1(a["var_i"]),
            t1(a["depth"]), tv(a["normal"])]
    with pytest.raises(ValueError):       # an int plane
        stencil.atrous(*good[:4], good[4].to(torch.int32), good[5], 1, 1.0,
                       128.0, 4.0)
    with pytest.raises(ValueError):       # a plane of another shape
        stencil.atrous(*good[:3], torch.zeros(4, 6), *good[4:], 1, 1.0,
                       128.0, 4.0)
    with pytest.raises(ValueError):       # not contiguous
        stencil.atrous(*good[:3], t1(a["var_i"]).t().contiguous().t(),
                       *good[4:], 1, 1.0, 128.0, 4.0)
    with pytest.raises(ValueError):
        stencil.atrous(*good, 0, 1.0, 128.0, 4.0)
    st = svgf.SVGFState.zeros(4, 5, "cpu")
    z = torch.zeros(4, 5)
    with pytest.raises(ValueError):       # matid must be int32
        reproject.reproject(st, z, z, good[5], z, z)
    assert stencil.LAUNCHES["atrous"] == 0 and reproject.LAUNCHES["reproject"] == 0


def tpt_references() -> dict:
    """tpt's outputs stored in GOLDEN: the interpret-mode Pallas kernels on
    the stored cases and run_svgf over both sequences."""
    out = {"atrous_pallas": np.stack(jax_atrous(atrous_inputs(seed=1), 2,
                                                pallas=True)),
           "reproject_field_pallas": jax_reproject(*tpt_field_case(),
                                                   pallas=True),
           "reproject_pan_pallas": jax_reproject(*pan_case((5.25, -3.5), 10),
                                                 pallas=True),
           "reproject_sheared_pallas_w": jax_reproject(*sheared_case(),
                                                       pallas=True)[-1],
           "reproject_far_pallas_w": jax_reproject(
               *pan_case((30.25, -2.0), 6), pallas=True)[-1]}
    out.update(jax_sequence(svgf_frames(7, 8), "seq"))
    out.update(jax_sequence(svgf_frames(8, 3, nonfinite=True), "nonfinite"))
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_svgf.py
    np.savez_compressed(GOLDEN, **tpt_references())
