"""tpt_torch's shading stages against tpt's, lane by lane: BSDF sample /
eval / pdf, light sampling, the hit-surface fetch, and one wavefront
bounce fed the same carry in both packages.

Tolerances: RNG states, masks and integer outputs are exact. Floats get
rtol 1e-4 / atol 1e-5 (1e-3 on the MIS-weighted radiance sums): XLA and
PyTorch evaluate sin, cos, sqrt and rsqrt with different last-bit
rounding, and XLA may contract multiply-adds, so float32 results differ
by a few ulp and grow through the GGX terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.config import RayCastBackend as JBackend, RenderConfig as JConfig
from tpt.integrators import common as jcommon, wavefront as jwave
from tpt.materials import bsdf as jbsdf
from tpt.scene import lights as jlights, procedural as jproc
from tpt.core.vec import Vec3 as JVec3
from tpt_torch.config import RayCastBackend as TBackend, RenderConfig as TConfig
from tpt_torch.integrators import common as tcommon, wavefront as twave
from tpt_torch.materials import bsdf as tbsdf
from tpt_torch.scene import lights as tlights, procedural as tproc
from tpt_torch.core.vec import Vec3 as TVec3

from torch_port_helpers import np3, to_jax3, to_torch3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
N = 4096


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, TVec3):
        got, want = np3(got), np3(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _exact(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype))


@pytest.fixture(scope="module")
def lanes():
    """Random shading lanes covering all four material classes."""
    rs = np.random.default_rng(21)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    n = unit(rs.normal(size=(N, 3)))
    wo = unit(rs.normal(size=(N, 3)))
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    wo[::5] = -wo[::5]                                  # some from inside
    wi = unit(rs.normal(size=(N, 3)))
    mat = dict(basecolor=rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32),
               metallic=rs.uniform(0, 1, N).astype(np.float32),
               roughness=rs.uniform(0.02, 1, N).astype(np.float32),
               emittance=np.zeros(N, np.float32),
               ior=rs.uniform(1.2, 1.8, N).astype(np.float32),
               mtype=np.arange(N, dtype=np.int32) % 4)
    state = rs.integers(1, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return n, wo, wi, mat, state


def _mats(mod, vec, arr, mat):
    neg = arr(np.full(N, -1, np.int32))
    return mod.MaterialLanes(
        basecolor=vec(mat["basecolor"]), metallic=arr(mat["metallic"]),
        roughness=arr(mat["roughness"]), emittance=arr(mat["emittance"]),
        ior=arr(mat["ior"]), mtype=arr(mat["mtype"]), tex_diffuse=neg,
        tex_metallic_roughness=neg, tex_normal=neg)


def _both(lanes):
    n, wo, wi, mat, state = lanes
    jm = _mats(jbsdf, to_jax3, jnp.asarray, mat)
    tm = _mats(tbsdf, to_torch3, torch.from_numpy, mat)
    return ((to_jax3(n), to_jax3(wo), to_jax3(wi), jm, jnp.asarray(state)),
            (to_torch3(n), to_torch3(wo), to_torch3(wi), tm,
             torch.from_numpy(state.astype(np.int64))))


def test_sample_bsdf_lane_by_lane(lanes):
    (jn, jwo, _, jm, js), (tn, two, _, tm, ts) = _both(lanes)
    js2, jsmp = jbsdf.sample_bsdf(jwo, jn, jm, js)
    ts2, tsmp = tbsdf.sample_bsdf(two, tn, tm, ts)
    _exact(ts2, np.asarray(js2).astype(np.int64))   # three uniforms each
    _exact(tsmp.is_transmission, jsmp.is_transmission)
    _close(tsmp.wi, jsmp.wi, atol=1e-5)
    # GGX half-vector sampling divides by 1 + (a^2 - 1) * u2, which cancels
    # for small roughness a as u2 -> 1: a last-bit difference there moves
    # the sampled pdf by up to ~2e-3 relative (measured: 24 of 4096 lanes
    # beyond 1e-4, all PBR with roughness 0.09-0.25)
    _close(tsmp.pdf, jsmp.pdf, rtol=5e-3)
    _close(tsmp.attenuation, jsmp.attenuation, rtol=5e-3)


@pytest.mark.parametrize("fn", ["eval_bsdf", "pdf_bsdf"])
def test_eval_pdf_lane_by_lane(lanes, fn):
    (jn, jwo, jwi, jm, _), (tn, two, twi, tm, _) = _both(lanes)
    _close(getattr(tbsdf, fn)(two, twi, tn, tm), getattr(jbsdf, fn)(jwo, jwi, jn, jm))


@pytest.fixture(scope="module")
def cornell_pair():
    jdata = jproc.cornell_box(resolution=(24, 24)).build(with_bvh=True,
                                                         prep_cache=False)
    thost = tproc.cornell_box(resolution=(24, 24))
    tdata = thost.build(with_bvh=True, device="cpu")
    return jdata, tdata, thost.camera


def test_sample_light(cornell_pair, lanes):
    jdata, tdata, _ = cornell_pair
    state = lanes[4]
    jout = jlights.sample_light(jdata.mesh, jdata.lights, jnp.asarray(state))
    tout = tlights.sample_light(tdata.mesh, tdata.lights,
                                torch.from_numpy(state.astype(np.int64)))
    _exact(tout[0], np.asarray(jout[0]).astype(np.int64))
    _exact(tout[4], jout[4])                         # light triangle
    for a, b in zip(tout[1:4] + (tout[5],), jout[1:4] + (jout[5],)):
        _close(a, b)


def test_fetch_hit_surface(cornell_pair, lanes):
    jdata, tdata, _ = cornell_pair
    rs = np.random.default_rng(2)
    tri = rs.integers(-1, tdata.mesh.num_triangles, N).astype(np.int32)
    u = rs.uniform(0, 0.5, N).astype(np.float32)
    v = rs.uniform(0, 0.5, N).astype(np.float32)
    wo = lanes[1]
    jout = jcommon.fetch_hit_surface(jdata, jnp.asarray(tri), jnp.asarray(u),
                                     jnp.asarray(v), to_jax3(wo))
    tout = tcommon.fetch_hit_surface(tdata, torch.from_numpy(tri),
                                     torch.from_numpy(u), torch.from_numpy(v),
                                     to_torch3(wo))
    jm, tm = jout[0], tout[0]
    _exact(tm.mtype, jm.mtype)
    _exact(tout[4], jout[4])                         # material id
    _close(tm.basecolor, jm.basecolor, rtol=0, atol=0)
    for i in (1, 2, 3, 5, 6):                        # normals, uv
        _close(tout[i], jout[i])
    _close(tcommon.oriented_geom_normal(tdata.mesh, torch.from_numpy(tri),
                                        to_torch3(wo)),
           jcommon.oriented_geom_normal(jdata.mesh, jnp.asarray(tri),
                                        to_jax3(wo)), rtol=0, atol=0)


def _carry_to_torch(jc):
    (ori, d, thr, lpdf, state, alive, direct, indirect, pix, gbuf, rays) = jc
    t3 = lambda v: to_torch3(np3(v))
    tt = lambda a: torch.from_numpy(np.array(a))
    tg = twave.GBuffers(depth=tt(gbuf.depth), normal=t3(gbuf.normal),
                        mat_id=tt(gbuf.mat_id), albedo=t3(gbuf.albedo),
                        motion_u=tt(gbuf.motion_u), motion_v=tt(gbuf.motion_v))
    return (t3(ori), t3(d), t3(thr), tt(lpdf),
            torch.from_numpy(np.asarray(state).astype(np.int64)), tt(alive),
            t3(direct), t3(indirect), tt(pix).to(torch.int64), tg,
            torch.tensor(int(rays)))


def _compare_carry(tc, jc, order):
    """Carry elements equal, lanes matched through `order` (the port's
    lanes sorted by pixel when its pool was re-sorted)."""
    names = ("ori", "direction", "throughput", "last_pdf", "state", "alive",
             "direct", "indirect", "pixel_idx")
    for name, a, b in zip(names, tc[:9], jc[:9]):
        a = a[order] if not isinstance(a, TVec3) else TVec3(a.x[order], a.y[order], a.z[order])
        if name in ("state", "alive", "pixel_idx"):
            want = np.asarray(b)
            _exact(a, want.astype(np.int64) if name != "alive" else want)
        elif name in ("direct", "indirect"):
            _close(a, b, rtol=1e-3, atol=1e-4)
        else:
            _close(a, b, rtol=RTOL, atol=1e-3 if name == "ori" else ATOL)
    _exact(tc[10], int(jc[10]))
    _close(tc[9].depth, jc[9].depth)
    _exact(tc[9].mat_id, jc[9].mat_id)


@pytest.mark.parametrize("backend", ["BRUTE_FORCE", "BVH_PALLAS"])
def test_bounce_body_same_carry(cornell_pair, backend):
    """Bounce 0 from the same camera carry, then bounce 1 fed tpt's own
    bounce-0 carry: the port's bounce (brute force, or the plain wide
    kernels with the coherence sort) equals tpt's brute-force bounce."""
    jdata, tdata, cam = cornell_pair
    jcfg = JConfig(backend=JBackend.BRUTE_FORCE, trace_depth=2)
    tcfg = TConfig(backend=getattr(TBackend, backend), trace_depth=2)
    jrc = jcommon.make_raycaster(jdata, jcfg)
    trc = tcommon.make_raycaster(tdata, tcfg)
    jcam = type(jproc.cornell_box(resolution=(24, 24)).camera)(**vars(cam))
    vp = twave.camera_view_proj(cam)
    jvp = jnp.asarray(vp)
    jc = jwave.batched_raygen(jcam, jcfg, jnp.uint32(3))
    for depth in range(2):
        tc = _carry_to_torch(jc)
        jc = jwave._bounce_body(jdata, jrc, jcam, jcfg, jvp, jvp, depth, jc)
        tc = twave._bounce_body(tdata, trc, cam, tcfg, vp, vp, depth, tc)
        order = torch.argsort(tc[8])
        _compare_carry(tc, jc, order)
    assert int(trc.capped) == 0


@pytest.mark.parametrize("mode", ["dir_major", "cell_major"])
def test_coherence_key_bit_exact(cornell_pair, lanes, mode):
    from tpt.integrators import raysort as jsort
    from tpt_torch.integrators import raysort as tsort

    jdata, tdata, _ = cornell_pair
    rs = np.random.default_rng(4)
    ori = rs.uniform(-10, 570, (N, 3)).astype(np.float32)
    d = lanes[1]
    jlo, jinv = jsort.world_bounds(jdata.mesh)
    tlo, tinv = tsort.world_bounds(tdata.mesh)
    _close(TVec3(*(t.reshape(1) for t in (tinv.x, tinv.y, tinv.z))),
           JVec3(*(j.reshape(1) for j in (jinv.x, jinv.y, jinv.z))), rtol=0, atol=0)
    want = jsort.coherence_key(to_jax3(ori), to_jax3(d), jlo, jinv, mode=mode)
    got = tsort.coherence_key(to_torch3(ori), to_torch3(d), tlo, tinv, mode=mode)
    _exact(got, np.asarray(want).astype(np.int64))


def test_sort_permutation_inverts():
    from tpt_torch.integrators import raysort as tsort

    key = torch.from_numpy(np.random.default_rng(1).integers(0, 50, 999))
    perm, inv = tsort.sort_permutation(key)
    assert bool((key[perm][1:] >= key[perm][:-1]).all())
    assert torch.equal(perm[inv], torch.arange(999))
    v = TVec3(key.float(), key.float() + 1, key.float() + 2)
    assert torch.equal(tsort.gather_vec3(v, perm).x, key[perm].float())


def test_interpolate_surface(cornell_pair):
    jdata, tdata, _ = cornell_pair
    rs = np.random.default_rng(8)
    tri = rs.integers(0, tdata.mesh.num_triangles, N).astype(np.int32)
    u = rs.uniform(0, 0.5, N).astype(np.float32)
    v = rs.uniform(0, 0.5, N).astype(np.float32)
    jout = jcommon.interpolate_surface(jdata.mesh, jnp.asarray(tri),
                                       jnp.asarray(u), jnp.asarray(v))
    tout = tcommon.interpolate_surface(tdata.mesh, torch.from_numpy(tri),
                                       torch.from_numpy(u), torch.from_numpy(v))
    for a, b in zip(tout, jout):
        _close(a, b)


def test_russian_roulette(lanes):
    state = lanes[4]
    thr = np.random.default_rng(6).uniform(0, 1.2, (N, 3)).astype(np.float32)
    alive = np.arange(N) % 3 != 0
    jcfg = JConfig(russian_roulette=True, rr_start_bounce=2)
    tcfg = TConfig(russian_roulette=True, rr_start_bounce=2)
    for depth in (1, 3):
        jt, ja, js = jcommon.apply_russian_roulette(
            jcfg, depth, to_jax3(thr), jnp.asarray(alive), jnp.asarray(state))
        tt, ta, ts = tcommon.apply_russian_roulette(
            tcfg, depth, to_torch3(thr), torch.from_numpy(alive),
            torch.from_numpy(state.astype(np.int64)))
        _exact(ta, ja)
        _exact(ts, np.asarray(js).astype(np.int64))
        _close(tt, jt)
