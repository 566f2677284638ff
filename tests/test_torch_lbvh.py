"""tpt_torch's LBVH builder (`bvh/build.py`) and validator
(`bvh/validate.py`) against tpt's, on the same host meshes.

- `build_lbvh` equals tpt's `build_lbvh` bit for bit (every int array,
  the boxes as float32 bit patterns) on the meshes of tests/test_bvh.py
  (a UV sphere, 30 random spheres, the two tiny spheres), on meshes of
  1, 2 and 3 triangles (one triangle gets a duplicated leaf), on a mesh
  whose centroids all coincide (every morton code equal, so the slots'
  own bits decide the tree), and with fewer refit sweeps than the tree
  has levels (the refit and the escape links stop after exactly
  `refit_iters` sweeps, converged or not).
- `validate_lbvh` gives tpt's report on the same tree, and flags the
  same broken trees.
- `morton3d` and the clz stand-in equal tpt's `morton3d` and
  `jax.lax.clz` on edge values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.bvh.build import build_lbvh as jbuild
from tpt.bvh.build import morton3d as jmorton
from tpt.bvh.validate import validate_lbvh as jvalidate
from tpt.scene import procedural as jproc
from tpt.scene.mesh import HostMesh as JHostMesh
from tpt.scene.mesh import finalize_mesh as jfinalize
from tpt.scene.mesh import merge_meshes as jmerge
from tpt_torch.bvh.build import build_lbvh, clz32, morton3d
from tpt_torch.bvh.validate import validate_lbvh
from tpt_torch.scene.convert import from_numpy_scene
from tpt_torch.scene.mesh import HostMesh, finalize_mesh

from torch_port_helpers import np3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

INT_FIELDS = ("left", "right", "parent", "escape", "prim_index")


def _same_report(a, b) -> bool:
    return vars(a) == vars(b)


def _port_mesh(m: JHostMesh) -> HostMesh:
    return HostMesh(*(np.array(getattr(m, f)) for f in (
        "positions", "normals", "uvs", "tangents", "indices", "material_ids")))


def _soup(corners: np.ndarray) -> JHostMesh:
    """A triangle soup from [T, 3, 3] corners."""
    t = corners.shape[0]
    pos = corners.reshape(-1, 3).astype(np.float32)
    n = np.tile(np.float32([0, 0, 1]), (3 * t, 1))
    return JHostMesh(pos, n, np.zeros((3 * t, 2), np.float32),
                     np.tile(np.float32([1, 0, 0]), (3 * t, 1)),
                     np.arange(3 * t, dtype=np.int32).reshape(t, 3),
                     np.zeros(t, np.int32))


def _spheres():
    rs = np.random.default_rng(3)
    parts = []
    for _ in range(30):
        c = rs.uniform(-5, 5, 3)
        parts.append(jproc.make_uv_sphere(tuple(c), rs.uniform(0.2, 0.8), 0,
                                          n_theta=6, n_phi=8))
    return jmerge(parts)


def _meshes():
    rs = np.random.default_rng(7)
    tri = lambda t: rs.uniform(-2, 2, (t, 3, 3)).astype(np.float32)
    # every box centre at the origin: integer corners shifted by their
    # box centre (half-integers, exact in float32)
    ints = rs.integers(-8, 9, (10, 3, 3)).astype(np.float32)
    same = ints - (ints.min(axis=1) + ints.max(axis=1))[:, None] * 0.5
    return {
        "sphere": jproc.make_uv_sphere((0, 0, 0), 1.0, 0, n_theta=16, n_phi=32),
        "clutter": _spheres(),
        "tiny2": jproc.make_uv_sphere((0, 0, 0), 1, 0, n_theta=2, n_phi=3),
        "tiny3": jproc.make_uv_sphere((0, 0, 0), 1, 0, n_theta=3, n_phi=3),
        "t1": _soup(tri(1)), "t2": _soup(tri(2)), "t3": _soup(tri(3)),
        "coincident": _soup(same),
    }


MESHES = _meshes()


def _host(bvh) -> dict:
    """Either package's LBVH as numpy: int arrays and [N, 3] boxes."""
    if isinstance(bvh.left, torch.Tensor):
        return bvh.numpy()
    out = {f: np.asarray(getattr(bvh, f)) for f in INT_FIELDS}
    out.update(aabb_min=np3(bvh.aabb_min), aabb_max=np3(bvh.aabb_max),
               num_triangles=bvh.num_triangles)
    return out


def _assert_bit_equal(got: dict, want: dict):
    assert got["num_triangles"] == want["num_triangles"]
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert got[f].dtype == np.int32
    for f in ("aabb_min", "aabb_max"):
        np.testing.assert_array_equal(got[f].view(np.uint32),
                                      want[f].view(np.uint32), err_msg=f)


@pytest.fixture(scope="module")
def built():
    """Both packages' LBVHs of every mesh, by name (and the sphere's with
    4 refit sweeps)."""
    out = {}
    for name, m in MESHES.items():
        jb = jbuild(jfinalize(m))
        tb = build_lbvh(finalize_mesh(_port_mesh(m), device="cpu"))
        out[name] = (jb, tb)
    m = MESHES["sphere"]
    out["sphere_refit4"] = (
        jbuild(jfinalize(m), refit_iters=4),
        build_lbvh(finalize_mesh(_port_mesh(m), device="cpu"), refit_iters=4))
    return out


@pytest.mark.parametrize("name", list(MESHES) + ["sphere_refit4"])
def test_build_lbvh_equals_tpt(built, name):
    jb, tb = built[name]
    _assert_bit_equal(_host(tb), _host(jb))


def test_coincident_centroids_share_one_code():
    """The coincident mesh really puts every triangle on one morton code,
    so its tree comes from the slots' bits alone."""
    m = MESHES["coincident"]
    c = m.positions.reshape(-1, 3, 3)
    assert not (c.min(axis=1) + c.max(axis=1)).any()
    assert len({tuple(t.ravel()) for t in c}) == c.shape[0]


def test_short_refit_is_not_converged(built):
    """4 sweeps leave the sphere's upper boxes unrefit (the tree is deeper
    than 4), in both packages alike, and the validator says so."""
    jb, tb = built["sphere_refit4"]
    rep = validate_lbvh(tb)
    assert rep.max_depth > 4 and not rep.ok
    assert _same_report(rep, jvalidate(jb))


@pytest.mark.parametrize("name", list(MESHES))
def test_validate_equals_tpt(built, name):
    jb, tb = built[name]
    rep = validate_lbvh(tb)
    assert rep.ok, rep.errors
    assert _same_report(rep, jvalidate(jb))


def test_validate_flags_broken_trees(built):
    """A cycle, a leaf naming its neighbour's triangle and a shrunk box,
    reported as tpt reports them (the tree carried across through
    from_numpy_scene)."""
    jb, _ = built["clutter"]
    base = _host(jb)
    n = base["num_triangles"]
    cases = []
    cyc = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in base.items()}
    cyc["left"][1] = 0
    cases.append(cyc)
    dup = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in base.items()}
    dup["prim_index"][n - 1] = dup["prim_index"][n]
    cases.append(dup)
    box = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in base.items()}
    box["aabb_max"][0] -= 1.0
    cases.append(box)
    from tpt.scene.structs import LBVHData as JLBVH
    from tpt.core.vec import Vec3 as JVec3

    for case in cases:
        tb = _carried(case)
        jcase = JLBVH(
            aabb_min=JVec3.from_stacked(jnp.asarray(case["aabb_min"])),
            aabb_max=JVec3.from_stacked(jnp.asarray(case["aabb_max"])),
            **{f: jnp.asarray(case[f]) for f in INT_FIELDS},
            num_triangles=n)
        rep = validate_lbvh(tb)
        assert not rep.ok
        assert _same_report(rep, jvalidate(jcase))


def _carried(bvh: dict):
    """An LBVH carried into the port by from_numpy_scene."""
    scene = jproc.cornell_box(resolution=(4, 4), spheres=False).build(
        prep_cache=False)
    from torch_port_helpers import scene_leaves

    leaves = scene_leaves(scene)
    leaves["bvh"] = bvh
    return from_numpy_scene(**leaves, device="cpu").bvh


def test_morton_edges_equal_tpt():
    v = np.float32([0.0, 1e-7, 0.5, 0.999, 1.0, 1.5, -0.25, 1023 / 1024,
                    1 / 1024, np.nextafter(np.float32(1 / 1024), 0)])
    x, y, z = np.meshgrid(v, v, v, indexing="ij")
    x, y, z = (a.ravel() for a in (x, y, z))
    want = np.asarray(jmorton(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    got = morton3d(*(torch.from_numpy(a) for a in (x, y, z))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert got.max() == (1 << 30) - 1 and got.min() == 0


def test_clz_equals_lax_clz():
    vals = [0, 1, 2, 3, 0xFFFF, 0x10000, (1 << 24) - 1, 1 << 24,
            (1 << 30) - 1, 1 << 30, (1 << 31) - 1, -1, -(1 << 31), 12345]
    vals += [1 << k for k in range(31)] + [(1 << k) - 1 for k in range(1, 32)]
    a = np.array(vals, np.int64).astype(np.int32)
    want = np.asarray(jax.lax.clz(jnp.asarray(a)))
    got = clz32(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(clz32(torch.tensor([0]))[0]) == 32
    assert int(clz32(torch.tensor([1]))[0]) == 31
    assert int(clz32(torch.tensor([1 << 30]))[0]) == 1
