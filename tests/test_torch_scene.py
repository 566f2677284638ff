"""tpt_torch's host layer against tpt's: the procedural host meshes, the
light CDF, the packed shading/material/light rows and the SAH +
wide-pack tables must be equal, bit for bit, for the same scene."""

import numpy as np
import pytest
import torch

from tpt.scene import procedural as jproc
from tpt_torch.scene import procedural as tproc
from tpt_torch.scene.convert import from_numpy_scene

from torch_port_helpers import np3, scene_leaves
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

SCENES = {
    "cornell": lambda mod: mod.cornell_box(resolution=(32, 32)),
    "fireplace_10k": lambda mod: mod.fireplace_like(num_triangles=10_000,
                                                    resolution=(32, 18)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    make = SCENES[request.param]
    jhost, thost = make(jproc), make(tproc)
    jdata = jhost.build(with_bvh=True, prep_cache=False)
    tdata = thost.build(with_bvh=True, device="cpu")
    return jhost, thost, jdata, tdata


def _eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_host_mesh_equal(pair):
    jhost, thost, _, _ = pair
    for f in ("positions", "normals", "uvs", "tangents", "indices",
              "material_ids"):
        np.testing.assert_array_equal(getattr(thost.mesh, f),
                                      getattr(jhost.mesh, f))
    assert thost.camera == type(thost.camera)(**vars(jhost.camera))


@pytest.mark.parametrize("field", ["shade_hit", "shade_tri", "shade_vtx",
                                   "i0", "material_ids"])
def test_mesh_tables_equal(pair, field):
    _, _, jdata, tdata = pair
    _eq(getattr(tdata.mesh, field), getattr(jdata.mesh, field))


def test_geometry_and_materials_equal(pair):
    _, _, jdata, tdata = pair
    np.testing.assert_array_equal(np3(tdata.mesh.positions),
                                  np3(jdata.mesh.positions))
    np.testing.assert_array_equal(np3(tdata.mesh.geom_normals),
                                  np3(jdata.mesh.geom_normals))
    _eq(tdata.materials.packed, jdata.materials.packed)
    _eq(tdata.materials.mtype, jdata.materials.mtype)


@pytest.mark.parametrize("field", ["tri_idx", "cdf", "areas", "total_area",
                                   "packed"])
def test_light_cdf_equal(pair, field):
    _, _, jdata, tdata = pair
    _eq(getattr(tdata.lights, field), getattr(jdata.lights, field))


@pytest.mark.parametrize("field", ["node_f32", "node_child", "tri_f32"])
def test_sah_wide_pack_equal(pair, field):
    _, _, jdata, tdata = pair
    _eq(getattr(tdata.pack, field), getattr(jdata.pack, field))
    for k in ("num_nodes", "num_triangles", "max_cluster", "arity"):
        assert getattr(tdata.pack, k) == getattr(jdata.pack, k)


def test_binary_pack_equal():
    """packet_arity=2 keeps the binary layout, equal to tpt's as well."""
    jd = jproc.cornell_box(resolution=(8, 8)).build(
        with_bvh=True, packet_arity=2, prep_cache=False)
    td = tproc.cornell_box(resolution=(8, 8)).build(
        with_bvh=True, packet_arity=2, device="cpu")
    for f in ("node_f32", "node_child", "tri_f32"):
        _eq(getattr(td.pack, f), getattr(jd.pack, f))


def test_from_numpy_scene_equals_own_build(pair):
    """The tables carried across from tpt's numpy leaves equal the port's
    own build, field for field."""
    _, _, jdata, tdata = pair
    conv = from_numpy_scene(**scene_leaves(jdata), device="cpu")
    for f in ("shade_hit", "i0", "i1", "i2", "material_ids", "uv_u"):
        _eq(getattr(conv.mesh, f), getattr(tdata.mesh, f))
    _eq(conv.materials.packed, tdata.materials.packed)
    _eq(conv.lights.packed, tdata.lights.packed)
    _eq(conv.lights.total_area, tdata.lights.total_area)
    for f in ("node_f32", "node_child", "tri_f32"):
        _eq(getattr(conv.pack, f), getattr(tdata.pack, f))


def test_cluster_codes_roundtrip():
    from tpt_torch.bvh.pack import decode_cluster, encode_cluster

    for start, count in ((0, 1), (5, 16), (138831, 255)):
        code = encode_cluster(start, count)
        assert code < -1
        assert decode_cluster(code) == (start, count)
