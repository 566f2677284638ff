"""The port's scene loading (`tpt_torch.scene.loader`, `obj`, `mesh`,
`native`) and the new procedural scenes against tpt's, all exact: host
meshes (positions, normals, uvs, tangents, indices, material ids),
materials, atlas texels and placements, environment planes and alias
tables, cameras, and the device tables `HostScene.build` makes from
them."""

import os

import numpy as np
import pytest
import torch

from tpt.scene import loader as jloader
from tpt.scene import mesh as jmesh
from tpt.scene import obj as jobj
from tpt.scene import procedural as jproc
from tpt_torch.scene import hero_assets
from tpt_torch.scene import loader as tloader
from tpt_torch.scene import mesh as tmesh
from tpt_torch.scene import obj as tobj
from tpt_torch.scene import procedural as tproc

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_FIELDS = ("positions", "normals", "uvs", "tangents", "indices",
               "material_ids")
MAT_FIELDS = ("name", "basecolor", "metallic", "roughness", "emittance", "ior",
              "mtype", "tex_diffuse", "tex_metallic_roughness", "tex_normal")


def _same_mesh(t, j):
    for f in MESH_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _same_materials(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        for f in MAT_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (int(x) == int(y)) if f == "mtype" else x == y, (a.name, f)


def _same_camera(t, j):
    for f in ("resolution", "position", "look_at", "up", "fovy_deg"):
        np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.fixture(scope="module")
def hero_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hero")
    hero_assets.write_hero_assets(str(d))
    return d


@pytest.fixture(scope="module")
def hero(hero_dir):
    path = str(hero_dir / "hero.json")
    return tloader.load_scene(path), jloader.load_scene(path)


def test_load_hero_matches_tpt(hero):
    t, j = hero
    _same_mesh(t.mesh, j.mesh)
    _same_materials(t.materials, j.materials)
    _same_camera(t.camera, j.camera)
    assert (t.iterations, t.trace_depth, t.image_name) == \
        (j.iterations, j.trace_depth, j.image_name)
    assert t.mesh.num_triangles == 6630
    # the floor, wall and metal sphere carry the four textures
    assert sorted(t.atlas.paths.values()) == [0, 1, 2, 3]
    assert t.atlas.paths == j.atlas.paths
    assert np.any(t.mesh.tangents)


def test_hero_atlas_and_env_match_tpt(hero):
    t, j = hero
    ta, ja = t.atlas.build(device="cpu"), j.atlas.build()
    for f in ("r", "g", "b", "a", "x0", "y0", "width", "height"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    te, je = t.env_map, j.env_map
    assert te.r.device.type == "cpu" and te.enabled and je.enabled
    for f in ("r", "g", "b", "pdf", "alias", "prob"):
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.asarray(getattr(je, f)), err_msg=f)


def test_hero_build_carries_textures_and_env(hero):
    """HostScene.build uploads the atlas and env map and sets the texture
    gates; its material and hit rows equal tpt's build."""
    t, j = hero
    td = t.build(device="cpu")
    jd = j.build(prep_cache=False)
    assert td.env.enabled and td.atlas.num_textures == 4
    assert (td.materials.any_tex_diffuse, td.materials.any_tex_mr,
            td.materials.any_tex_normal) == (
        jd.materials.any_tex_diffuse, jd.materials.any_tex_mr,
        jd.materials.any_tex_normal) == (True, True, True)
    np.testing.assert_array_equal(td.materials.packed.numpy(),
                                  np.asarray(jd.materials.packed))
    np.testing.assert_array_equal(td.mesh.shade_hit.numpy(),
                                  np.asarray(jd.mesh.shade_hit))
    np.testing.assert_array_equal(td.lights.packed.numpy(),
                                  np.asarray(jd.lights.packed))
    np.testing.assert_array_equal(td.env.alias.numpy(), np.asarray(jd.env.alias))


def test_load_cornell_matches_tpt():
    path = os.path.join(REPO, "scenes", "cornell.json")
    t, j = tloader.load_scene(path), jloader.load_scene(path)
    _same_mesh(t.mesh, j.mesh)
    _same_materials(t.materials, j.materials)
    _same_camera(t.camera, j.camera)
    assert t.env_map is None and j.env_map is None and not t.atlas.images
    assert tloader.peek_resolution(path) == jloader.peek_resolution(path) \
        == (800, 800)


def test_obj_parsers_agree(hero_dir):
    """The port's native and Python OBJ paths each give tpt's mesh on the
    same path (vertex order of the dedup included: the native parser
    numbers vertices by first use, the Python one by np.unique's order),
    with a TRS and with a material override."""
    from tpt.core.mathutil import build_trs_matrix as jtrs
    from tpt_torch.core.mathutil import build_trs_matrix as ttrs

    obj = str(hero_dir / "hero_studio.obj")
    args = ([1.0, -2.0, 0.5], [10.0, 35.0, -20.0], [1.5, 0.5, 2.0])
    trs = ttrs(*args)
    np.testing.assert_array_equal(trs, jtrs(*args))
    for kw in (dict(trs=trs), dict(material_override=2)):
        for native in (True, False):
            jscene, tscene = jloader.HostScene(), tloader.HostScene()
            jm = jobj.load_obj(obj, jscene, use_native=native, **kw)
            tm = tobj.load_obj(obj, tscene, use_native=native, **kw)
            _same_mesh(tm, jm)
            _same_materials(tscene.materials, jscene.materials)
            assert tscene.atlas.paths == jscene.atlas.paths


def test_obj_polygons_negative_indices_and_missing_normals(tmp_path):
    """A quad and a pentagon (fan triangulation), negative indices, faces
    without normals or uvs, an unknown usemtl and a missing mtllib."""
    path = tmp_path / "poly.obj"
    path.write_text(
        "mtllib nowhere.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0.2\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
        "usemtl nothing\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "f -5 -4 -3 -1 -2\n"
        "f 1//1 3//1 5//1\n")
    for native in (True, False):
        jm = jobj.load_obj(str(path), jloader.HostScene(), use_native=native)
        tm = tobj.load_obj(str(path), tloader.HostScene(), use_native=native)
        _same_mesh(tm, jm)
        assert tm.num_triangles == 6


def test_mtl_to_pbr_matches_tpt(tmp_path):
    path = tmp_path / "m.mtl"
    path.write_text(
        "newmtl lamp\nKe 3 2 1\n"
        "newmtl glass\nKd 0.01 0.01 0.01\nNi 1.45\nd 0.3\n"
        "newmtl mirror\nKs 1 1 1\nNs 100000\n"
        "newmtl plastic\nKd 0.2 0.4 0.6\nNs 300\nKs 0.04 0.04 0.04\n"
        "newmtl chalk\nKd 0.9 0.9 0.9\n"
        "newmtl tex\nmap_Kd a.png\nTr 0.25\nillum 2\nmap_Pr b.png\n")
    tm, jm = tobj.parse_mtl(str(path)), jobj.parse_mtl(str(path))
    assert list(tm) == list(jm)
    for name in tm:
        assert vars(tm[name]) == vars(jm[name])
        _same_materials([tobj.mtl_to_pbr(tm[name])],
                        [jobj.mtl_to_pbr(jm[name])])


def test_mesh_helpers_match_tpt():
    """apply_transform, compute_tangents and dedup_vertices on random
    meshes with repeated vertices, degenerate uvs and no uvs."""
    rs = np.random.default_rng(21)
    pos = rs.normal(size=(300, 3)).astype(np.float32)
    nrm = rs.normal(size=(300, 3)).astype(np.float32)
    uv = rs.uniform(size=(300, 2)).astype(np.float32)
    pos[100:150], nrm[100:150], uv[100:150] = pos[:50], nrm[:50], uv[:50]
    uv[200:210] = uv[200]
    idx = rs.integers(0, 300, (400, 3)).astype(np.int32)
    trs = np.asarray(rs.normal(size=(4, 4)), np.float32)
    for a, b in zip(tmesh.apply_transform(pos, nrm, trs),
                    jmesh.apply_transform(pos, nrm, trs)):
        np.testing.assert_array_equal(a, b)
    for u in (uv, np.zeros_like(uv)):
        np.testing.assert_array_equal(
            tmesh.compute_tangents(pos, nrm, u, idx),
            jmesh.compute_tangents(pos, nrm, u, idx))
    for a, b in zip(tmesh.dedup_vertices(pos, nrm, uv, idx),
                    jmesh.dedup_vertices(pos, nrm, uv, idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_missing_object_raises(tmp_path):
    doc = tmp_path / "s.json"
    doc.write_text('{"Camera": {"RES": [8, 8], "FOVY": 40, "EYE": [0,0,0],'
                   ' "LOOKAT": [0,0,1], "UP": [0,1,0]},'
                   ' "Objects": [{"FILE": "gone.obj"}]}')
    with pytest.raises(FileNotFoundError, match="gone.obj"):
        tloader.load_scene(str(doc))
    empty = tloader.load_scene(str(doc), load_meshes=False)
    assert [m.name for m in empty.materials] == ["default"]


def test_stress_interior_matches_tpt():
    t = tproc.stress_interior(num_triangles=3000, resolution=(64, 36))
    j = jproc.stress_interior(num_triangles=3000, resolution=(64, 36))
    _same_mesh(t.mesh, j.mesh)
    _same_materials(t.materials, j.materials)
    _same_camera(t.camera, j.camera)
    assert 2500 < t.mesh.num_triangles <= 3000


def test_veach_mis_matches_tpt():
    t = tproc.veach_mis(resolution=(128, 96))
    j = jproc.veach_mis(resolution=(128, 96))
    _same_mesh(t.mesh, j.mesh)
    _same_materials(t.materials, j.materials)
    _same_camera(t.camera, j.camera)
    assert (t.iterations, t.trace_depth) == (j.iterations, j.trace_depth)


def test_host_build_device_rule(hero, monkeypatch):
    t, _ = hero
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t.atlas.build()
    with pytest.raises(RuntimeError, match="CUDA"):
        t.build()
