"""tpt_torch's scene-prep disk cache (`scene/prepcache.py`) behind
`HostScene.build(bvh_builder=..., prep_cache=True)`, as
tests/test_prepcache.py holds tpt's: the second build of the same mesh
and parameters is a disk hit equal bit for bit to the first, the key
moves with the parameters and the geometry, scenes under 10k triangles
skip the cache, a corrupt entry rebuilds, `bvh_builder="auto"` takes
cached SAH tables without the native library, and nothing is read from
tpt's cache or `benchmarks/prebuilt/` (pickled JAX pytrees): entries are
plain numpy arrays loaded with pickling off."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpt_torch.core.vec import Vec3
from tpt_torch.scene import native, prepcache, procedural

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

TRIS = 12_000


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TPT_TORCH_SCENE_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("TPT_NO_CACHE", raising=False)
    return tmp_path


@pytest.fixture(scope="module")
def host():
    return procedural.fireplace_like(num_triangles=TRIS, resolution=(16, 16))


def _leaves(data) -> list:
    out = []
    for obj in (data.bvh, data.pack, data.sweep):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, Vec3):
                v = v.stacked()
            out.append((f.name, v.numpy() if isinstance(v, torch.Tensor) else v))
    return out


def _assert_same_tables(a, b):
    for (na, va), (nb, vb) in zip(_leaves(a), _leaves(b), strict=True):
        assert na == nb
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, na
            np.testing.assert_array_equal(va, vb, err_msg=na)
        else:
            assert va == vb, na


def test_second_build_is_a_bit_identical_disk_hit(cache_env, host,
                                                  monkeypatch):
    cold = host.build(with_bvh=True, device="cpu")
    files = list(cache_env.glob("*.npz"))
    assert len(files) == 1, "one cache entry after a cold build"
    from tpt_torch.bvh import sah

    def boom(*a, **k):
        raise AssertionError("rebuilt instead of loading the entry")

    monkeypatch.setattr(sah, "build_sah_bvh", boom)
    warm = host.build(with_bvh=True, device="cpu")
    _assert_same_tables(cold, warm)
    assert warm.sweep.num_treelets == cold.sweep.num_treelets > 0


def test_entries_load_without_pickle(cache_env, host):
    host.build(with_bvh=True, bvh_builder="lbvh", device="cpu")
    (entry,) = cache_env.glob("*.npz")
    with np.load(entry, allow_pickle=False) as f:
        assert all(f[k].dtype != object for k in f.files)
        assert {"bvh.escape", "pack.node_f32", "sweep.tri_f32"} <= set(f.files)


def test_key_moves_with_params_and_geometry(host):
    k1 = prepcache.fingerprint(host.mesh, treelet_max_tris=256)
    assert k1 == prepcache.fingerprint(host.mesh, treelet_max_tris=256)
    assert k1 != prepcache.fingerprint(host.mesh, treelet_max_tris=128)
    assert k1 != prepcache.fingerprint(host.mesh, treelet_max_tris=256,
                                       builder="lbvh")
    moved = dataclasses.replace(host.mesh, positions=host.mesh.positions.copy())
    moved.positions[0, 0] += 1.0
    assert k1 != prepcache.fingerprint(moved, treelet_max_tris=256)


def test_builders_keep_their_own_entries(cache_env, host):
    sah = host.build(with_bvh=True, bvh_builder="sah", device="cpu")
    lbvh = host.build(with_bvh=True, bvh_builder="lbvh", device="cpu")
    assert len(list(cache_env.glob("*.npz"))) == 2
    assert not torch.equal(sah.bvh.prim_index, lbvh.bvh.prim_index)


def test_small_scenes_skip_the_cache(cache_env):
    s = procedural.cornell_box(resolution=(16, 16), spheres=True)
    assert s.mesh.num_triangles < 10_000
    s.build(with_bvh=True, device="cpu")
    assert list(cache_env.glob("*.npz")) == []


def test_no_cache_opt_outs(cache_env, host, monkeypatch):
    host.build(with_bvh=True, prep_cache=False, device="cpu")
    assert list(cache_env.glob("*.npz")) == []
    monkeypatch.setenv("TPT_NO_CACHE", "1")
    host.build(with_bvh=True, device="cpu")
    assert list(cache_env.glob("*.npz")) == []


def test_corrupt_entry_falls_back_to_build(cache_env, host):
    cold = host.build(with_bvh=True, device="cpu")
    (entry,) = cache_env.glob("*.npz")
    entry.write_bytes(b"not an npz")
    again = host.build(with_bvh=True, device="cpu")
    _assert_same_tables(cold, again)
    with np.load(entry, allow_pickle=False) as f:   # rewritten whole
        assert "pack.tri_f32" in f.files


def test_auto_builder_takes_cached_sah_without_native(cache_env, host,
                                                      monkeypatch):
    """bvh_builder='auto' where the native library does not load uses the
    cached SAH tables (loading needs no C++) before a cold LBVH build."""
    sah = host.build(with_bvh=True, device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    from tpt_torch.bvh import build as lbvh_mod

    def boom(*a, **k):
        raise AssertionError("took the cold LBVH build path")

    monkeypatch.setattr(lbvh_mod, "build_lbvh", boom)
    again = host.build(with_bvh=True, device="cpu")
    _assert_same_tables(sah, again)


def test_auto_builder_falls_back_to_lbvh(cache_env, host, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    data = host.build(with_bvh=True, prep_cache=False, device="cpu")
    want = host.build(with_bvh=True, bvh_builder="lbvh", prep_cache=False,
                      device="cpu")
    assert torch.equal(data.bvh.prim_index, want.bvh.prim_index)


def test_bad_builder_name_raises(host):
    with pytest.raises(ValueError, match="bvh_builder"):
        host.build(with_bvh=True, bvh_builder="octree", device="cpu")


def test_tpt_and_prebuilt_tables_are_never_read(cache_env, host,
                                                tmp_path_factory,
                                                monkeypatch):
    """An entry under the same key in tpt's cache directory or in a
    prebuilt directory is not consulted: the port builds its own."""
    key = prepcache.fingerprint(host.mesh, builder="sah", max_cluster=16,
                                packet_arity=4, treelet_max_tris=256,
                                sweep_chunk_align=4)
    other = tmp_path_factory.mktemp("foreign")
    for name in (key + ".pkl", key + ".npz"):
        (other / name).write_bytes(b"foreign tables")
    monkeypatch.setenv("TPT_SCENE_CACHE_DIR", str(other))
    monkeypatch.setenv("TPT_PREBUILT_DIR", str(other))
    opened = []
    real_load = np.load

    def spy(path, *a, **k):
        opened.append(os.fspath(path))
        return real_load(path, *a, **k)

    monkeypatch.setattr(np, "load", spy)
    data = host.build(with_bvh=True, device="cpu")
    assert data.pack is not None
    assert opened and all(p.startswith(str(cache_env)) for p in opened)
    assert (cache_env / (key + ".npz")).exists()
