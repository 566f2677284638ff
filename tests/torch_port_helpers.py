"""Shared helpers of the tests that hold tpt_torch against tpt: numpy
round trips between the two packages' Vec3s and scene leaves."""

import numpy as np
import pytest
import torch

from tpt.core.vec import Vec3 as JVec3
from tpt_torch.core.vec import Vec3 as TVec3


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads per test module: the suite runs test files in
    several worker processes at once, and PyTorch's default of one thread
    per core oversubscribes the machine (6 workers on 8 cores spent about
    4x the CPU time on the same tests)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def np3(v) -> np.ndarray:
    """Either package's Vec3 -> [N, 3] numpy."""
    comps = [v.x, v.y, v.z]
    if isinstance(v, TVec3):
        return np.stack([c.cpu().numpy() for c in comps], -1)
    return np.stack([np.asarray(c) for c in comps], -1)


def to_jax3(a: np.ndarray) -> JVec3:
    import jax.numpy as jnp

    return JVec3.from_stacked(jnp.asarray(np.asarray(a, np.float32)))


def to_torch3(a: np.ndarray) -> TVec3:
    return TVec3.from_stacked(torch.from_numpy(np.ascontiguousarray(a, np.float32)))


def scene_leaves(data) -> dict:
    """Numpy leaves of a tpt SceneData as from_numpy_scene keyword
    arguments (device left to the caller)."""
    m = data.mesh
    g = lambda a: None if a is None else np.asarray(a)
    mesh = dict(positions=np3(m.positions), normals=np3(m.normals),
                tangents=np3(m.tangents), uv_u=g(m.uv_u), uv_v=g(m.uv_v),
                i0=g(m.i0), i1=g(m.i1), i2=g(m.i2),
                material_ids=g(m.material_ids), geom_normals=np3(m.geom_normals),
                shade_tri=g(m.shade_tri), shade_vtx=g(m.shade_vtx),
                shade_hit=g(m.shade_hit))
    lt = data.lights
    lights = dict(tri_idx=g(lt.tri_idx), cdf=g(lt.cdf), areas=g(lt.areas),
                  total_area=g(lt.total_area), packed=g(lt.packed))
    pack = None
    if data.pack is not None:
        p = data.pack
        pack = dict(node_f32=g(p.node_f32), node_child=g(p.node_child),
                    tri_f32=g(p.tri_f32), num_nodes=p.num_nodes,
                    num_triangles=p.num_triangles, max_cluster=p.max_cluster,
                    arity=p.arity, top_f32=g(p.top_f32),
                    top_child=g(p.top_child), top_tref=g(p.top_tref),
                    top_tord=g(p.top_tord), num_top=p.num_top,
                    num_treelets=p.num_treelets, treelet_max=p.treelet_max)
    sweep = None
    sw = getattr(data, "sweep", None)
    if sw is not None:
        sweep = dict(tri_f32=g(sw.tri_f32), ranges=g(sw.ranges),
                     boxes=g(sw.boxes), group_boxes=g(sw.group_boxes),
                     num_treelets=sw.num_treelets, max_chunks=sw.max_chunks,
                     unroll=sw.unroll, chunk_align=sw.chunk_align)
    return dict(mesh=mesh, material_rows=g(data.materials.packed),
                lights=lights, pack=pack, sweep=sweep)


def random_rays(n, lo, hi, seed):
    """[n,3] origins uniform in the box and unit directions, float32."""
    rs = np.random.default_rng(seed)
    ori = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ori, d


def count_calls(monkeypatch, module, names) -> dict:
    """Wrap module.<name> for each name so that every call is counted;
    returns the counts (a name appears once it has been called)."""
    calls = {}
    for name in names:
        inner = getattr(module, name)

        def counted(*a, _inner=inner, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _inner(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls
