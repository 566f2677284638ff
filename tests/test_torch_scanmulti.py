"""The port's multi-slot top-tree scan K11 (`treelet_scan_multi`) against
tpt on the CPU, and against the port's own dense scan K3 and sweep cast.

On CPU tensors the wrapper runs its plain PyTorch version; the CUDA
kernel is held against it by tests/test_torch_gpu.py. tpt's K11 takes
about 6 s a call in interpret mode, so its outputs are stored in
tests/golden_sweepvar_tpt.npz (`python tests/test_torch_sweepvar.py`
regenerates it); their inputs are made here from fixed seeds. Both
packages get the same tables (tpt's, carried across) and the same numpy
rays. K11's three outputs are held exactly: its arithmetic is a slab
test (a difference, then a product) and min/max, which XLA does not
contract. Against K3 on the same rays, the slots are equal and K11's thr
lies at or below K3's (it also counts the subtrees its window prunes);
the sweep cast seeded by K11's slots gives K2's t exactly."""

import numpy as np
import pytest
import torch
from dataclasses import replace

import jax.numpy as jnp

from tpt.bvh import pallas_treelet as jpt
from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.bvh import sweep as ts
from tpt_torch.bvh import sweepcast as tsc
from tpt_torch.bvh import treelet_traverse as tlt
from tpt_torch.scene.convert import from_numpy_scene

from test_torch_treelet import _case_rays, _port_pack, tpt_packs
from torch_port_helpers import scene_leaves, to_jax3, to_torch3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)
from test_torch_sweepvar import GOLDEN, _fire, _pool

# pack key (a treelet cut of tests/test_treelet.py's cluttered scene, the
# single-treelet cut 10**9, or the 2000-triangle fireplace) -> (packet
# group, slots, ray seed); rays: 1024 * group + 300 (the last packet
# partial), every 5th lane dead
CASES = {
    48: (1, 4, 7),
    256: (2, 4, 8),
    10**9: (2, 2, 9),
    "fire": (2, 8, 10),
    64: (2, 1, 11),
}


def _rays(mesh, key, group, seed):
    return _case_rays(mesh, key, 1024 * group + 300, seed, 5)


def tpt_outputs() -> dict:
    """tpt's K11 on every case (interpret mode, ~6 s a call)."""
    out = {}
    packs = tpt_packs()
    for key, (group, S, seed) in CASES.items():
        mesh, p = packs[key]
        o, d, tm = _rays(mesh, key, group, seed)
        got = jpt.treelet_scan_multi(p, to_jax3(o), to_jax3(d),
                                     jnp.asarray(tm), slots=S, group=group)
        for name, a in zip(("st", "so", "thr"), got):
            out[f"k11_{key}_{name}"] = np.asarray(a)
    return out


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def packs():
    return {k: (mesh, p, _port_pack(p)) for k, (mesh, p) in tpt_packs().items()}


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", list(CASES))
def test_scan_multi_equals_tpt(packs, golden, key):
    """K11's slots (entry t, ordinal) and thr bit for bit, over 1024- and
    2048-lane packets with dead lanes, S from 1 to 8."""
    mesh, _, tp = packs[key]
    group, S, seed = CASES[key]
    o, d, tm = _rays(mesh, key, group, seed)
    s_t, s_o, thr, capped = tlt.treelet_scan_multi(
        tp, to_torch3(o), to_torch3(d), torch.from_numpy(tm), slots=S,
        group=group)
    assert int(capped) == 0
    for name, got in (("st", s_t), ("so", s_o), ("thr", thr)):
        _bits(got.numpy(), golden[f"k11_{key}_{name}"])
    dead = ~(tm > 0)
    assert (s_o.numpy()[:, dead] == ts.NONE_ORD).all()
    assert (thr.numpy()[dead] == 3.0e38).all()
    assert (s_o.numpy()[0, ~dead] != ts.NONE_ORD).mean() > 0.1


@pytest.fixture(scope="module")
def fire():
    host, jd = _fire(4)
    return host, jd, from_numpy_scene(**scene_leaves(jd), device="cpu")


def test_scan_multi_agrees_with_dense_scan(fire):
    """tests/test_sweep.py:371's check: the top-tree scan and the dense
    scan both keep the S lexicographically nearest candidates, so their
    slots agree; K11's thr is at or below K3's exact one."""
    host, jd, td = fire
    o, d, tm = (to_torch3(a) if a.ndim == 2 else torch.from_numpy(a)
                for a in _pool(host, jd))
    k11 = tlt.treelet_scan_multi(td.pack, o, d, tm)
    k3 = ts.dense_scan(td.sweep, o, d, tm)
    assert int(k11[3]) == 0
    assert torch.equal(k11[1], k3[1])
    assert torch.equal(k11[0], k3[0])
    assert bool((k11[2] <= k3[2]).all()) and bool((k11[2] < k3[2]).any())


def test_scan_multi_feeds_the_sweep_cast(fire):
    """K11's slots through the bin sort and sweep_cast_sorted give K2's t
    on every lane, and its triangles up to equal-t ties."""
    host, jd, td = fire
    o, d, tm = _pool(host, jd)
    tm = np.where(tm > 0, tm, -1.0).astype(np.float32)
    o, d, tm = to_torch3(o), to_torch3(d), torch.from_numpy(tm)
    s_t, s_o, thr, _ = tlt.treelet_scan_multi(td.pack, o, d, tm)
    key = tsc.bin_key(s_o, d, td.sweep.num_treelets, 4)
    perm = tsc.bin_sort_perm([torch.where(tm > 0, key, 1 << 30)])
    g = lambda a: a[..., perm].contiguous()
    o, d = type(o)(g(o.x), g(o.y), g(o.z)), type(d)(g(d.x), g(d.y), g(d.z))
    hit, capped = tsc.sweep_cast_sorted(td.pack, td.sweep, o, d, g(tm),
                                        g(s_o), g(s_t), g(thr))
    ref, capped2 = pt.packet_closest_hit_wide(td.pack, o, d, g(tm))
    assert int(capped) == 0 and int(capped2) == 0
    assert torch.equal(hit.t, ref.t)
    assert float((hit.tri != ref.tri).float().mean()) <= 1e-3


def test_scan_multi_dead_pool_and_cycle(fire):
    """A dead pool walks nothing; a top root that lists itself as its
    children fills the stack, and every live lane of its packets counts
    as capped (the walk still ends)."""
    host, jd, td = fire
    o, d, _ = _pool(host, jd)
    o, d = to_torch3(o), to_torch3(d)
    s_t, s_o, thr, capped = tlt.treelet_scan_multi(
        td.pack, o, d, torch.full((o.x.shape[0],), -1.0))
    assert bool((s_o == ts.NONE_ORD).all()) and bool((thr == 3.0e38).all())
    assert int(capped) == 0
    child = td.pack.top_child.clone()
    child[0, :td.pack.arity] = 0
    bad = replace(td.pack, top_child=child)
    tm = torch.full((o.x.shape[0],), 3.4e38)
    _, _, _, capped = tlt.treelet_scan_multi(bad, o, d, tm, node_pops=1)
    assert int(capped) == o.x.shape[0]
