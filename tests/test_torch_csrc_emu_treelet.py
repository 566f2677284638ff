"""The treelet kernels' CUDA source runs on the CPU: `csrc/treelet.cu`
(K9 `tpt_treelet_scan`, K10 `tpt_treelet_closest_hit`, K11
`tpt_treelet_scan_multi`) compiled with g++ against the stand-in
`tests/cuda_emu/cuda_runtime.h` (a block's threads as fibers, barriers
for the warp and block votes, dynamic shared memory as one static buffer)
with -ffp-contract=off, and held bit for bit against the plain PyTorch
versions on the Cornell box cut into treelets of <= 16 triangles (every
treelet a single cluster) and <= 64: dead lanes, NaN and +-0 directions,
a NaN origin, K10 seeded from K9 and not, S = 1 to 8 slots, packets of
1024 to 8192 lanes (every placement of K10's lane planes: all in shared
memory, the slots in the global scratch, all in the scratch), equal-t
ties across treelets and a packet that reaches max_rounds. This checks
the kernels' control flow and arithmetic before a card runs them; it says
nothing of their speed.

Skips where no g++ is found.
"""

import ctypes
import os
import shutil
import subprocess
from dataclasses import replace

import pytest
import torch

from test_torch_csrc_emu import CSRC, FLAGS, STUB, rewrite_launches
from torch_treelet_pools import tie_pool, treelet_rays
from tpt_torch.bvh import sweep as sw
from tpt_torch.bvh import treelet_traverse as tlt
from tpt_torch.core.vec import Vec3
from tpt_torch.integrators import intersect
from tpt_torch.scene import procedural

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

N = 1500   # lanes a K9/K11 case: one or two packets
N10 = 700  # lanes a K10 case: one packet, some 40-300 drain rounds


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("csrc_emu_treelet")
    with open(os.path.join(CSRC, "treelet.cu")) as f:
        src = rewrite_launches(f.read())
    cpp = out / "treelet.cpp"
    cpp.write_text(src)
    so = out / "libtreelet.so"
    proc = subprocess.run(
        [cxx] + FLAGS + ["-I", STUB, "-I", CSRC, str(cpp), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("g++ treelet.cu failed:\n"
                           + proc.stdout.decode()[-4000:])
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def scenes():
    host = procedural.cornell_box(resolution=(32, 32))
    return {mt: host.build(with_bvh=True, treelet_max_tris=mt, device="cpu")
            for mt in (16, 64)}


def _p(a):
    return ctypes.c_void_p(a.data_ptr() if a is not None else None)


def _call(lib, name, args):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    rc = fn(*[a if isinstance(a, ctypes.c_void_p) else ctypes.c_int(a)
              for a in args])
    assert rc == 0, rc


def _rays(o, d, t_max):
    return [_p(a) for a in (o.x, o.y, o.z, d.x, d.y, d.z, t_max)]


def _k9(lib, pack, o, d, t_max, group):
    n = t_max.numel()
    st = torch.zeros(n)
    sc, so, ovf, cnt = (torch.zeros(n, dtype=torch.int32) for _ in range(4))
    capped = torch.zeros(1, dtype=torch.int32)
    stats = torch.zeros(2, dtype=torch.int64)
    _call(lib, "tpt_treelet_scan", _rays(o, d, t_max) + [
        n, 1024 * group, _p(pack.top_f32), pack.top_f32.shape[1],
        _p(pack.top_child), _p(pack.top_tref), _p(pack.top_tord),
        pack.num_top, pack.arity] + [_p(a) for a in (
            st, sc, so, ovf, cnt, capped, stats)] + [ctypes.c_void_p(None)])
    return (st, sc, so, ovf, cnt, capped[0]), stats


def _k10(lib, pack, o, d, t_max, group, slots, seed=None, max_rounds=4096):
    n = t_max.numel()
    L = 1024 * group
    lib.tpt_treelet_closest_scratch.restype = ctypes.c_int
    planes = lib.tpt_treelet_closest_scratch(L, slots)
    assert planes >= 0
    scratch = torch.zeros(max(1, planes * -(-n // L) * L))
    res = [torch.zeros(n), torch.zeros(n, dtype=torch.int32), torch.zeros(n),
           torch.zeros(n)]
    capped = torch.zeros(1, dtype=torch.int32)
    stats = torch.zeros(6, dtype=torch.int64)
    sd = ([_p(a) for a in seed] if seed is not None
          else [ctypes.c_void_p(None)] * 3)
    _call(lib, "tpt_treelet_closest_hit", _rays(o, d, t_max) + [
        n, L, slots, max_rounds] + sd + [
        _p(pack.node_f32), pack.node_f32.shape[1], _p(pack.node_child),
        pack.num_nodes, _p(pack.tri_f32), pack.tri_f32.shape[0],
        pack.max_cluster, _p(pack.top_f32), pack.top_f32.shape[1],
        _p(pack.top_child), _p(pack.top_tref), pack.num_top, pack.arity,
        _p(scratch)] + [_p(a) for a in res] + [
        _p(capped), _p(stats), ctypes.c_void_p(None)])
    return res, capped[0], stats, planes


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b)), int((_bits(a) != _bits(b))
                                                    .sum())


def _hit_planes(h):
    return (h.t, h.tri, h.u, h.v)


def _seeded(o, d, t_max, k9):
    """The pool sorted by K9's ordinal (as the wavefront does) and its
    seed."""
    st, sc, so, ovf = k9[:4]
    key = torch.where(sc != tlt.NONE_CODE, so.long(), 1 << 30)
    perm = torch.sort(key, stable=True).indices
    g = lambda a: a[perm].contiguous()
    return (Vec3(g(o.x), g(o.y), g(o.z)), Vec3(g(d.x), g(d.y), g(d.z)),
            g(t_max), (g(st), g(sc), g(ovf)))


@pytest.mark.parametrize("mt", [16, 64])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_k9_equals_plain(lib, scenes, mt, group):
    """Every output plane and the capped count, bit for bit, for each
    lanes-a-thread instantiation."""
    pack = scenes[mt].pack
    o, d, t_max = treelet_rays(scenes[mt], N, 31 + group, "cpu")
    got, stats = _k9(lib, pack, o, d, t_max, group)
    want = tlt.treelet_scan_plain(pack, o, d, t_max, group=group)
    _equal(got, want)
    assert int(got[5]) == 0 and int(stats[0]) > 0 and int(stats[1]) > 0
    assert bool((got[1] != tlt.NONE_CODE).any())


# each level of group, S and seeding on each scene, every pair of levels
# once (an orthogonal array)
K10_CASES = [(2, 4, False), (2, 8, True), (4, 4, True), (4, 8, False)]


@pytest.mark.parametrize("mt", [16, 64])
@pytest.mark.parametrize("group,slots,seeded", K10_CASES)
def test_k10_equals_plain(lib, scenes, mt, group, slots, seeded):
    """Closest hits bit for bit, 0 capped; the hits are brute force's t."""
    data = scenes[mt]
    pack = data.pack
    o, d, t_max = treelet_rays(data, N10, 33 + group + slots, "cpu")
    seed = None
    if seeded:
        o, d, t_max, seed = _seeded(o, d, t_max, tlt.treelet_scan_plain(
            pack, o, d, t_max, group=2))
    got, capped, stats, planes = _k10(lib, pack, o, d, t_max, group, slots,
                                      seed)
    want, cap_p = tlt.treelet_closest_hit_plain(pack, o, d, t_max,
                                                group=group, slots=slots,
                                                seed=seed)
    _equal(got, _hit_planes(want))
    assert int(capped) == 0 and int(cap_p) == 0
    ref = intersect.brute_force_closest_hit(data.mesh, o, d, t_max)
    assert torch.equal(got[0], ref.t)
    # the thresholds, flags and slots leave shared memory at 2048 lanes
    # and S 8, and at 4096 lanes
    assert planes == {(2, 4): 0, (2, 8): 19, (4, 4): 11,
                      (4, 8): 19}[group, slots]
    assert int(stats[3]) > 0 and int(stats[5]) <= int(stats[3])
    assert int(stats[2]) > 0 and int(stats[1]) > 0


def test_k10_planes_in_global_scratch(lib, scenes):
    """8192-lane packets: no lane plane fits in shared memory."""
    pack = scenes[64].pack
    o, d, t_max = treelet_rays(scenes[64], 300, 51, "cpu")
    got, capped, _, planes = _k10(lib, pack, o, d, t_max, 8, 2)
    want, _ = tlt.treelet_closest_hit_plain(pack, o, d, t_max, group=8,
                                            slots=2)
    assert planes == 13 + 3 + 2 * 2
    _equal(got, _hit_planes(want))
    assert int(capped) == 0


def test_k10_equal_t_ties_across_treelets(lib, scenes):
    """Rays at edges shared by triangles of different treelets: where both
    hit at the same t, the packet's first-drained treelet wins, as the
    plain walk's; the kernel's triangle differs from brute force's first
    minimum on some lanes."""
    data = scenes[16]
    pack = data.pack
    o, d, t_max, ties = tie_pool(data, 1024, 5, "cpu")
    assert ties > 10
    got, capped, _, _ = _k10(lib, pack, o, d, t_max, 1, 4)
    want, _ = tlt.treelet_closest_hit_plain(pack, o, d, t_max, group=1,
                                            slots=4)
    _equal(got, _hit_planes(want))
    assert int(capped) == 0
    ref = intersect.brute_force_closest_hit(data.mesh, o, d, t_max)
    assert torch.equal(got[0], ref.t)
    assert int((got[1] != ref.tri).sum()) > 0


def test_k10_stages_large_clusters_in_chunks(lib):
    """Clusters of up to 64 triangles: a step's 4 popped clusters can hold
    more rows than one staging chunk (STAGE_ROWS = 64), and the rows go
    through shared memory in chunks, each lane still taking them in pop
    then row order."""
    host = procedural.cornell_box(resolution=(32, 32))
    data = host.build(with_bvh=True, max_cluster=64, treelet_max_tris=256,
                      device="cpu")
    pack = data.pack
    codes = pack.node_child[pack.node_child < -1].long()
    assert int((-(codes + 1) & 255).max()) > 32
    o, d, t_max = treelet_rays(data, N10, 45, "cpu")
    got, capped, _, _ = _k10(lib, pack, o, d, t_max, 2, 4)
    want, _ = tlt.treelet_closest_hit_plain(pack, o, d, t_max, slots=4)
    _equal(got, _hit_planes(want))
    assert int(capped) == 0


def test_k10_max_rounds_is_capped(lib, scenes):
    """One round cannot finish: the kernel's state after it equals the
    plain walk's, and every live lane of every packet counts."""
    pack = scenes[64].pack
    o, d, t_max = treelet_rays(scenes[64], N, 40, "cpu")
    got, capped, _, _ = _k10(lib, pack, o, d, t_max, 2, 4, max_rounds=1)
    want, cap_p = tlt.treelet_closest_hit_plain(pack, o, d, t_max,
                                                max_rounds=1)
    _equal(got, _hit_planes(want))
    assert int(capped) == int(cap_p) == int((t_max > 0).sum()) > 0


def _k11(lib, pack, o, d, t_max, group, slots, node_pops=tlt.NODE_POPS):
    n = t_max.numel()
    L = 1024 * group
    lib.tpt_treelet_scan_multi_place.restype = ctypes.c_int
    place = tlt.MULTI_PLACES[lib.tpt_treelet_scan_multi_place(L, slots)]
    scratch = torch.zeros(-(-n // L) * (2 * slots + 1) * L
                          if place == "scratch" else 1)
    s_t = torch.zeros(slots * n)
    s_o = torch.zeros(slots * n, dtype=torch.int32)
    thr = torch.zeros(n)
    capped = torch.zeros(1, dtype=torch.int32)
    stats = torch.zeros(2, dtype=torch.int64)
    _call(lib, "tpt_treelet_scan_multi", _rays(o, d, t_max) + [
        n, L, slots, node_pops, _p(pack.top_f32), pack.top_f32.shape[1],
        _p(pack.top_child), _p(pack.top_tord), pack.num_top,
        pack.arity] + [_p(a) for a in (
            scratch, s_t, s_o, thr, capped, stats)] + [ctypes.c_void_p(None)])
    return ((s_t.view(slots, n), s_o.view(slots, n), thr, capped[0]), stats,
            place)


# every placement of K11's slots: registers while a thread's lanes hold at
# most 18 slot words, then dynamic shared memory, then the global scratch
K11_PLACES = {(1, 1): "registers", (1, 4): "registers", (1, 8): "registers",
              (2, 1): "registers", (2, 4): "registers", (2, 8): "shared",
              (4, 1): "registers", (4, 4): "shared", (4, 8): "scratch"}


@pytest.mark.parametrize("group,slots", list(K11_PLACES))
def test_k11_equals_plain(lib, scenes, group, slots):
    """Entry t, ordinal, thr and capped bit for bit on 1500 lanes (no
    multiple of the packet), in every placement of the lanes' slots."""
    pack = scenes[64].pack
    o, d, t_max = treelet_rays(scenes[64], N, 41 + slots, "cpu")
    got, stats, place = _k11(lib, pack, o, d, t_max, group, slots)
    assert place == K11_PLACES[group, slots]
    want = tlt.treelet_scan_multi_plain(pack, o, d, t_max, slots=slots,
                                        group=group)
    _equal(got, want)
    assert int(got[3]) == 0 and int(stats[0]) > 0
    assert bool((got[1][0] != sw.NONE_ORD).any())
    assert bool((got[2] < 3.0e38).any())


def _chain_top(pack, depth):
    """A top tree that overflows K11's 256-entry stack and then ends: a
    chain of `depth` nodes, each with a box around everything, whose
    near child is the next chain node and whose far child is a node with
    no child a ray can enter (NaN boxes), so each pop leaves one node on
    the stack below the chain."""
    A = pack.arity
    num = 2 * depth
    f32 = torch.full((num, pack.top_f32.shape[1]), float("nan"))
    child = torch.full((num, 16), -1, dtype=torch.int32)
    box = torch.tensor([-1e6] * 3 + [1e6] * 3)
    order = sum(15 << (4 * p) for p in range(A))  # every slot past A
    child[:, 8:] = order
    for k in range(depth):
        node = 2 * k
        f32[node, 6:12] = box                      # slot 1: the far node
        child[node, 1] = node + 1
        if k + 1 < depth:
            f32[node, 0:6] = box                   # slot 0: the next node
            child[node, 0] = node + 2
        child[node, 8:] = (order & ~0xFF) | (1 << 4)  # slot 0 popped first
    tref = torch.full((num, 8), -2, dtype=torch.int32)
    tord = torch.zeros((num, 8), dtype=torch.int32)
    return replace(pack, top_f32=f32, top_child=child, top_tref=tref,
                   top_tord=tord, num_top=num)


def test_k11_stack_overflow_is_capped(lib, scenes):
    """A walk that drops pushes on a full stack, then ends: every live lane
    of the packet counts as capped, as in the plain walk, and the slots
    and thr agree bit for bit."""
    pack = _chain_top(scenes[64].pack, 300)
    o, d, t_max = treelet_rays(scenes[64], 200, 47, "cpu")
    got, stats, _ = _k11(lib, pack, o, d, t_max, 1, 4)
    want = tlt.treelet_scan_multi_plain(pack, o, d, t_max, slots=4, group=1)
    _equal(got, want)
    assert int(got[3]) == int((t_max > 0).sum()) > 0
    assert int(stats[0]) < 8 * pack.num_top + 1024   # ended before the cap
