"""The port's CUDA sources run on the CPU: `csrc/packet_wide.cu` (K2/K1)
and `csrc/sweep.cu` (K4 and K7) compiled with g++ against the
stand-in `tests/cuda_emu/cuda_runtime.h` (a block's threads as fibers,
barriers for the warp intrinsics) with -ffp-contract=off, and
held bit for bit against their plain PyTorch versions: K2/K1 on Cornell
rays (dead lanes, NaN rays, arity 4 and 8, equal-t ties, a cyclic table
that caps a ray), the sweeps on the flat-group warp and edge pool of
`torch_flatgroup`. This checks a kernel's control flow and arithmetic
before a card runs it; it says nothing of its speed.

Skips where no g++ is found.
"""

import ctypes
import os
import shutil
import subprocess
from dataclasses import replace

import numpy as np
import pytest
import torch

import torch_flatgroup as fg
from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.bvh import sweep as sw
from tpt_torch.core.vec import Vec3
from tpt_torch.scene import procedural

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "tpt_torch", "csrc")
STUB = os.path.join(HERE, "cuda_emu")
FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-w", "-x", "c++"]


def _split_top(s):
    """Split a launch configuration at its top-level commas."""
    parts, depth, cur = [], 0, ""
    for c in s:
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        if c == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += c
    return parts + [cur]


def rewrite_launches(src):
    """k<<<grid, block, smem, stream>>>(args); ->
    emu_launch(grid, block, [&] { k(args); });"""
    out, i = [], 0
    while True:
        k = src.find("<<<", i)
        if k < 0:
            return "".join(out) + src[i:]
        j = k
        if src[j - 1] == ">":                  # template arguments
            depth, j = 0, j - 1
            while True:
                depth += {">": 1, "<": -1}.get(src[j], 0)
                if depth == 0:
                    break
                j -= 1
        while src[j - 1].isalnum() or src[j - 1] == "_":
            j -= 1
        e = src.index(">>>", k)
        cfg = _split_top(src[k + 3:e])
        p = src.index("(", e)
        depth, q = 0, p
        while True:
            depth += {"(": 1, ")": -1}.get(src[q], 0)
            if depth == 0:
                break
            q += 1
        out.append(src[i:j])
        out.append(f"emu_launch({cfg[0]}, {cfg[1]}, [&] {{ "
                   f"{src[j:k]}({src[p + 1:q]}); }})")
        i = q + 1


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("csrc_emu")
    procs = {}
    for name in ("packet_wide", "sweep"):
        with open(os.path.join(CSRC, name + ".cu")) as f:
            src = rewrite_launches(f.read())
        cpp = out / (name + ".cpp")
        cpp.write_text(src)
        so = out / ("lib" + name + ".so")
        procs[name] = (subprocess.Popen(
            [cxx] + FLAGS + ["-I", STUB, "-I", CSRC, str(cpp), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    built = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate(timeout=300)[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {name}.cu failed:\n{log[-4000:]}")
        built[name] = ctypes.CDLL(str(so))
    return built


@pytest.fixture(scope="module")
def cornell():
    host = procedural.cornell_box(resolution=(32, 32))
    return host.build(with_bvh=True, device="cpu")


@pytest.fixture(scope="module")
def cornell8():
    host = procedural.cornell_box(resolution=(32, 32))
    return host.build(with_bvh=True, packet_arity=8, device="cpu")


def _p(a):
    return ctypes.c_void_p(a.data_ptr() if a is not None else None)


def _cast(lib, pack, o, d, t_max, any_hit):
    """K2 (K1 with `any_hit`) of the emulated library: (result, capped,
    stats)."""
    n = t_max.numel()
    capped = torch.zeros(1, dtype=torch.int32)
    stats = torch.zeros(3, dtype=torch.int64)
    args = [_p(a) for a in (o.x, o.y, o.z, d.x, d.y, d.z, t_max)]
    args += [n, _p(pack.node_f32), pack.node_f32.shape[1], _p(pack.node_child),
             pack.num_nodes, _p(pack.tri_f32), pack.tri_f32.shape[0],
             pack.arity, pack.max_cluster]
    if any_hit:
        occ = torch.zeros(n, dtype=torch.uint8)
        fn = lib.tpt_packet_any_hit_wide
        args += [_p(occ)]
    else:
        res = [torch.zeros(n), torch.zeros(n, dtype=torch.int32),
               torch.zeros(n), torch.zeros(n)]
        fn = lib.tpt_packet_closest_hit_wide
        args += [_p(a) for a in res]
    args += [_p(capped), _p(stats), ctypes.c_void_p(None)]
    fn.restype = ctypes.c_int
    assert fn(*[a if isinstance(a, ctypes.c_void_p) else ctypes.c_int(a)
                for a in args]) == 0
    return (occ.bool() if any_hit else res), int(capped[0]), stats


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform([20, 20, -20], [536, 528, 540], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[5] = (0.0, -0.0, 1.0)
    o[6] = (np.nan, 100.0, 100.0)
    d[7] = (np.inf, 0.0, 0.0)
    t = np.full(n, 3.4e38, np.float32)
    t[::13] = -1.0
    t[8] = np.nan
    t[40:60] = 150.0
    v = lambda a: Vec3.from_stacked(torch.from_numpy(np.ascontiguousarray(a)))
    return v(o), v(d), torch.from_numpy(t)


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.parametrize("arity", [4, 8])
def test_wide_walks_equal_plain(libs, cornell, cornell8, arity):
    """K2 and K1 on 300 rays (dead lanes, NaN and infinite rays, short
    segments; n not a multiple of a block), bit for bit, 0 capped."""
    pack = (cornell if arity == 4 else cornell8).pack
    o, d, t_max = _rays(300, 41)
    want, cap = pt.closest_hit_wide_plain(pack, o, d, t_max)
    occ_want, cap_a = pt.any_hit_wide_plain(pack, o, d, t_max)
    assert int(cap) == 0 and int(cap_a) == 0
    got, capped, _ = _cast(libs["packet_wide"], pack, o, d, t_max, False)
    for a, b in zip(got, (want.t, want.tri, want.u, want.v)):
        assert torch.equal(_bits(a), _bits(b))
    occ, capped_a, _ = _cast(libs["packet_wide"], pack, o, d, t_max, True)
    assert torch.equal(occ, occ_want)
    assert capped == 0 and capped_a == 0
    assert bool((want.tri >= 0).any()) and bool(occ_want.any())


def test_wide_walks_on_equal_t_ties(libs):
    """K2 on the two flat triangles packed as one cluster, with rays at
    their shared edge (many hit both at the same t): the serial first
    minimum, bit for bit."""
    pack = fg.flat_pack("cpu")
    o, d, t_max, _, _ = fg.edge_pool(512, 3, "cpu")
    want, _ = pt.closest_hit_wide_plain(pack, o, d, t_max)
    got, capped, _ = _cast(libs["packet_wide"], pack, o, d, t_max, False)
    for a, b in zip(got, (want.t, want.tri, want.u, want.v)):
        assert torch.equal(_bits(a), _bits(b))
    assert capped == 0


def test_wide_cyclic_table_caps_every_ray(libs, cornell):
    """A root that lists itself as its children: the ray overflows its
    stack and reaches the step cap, and is counted once, as the plain walk
    counts it (tests/test_torch_traverse.py)."""
    child = cornell.pack.node_child.clone()
    child[0, :4] = 0
    bad = replace(cornell.pack, node_child=child)
    o = Vec3.from_stacked(torch.tensor([[275.0, 272.0, 278.0]]))
    d = Vec3.from_stacked(torch.tensor([[0.6, -0.48, 0.64]]))
    t_max = torch.full((1,), 1e4)
    _, capped, _ = _cast(libs["packet_wide"], bad, o, d, t_max, False)
    assert capped == 1


def _sweep(lib, entry, tables, o, d, t_max, s_o, s_t, any_hit, galign):
    n = t_max.numel()
    res = [torch.zeros(n), torch.zeros(n, dtype=torch.int32), torch.zeros(n),
           torch.zeros(n)]
    stats = torch.zeros(3, dtype=torch.int64)
    gbox = tables.group_boxes if galign else None
    rpc = tables.unroll
    args = [_p(a) for a in (o.x, o.y, o.z, d.x, d.y, d.z, t_max)]
    args += [n, s_o.shape[0], _p(s_o.contiguous()),
             _p(s_t.contiguous() if s_t is not None else None),
             _p(tables.ranges), _p(tables.tri_f32), rpc, int(any_hit),
             _p(gbox), galign] + [_p(a) for a in res]
    args += [_p(stats), ctypes.c_void_p(None)]
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    assert fn(*[a if isinstance(a, ctypes.c_void_p) else ctypes.c_int(a)
                for a in args]) == 0
    return res, stats


def _hits_bits_equal(res, want):
    for a, f in zip(res, ("t", "tri", "u", "v")):
        assert torch.equal(_bits(a), _bits(getattr(want, f))), f


@pytest.mark.parametrize("mode", ["K4", "K4 any-hit", "K7", "K7 any-hit",
                                  "K7 every slot"])
def test_sweeps_on_the_flat_warp(libs, mode):
    """K4 and K7 on the flat-group warp: B's t and id (A's in any-hit
    mode), as the plain sweep; every row of both treelets tested."""
    tables = fg.flat_tables("cpu")
    o, d, t_max, s_o, s_t = fg.flat_warp("cpu")
    any_hit = "any-hit" in mode
    e = None if "every" in mode else s_t
    if mode.startswith("K4"):
        entry = "tpt_sweep8_closest_hit"
        want = sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o, e,
                                           unroll=1, any_hit=any_hit)
    else:
        entry = "tpt_sweep_closest_hit"
        want = sw.sweep_closest_hit_plain(tables, o, d, t_max, s_o, e,
                                          any_hit=any_hit)
    res, stats = _sweep(libs["sweep"], entry, tables, o, d, t_max, s_o, e,
                        any_hit, 0)
    _hits_bits_equal(res, want)
    assert int(res[1][0]) == (0 if any_hit else 1)
    assert int(stats[1]) == (8 if any_hit else 16)


def test_k4_on_the_edge_pool_and_flat_grid(libs):
    """K4 on 256 rays at the shared edge, and K4 with and without its
    group mode on a flat grid in the plane z = 0, bit for bit."""
    tables = fg.flat_tables("cpu")
    pool = fg.edge_pool(256, 3, "cpu")
    res, _ = _sweep(libs["sweep"], "tpt_sweep8_closest_hit", tables, *pool,
                    False, 0)
    _hits_bits_equal(res, sw.sweep8_closest_hit_plain(tables, *pool,
                                                      unroll=1))
    grid, p, q = fg.stress_tables(2, 5, "cpu")
    pool = fg.stress_pool(2, (p, q), 256, 6, "cpu")
    for galign in (0, 1):
        res, _ = _sweep(libs["sweep"], "tpt_sweep8_closest_hit", grid, *pool,
                        False, galign)
        _hits_bits_equal(res, sw.sweep8_closest_hit_plain(
            grid, *pool, unroll=1, use_groups=bool(galign)))
    assert float((res[1] >= 0).float().mean()) > 0.8
