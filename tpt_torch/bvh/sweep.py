"""Dense treelet scan and demand sweep: K3 `dense_scan` and K4
`sweep8_closest_hit`, the port's counterparts of the Pallas kernels in
`tpt/bvh/pallas_sweep.py` (:337 and :623; demand mode, closest hit, no
group culling).

On CUDA tensors each wrapper launches its hand-written kernel
(`tpt_torch/csrc/sweep.cu`, built with nvcc for sm_90a on first use and
bound with ctypes); on CPU tensors it runs the plain PyTorch version
below. There is no fallback between the two: a CUDA tensor launches the
kernel or raises.

K3 gives each ray its S nearest treelet candidates — entry t [S, n] and
ordinal [S, n] in ascending (t, ordinal) order, NONE_ORD where there is
none — and thr [n], the smallest entry t of every candidate the slots
could not hold (3e38 if none). K4 sweeps, per 128-lane block, every
treelet that some lane of the block still demands (slot k is demanded
while its entry t precedes the lane's best hit) and returns the closest
hit among those triangles; like tpt's kernel, its raw result depends on
which lanes share a block. The plain versions compute the same functions
by other means (K3: the S+1 smallest of every ray's candidates; K4: all
blocks' union walks at once) with the kernels' float32 arithmetic, so
kernel and plain agree bit for bit.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple, Union

import torch

from .. import _build
from ..core.vec import Vec3
from ..integrators.intersect import FLT_MAX, HitRecord, safe_inv
from .packet_traverse import HEADERS, NVCC_FLAGS, _mt_rows
from .treelet import SweepTables

# ordinal of "no candidate": sorts past every real ordinal
NONE_ORD = 0x7FFFFF
_INF = 3.0e38        # K3's initial entry t and thr (pallas_sweep.py _INF)
LANES = 128          # lanes per K4 block (csrc/sweep.cu SWEEP_LANES)
MAX_SLOTS = 8        # slot counts the library instantiates

# launches of each CUDA kernel in this process (chip_smoke.py resets and
# reads them around the main path to show the path went through them)
LAUNCHES = {"dense_scan": 0, "sweep8_closest_hit": 0}

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "sweep.cu")
BUILD_TIMEOUT_S = 600.0

Planes = Union[torch.Tensor, Sequence[torch.Tensor]]


# ---------------------------------------------------------------------------
# CUDA kernels (ctypes)
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load_library("tpt_sweep", [_build.find_nvcc()] + NVCC_FLAGS,
                              [SOURCE], BUILD_TIMEOUT_S, HEADERS)
    if not getattr(lib, "_tpt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tpt_dense_scan.restype = ctypes.c_int
        lib.tpt_dense_scan.argtypes = [p] * 7 + [i, p, i, i] + [p] * 5
        lib.tpt_sweep8_closest_hit.restype = ctypes.c_int
        lib.tpt_sweep8_closest_hit.argtypes = ([p] * 7 + [i, i] + [p] * 4
                                               + [i] + [p] * 6)
        lib.tpt_sweep_max_slots.restype = ctypes.c_int
        lib.tpt_sweep_max_slots.argtypes = []
        if lib.tpt_sweep_max_slots() != MAX_SLOTS:
            raise RuntimeError("sweep.cu MAX_SLOTS differs from sweep.MAX_SLOTS")
        lib._tpt_bound = True
    return lib


def build_kernels() -> None:
    """Compile and load the CUDA library now (otherwise at first launch)."""
    _lib()


def _check_rays(ori: Vec3, d: Vec3, t_max: torch.Tensor) -> int:
    n = ori.x.shape[0]
    dev = ori.x.device
    for a in (ori.x, ori.y, ori.z, d.x, d.y, d.z, t_max):
        if a.device != dev or a.dtype != torch.float32 or a.dim() != 1 \
                or a.shape[0] != n or not a.is_contiguous():
            raise ValueError("ray inputs must be contiguous float32 [N] "
                             "tensors on one device")
    if n >= 2**31 // MAX_SLOTS:
        raise ValueError(f"{n} rays exceed the kernels' int32 lane index")
    return n


def _check_tables(sweep: SweepTables, dev: torch.device) -> None:
    tabs = (sweep.tri_f32, sweep.ranges, sweep.boxes)
    if any(a.device != dev for a in tabs):
        raise ValueError(f"sweep tables are on {sweep.device}, rays on {dev}")
    if (sweep.tri_f32.dtype != torch.float32 or sweep.ranges.dtype != torch.int32
            or sweep.boxes.dtype != torch.float32):
        raise ValueError("sweep tables must be float32/int32/float32")
    T = sweep.num_treelets
    if (tuple(sweep.ranges.shape) != (T, 2) or tuple(sweep.boxes.shape) != (T, 8)
            or sweep.tri_f32.dim() != 2 or sweep.tri_f32.shape[1] != 16):
        raise ValueError("sweep tables do not have the SweepTables layout")
    if not all(a.is_contiguous() for a in tabs):
        raise ValueError("sweep tables must be contiguous")


def _check_stats(stats: Optional[torch.Tensor], dev, size: int) -> None:
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or tuple(stats.shape) != (size,)):
        raise ValueError(f"stats must be an int64 [{size}] tensor on the "
                         "rays' device")


def _ptr(a: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if a is None else a.data_ptr())


def _run(name: str, dev: torch.device, *args) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, "tpt_" + name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _slots(slots: int) -> int:
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"slots must be in 1..{MAX_SLOTS}, got {slots}")
    return slots


def dense_scan(sweep: SweepTables, ori: Vec3, d: Vec3, t_max: torch.Tensor,
               slots: int = 4, stats: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: (entry t [S, n] f32, ordinal [S, n] int32, thr [n] f32) over
    SweepTables.boxes. `stats`, an int64 [1] CUDA tensor, collects the
    slab tests of live rays."""
    S = _slots(slots)
    n = _check_rays(ori, d, t_max)
    dev = ori.x.device
    _check_tables(sweep, dev)
    if dev.type == "cpu":
        return dense_scan_plain(sweep, ori, d, t_max, slots=S)
    _check_stats(stats, dev, 1)
    s_t = torch.empty((S, n), dtype=torch.float32, device=dev)
    s_o = torch.empty((S, n), dtype=torch.int32, device=dev)
    thr = torch.empty(n, dtype=torch.float32, device=dev)
    rays = [_ptr(a) for a in (ori.x, ori.y, ori.z, d.x, d.y, d.z, t_max)]
    _run("dense_scan", dev, *rays, n, _ptr(sweep.boxes), sweep.num_treelets,
         S, _ptr(s_t), _ptr(s_o), _ptr(thr), _ptr(stats))
    return s_t, s_o, thr


def _planes(planes: Planes, dtype, n: int, dev) -> torch.Tensor:
    p = planes if isinstance(planes, torch.Tensor) else torch.stack(list(planes))
    if p.dim() != 2 or p.shape[1] != n or p.dtype != dtype or p.device != dev:
        raise ValueError(f"slot planes must be {dtype} [S, {n}] on {dev}")
    return p.contiguous()


def _check_unroll(sweep: SweepTables, unroll: int) -> None:
    # tpt's contract (pallas_sweep.py:645): an unroll that does not divide
    # the table's chunk_align would skip tail chunks on the TPU
    assert sweep.chunk_align % unroll == 0, \
        (f"unroll={unroll} must divide the table's chunk_align="
         f"{sweep.chunk_align} (rebuild sweep_tables with "
         f"chunk_align={unroll})")


def sweep8_closest_hit(sweep: SweepTables, ori: Vec3, d: Vec3,
                       t_max: torch.Tensor, ordinal: Planes, entry_t: Planes,
                       unroll: int = 4,
                       stats: Optional[torch.Tensor] = None) -> HitRecord:
    """K4: closest hit over each 128-lane block's demanded treelets.
    `ordinal`/`entry_t` are the scan's slot planes ([S, n] or S tensors of
    [n]) in pool order. `unroll` is tpt's unroll_chunks and must divide
    the table's chunk_align; it has no meaning per thread. `stats`, an
    int64 [3] CUDA tensor, collects (treelet sweeps summed over blocks,
    triangle tests of live lanes, live lanes)."""
    _check_unroll(sweep, unroll)
    n = _check_rays(ori, d, t_max)
    dev = ori.x.device
    _check_tables(sweep, dev)
    o = _planes(ordinal, torch.int32, n, dev)
    e = _planes(entry_t, torch.float32, n, dev)
    S = _slots(o.shape[0])
    if e.shape[0] != S:
        raise ValueError("ordinal and entry_t have different slot counts")
    if dev.type == "cpu":
        return sweep8_closest_hit_plain(sweep, ori, d, t_max, o, e,
                                        unroll=unroll)
    _check_stats(stats, dev, 3)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    rays = [_ptr(a) for a in (ori.x, ori.y, ori.z, d.x, d.y, d.z, t_max)]
    _run("sweep8_closest_hit", dev, *rays, n, S, _ptr(o), _ptr(e),
         _ptr(sweep.ranges), _ptr(sweep.tri_f32), sweep.unroll, _ptr(t),
         _ptr(tri), _ptr(u), _ptr(v), _ptr(stats))
    return HitRecord(t=t, tri=tri, u=u, v=v)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def dense_scan_plain(sweep: SweepTables, ori: Vec3, d: Vec3,
                     t_max: torch.Tensor, slots: int = 4
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K3 (any device): every ray's candidates over all T boxes in
    ray chunks, then the S+1 smallest in (t, ordinal) order by repeated
    first-argmin. thr is the (S+1)-th t."""
    S = _slots(slots)
    n = _check_rays(ori, d, t_max)
    dev = ori.x.device
    T = sweep.num_treelets
    box = sweep.boxes[:, :6]
    tm = torch.where(t_max > 0, t_max, 0.0)
    bt_all = torch.clamp_max(tm, _INF)
    inv = [safe_inv(c) for c in (d.x, d.y, d.z)]
    org = [ori.x, ori.y, ori.z]
    zero = torch.zeros((), device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    s_t = torch.full((S, n), _INF, device=dev)
    s_o = torch.full((S, n), NONE_ORD, dtype=torch.int32, device=dev)
    thr = torch.full((n,), _INF, device=dev)
    chunk = max(1, (1 << 24) // max(T, 1))
    for a in range(0, n, chunk):
        sl = slice(a, min(n, a + chunk))
        o = [c[sl, None] for c in org]
        iv = [c[sl, None] for c in inv]
        bt = bt_all[sl, None]
        t0 = [(box[None, :, k] - o[k]) * iv[k] for k in range(3)]
        t1 = [(box[None, :, 3 + k] - o[k]) * iv[k] for k in range(3)]
        tn = torch.maximum(
            torch.maximum(torch.minimum(t0[0], t1[0]),
                          torch.minimum(t0[1], t1[1])),
            torch.maximum(torch.minimum(t0[2], t1[2]), zero))
        tf = torch.minimum(
            torch.minimum(torch.maximum(t0[0], t1[0]),
                          torch.maximum(t0[1], t1[1])),
            torch.minimum(torch.maximum(t0[2], t1[2]), bt))
        key = torch.where((tn <= tf) & (tn < bt), tn, inf)
        rows = torch.arange(key.shape[0], device=dev)
        for k in range(S + 1):
            idx = torch.argmin(key, dim=1)   # first minimum: smallest ordinal
            val = key[rows, idx]
            some = val < inf
            if k < S:
                s_t[k, sl] = torch.where(some, val, _INF)
                s_o[k, sl] = torch.where(some, idx.to(torch.int32), NONE_ORD)
                key[rows, idx] = inf
            else:
                thr[sl] = torch.where(some, val, _INF)
    return s_t, s_o, thr


def sweep8_closest_hit_plain(sweep: SweepTables, ori: Vec3, d: Vec3,
                             t_max: torch.Tensor, ordinal: Planes,
                             entry_t: Planes, unroll: int = 4) -> HitRecord:
    """Plain K4 (any device): every 128-lane block walks its own demand
    union in ascending ordinal, all blocks at once; each step tests the
    current treelet's rows against the block's lanes (in block chunks)
    and keeps the first row of the smallest t below the lane's best."""
    _check_unroll(sweep, unroll)
    n = _check_rays(ori, d, t_max)
    dev = ori.x.device
    o = _planes(ordinal, torch.int32, n, dev)
    e = _planes(entry_t, torch.float32, n, dev)
    S = o.shape[0]
    nb = max(1, -(-n // LANES))
    pad = nb * LANES - n

    def blocks(a, fill):
        if pad:
            a = torch.cat([a, a.new_full((pad,), fill)])
        return a.reshape(nb, LANES)

    alive = t_max > 0
    tm = blocks(torch.where(alive, t_max, 0.0), 0.0)
    o = torch.stack([blocks(torch.where(alive, o[k], NONE_ORD), NONE_ORD)
                     for k in range(S)], 1)             # [nb, S, 128]
    e = torch.stack([blocks(e[k], _INF) for k in range(S)], 1)
    rays = [blocks(c, 0.0) for c in (ori.x, ori.y, ori.z, d.x, d.y, d.z)]
    bt = torch.clamp_max(tm, FLT_MAX)
    brow = torch.full((nb, LANES), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((nb, LANES), device=dev)
    bv = torch.zeros((nb, LANES), device=dev)
    cur = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    none = torch.tensor(NONE_ORD, dtype=torch.int32, device=dev)
    rpc = sweep.unroll
    max_rows = sweep.max_chunks * rpc
    inf = torch.tensor(float("inf"), device=dev)
    bchunk = max(1, (1 << 24) // (max_rows * LANES))
    while True:
        demand = (o > cur[:, None, None]) & (e < bt[:, None, :])
        cur = torch.where(demand, o, none).amin(dim=(1, 2))
        act = torch.nonzero(cur < NONE_ORD).squeeze(1)
        if act.numel() == 0:
            break
        for a in range(0, act.numel(), bchunk):
            blk = act[a:a + bchunk]
            rng = sweep.ranges[cur[blk].long()].long()
            start, nrows = rng[:, 0], rng[:, 1] * rpc
            R = int(nrows.max())
            j = torch.arange(R, device=dev)
            row = start[:, None] + j[None, :]                 # [b, R]
            valid = j[None, :] < nrows[:, None]
            tri = sweep.tri_f32[row.clamp(max=sweep.tri_f32.shape[0] - 1)]
            rc = lambda c: c[blk][:, None, :]                 # [b, 1, 128]
            t, u, v, hit = _mt_rows(tri[:, :, None, :],
                                    (rc(rays[0]), rc(rays[1]), rc(rays[2])),
                                    (rc(rays[3]), rc(rays[4]), rc(rays[5])))
            btb = bt[blk]
            t_m = torch.where(hit & valid[:, :, None] & (t < btb[:, None, :]),
                              t, inf)
            best, arg = torch.min(t_m, dim=1)       # first minimum: lowest row
            win = best < btb
            pick = lambda a: a.gather(1, arg[:, None, :]).squeeze(1)
            bt[blk] = torch.where(win, best, btb)
            brow[blk] = torch.where(win, pick(row[:, :, None].expand_as(t)),
                                    brow[blk])
            bu[blk] = torch.where(win, pick(u), bu[blk])
            bv[blk] = torch.where(win, pick(v), bv[blk])
    flat = lambda a: a.reshape(-1)[:n]
    brow = flat(brow)
    found = brow >= 0
    ids = sweep.tri_f32[:, 9].to(torch.int32)
    tri = torch.where(found, ids[brow.clamp_min(0)], -1)
    return HitRecord(t=torch.where(found, flat(bt), FLT_MAX), tri=tri,
                     u=torch.where(found, flat(bu), 0.0),
                     v=torch.where(found, flat(bv), 0.0))
