"""Dense treelet scan and demand sweeps: K3 `dense_scan`, K4
`sweep8_closest_hit` and K7 `sweep_closest_hit`, the port's counterparts
of the Pallas kernels in `tpt/bvh/pallas_sweep.py` (:337, :623 with its
demand closest-hit, any-hit and group modes, and :168).

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
which lanes share a block. K7 is the same sweep over 1024-lane blocks,
with or without entry planes (without them every requested slot is
swept). In any-hit mode a lane that holds a hit before t_max - 1e-3
demands nothing more (it still tests what its block sweeps); K4's group
mode sweeps only the rows of a treelet's group boxes that some lane of
the block enters, which leaves the raw result unchanged. The plain
versions compute the same functions by other means (K3: the S+1 smallest
of every ray's candidates; K4/K7: all blocks' union walks at once) with
the kernels' float32 arithmetic, so kernel and plain agree bit for bit.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple, Union

import torch

from .. import _build
from ..core.vec import Vec3
from ..integrators.intersect import FLT_MAX, HitRecord, safe_inv
from .packet_traverse import HEADERS, NVCC_FLAGS, _mt_rows, _slab
from .treelet import SweepTables

# ordinal of "no candidate": sorts past every real ordinal
NONE_ORD = 0x7FFFFF
_INF = 3.0e38        # K3's initial entry t and thr (pallas_sweep.py _INF)
LANES = 128          # lanes per K4 block (csrc/sweep.cu SWEEP8_LANES)
LANES_K7 = 1024      # lanes per K7 block (csrc/sweep.cu SWEEP_LANES)
K7_ROWS = 8          # rows a chunk in tpt's K7 (always called with unroll=8)
MAX_SLOTS = 8        # slot counts the library instantiates

# launches of each CUDA kernel in this process (chip_smoke.py resets and
# reads them around the main path to show the path went through them);
# K4 and K7 count each mode on its own
LAUNCHES = {"dense_scan": 0, "sweep8_closest_hit": 0,
            "sweep8_closest_hit/groups": 0, "sweep8_closest_hit/any_hit": 0,
            "sweep_closest_hit": 0, "sweep_closest_hit/any_hit": 0}

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
                                               + [i, i, p, i] + [p] * 6)
        lib.tpt_sweep_closest_hit.restype = ctypes.c_int
        lib.tpt_sweep_closest_hit.argtypes = ([p] * 7 + [i, i] + [p] * 4
                                              + [i, i] + [p] * 6)
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


def _run(name: str, dev: torch.device, *args, count_as=None) -> None:
    _build.launch(_lib, LAUNCHES, name, dev, *args, count_as=count_as)


def _slots(slots: int, most: int = MAX_SLOTS) -> int:
    if not 1 <= slots <= most:
        raise ValueError(f"slots must be in 1..{most}, got {slots}")
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


def _group_align(sweep: SweepTables, unroll: int, use_groups: bool) -> int:
    """chunk_align of K4's group mode, or 0 where tpt does not apply it
    (pallas_sweep.py:649-659: use_groups and unroll < max_chunks)."""
    if not use_groups or unroll >= sweep.max_chunks:
        return 0
    if sweep.max_chunks > 8 * sweep.chunk_align:
        raise ValueError(f"group culling needs max_chunks={sweep.max_chunks} "
                         f"<= 8*chunk_align={8 * sweep.chunk_align} (rebuild "
                         "sweep_tables with a larger chunk_align)")
    g = sweep.group_boxes
    if g is None or g.device != sweep.device or g.dtype != torch.float32 \
            or tuple(g.shape) != (8 * sweep.num_treelets, 8) \
            or not g.is_contiguous():
        raise ValueError("group culling needs SweepTables.group_boxes, "
                         "float32 [8T, 8] on the tables' device")
    return sweep.chunk_align


def _slot_planes(ordinal: Planes, entry_t: Optional[Planes], n: int, dev):
    o = _planes(ordinal, torch.int32, n, dev)
    S = _slots(o.shape[0])
    e = None
    if entry_t is not None:
        e = _planes(entry_t, torch.float32, n, dev)
        if e.shape[0] != S:
            raise ValueError("ordinal and entry_t have different slot counts")
    return o, e


def _outputs(n: int, dev):
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev))


def sweep8_closest_hit(sweep: SweepTables, ori: Vec3, d: Vec3,
                       t_max: torch.Tensor, ordinal: Planes,
                       entry_t: Optional[Planes] = None,
                       unroll: int = 4, any_hit: bool = False,
                       use_groups: bool = False,
                       stats: Optional[torch.Tensor] = None) -> HitRecord:
    """K4: closest hit over each 128-lane block's demanded treelets.
    `ordinal`/`entry_t` are the scan's slot planes ([S, n] or S tensors of
    [n]) in pool order; without `entry_t` every requested slot is swept. `unroll` is tpt's unroll_chunks and must divide
    the table's chunk_align; it has no meaning per thread, but decides
    with `use_groups` whether the group mode runs (only where tpt runs
    it). `any_hit` is tpt's any-hit mode. `stats`, an int64 [3] CUDA
    tensor, collects (treelet sweeps summed over blocks, triangle tests of
    live lanes, live lanes)."""
    _check_unroll(sweep, unroll)
    galign = _group_align(sweep, unroll, use_groups)
    n = _check_rays(ori, d, t_max)
    dev = ori.x.device
    _check_tables(sweep, dev)
    o, e = _slot_planes(ordinal, entry_t, n, dev)
    if dev.type == "cpu":
        return _sweep_plain(sweep, ori, d, t_max, o, e, LANES, sweep.unroll,
                            any_hit, galign)
    _check_stats(stats, dev, 3)
    t, tri, u, v = _outputs(n, dev)
    if n == 0:
        return HitRecord(t=t, tri=tri, u=u, v=v)
    rays = [_ptr(a) for a in (ori.x, ori.y, ori.z, d.x, d.y, d.z, t_max)]
    mode = ("/any_hit" if any_hit else "/groups" if galign else "")
    _run("sweep8_closest_hit", dev, *rays, n, o.shape[0], _ptr(o), _ptr(e),
         _ptr(sweep.ranges), _ptr(sweep.tri_f32), sweep.unroll, int(any_hit),
         _ptr(sweep.group_boxes if galign else None), galign, _ptr(t),
         _ptr(tri), _ptr(u), _ptr(v), _ptr(stats),
         count_as="sweep8_closest_hit" + mode)
    return HitRecord(t=t, tri=tri, u=u, v=v)


def _check_k7_tables(sweep: SweepTables) -> None:
    # tpt's K7 is always called with unroll=8 and sweeps ranges[t, 1] * 8
    # rows (pallas_sweep.py:108-121): on a table of other chunks it would
    # sweep into the next treelet's rows
    if sweep.unroll != K7_ROWS:
        raise ValueError(f"K7 sweeps {K7_ROWS}-row chunks; the table's chunks "
                         f"have {sweep.unroll} rows (build it with unroll="
                         f"{K7_ROWS})")


def sweep_closest_hit(sweep: SweepTables, ori: Vec3, d: Vec3,
                      t_max: torch.Tensor, ordinal: Planes,
                      entry_t: Optional[Planes] = None, any_hit: bool = False,
                      stats: Optional[torch.Tensor] = None) -> HitRecord:
    """K7: K4's sweep over 1024-lane blocks. Without `entry_t` every
    requested ordinal is swept; with it, the demand drop; `any_hit` is
    tpt's any-hit mode. The table's chunks must have 8 rows. `stats` as
    for K4."""
    _check_k7_tables(sweep)
    n = _check_rays(ori, d, t_max)
    dev = ori.x.device
    _check_tables(sweep, dev)
    o, e = _slot_planes(ordinal, entry_t, n, dev)
    if dev.type == "cpu":
        return _sweep_plain(sweep, ori, d, t_max, o, e, LANES_K7, K7_ROWS,
                            any_hit, 0)
    _check_stats(stats, dev, 3)
    t, tri, u, v = _outputs(n, dev)
    if n == 0:
        return HitRecord(t=t, tri=tri, u=u, v=v)
    rays = [_ptr(a) for a in (ori.x, ori.y, ori.z, d.x, d.y, d.z, t_max)]
    _run("sweep_closest_hit", dev, *rays, n, o.shape[0], _ptr(o), _ptr(e),
         _ptr(sweep.ranges), _ptr(sweep.tri_f32), K7_ROWS, int(any_hit),
         _ptr(t), _ptr(tri), _ptr(u), _ptr(v), _ptr(stats),
         count_as="sweep_closest_hit" + ("/any_hit" if any_hit else ""))
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
                             entry_t: Optional[Planes] = None, unroll: int = 4,
                             any_hit: bool = False,
                             use_groups: bool = False) -> HitRecord:
    """Plain K4 (any device)."""
    _check_unroll(sweep, unroll)
    galign = _group_align(sweep, unroll, use_groups)
    n = _check_rays(ori, d, t_max)
    o, e = _slot_planes(ordinal, entry_t, n, ori.x.device)
    return _sweep_plain(sweep, ori, d, t_max, o, e, LANES, sweep.unroll,
                        any_hit, galign)


def sweep_closest_hit_plain(sweep: SweepTables, ori: Vec3, d: Vec3,
                            t_max: torch.Tensor, ordinal: Planes,
                            entry_t: Optional[Planes] = None,
                            any_hit: bool = False) -> HitRecord:
    """Plain K7 (any device)."""
    _check_k7_tables(sweep)
    n = _check_rays(ori, d, t_max)
    o, e = _slot_planes(ordinal, entry_t, n, ori.x.device)
    return _sweep_plain(sweep, ori, d, t_max, o, e, LANES_K7, K7_ROWS,
                        any_hit, 0)


def _sweep_plain(sweep: SweepTables, ori: Vec3, d: Vec3, t_max: torch.Tensor,
                 o: torch.Tensor, e: Optional[torch.Tensor], lanes: int,
                 rpc: int, any_hit: bool, galign: int) -> HitRecord:
    """K4/K7 (`lanes` a block, `rpc` rows a chunk): every block walks its
    own demand union in ascending ordinal, all blocks at once; each step
    tests the current treelet's rows (the group window's, with `galign`)
    against the block's lanes (in block chunks) and keeps the first row of
    the smallest t below the lane's best. Lanes past n are tpt's padding
    (zero rays, t_max 0)."""
    n = t_max.shape[0]
    dev = ori.x.device
    S = o.shape[0]
    nb = max(1, -(-n // lanes))
    pad = nb * lanes - n

    def blocks(a, fill):
        if pad:
            a = torch.cat([a, a.new_full((pad,), fill)])
        return a.reshape(nb, lanes)

    alive = t_max > 0
    tm = blocks(torch.where(alive, t_max, 0.0), 0.0)
    o = torch.stack([blocks(torch.where(alive, o[k], NONE_ORD), NONE_ORD)
                     for k in range(S)], 1)             # [nb, S, lanes]
    if e is not None:
        e = torch.stack([blocks(e[k], _INF) for k in range(S)], 1)
    rays = [blocks(c, 0.0) for c in (ori.x, ori.y, ori.z, d.x, d.y, d.z)]
    inv = [safe_inv(c) for c in rays[3:]]
    bt = torch.clamp_max(tm, FLT_MAX)
    budget = bt
    brow = torch.full((nb, lanes), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((nb, lanes), device=dev)
    bv = torch.zeros((nb, lanes), device=dev)
    cur = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    none = torch.tensor(NONE_ORD, dtype=torch.int32, device=dev)
    max_rows = sweep.max_chunks * rpc
    inf = torch.tensor(float("inf"), device=dev)
    gbox = (sweep.group_boxes.reshape(sweep.num_treelets, 8, 8) if galign
            else None)
    groups = torch.arange(8, device=dev)[None, :, None]
    bchunk = max(1, (1 << 24) // (max_rows * lanes))
    while True:
        demand = o > cur[:, None, None]
        if e is not None:
            demand &= e < budget[:, None, :]
        cur = torch.where(demand, o, none).amin(dim=(1, 2))
        act = torch.nonzero(cur < NONE_ORD).squeeze(1)
        if act.numel() == 0:
            break
        for a in range(0, act.numel(), bchunk):
            blk = act[a:a + bchunk]
            rng = sweep.ranges[cur[blk].long()].long()
            start, nchunks = rng[:, 0], rng[:, 1]
            lo = torch.zeros_like(start)
            hi = nchunks * rpc
            rc = lambda c: c[blk][:, None, :]                 # [b, 1, lanes]
            btb = bt[blk]
            if gbox is not None:
                # every lane, dead and padded ones too, slab-tests the
                # treelet's 8 group boxes at its best t
                gb = gbox[cur[blk].long()][:, :, None, :6]    # [b, 8, 1, 6]
                m = _slab(gb, [rc(c) for c in rays[:3]],
                          [rc(c) for c in inv], btb[:, None, :])
                first = torch.where(m, groups, 8).amin(dim=(1, 2))
                last = torch.where(m, groups, -1).amax(dim=(1, 2))
                lo = first * galign * rpc
                hi = torch.minimum((last + 1) * galign, nchunks) * rpc
            R = int(hi.max())
            if R > 0:
                j = torch.arange(R, device=dev)
                row = start[:, None] + j[None, :]                 # [b, R]
                valid = (j[None, :] >= lo[:, None]) & (j[None, :] < hi[:, None])
                tri = sweep.tri_f32[row.clamp(max=sweep.tri_f32.shape[0] - 1)]
                t, u, v, hit = _mt_rows(tri[:, :, None, :],
                                        (rc(rays[0]), rc(rays[1]), rc(rays[2])),
                                        (rc(rays[3]), rc(rays[4]), rc(rays[5])))
                t_m = torch.where(hit & valid[:, :, None]
                                  & (t < btb[:, None, :]), t, inf)
                best, arg = torch.min(t_m, dim=1)   # first minimum: lowest row
                win = best < btb
                pick = lambda a: a.gather(1, arg[:, None, :]).squeeze(1)
                bt[blk] = torch.where(win, best, btb)
                brow[blk] = torch.where(
                    win, pick(row[:, :, None].expand_as(t)), brow[blk])
                bu[blk] = torch.where(win, pick(u), bu[blk])
                bv[blk] = torch.where(win, pick(v), bv[blk])
        # an occluded lane demands nothing more (any-hit mode)
        budget = (torch.where(bt < tm - 1e-3, -FLT_MAX, bt) if any_hit
                  else bt)
    flat = lambda a: a.reshape(-1)[:n]
    brow = flat(brow)
    found = brow >= 0
    ids = sweep.tri_f32[:, 9].to(torch.int32)
    tri = torch.where(found, ids[brow.clamp_min(0)], -1)
    return HitRecord(t=torch.where(found, flat(bt), FLT_MAX), tri=tri,
                     u=torch.where(found, flat(bu), 0.0),
                     v=torch.where(found, flat(bv), 0.0))

