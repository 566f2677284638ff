"""Treelet traversal: K9 `treelet_scan`, K10 `treelet_closest_hit` and
K11 `treelet_scan_multi`, the port's counterparts of the Pallas kernels
in `tpt/bvh/pallas_treelet.py` (:522, :570 and :769). K9 and K10 are the
ray casts of the BVH_TREELET backend; K11, the S-slot candidate scan
through the top tree, is on no render path of tpt (its tests and
benchmarks call it) and gives the sweep pipeline K3's planes.

On CUDA tensors each wrapper launches its hand-written kernel
(`tpt_torch/csrc/treelet.cu`, built with nvcc for sm_90a on first use and
bound with ctypes); on CPU tensors it runs the plain PyTorch version
below. There is no fallback between the two: a CUDA tensor launches the
kernel or raises.

All three walk tpt's super-packets of `group * 1024` consecutive lanes
with one stack per packet, as the TPU kernels do (on the card each runs
a packet as one block of THREADS threads with its lanes' state on chip;
K11 on K9's walk, its slots in registers, shared memory or a global
scratch as `multi_place` says), because what they return depends on the
packet: K9's overflow flag and candidate count (the hybrid easy/hard
split) count every child the packet visits, K11's thr is lowered by
every child its slot window excludes, and K10's packet decides which
treelet it drains next, which decides equal-t ties.
K9 gives each lane its lexicographically nearest (entry t, treelet code)
candidate past the top tree, the candidate's ordinal, an overflow flag
(another candidate existed or may exist) and a candidate count. K10 runs
tpt's round machine (scan the top tree into S slots a lane, drain the
packet-nearest requested treelet, repeat) and returns the closest hit,
from scratch or from a K9 seed. K11 keeps each lane's S nearest
(entry t, ordinal) candidates and thr, as K3 does. The plain versions run the same walks
vectorised over packets ([packets, lanes] state, a [packets, depth] stack
per packet), in the kernels' float32 arithmetic, so kernel and plain
agree bit for bit.

Each call also returns a device int32 count of capped lanes: the live
lanes (t_max > 0) of packets that dropped a push on a full stack, reached
a step cap or, in K10, reached `max_rounds` with work left. tpt drops
these silently; their results are not exact, and callers that measure
require the count to be 0.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from .. import _build
from ..core.vec import Vec3
from ..integrators.intersect import FLT_MAX, HitRecord, safe_inv
from .pack import PacketBVH
from .packet_traverse import HEADERS, NVCC_FLAGS, _mt_rows, _slab
from .sweep import NONE_ORD, _check_rays, _check_stats, _ptr, _slots

NONE_CODE = 0x7FFFFFFF   # empty slot (pallas_treelet.py NONE_CODE)
INT_MIN = -0x80000000
_INF = 3.0e38            # pallas_treelet.py _INF
LANES_PER_GROUP = 1024   # tpt's super-packet: group x 8 x 128 lanes
SCAN_STACK = 256         # K9's stack entries (pallas_treelet.py:499)
NSTACK = 192             # K10's node stack (pallas_traverse.NSTACK_DEPTH)
CSTACK = 1024            # K10's cluster stack (CSTACK_DEPTH)
NODE_POPS = 4            # pops a step (RenderConfig.trav_node_pops)
CLUSTER_POPS = 4         # RenderConfig.trav_cluster_pops
MAX_SLOTS = 8            # slot counts the library instantiates
SLOTS = 4                # tpt's defaults (pallas_treelet.py:563-564)
MAX_ROUNDS = 4096
THREADS = 1024           # K9/K10's threads a packet (csrc/treelet.cu)
SCAN_WAVE = 16           # plain K10: iterations between batched scans

# launches of each CUDA kernel in this process (chip_smoke.py resets and
# reads them around the main path to show the path went through them)
LAUNCHES = {"treelet_scan": 0, "treelet_closest_hit": 0,
            "treelet_scan_multi": 0}

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "treelet.cu")
BUILD_TIMEOUT_S = 600.0


# ---------------------------------------------------------------------------
# CUDA kernels (ctypes)
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load_library("tpt_treelet",
                              [_build.find_nvcc()] + NVCC_FLAGS, [SOURCE],
                              BUILD_TIMEOUT_S, HEADERS)
    if not getattr(lib, "_tpt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tpt_treelet_scan.restype = ctypes.c_int
        lib.tpt_treelet_scan.argtypes = ([p] * 7 + [i, i, p, i, p, p, p, i, i]
                                         + [p] * 8)
        lib.tpt_treelet_closest_hit.restype = ctypes.c_int
        lib.tpt_treelet_closest_hit.argtypes = (
            [p] * 7 + [i, i, i, i] + [p] * 3 + [p, i, p, i, p, i, i]
            + [p, i, p, p, i, i] + [p] * 8)
        lib.tpt_treelet_closest_scratch.restype = ctypes.c_int
        lib.tpt_treelet_closest_scratch.argtypes = [i, i]
        lib.tpt_treelet_attributes.restype = ctypes.c_int
        lib.tpt_treelet_attributes.argtypes = [i, i, i, p]
        lib.tpt_treelet_scan_multi.restype = ctypes.c_int
        lib.tpt_treelet_scan_multi.argtypes = ([p] * 7 + [i, i, i, i, p, i, p,
                                                p, i, i] + [p] * 7)
        lib.tpt_treelet_scan_multi_place.restype = ctypes.c_int
        lib.tpt_treelet_scan_multi_place.argtypes = [i, i]
        for name in ("tpt_treelet_max_slots", "tpt_treelet_threads"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        if lib.tpt_treelet_max_slots() != MAX_SLOTS or \
                lib.tpt_treelet_threads() != THREADS:
            raise RuntimeError("treelet.cu MAX_SLOTS/THREADS differ from "
                               "treelet_traverse's")
        lib._tpt_bound = True
    return lib


def build_kernels() -> None:
    """Compile and load the CUDA library now (otherwise at first launch)."""
    _lib()


def kernel_attributes(kernel: int, group: int = 2, slots: int = SLOTS) -> dict:
    """Registers a thread, local (spill) bytes a thread, static and
    dynamic shared bytes a block (at `group` * 1024 lanes a packet) and
    the most threads a block of K9, K10 or K11 (`kernel` 9, 10 or 11) for
    `slots` slots, as compiled."""
    out = (ctypes.c_int * 5)()
    rc = _lib().tpt_treelet_attributes(kernel, group, slots,
                                       ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {rc}")
    return dict(regs=out[0], local_bytes=out[1], shared_bytes=out[2],
                dynamic_shared_bytes=out[3], threads=out[4])


def _packet(group: int) -> int:
    if not 1 <= group <= 8:
        raise ValueError(f"group must be in 1..8, got {group}")
    return LANES_PER_GROUP * group


def _check_pack(pack: PacketBVH, dev, wide: bool) -> None:
    if pack.top_f32 is None:
        raise ValueError("BVH_TREELET needs treelet tables "
                         "(bvh.treelet.attach_treelets)")
    if pack.arity not in (4, 8):
        raise ValueError(f"the treelet kernels need an arity-4/8 pack, got "
                         f"{pack.arity}")
    tabs = [(pack.top_f32, torch.float32, None),
            (pack.top_child, torch.int32, 16), (pack.top_tref, torch.int32, 8),
            (pack.top_tord, torch.int32, 8)]
    if wide:
        tabs += [(pack.node_f32, torch.float32, None),
                 (pack.node_child, torch.int32, 16),
                 (pack.tri_f32, torch.float32, 16)]
    for a, dtype, width in tabs:
        if a.device != dev or a.dtype != dtype or a.dim() != 2 \
                or not a.is_contiguous() or (width and a.shape[1] != width):
            raise ValueError("pack tables must be contiguous 2-D tensors of "
                             "the wide/treelet layout on the rays' device")
    if pack.top_f32.shape[1] < 6 * pack.arity or \
            pack.top_f32.shape[0] != pack.num_top:
        raise ValueError("top tables do not match num_top and the arity")
    if wide and (pack.node_f32.shape[0] != pack.num_nodes
                 or pack.node_f32.shape[1] < 6 * pack.arity
                 or pack.tri_f32.shape[0] < pack.max_cluster):
        raise ValueError("pack tables do not have the wide layout")


def _run(name: str, dev: torch.device, *args) -> None:
    _build.launch(_lib, LAUNCHES, name, dev, *args)


def _rays(ori: Vec3, d: Vec3, t_max: torch.Tensor):
    return [_ptr(a) for a in (ori.x, ori.y, ori.z, d.x, d.y, d.z, t_max)]


def _top(pack: PacketBVH):
    return [_ptr(pack.top_f32), pack.top_f32.shape[1], _ptr(pack.top_child),
            _ptr(pack.top_tref)]


def treelet_scan(pack: PacketBVH, ori: Vec3, d: Vec3, t_max: torch.Tensor,
                 group: int = 2, stats: Optional[torch.Tensor] = None):
    """K9: per lane (entry t f32, treelet code, ordinal, overflow, count)
    int32 [n] planes over super-packets of group * 1024 lanes, and the
    capped count. Dead lanes (t_max <= 0) get NONE_CODE, overflow 0 and
    count 0. `stats`, an int64 [2] CUDA tensor, collects (top node pops
    summed over packets, slab tests)."""
    n = _check_rays(ori, d, t_max)
    dev = t_max.device
    _check_pack(pack, dev, wide=False)
    L = _packet(group)
    if dev.type == "cpu":
        return treelet_scan_plain(pack, ori, d, t_max, group=group)
    _check_stats(stats, dev, 2)
    st = torch.empty(n, dtype=torch.float32, device=dev)
    sc, so, ovf, cnt = (torch.empty(n, dtype=torch.int32, device=dev)
                        for _ in range(4))
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        _run("treelet_scan", dev, *_rays(ori, d, t_max), n, L, *_top(pack),
             _ptr(pack.top_tord), pack.num_top, pack.arity, _ptr(st),
             _ptr(sc), _ptr(so), _ptr(ovf), _ptr(cnt), _ptr(capped),
             _ptr(stats))
    return st, sc, so, ovf, cnt, capped


def treelet_scan_multi(pack: PacketBVH, ori: Vec3, d: Vec3,
                       t_max: torch.Tensor, slots: int = SLOTS,
                       node_pops: int = NODE_POPS, group: int = 2,
                       stats: Optional[torch.Tensor] = None):
    """K11: (entry t [S, n] f32 ascending, ordinal [S, n] int32, NONE_ORD
    where empty, thr [n] f32, capped) over super-packets of group * 1024
    lanes: K3's contract through the top tree, with thr a lower bound on
    every candidate the slots do not hold (3e38: the slots are
    exhaustive). Dead lanes (t_max <= 0) get empty slots and thr 3e38.
    `stats`, an int64 [2] CUDA tensor, collects (top node pops summed
    over packets, slab tests)."""
    S = _slots(slots, MAX_SLOTS)
    if node_pops < 1:
        raise ValueError(f"node_pops must be >= 1, got {node_pops}")
    n = _check_rays(ori, d, t_max)
    dev = t_max.device
    _check_pack(pack, dev, wide=False)
    L = _packet(group)
    if dev.type == "cpu":
        return treelet_scan_multi_plain(pack, ori, d, t_max, slots=S,
                                        node_pops=node_pops, group=group)
    _check_stats(stats, dev, 2)
    s_t = torch.empty((S, n), dtype=torch.float32, device=dev)
    s_o = torch.empty((S, n), dtype=torch.int32, device=dev)
    thr = torch.empty(n, dtype=torch.float32, device=dev)
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        scratch = None
        if multi_place(group, S) == "scratch":
            scratch = torch.empty((-(-n // L), 2 * S + 1, L),
                                  dtype=torch.float32, device=dev)
        _run("treelet_scan_multi", dev, *_rays(ori, d, t_max), n, L, S,
             node_pops, _ptr(pack.top_f32), pack.top_f32.shape[1],
             _ptr(pack.top_child), _ptr(pack.top_tord), pack.num_top,
             pack.arity, _ptr(scratch), _ptr(s_t), _ptr(s_o), _ptr(thr),
             _ptr(capped), _ptr(stats))
    return s_t, s_o, thr, capped


MULTI_PLACES = ("registers", "shared", "scratch")


def multi_place(group: int, slots: int) -> str:
    """Where K11 keeps its lanes' slots and thr at `group` * 1024 lanes a
    packet and `slots` slots, as the library decides: "registers",
    "shared" (dynamic shared memory) or "scratch" (a global scratch per
    packet)."""
    place = _lib().tpt_treelet_scan_multi_place(_packet(group),
                                                _slots(slots, MAX_SLOTS))
    if place < 0:
        raise ValueError(f"K11 takes no packet of group {group} with "
                         f"{slots} slots")
    return MULTI_PLACES[place]


def _check_seed(seed, n: int, dev):
    st, sc, ovf = seed
    for a, dtype in ((st, torch.float32), (sc, torch.int32),
                     (ovf, torch.int32)):
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != (n,) \
                or not a.is_contiguous():
            raise ValueError("seed must be contiguous (float32, int32, int32) "
                             "[N] tensors on the rays' device")
    return st, sc, ovf


def treelet_closest_hit(pack: PacketBVH, ori: Vec3, d: Vec3,
                        t_max: torch.Tensor, group: int = 2,
                        slots: int = SLOTS, max_rounds: int = MAX_ROUNDS,
                        seed=None, stats: Optional[torch.Tensor] = None
                        ) -> Tuple[HitRecord, torch.Tensor]:
    """K10: closest hit (t, tri, u, v) with t < t_max over super-packets of
    group * 1024 lanes; `seed` = (entry t, code, overflow) [n] from K9,
    already in pool order, starts each lane at its K9 candidate. Returns
    (HitRecord, capped). `stats`, an int64 [6] CUDA tensor, collects (node
    pops, slab tests, triangle tests, drain rounds, scan rounds, most
    drain rounds of one packet)."""
    S = _slots(slots, MAX_SLOTS)
    n = _check_rays(ori, d, t_max)
    dev = t_max.device
    _check_pack(pack, dev, wide=True)
    L = _packet(group)
    if seed is not None:
        seed = _check_seed(seed, n, dev)
    if dev.type == "cpu":
        return treelet_closest_hit_plain(pack, ori, d, t_max, group=group,
                                         slots=S, max_rounds=max_rounds,
                                         seed=seed)
    _check_stats(stats, dev, 6)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        # the lane planes that do not fit in a block's shared memory
        planes = _lib().tpt_treelet_closest_scratch(L, S)
        scratch = torch.empty(max(1, planes * -(-n // L) * L),
                              dtype=torch.float32, device=dev)
        sd = [_ptr(a) for a in seed] if seed is not None else [_ptr(None)] * 3
        _run("treelet_closest_hit", dev, *_rays(ori, d, t_max), n, L, S,
             max_rounds, *sd, _ptr(pack.node_f32), pack.node_f32.shape[1],
             _ptr(pack.node_child), pack.num_nodes, _ptr(pack.tri_f32),
             pack.tri_f32.shape[0], pack.max_cluster, *_top(pack),
             pack.num_top, pack.arity, _ptr(scratch), _ptr(t),
             _ptr(tri), _ptr(u), _ptr(v), _ptr(capped), _ptr(stats))
    return HitRecord(t=t, tri=tri, u=u, v=v), capped


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same packet walks, vectorised over packets
# ---------------------------------------------------------------------------

def _tiles(ori: Vec3, d: Vec3, t_max: torch.Tensor, L: int):
    """[P, L] planes of the rays, padded as tpt pads (t_max -1, zeros)."""
    n = t_max.shape[0]
    P = max(1, -(-n // L))
    pad = P * L - n

    def tile(a, fill):
        if pad:
            a = torch.cat([a, a.new_full((pad,), fill)])
        return a.reshape(P, L)

    o = tuple(tile(c, 0.0) for c in (ori.x, ori.y, ori.z))
    dd = tuple(tile(c, 0.0) for c in (d.x, d.y, d.z))
    return o, dd, tile(t_max, -1.0), tile


def _lex_lt(t_a, c_a, t_b, c_b):
    return (t_a < t_b) | ((t_a == t_b) & (c_a < c_b))


def _octant(dd) -> torch.Tensor:
    """[P] octant of each packet's first lane (pallas_traverse.py:465)."""
    return ((dd[0][:, 0] >= 0).long() * 4 + (dd[1][:, 0] >= 0).long() * 2
            + (dd[2][:, 0] >= 0).long())


def _pop(stack: torch.Tensor, sp: torch.Tensor):
    has = sp > 0
    top = stack.gather(1, (sp - 1).clamp_min(0)[:, None]).squeeze(1)
    return torch.where(has, top, -1), sp - has.long()


def _push(stack: torch.Tensor, sp: torch.Tensor, vals: torch.Tensor,
          want: torch.Tensor, depth: int):
    """Push vals [P, M] where want, column by column; a push that finds
    the stack full (sp >= depth) is dropped, as are all after it. Returns
    (sp, dropped [P])."""
    w = want.long()
    pos = sp[:, None] + torch.cumsum(w, 1) - w
    do = want & (pos < depth)
    stack.scatter_(1, torch.where(do, pos, depth + 1),
                   torch.where(do, vals, 0))
    return sp + do.sum(1), (want & ~do).any(1)


def _ordered(codes: torch.Tensor, anyh: torch.Tensor, ordw: torch.Tensor,
             A: int):
    """Children of popped nodes in push order (far to near by the order
    word): codes, anyh [..., A], ordw [...] -> (child code, some lane
    keeps it) [..., A]."""
    pos = torch.arange(A - 1, -1, -1, device=codes.device)
    slot = (ordw[..., None] >> (4 * pos)) & 15
    ok = slot < A
    sl = slot.clamp(max=A - 1)
    csel = torch.where(ok, codes.gather(-1, sl), -1)
    return csel, ok & anyh.gather(-1, sl)


def _live_capped(inexact: torch.Tensor, tm: torch.Tensor) -> torch.Tensor:
    return ((tm > 0) & inexact[:, None]).sum().to(torch.int32)


def treelet_scan_plain(pack: PacketBVH, ori: Vec3, d: Vec3,
                       t_max: torch.Tensor, group: int = 2):
    """Plain K9 (any device): tpt's top-tree walk, one stack per packet,
    all packets at once."""
    n = _check_rays(ori, d, t_max)
    dev = t_max.device
    _check_pack(pack, dev, wide=False)
    L = _packet(group)
    A = pack.arity
    o, dd, tm, _ = _tiles(ori, d, t_max, L)
    P = tm.shape[0]
    inf = torch.tensor(_INF, device=dev)
    bt = torch.minimum(tm, inf)
    inv = tuple(safe_inv(c) for c in dd)
    octant = _octant(dd)
    top_child = pack.top_child.long()
    tref, tord = pack.top_tref.long(), pack.top_tord.long()
    s_t = torch.full((P, L), _INF, device=dev)
    s_c = torch.full((P, L), NONE_CODE, dtype=torch.int64, device=dev)
    s_o = torch.zeros((P, L), dtype=torch.int64, device=dev)
    ovf = torch.zeros((P, L), dtype=torch.bool, device=dev)
    cnt = torch.zeros((P, L), dtype=torch.int64, device=dev)
    stack = torch.zeros((P, SCAN_STACK + 2), dtype=torch.int64, device=dev)
    sp = (bt.amax(1) > 0).long()      # jnp.max: NaN anywhere -> no walk
    inexact = torch.zeros(P, dtype=torch.bool, device=dev)
    cap = 8 * pack.num_top + 1024
    step = 0
    while bool((sp > 0).any()):
        if step >= cap:
            inexact |= sp > 0
            break
        step += 1
        for _ in range(NODE_POPS):
            code, sp = _pop(stack, sp)
            vp = (code >= 0)[:, None]
            nid = code.clamp(0, pack.num_top - 1)
            row, crow = pack.top_f32[nid], top_child[nid]
            trow, orow = tref[nid], tord[nid]
            anyh = []
            for s in range(A):
                hit, tn = _slab(row[:, None, 6 * s:6 * s + 6], o, inv, bt,
                                entry=True)
                kept = tn <= s_t
                internal = (crow[:, s] >= 0)[:, None]
                cand = hit & (tn < bt) & vp & ~internal
                valid = cand & kept
                cnt += cand
                ovf |= (cand & ~kept) | (hit & ~kept & vp & internal)
                cur_t = torch.where(valid, tn, inf)
                cur_c = torch.where(valid, trow[:, s:s + 1], NONE_CODE)
                cur_o = torch.where(valid, orow[:, s:s + 1], 0)
                swap = _lex_lt(cur_t, cur_c, s_t, s_c)
                s_t = torch.where(swap, cur_t, s_t)
                ovf |= torch.where(swap, s_c, cur_c) != NONE_CODE
                s_c = torch.where(swap, cur_c, s_c)
                s_o = torch.where(swap, cur_o, s_o)
                anyh.append((hit & kept & internal & vp).any(1))
            ordw = crow.gather(1, 8 + octant[:, None]).squeeze(1)
            csel, hsel = _ordered(crow[:, :A], torch.stack(anyh, 1), ordw, A)
            sp, dropped = _push(stack, sp, csel, hsel & (csel >= 0),
                                SCAN_STACK)
            inexact |= dropped
    flat = lambda a, dt: a.reshape(-1)[:n].to(dt).contiguous()
    i32 = torch.int32
    return (flat(s_t, torch.float32), flat(s_c, i32), flat(s_o, i32),
            flat(ovf, i32), flat(cnt, i32), _live_capped(inexact, tm))


def treelet_scan_multi_plain(pack: PacketBVH, ori: Vec3, d: Vec3,
                             t_max: torch.Tensor, slots: int = SLOTS,
                             node_pops: int = NODE_POPS, group: int = 2):
    """Plain K11 (any device): K9's walk keeping S slots and thr per
    lane, one stack per packet, all packets at once."""
    S = _slots(slots, MAX_SLOTS)
    n = _check_rays(ori, d, t_max)
    dev = t_max.device
    _check_pack(pack, dev, wide=False)
    L = _packet(group)
    A = pack.arity
    o, dd, tm, _ = _tiles(ori, d, t_max, L)
    P = tm.shape[0]
    inf = torch.tensor(_INF, device=dev)
    bt = torch.minimum(tm, inf)
    inv = tuple(safe_inv(c) for c in dd)
    octant = _octant(dd)
    top_child = pack.top_child.long()
    tord = pack.top_tord.long()
    s_t = [torch.full((P, L), _INF, device=dev) for _ in range(S)]
    s_o = [torch.full((P, L), NONE_ORD, dtype=torch.int64, device=dev)
           for _ in range(S)]
    thr = torch.full((P, L), _INF, device=dev)
    stack = torch.zeros((P, SCAN_STACK + 2), dtype=torch.int64, device=dev)
    sp = (bt.amax(1) > 0).long()      # jnp.max: NaN anywhere -> no walk
    inexact = torch.zeros(P, dtype=torch.bool, device=dev)
    cap = 8 * pack.num_top + 1024
    step = 0
    while bool((sp > 0).any()):
        if step >= cap:
            inexact |= sp > 0
            break
        step += 1
        for _ in range(node_pops):
            code, sp = _pop(stack, sp)
            vp = (code >= 0)[:, None]
            nid = code.clamp(0, pack.num_top - 1)
            row, crow, orow = pack.top_f32[nid], top_child[nid], tord[nid]
            anyh = []
            for s in range(A):
                hit, tn = _slab(row[:, None, 6 * s:6 * s + 6], o, inv, bt,
                                entry=True)
                kept = tn <= s_t[S - 1]
                internal = (crow[:, s] >= 0)[:, None]
                cand = hit & (tn < bt) & vp & ~internal
                # anything the slot window excludes lower-bounds thr
                excl = (cand | (hit & vp & internal)) & ~kept
                thr = torch.where(excl, torch.minimum(thr, tn), thr)
                valid = cand & kept
                cur_t = torch.where(valid, tn, inf)
                cur_o = torch.where(valid, orow[:, s:s + 1], NONE_ORD)
                for q in range(S):
                    swap = _lex_lt(cur_t, cur_o, s_t[q], s_o[q])
                    s_t[q], cur_t = (torch.where(swap, cur_t, s_t[q]),
                                     torch.where(swap, s_t[q], cur_t))
                    s_o[q], cur_o = (torch.where(swap, cur_o, s_o[q]),
                                     torch.where(swap, s_o[q], cur_o))
                # the displaced slot (or the uninserted candidate)
                thr = torch.where(cur_o != NONE_ORD, torch.minimum(thr, cur_t),
                                  thr)
                anyh.append((hit & kept & internal & vp).any(1))
            ordw = crow.gather(1, 8 + octant[:, None]).squeeze(1)
            csel, hsel = _ordered(crow[:, :A], torch.stack(anyh, 1), ordw, A)
            sp, dropped = _push(stack, sp, csel, hsel & (csel >= 0),
                                SCAN_STACK)
            inexact |= dropped
    flat = lambda a: a.reshape(-1)[:n]
    return (torch.stack([flat(a) for a in s_t]).contiguous(),
            torch.stack([flat(a) for a in s_o]).to(torch.int32).contiguous(),
            flat(thr).contiguous(), _live_capped(inexact, tm))


class _Lanes:
    """K10's per-lane state, [P, L] planes ([S, P, L] for the slots), and
    its per-packet flags."""

    def __init__(self, pack, o, dd, tm, S):
        dev = tm.device
        P, L = tm.shape
        self.pack, self.S, self.A = pack, S, pack.arity
        self.o, self.d = o, dd
        self.inv = tuple(safe_inv(c) for c in dd)
        self.tm = tm
        self.inf = torch.tensor(_INF, device=dev)
        self.bt = torch.minimum(tm, self.inf)
        self.btri = torch.full((P, L), -1, dtype=torch.int64, device=dev)
        self.bu = torch.zeros((P, L), device=dev)
        self.bv = torch.zeros((P, L), device=dev)
        self.s_t = torch.full((S, P, L), _INF, device=dev)
        self.s_c = torch.full((S, P, L), NONE_CODE, dtype=torch.int64,
                              device=dev)
        self.thr_t = torch.full((P, L), -_INF, device=dev)
        self.thr_c = torch.full((P, L), INT_MIN, dtype=torch.int64, device=dev)
        self.exh = torch.zeros((P, L), dtype=torch.int64, device=dev)
        self.octant = _octant(dd)
        self.inexact = torch.zeros(P, dtype=torch.bool, device=dev)
        self.top_child = pack.top_child.long()
        self.tref = pack.top_tref.long()
        self.node_child = pack.node_child.long()

    def slot0_valid(self):
        return (self.s_c[0] != NONE_CODE) & (self.s_t[0] < self.bt)

    def needs_scan(self):
        return ((self.s_c[0] == NONE_CODE) & (self.exh == 0)
                & (self.thr_t < self.bt))


def _insert(s_t, s_c, cur_t, cur_c):
    """tpt's compare-swap cascade of (cur_t, cur_c) [P, L] into the
    ascending slots [S, P, L], done at once: the entry goes to the first
    slot it precedes, the later ones move down one, and the last falls out
    (returned code; NONE_CODE if nothing fell out). The cascade gives the
    same slots because a lane's real entries are distinct and ascending
    and its empty ones all equal (entry t _INF, NONE_CODE)."""
    lt = _lex_lt(cur_t, cur_c, s_t, s_c)
    prev = torch.cat((torch.zeros_like(lt[:1]), lt[:-1]))
    new_t = torch.where(prev, torch.cat((s_t[:1], s_t[:-1])),
                        torch.where(lt, cur_t, s_t))
    new_c = torch.where(prev, torch.cat((s_c[:1], s_c[:-1])),
                        torch.where(lt, cur_c, s_c))
    return new_t, new_c, torch.where(lt[-1], s_c[-1], cur_c)


def _scan_round(st: _Lanes, part: torch.Tensor) -> None:
    """A SCAN round of the packets in `part` (pallas_treelet.py:115-218)."""
    pack, S, A = st.pack, st.S, st.A
    P = part.shape[0]
    dev = part.device
    scan_mask = part[:, None] & st.needs_scan()
    limit = torch.where(scan_mask, st.bt, -1.0)
    ovf = torch.zeros_like(scan_mask)
    stack = torch.zeros((P, NSTACK + 2), dtype=torch.int64, device=dev)
    sp = part.long()                  # the top root, row 0
    cap = 8 * pack.num_top + 1024
    s_t, s_c = st.s_t, st.s_c
    o3 = tuple(c[:, None, :] for c in st.o)
    inv3 = tuple(c[:, None, :] for c in st.inv)
    step = 0
    while bool((sp > 0).any()):
        if step >= cap:
            st.inexact |= sp > 0
            break
        step += 1
        for _ in range(NODE_POPS):
            code, sp = _pop(stack, sp)
            vp = (code >= 0)[:, None]
            nid = code.clamp(0, pack.num_top - 1)
            row, crow = pack.top_f32[nid], st.top_child[nid]
            trow = st.tref[nid]
            # every child's slab test at once; a lane of an empty pop
            # tests nothing
            hits, tns = _slab(row[:, :6 * A].reshape(P, A, 1, 6), o3, inv3,
                              limit[:, None, :], entry=True)
            hits = hits & vp[:, :, None]
            anyh = []
            for s in range(A):
                hit, tn = hits[:, s], tns[:, s]
                kept = tn <= s_t[S - 1]
                internal = (crow[:, s] >= 0)[:, None]
                tcode = trow[:, s:s + 1]
                cand = (hit & (tn < st.bt) & scan_mask & ~internal
                        & ((tn > st.thr_t)
                           | ((tn == st.thr_t) & (tcode > st.thr_c))))
                valid = cand & kept
                ovf |= ((cand & ~kept)
                        | (hit & ~kept & scan_mask & internal))
                s_t, s_c, out = _insert(
                    s_t, s_c, torch.where(valid, tn, st.inf),
                    torch.where(valid, tcode, NONE_CODE))
                ovf |= out != NONE_CODE
                anyh.append((hit & kept & internal).any(1))
            ordw = crow.gather(1, 8 + st.octant[:, None]).squeeze(1)
            csel, hsel = _ordered(crow[:, :A], torch.stack(anyh, 1), ordw, A)
            sp, dropped = _push(stack, sp, csel, hsel & (csel >= 0), NSTACK)
            st.inexact |= dropped
    st.s_t, st.s_c = s_t, s_c
    full = s_c[S - 1] != NONE_CODE
    st.thr_t = torch.where(scan_mask & full, s_t[S - 1], st.thr_t)
    st.thr_c = torch.where(scan_mask & full, s_c[S - 1], st.thr_c)
    st.exh = torch.where(scan_mask, (~ovf).long(), st.exh)


def _drain_clusters(st: _Lanes, cval: torch.Tensor) -> None:
    """Every lane of each packet tests the popped clusters cval [P, 4] in
    order with a strict t < best: the first triangle of the least t."""
    pack = st.pack
    K = pack.max_cluster
    rows = pack.tri_f32.shape[0]
    dev = cval.device
    count = torch.clamp_max(cval % 256, K)
    start = (cval // 256).clamp(0, rows - K)
    j = torch.arange(K, device=dev)
    valid = (j < count[..., None]).reshape(cval.shape[0], -1)      # [P, 4K]
    idx = (start[..., None] + j).clamp(0, rows - 1).reshape(cval.shape[0], -1)
    P, L = st.bt.shape
    chunk = max(1, (1 << 23) // (valid.shape[1] * L))
    for a in range(0, P, chunk):
        pk = slice(a, a + chunk)
        tri = pack.tri_f32[idx[pk]]                           # [b, 4K, 16]
        lane = lambda c: c[pk][:, None, :]
        t, u, v, hit = _mt_rows(tri[:, :, None, :],
                                tuple(lane(c) for c in st.o),
                                tuple(lane(c) for c in st.d))
        bt = st.bt[pk]
        hit = hit & valid[pk][:, :, None] & (t < bt[:, None, :])
        best, arg = torch.min(torch.where(hit, t, float("inf")), dim=1)
        win = best < bt
        pick = lambda x: x.gather(1, arg[:, None, :]).squeeze(1)
        ids = tri[:, :, 9].to(torch.int32).long().gather(1, arg)
        st.bt[pk] = torch.where(win, best, bt)
        st.btri[pk] = torch.where(win, ids, st.btri[pk])
        st.bu[pk] = torch.where(win, pick(u), st.bu[pk])
        st.bv[pk] = torch.where(win, pick(v), st.bv[pk])


def _drain_round(st: _Lanes, part: torch.Tensor) -> None:
    """A DRAIN round of the packets in `part` (pallas_treelet.py:223-331)."""
    pack, A = st.pack, st.A
    P = part.shape[0]
    dev = part.device
    v0 = st.slot0_valid()
    min_t = torch.where(v0, st.s_t[0], st.inf).amin(1)
    root = torch.where(v0 & (st.s_t[0] == min_t[:, None]), st.s_c[0],
                       NONE_CODE).amin(1)
    root = torch.where(part, root, -1)   # -1: a code no slot holds
    nstack = torch.zeros((P, NSTACK + 2), dtype=torch.int64, device=dev)
    cstack = torch.zeros((P, CSTACK + 2), dtype=torch.int64, device=dev)
    nstack[:, 0] = root
    cstack[:, 0] = -(root + 1)
    nsp = (part & (root >= 0)).long()
    csp = (part & (root < 0)).long()
    max_steps = 8 * pack.num_nodes + 8192
    cmargin = CSTACK - NODE_POPS * A - 1
    k = torch.arange(NODE_POPS, device=dev)
    kc = torch.arange(CLUSTER_POPS, device=dev)
    o3 = tuple(c[:, None, :] for c in st.o)
    inv3 = tuple(c[:, None, :] for c in st.inv)
    step = 0
    while True:
        if step >= max_steps:
            st.inexact |= (nsp > 0) | (csp > 0)
            break
        allow = csp < cmargin
        nhas = allow[:, None] & (nsp[:, None] > k)
        ncode = torch.where(nhas, nstack.gather(
            1, (nsp[:, None] - 1 - k).clamp_min(0)), -1)          # [P, 4]
        nsp = torch.where(allow, (nsp - NODE_POPS).clamp_min(0), nsp)
        chas = csp[:, None] > kc
        cval = torch.where(chas, cstack.gather(
            1, (csp[:, None] - 1 - kc).clamp_min(0)), 0)
        csp = (csp - CLUSTER_POPS).clamp_min(0)
        # one host sync a step: popping nothing means every stack was
        # empty, and the round is over
        any_c, any_n = torch.stack([(cval > 0).any(),
                                    (ncode >= 0).any()]).tolist()
        if not (any_c or any_n):
            break
        step += 1
        if any_c:
            _drain_clusters(st, cval)
        if not any_n:
            continue
        nid = ncode.clamp(0, pack.num_nodes - 1)
        row, crow = pack.node_f32[nid], st.node_child[nid]       # [P, 4, .]
        boxes = torch.stack([row[..., 6 * s:6 * s + 6] for s in range(A)],
                            2).reshape(P, NODE_POPS * A, 6)
        hit = _slab(boxes[:, :, None], o3, inv3, st.bt[:, None, :])
        hit = hit & (ncode >= 0).repeat_interleave(A, 1)[:, :, None]
        anyh = hit.any(2).reshape(P, NODE_POPS, A)
        ordw = crow.gather(2, (8 + st.octant)[:, None, None].expand(
            P, NODE_POPS, 1)).squeeze(2)
        csel, hsel = _ordered(crow[..., :A], anyh, ordw, A)
        csel, hsel = csel.reshape(P, -1), hsel.reshape(P, -1)
        cpush = -(csel + 1)
        nsp, d1 = _push(nstack, nsp, csel, hsel & (csel >= 0), NSTACK)
        csp, d2 = _push(cstack, csp, cpush, hsel & (csel < 0) & (cpush > 0),
                        CSTACK)
        st.inexact |= d1 | d2
    # consume the drained slot: from the match on, each slot takes its
    # successor's entry
    shifted = torch.cumsum(st.s_c == root[None, :, None], 0) > 0
    st.s_t = torch.where(shifted, torch.cat(
        (st.s_t[1:], st.inf.expand(1, P, st.s_t.shape[2]))), st.s_t)
    st.s_c = torch.where(shifted, torch.cat(
        (st.s_c[1:], torch.full_like(st.s_c[:1], NONE_CODE))), st.s_c)


def treelet_closest_hit_plain(pack: PacketBVH, ori: Vec3, d: Vec3,
                              t_max: torch.Tensor, group: int = 2,
                              slots: int = SLOTS,
                              max_rounds: int = MAX_ROUNDS, seed=None
                              ) -> Tuple[HitRecord, torch.Tensor]:
    """Plain K10 (any device): tpt's round machine for all packets at
    once."""
    S = _slots(slots, MAX_SLOTS)
    n = _check_rays(ori, d, t_max)
    dev = t_max.device
    _check_pack(pack, dev, wide=True)
    L = _packet(group)
    o, dd, tm, tile = _tiles(ori, d, t_max, L)
    st = _Lanes(pack, o, dd, tm, S)
    if seed is not None:
        sd_t, sd_c, sd_ovf = _check_seed(seed, n, dev)
        sd_t = tile(sd_t, _INF)
        sd_c = tile(sd_c.long(), NONE_CODE)
        st.exh = tile(1 - sd_ovf.long(), 1)
        valid = (sd_c != NONE_CODE) & (sd_t < st.bt)
        st.s_t[0] = torch.where(valid, sd_t, st.inf)
        st.s_c[0] = torch.where(valid, sd_c, NONE_CODE)
        st.thr_t = torch.where(valid, sd_t, -_INF)
        st.thr_c = torch.where(valid, sd_c, INT_MIN)
        drain = valid.any(1)
        need = (~valid & (st.exh == 0) & (st.bt > 0)).any(1)
        done = ~drain & ~need
    else:
        done = st.bt.amax(1) <= 0
        drain = torch.zeros_like(done)
    # A packet's rounds touch no other packet, so packets need not run
    # them in step: a SCAN round (a walk of the whole top tree, the
    # costliest round here) runs for every packet waiting for one at once,
    # when no packet drains or at most every SCAN_WAVE iterations
    rounds = torch.zeros(done.shape, dtype=torch.int64, device=dev)
    it = 0
    while True:
        over = ~done & (rounds >= max_rounds)
        st.inexact |= over
        done = done | over
        waiting, draining = ~done & ~drain, ~done & drain
        any_s, any_d = torch.stack([waiting.any(), draining.any()]).tolist()
        if not (any_s or any_d):
            break
        part = torch.zeros_like(done)
        if any_s and (not any_d or it % SCAN_WAVE == 0):
            _scan_round(st, waiting)
            part = waiting
        if any_d:
            _drain_round(st, draining)
            part = part | draining
        rounds += part.long()
        it += 1
        any_slot = st.slot0_valid().any(1)
        need = st.needs_scan().any(1)
        done = torch.where(part, ~any_slot & ~need, done)
        drain = torch.where(part, any_slot, drain)
    flat = lambda a: a.reshape(-1)[:n].contiguous()
    btri = flat(st.btri).to(torch.int32)
    t = torch.where(btri >= 0, flat(st.bt), torch.full_like(flat(st.bt),
                                                           FLT_MAX))
    return (HitRecord(t=t, tri=btri, u=flat(st.bu), v=flat(st.bv)),
            _live_capped(st.inexact, tm))
