"""Packet-BVH ray casts: K2 `packet_closest_hit_wide` and K1
`packet_any_hit_wide` over the wide (arity-4/8) pack, K8a
`packet_closest_hit` and K8b `packet_any_hit` over the binary (arity-2)
pack; the port's counterparts of the Pallas kernels in
`tpt/bvh/pallas_traverse.py` (:893, :959, :350 and :394).

On CUDA tensors each wrapper launches its hand-written kernel
(`tpt_torch/csrc/packet_wide.cu`, built with nvcc for sm_90a on first
use and bound with ctypes); on CPU tensors it runs the plain PyTorch
version below, which is the same per-ray stack walk written as a
vectorised loop. There is no fallback between the two: a CUDA tensor
launches the kernel or raises.

Both versions walk each ray with its own stack over the same tables, in
the same child order, with the same float32 arithmetic (the kernel is
compiled without multiply-add contraction), so on the same inputs they
give the same bits. Each returns, beside its result, a device int32
count of rays that overflowed their stack or reached the step cap
(8 * num_nodes + 8192 pops for the wide pack, + 4096 for the binary
one, as in the TPU kernels); such a ray's result is not exact, and
callers that measure require the count to be 0.

The wide walk orders a node's children by the ray's direction octant
(the pack's order words). The binary closest hit orders the two children
by the ray's own entry t, where tpt's packet orders them by its 1024
lanes' smallest: the closest t is the same, but an equal-t tie on a
shared edge may name the other triangle. The binary any hit pushes them
in slot order, as tpt does.

Result conventions are `tpt`'s: closest-hit t = FLT_MAX where tri < 0;
any-hit reports lanes with t_max - 1e-3 <= 0 as occluded (dead lanes).
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

STACK_DEPTH = 64     # per-ray stack entries (csrc/packet_wide.cu STACK_DEPTH)
_BIG = 3.0e38        # the TPU kernel's _INF: initial best t

# launches of each CUDA kernel in this process (chip_smoke.py resets and
# reads them around the main path to show the path went through them)
LAUNCHES = {"packet_closest_hit_wide": 0, "packet_any_hit_wide": 0,
            "packet_closest_hit": 0, "packet_any_hit": 0}

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "packet_wide.cu")
HEADERS = [os.path.join(_build.PKG_DIR, "csrc", "ray_common.cuh")]
BUILD_TIMEOUT_S = 600.0
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]


def max_steps(pack: PacketBVH) -> int:
    """Pops a ray may take: the TPU kernels' caps (pallas_traverse.py:567
    for the wide pack, :203 for the binary one)."""
    return 8 * pack.num_nodes + (4096 if pack.arity == 2 else 8192)


# ---------------------------------------------------------------------------
# CUDA kernels (ctypes)
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load_library("tpt_packet_wide",
                              [_build.find_nvcc()] + NVCC_FLAGS, [SOURCE],
                              BUILD_TIMEOUT_S, HEADERS)
    if not getattr(lib, "_tpt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        common = [p] * 7 + [i, p, i, p, i, p, i, i, i]
        for suffix in ("_wide", ""):
            closest = getattr(lib, "tpt_packet_closest_hit" + suffix)
            closest.restype = ctypes.c_int
            closest.argtypes = common + [p] * 7
            any_hit = getattr(lib, "tpt_packet_any_hit" + suffix)
            any_hit.restype = ctypes.c_int
            any_hit.argtypes = common + [p] * 4
        lib.tpt_packet_wide_attributes.restype = ctypes.c_int
        lib.tpt_packet_wide_attributes.argtypes = [i, i, p]
        lib.tpt_stack_depth.restype = ctypes.c_int
        lib.tpt_stack_depth.argtypes = []
        if lib.tpt_stack_depth() != STACK_DEPTH:
            raise RuntimeError("packet_wide.cu STACK_DEPTH differs from "
                               "packet_traverse.STACK_DEPTH")
        lib._tpt_bound = True
    return lib


def build_kernels() -> None:
    """Compile and load the CUDA library now (otherwise at first launch)."""
    _lib()


def kernel_attributes(any_hit: bool, arity: int) -> dict:
    """Registers a thread, local bytes a thread, static shared bytes a
    block and the most threads a block of the K2 (K1 with `any_hit`)
    kernel for `arity`, as compiled (without stats)."""
    out = (ctypes.c_int * 4)()
    rc = _lib().tpt_packet_wide_attributes(int(any_hit), arity,
                                           ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {rc}")
    return dict(regs=out[0], local_bytes=out[1], shared_bytes=out[2],
                max_threads=out[3])


def _check(pack: PacketBVH, ori: Vec3, d: Vec3, t_max: torch.Tensor,
           binary: bool = False) -> int:
    """The inputs of a wide (K1/K2) or, with `binary`, a binary (K8a/K8b)
    cast; returns the ray count."""
    n = ori.x.shape[0]
    dev = ori.x.device
    rays = (ori.x, ori.y, ori.z, d.x, d.y, d.z, t_max)
    for a in rays:
        if a.device != dev or a.dtype != torch.float32 or a.dim() != 1 \
                or a.shape[0] != n or not a.is_contiguous():
            raise ValueError("ray inputs must be contiguous float32 [N] "
                             "tensors on one device")
    if binary and pack.arity != 2:
        raise ValueError(f"binary kernels need an arity-2 pack, got {pack.arity}")
    if not binary and pack.arity not in (4, 8):
        raise ValueError(f"wide kernels need an arity-4/8 pack, got {pack.arity}")
    nf, nc, tf = pack.node_f32, pack.node_child, pack.tri_f32
    if (nf.device != dev or nc.device != dev or tf.device != dev):
        raise ValueError(f"pack tables are on {nf.device}, rays on {dev}")
    if (nf.dtype != torch.float32 or nc.dtype != torch.int32
            or tf.dtype != torch.float32):
        raise ValueError("pack tables must be float32/int32/float32")
    if binary:
        if (nf.dim() != 2 or nf.shape[1] != 16
                or tuple(nc.shape) != (nf.shape[0], 2)
                or tf.dim() != 2 or tf.shape[1] != 16
                or nf.shape[0] != pack.num_nodes
                or not 1 <= pack.max_cluster <= min(255, tf.shape[0])):
            raise ValueError("pack tables do not have the binary layout "
                             "(node_f32 [Nt, 16], node_child [Nt, 2], "
                             "tri_f32 [Tp >= max_cluster, 16])")
    elif (nf.dim() != 2 or nf.shape[1] < 6 * pack.arity
            or tuple(nc.shape) != (nf.shape[0], 16)
            or tf.dim() != 2 or tf.shape[1] != 16
            or nf.shape[0] != pack.num_nodes):
        raise ValueError("pack tables do not have the wide layout")
    if not (nf.is_contiguous() and nc.is_contiguous() and tf.is_contiguous()):
        raise ValueError("pack tables must be contiguous")
    return n


def _launch(name: str, pack: PacketBVH, ori: Vec3, d: Vec3,
            t_max: torch.Tensor, outs, capped, stats) -> None:
    n = ori.x.shape[0]
    if n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernels' int32 lane index")
    if stats is not None and (stats.device != ori.x.device
                              or stats.dtype != torch.int64
                              or tuple(stats.shape) != (3,)):
        raise ValueError("stats must be an int64 [3] tensor on the rays' device")
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    args = [ptr(a) for a in (ori.x, ori.y, ori.z, d.x, d.y, d.z, t_max)]
    args += [n, ptr(pack.node_f32), pack.node_f32.shape[1],
             ptr(pack.node_child), pack.num_nodes, ptr(pack.tri_f32),
             pack.tri_f32.shape[0], pack.arity, pack.max_cluster]
    if name.endswith("_wide"):
        # K1/K2 read node rows and triangle rows as float4/int4
        if (pack.node_f32.shape[1] % 4 or any(
                a.data_ptr() % 16 for a in (pack.node_f32, pack.node_child,
                                            pack.tri_f32))):
            raise ValueError("wide kernels need 16-byte aligned tables and "
                             "a node width that is a multiple of 4")
    args += [ptr(o) for o in outs] + [ptr(capped)]
    args.append(ptr(stats) if stats is not None else ctypes.c_void_p(None))
    _build.launch(_lib, LAUNCHES, name, ori.x.device, *args)


def packet_closest_hit_wide(pack: PacketBVH, ori: Vec3, d: Vec3,
                            t_max: torch.Tensor,
                            stats: Optional[torch.Tensor] = None
                            ) -> Tuple[HitRecord, torch.Tensor]:
    """K2: closest hit (t, tri, u, v) with t < t_max. Returns
    (HitRecord, capped int32 count). `stats`, an int64 [3] CUDA tensor,
    collects (node visits, slab tests, triangle tests) for roofline
    accounting."""
    n = _check(pack, ori, d, t_max)
    dev = ori.x.device
    if dev.type == "cpu":
        return closest_hit_wide_plain(pack, ori, d, t_max)
    if dev.type != "cuda":
        raise ValueError(f"no K2 kernel for device {dev}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    _launch("packet_closest_hit_wide", pack, ori, d, t_max,
            (t, tri, u, v), capped, stats)
    return HitRecord(t=t, tri=tri, u=u, v=v), capped


def packet_any_hit_wide(pack: PacketBVH, ori: Vec3, d: Vec3,
                        t_max: torch.Tensor,
                        stats: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: occlusion (bool [N]) by any hit with t < t_max - 1e-3. Returns
    (occluded, capped int32 count); `stats` as for K2."""
    n = _check(pack, ori, d, t_max)
    dev = ori.x.device
    if dev.type == "cpu":
        return any_hit_wide_plain(pack, ori, d, t_max)
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    _launch("packet_any_hit_wide", pack, ori, d, t_max, (occ,), capped, stats)
    return occ, capped


def packet_closest_hit(pack: PacketBVH, ori: Vec3, d: Vec3,
                       t_max: torch.Tensor,
                       stats: Optional[torch.Tensor] = None
                       ) -> Tuple[HitRecord, torch.Tensor]:
    """K8a: closest hit over the binary pack, as K2 over the wide one."""
    n = _check(pack, ori, d, t_max, binary=True)
    dev = ori.x.device
    if dev.type == "cpu":
        return closest_hit_plain(pack, ori, d, t_max)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    _launch("packet_closest_hit", pack, ori, d, t_max, (t, tri, u, v),
            capped, stats)
    return HitRecord(t=t, tri=tri, u=u, v=v), capped


def packet_any_hit(pack: PacketBVH, ori: Vec3, d: Vec3, t_max: torch.Tensor,
                   stats: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8b: occlusion over the binary pack, as K1 over the wide one."""
    n = _check(pack, ori, d, t_max, binary=True)
    dev = ori.x.device
    if dev.type == "cpu":
        return any_hit_plain(pack, ori, d, t_max)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    capped = torch.zeros((), dtype=torch.int32, device=dev)
    _launch("packet_any_hit", pack, ori, d, t_max, (occ,), capped, stats)
    return occ, capped


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same walk, vectorised over rays
# ---------------------------------------------------------------------------

def _slab(box: torch.Tensor, o, inv, limit, entry: bool = False):
    """Slab test of boxes box [..., 6] (min xyz, max xyz) against rays o,
    inv (x, y, z), each box[..., c] broadcast against them; the hit mask,
    or (hit, entry t) when `entry`. NaN-propagating, as jnp's min/max."""
    t0x = (box[..., 0] - o[0]) * inv[0]
    t0y = (box[..., 1] - o[1]) * inv[1]
    t0z = (box[..., 2] - o[2]) * inv[2]
    t1x = (box[..., 3] - o[0]) * inv[0]
    t1y = (box[..., 4] - o[1]) * inv[1]
    t1z = (box[..., 5] - o[2]) * inv[2]
    zero = torch.zeros((), device=box.device)
    tn = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.maximum(torch.minimum(t0z, t1z), zero))
    tf = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.minimum(torch.maximum(t0z, t1z), limit))
    return (tn <= tf, tn) if entry else tn <= tf


def _mt_rows(rows: torch.Tensor, o, d):
    """Möller–Trumbore of tri_f32 rows [k, K, 16] against per-ray (x, y,
    z) [k, 1] columns, in the kernel's operation order."""
    v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() > 1e-9
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    return t, u, v, hit


def _walk(pack: PacketBVH, ori: Vec3, d: Vec3, t_max: torch.Tensor,
          any_hit: bool):
    """The per-ray stack walk of the four kernels (the pack's arity picks
    the wide or the binary rule), one pop per live ray per iteration.
    Returns (bt, btri, bu, bv, occ, capped)."""
    n = ori.x.shape[0]
    dev = ori.x.device
    A = pack.arity
    K = pack.max_cluster
    tri_rows = pack.tri_f32.shape[0]
    o = (ori.x, ori.y, ori.z)
    dd = (d.x, d.y, d.z)
    inv = tuple(safe_inv(c) for c in dd)
    octant = ((d.x >= 0).to(torch.int64) * 4 + (d.y >= 0).to(torch.int64) * 2
              + (d.z >= 0).to(torch.int64))
    finite = (torch.isfinite(ori.x) & torch.isfinite(ori.y)
              & torch.isfinite(ori.z) & torch.isfinite(d.x)
              & torch.isfinite(d.y) & torch.isfinite(d.z) & ~torch.isnan(t_max))

    bt = torch.clamp_max(t_max, _BIG)
    btri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    limit0 = t_max - 1e-3
    occ = limit0 <= 0.0
    start_walk = finite & (~occ if any_hit else bt > 0.0)

    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = start_walk.to(torch.int64)          # root node 0 pushed
    inexact = torch.zeros(n, dtype=torch.bool, device=dev)
    node_child = pack.node_child.to(torch.int64)
    jj = torch.arange(K, device=dev)
    active = torch.nonzero(sp > 0).squeeze(1)
    steps = 0
    cap = max_steps(pack)
    while active.numel() > 0:
        if steps >= cap:
            inexact[active] = True
            break
        steps += 1
        top = sp[active] - 1
        code = stack[active, top].to(torch.int64)
        sp[active] = top
        is_node = code >= 0

        # -- nodes: slab-test the children, push the hit ones far to near
        a = active[is_node]
        if a.numel() > 0:
            c = code[is_node]
            row = pack.node_f32[c]
            crow = node_child[c]
            oa = tuple(x[a] for x in o)
            ia = tuple(x[a] for x in inv)
            limit = limit0[a] if any_hit else bt[a]

            def push(hit, child):
                spa = sp[a]
                full = hit & (spa >= STACK_DEPTH)
                ok = hit & ~full
                inexact[a[full]] = True
                stack[a[ok], spa[ok]] = child[ok].to(torch.int32)
                sp[a] = spa + ok.to(torch.int64)

            if A == 2:
                h0, t0 = _slab(row[:, 0:6], oa, ia, limit, entry=True)
                h1, t1 = _slab(row[:, 6:12], oa, ia, limit, entry=True)
                c0, c1 = crow[:, 0], crow[:, 1]
                if any_hit:
                    # slot order, no sort (pallas_traverse.py:215-224)
                    push(h0, c0)
                    push(h1, c1)
                else:
                    # entry-t order, swapped only when strictly larger;
                    # far first (pallas_traverse.py:158-183)
                    m0 = torch.where(h0, t0, _BIG)
                    m1 = torch.where(h1, t1, _BIG)
                    swap = m0 > m1
                    near_m = torch.where(swap, m1, m0)
                    far_m = torch.where(swap, m0, m1)
                    push(far_m < _BIG, torch.where(swap, c0, c1))
                    push(near_m < _BIG, torch.where(swap, c1, c0))
            else:
                ordw = crow.gather(1, (8 + octant[a])[:, None]).squeeze(1)
                for pos in range(A - 1, -1, -1):
                    s = (ordw >> (4 * pos)) & 15
                    child = crow.gather(1, s[:, None]).squeeze(1)
                    box = row.gather(1, 6 * s[:, None]
                                     + torch.arange(6, device=dev)[None, :])
                    push(_slab(box, oa, ia, limit) & (child != -1), child)

        # -- clusters: Möller–Trumbore over the cluster's triangles
        b = active[~is_node]
        if b.numel() > 0:
            v = -(code[~is_node] + 1)
            if A == 2:
                # pallas_traverse.py:188-190, at most K triangles
                start = torch.clamp(v // 256, 0, tri_rows - K)
                count = torch.clamp_max(v % 256, K)
            else:
                start = v // 256
                count = torch.minimum(v % 256,
                                      torch.clamp_min(tri_rows - start, 0))
            valid = jj[None, :] < count[:, None]
            rows = pack.tri_f32[(start[:, None] + jj[None, :]).clamp(
                max=tri_rows - 1)]
            ob = tuple(x[b][:, None] for x in o)
            db = tuple(x[b][:, None] for x in dd)
            t, u, vv, hit = _mt_rows(rows, ob, db)
            hit = hit & valid
            if any_hit:
                found = (hit & (t < limit0[b][:, None])).any(dim=1)
                occ[b[found]] = True
                sp[b[found]] = 0
            else:
                hit = hit & (t < bt[b][:, None])
                t_m = torch.where(hit, t, float("inf"))
                arg = torch.argmin(t_m, dim=1)
                r = torch.arange(b.numel(), device=dev)
                cand = t_m[r, arg]
                better = cand < bt[b]
                w = b[better]
                bt[w] = cand[better]
                btri[w] = rows[r, arg, 9][better].to(torch.int32)
                bu[w] = u[r, arg][better]
                bv[w] = vv[r, arg][better]
        active = active[sp[active] > 0]
    capped = inexact.sum().to(torch.int32)
    return bt, btri, bu, bv, occ, capped


def _closest_plain(pack, ori, d, t_max, binary: bool):
    _check(pack, ori, d, t_max, binary=binary)
    bt, btri, bu, bv, _, capped = _walk(pack, ori, d, t_max, any_hit=False)
    t = torch.where(btri >= 0, bt, torch.full_like(bt, FLT_MAX))
    return HitRecord(t=t, tri=btri, u=bu, v=bv), capped


def _any_plain(pack, ori, d, t_max, binary: bool):
    _check(pack, ori, d, t_max, binary=binary)
    _, _, _, _, occ, capped = _walk(pack, ori, d, t_max, any_hit=True)
    return occ, capped


def closest_hit_wide_plain(pack: PacketBVH, ori: Vec3, d: Vec3,
                           t_max: torch.Tensor
                           ) -> Tuple[HitRecord, torch.Tensor]:
    """Plain PyTorch K2 (any device)."""
    return _closest_plain(pack, ori, d, t_max, binary=False)


def any_hit_wide_plain(pack: PacketBVH, ori: Vec3, d: Vec3,
                       t_max: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1 (any device)."""
    return _any_plain(pack, ori, d, t_max, binary=False)


def closest_hit_plain(pack: PacketBVH, ori: Vec3, d: Vec3,
                      t_max: torch.Tensor) -> Tuple[HitRecord, torch.Tensor]:
    """Plain PyTorch K8a (any device)."""
    return _closest_plain(pack, ori, d, t_max, binary=True)


def any_hit_plain(pack: PacketBVH, ori: Vec3, d: Vec3,
                  t_max: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K8b (any device)."""
    return _any_plain(pack, ori, d, t_max, binary=True)
