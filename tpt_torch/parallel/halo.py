"""SVGF over row windows: the denoiser of the multi-device render.

Each rank holds rows [r0, r1) of a frame's planes and of the SVGFState.
tpt row-shards SVGF's whole-frame planes and lets GSPMD insert the halo
exchanges (`tpt/parallel/sharding.py:124-140`). Here a rank fetches, a
frame, the window of rows [r0 - m, r1 + m), clipped at the image's top
and bottom, of the current planes and of the history from the ranks
that own them; runs the unchanged `svgf.run_svgf` (K6, then K5's passes)
on the window; and keeps its own rows of the image and the new state.

Why the window is exact. m = R + M + 1, where R = `svgf_reach(cfg)` is
how far the stencils after the reprojection reach (3 for the 7x7
variance fallback, 1 for the 3x3 blur, 2**atrous_iterations - 1 for the
a-trous steps) and M = ceil(max |motion_v|) over the whole frame (NaN
counts as 0, since K6 masks it). K6 reads rows floor(y - mv) and the one
below, so its output is right at every row whose taps lie in the
window; a wrong value at a window edge that is not an image edge then
reaches at most R rows inward. An edge the window shares with the image
behaves as in the whole frame. The current and history planes share the
window because K6's bounds test and tap index are local to it.

K6 subtracts motion_v from the pixel's row as a float32, so the window's
local row y = Y - a would round y - mv differently from the frame's
Y - mv. `rebase_motion_v` therefore hands run_svgf mv' = Y - fl(Y - mv):
then y - mv' equals fl(Y - mv) - a exactly, and K6's floor, fraction,
bounds test and taps are the frame's, shifted by a. Nothing in run_svgf,
K6 or K5 changes. The window may span several ranks (small images,
large motion); `exchange_rows` fetches from every rank it overlaps.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import SVGFConfig
from ..core.vec import Vec3
from ..denoise import svgf
from ..denoise.svgf import SVGFState


def svgf_reach(cfg: SVGFConfig) -> int:
    """Rows the stencils after K6 reach: the 7x7 spatial variance (3),
    the 3x3 blur (1) and the a-trous steps 1, 2, .. 2**(n-1)."""
    return 3 + 1 + (1 << cfg.atrous_iterations) - 1


def motion_reach(mesh, motion_v: torch.Tensor, h: int) -> int:
    """M = ceil(max |motion_v|) over every rank's rows (one all_reduce),
    NaN as 0, at most h."""
    local = torch.nan_to_num(motion_v.abs(), nan=0.0, posinf=float(h))
    m = local.max() if local.numel() else torch.zeros((), device=local.device)
    m = mesh.all_reduce(m.reshape(1).to(torch.float32), dist.ReduceOp.MAX)
    return int(min(math.ceil(float(m[0])), h))


def windows(h: int, world: int, m: int) -> List[Tuple[int, int]]:
    """Every rank's window [a, b) at halo m (the same on every rank)."""
    rows = h // world
    return [(max(0, q * rows - m), min(h, (q + 1) * rows + m))
            for q in range(world)]


def rebase_motion_v(motion_v: torch.Tensor, a: int) -> torch.Tensor:
    """motion_v of a window starting at image row a, rebased so that K6's
    local `y - mv'` is the frame's `fl(Y - mv) - a` bit for bit.

    With s = fl(Y - mv) and M >= |mv|: for every row whose taps lie in
    the window, s >= a >= 1, so s - a is a multiple of ulp(s) below s and
    exactly representable; Y - s is a multiple of ulp(s) of magnitude at
    most s + ulp(s) (or exactly mv where |mv| > s), so mv' = Y - s is
    exact too, and y - mv' = s - a with no rounding."""
    if a == 0:
        return motion_v
    Y = torch.arange(a, a + motion_v.shape[0], dtype=torch.float32,
                     device=motion_v.device)[:, None]
    return Y - (Y - motion_v)


def _bits(p: torch.Tensor) -> torch.Tensor:
    """A float32 or int32 plane as int32 bits (moved bit for bit)."""
    return p if p.dtype == torch.int32 else p.view(torch.int32)


def exchange_rows(mesh, own: torch.Tensor, wins: Sequence[Tuple[int, int]]
                  ) -> torch.Tensor:
    """[P, rows, W] planes of this rank's rows -> [P, b - a, W] planes of
    its window wins[rank], the other rows fetched from their owners in
    one batch of point-to-point transfers (through the host where the
    backend is not NCCL)."""
    me, rows = mesh.rank, own.shape[1]
    a, b = wins[me]
    r0 = me * rows
    out = torch.empty((own.shape[0], b - a, own.shape[2]), dtype=own.dtype,
                      device=own.device)
    out[:, r0 - a:r0 - a + rows] = own
    ops, recvs = [], []
    for q in range(mesh.world):
        if q == me:
            continue
        qa, qb = wins[q]
        lo, hi = max(qa, r0), min(qb, r0 + rows)      # my rows q needs
        if lo < hi:
            t = mesh.to_comm(own[:, lo - r0:hi - r0].contiguous())
            ops.append(dist.P2POp(dist.isend, t, mesh.peer(q), mesh.group))
        lo, hi = max(a, q * rows), min(b, (q + 1) * rows)  # q's rows I need
        if lo < hi:
            buf = torch.empty((own.shape[0], hi - lo, own.shape[2]),
                              dtype=own.dtype, device=mesh.comm_device)
            ops.append(dist.P2POp(dist.irecv, buf, mesh.peer(q), mesh.group))
            recvs.append((lo - a, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for lo, buf in recvs:
        out[:, lo:lo + buf.shape[1]] = buf.to(out.device)
    return out


def svgf_rows(mesh, cfg: SVGFConfig, state: SVGFState, raw_direct: Vec3,
              raw_indirect: Vec3, albedo: Vec3, depth: torch.Tensor,
              normal: Vec3, matid: torch.Tensor, motion_u: torch.Tensor,
              motion_v: torch.Tensor):
    """One denoised frame of this rank's rows (every argument [rows, W]
    planes of them; every rank holds as many). Returns (rgb Vec3 of its
    rows, its rows of the next SVGFState, {"rows", "R", "M", "window"})."""
    rows = depth.shape[0]
    r0, h = mesh.rank * rows, mesh.world * rows
    R = svgf_reach(cfg)
    M = motion_reach(mesh, motion_v, h)
    wins = windows(h, mesh.world, R + M + 1)
    a, b = wins[mesh.rank]
    cur = [raw_direct.x, raw_direct.y, raw_direct.z, raw_indirect.x,
           raw_indirect.y, raw_indirect.z, albedo.x, albedo.y, albedo.z,
           depth, normal.x, normal.y, normal.z, matid, motion_u, motion_v]
    planes = state.leaves() + cur
    if mesh.world > 1:       # every rank takes part: others need its rows
        dtypes = [p.dtype for p in planes]
        win = exchange_rows(mesh, torch.stack([_bits(p) for p in planes]),
                            wins)
        planes = [win[k].view(dt) for k, dt in enumerate(dtypes)]
    st = SVGFState.from_leaves(planes[:18])
    (dr, dg, db, ir, ig, ib, alr, alg, alb, dep, nx, ny, nz, mid, mu,
     mv) = planes[18:]
    rgb, new = svgf.run_svgf(cfg, st, Vec3(dr, dg, db), Vec3(ir, ig, ib),
                             Vec3(alr, alg, alb), dep, Vec3(nx, ny, nz), mid,
                             mu, rebase_motion_v(mv, a))
    lo, hi = r0 - a, r0 - a + rows
    keep = lambda p: p[lo:hi]
    return (rgb.map(keep), SVGFState.from_leaves(map(keep, new.leaves())),
            dict(rows=b - a, R=R, M=M, window=(a, b)))
