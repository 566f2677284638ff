"""The least work of the sweep casts, counted from what each call took
and returned, whatever runs inside it.

K3, the dense treelet scan (tpt_torch/bvh/sweep.py dense_scan), tests
every treelet's box against every live lane: live lanes x treelets slab
tests, at OPS_PER_SLAB fp32 instructions each; its bytes are every lane's
ray in (28 B) and its S slots and threshold out (8 S + 4 B), plus the
boxes once (chip_smoke.py, the K3 bound of `sweep_phases`).

K4, the demand sweep with its K2 tail (tpt_torch/bvh/sweepcast.py
sweep_cast_sorted), needs every triangle row of each treelet that some
live lane of a 128-lane block still demands at its final t, for each
live lane of that block, at OPS_PER_TRI instructions a test; its bytes
are the rays and S slots in (28 + 8 S B), the hits out (16 B) and the
tables once. `sweep_need` is a frozen copy of tpt_torch.bvh.sweep.
sweep_need (without its group mode, which the cells do not run), and
the bound is chip_smoke.py's `need_bound`. Counted on the final hits,
the need is of the result: the tail's own tests add nothing to it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .peaks import PEAK_BYTES_S, PEAK_F32_INSTR_S

# fp32 instructions per slab test (6 sub, 6 mul, 12 min/max, 1 compare)
# and per Moller-Trumbore triangle test (the divide counted as one), as
# chip_smoke.py counts them from the kernel source
OPS_PER_SLAB = 25
OPS_PER_TRI = 52
NONE_ORD = 0x7FFFFF   # an empty slot's ordinal (tpt_torch/bvh/sweep.py)
LANES = 128           # lanes per K4 block (csrc/sweep.cu SWEEP8_LANES)
FLT_MAX = 3.4e38


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time of `ops` fp32 instructions and `nbytes` bytes."""
    return max(ops / PEAK_F32_INSTR_S, nbytes / PEAK_BYTES_S)


def k3_need(alive: torch.Tensor, num_treelets: int, slots: int,
            box_numel: int) -> Tuple[int, int]:
    """(operations, bytes) of one dense scan over a pool with `alive`."""
    n = int(alive.shape[0])
    live = int(alive.sum())
    return (OPS_PER_SLAB * live * num_treelets,
            n * (28 + 8 * slots + 4) + 4 * box_numel)


def sweep_need(tri_f32: torch.Tensor, ranges: torch.Tensor, unroll: int,
               num_treelets: int, t_max: torch.Tensor, ordinal: torch.Tensor,
               entry_t: torch.Tensor, hit_t: torch.Tensor,
               hit_tri: torch.Tensor, lanes: int = LANES) -> Tuple[int, int]:
    """(triangle tests, treelets summed over blocks) that the hits of one
    demand sweep need. `ordinal`, `entry_t`: the [S, n] slot planes."""
    n = int(t_max.shape[0])
    dev = t_max.device
    T = num_treelets
    o, e = ordinal.to(torch.int32), entry_t
    nb = max(1, -(-n // lanes))
    pad = nb * lanes - n
    alive = t_max > 0
    tm = torch.where(alive, t_max, 0.0)
    bt = torch.where(hit_tri >= 0, hit_t, torch.clamp_max(tm, FLT_MAX))
    demand = alive[None] & (o != NONE_ORD) & (e < bt[None])
    blk = torch.arange(n, device=dev) // lanes
    U = torch.zeros(nb * T, dtype=torch.bool, device=dev)
    U[(blk[None] * T + o.long())[demand]] = True
    pairs = torch.nonzero(U.reshape(nb, T))
    a = alive
    if pad:
        a = torch.cat([a, a.new_zeros(pad)])
    nlive = a.reshape(nb, lanes).sum(1)
    b, t = pairs[:, 0], pairs[:, 1]
    real = (tri_f32[:, :9] != 0).any(1).long()
    csum = torch.cat([real.new_zeros(1), torch.cumsum(real, 0)])
    start = ranges[:, 0].long()
    nrows = ranges[:, 1].long() * unroll
    rows = csum[start + nrows] - csum[start]
    return int((nlive[b] * rows[t]).sum()), int(pairs.shape[0])


def k4_need(tri_f32: torch.Tensor, ranges: torch.Tensor, group_boxes,
            unroll: int, num_treelets: int, t_max: torch.Tensor,
            ordinal: torch.Tensor, entry_t: torch.Tensor, hit_t: torch.Tensor,
            hit_tri: torch.Tensor) -> Tuple[int, int]:
    """(operations, bytes) of one sweep cast's result."""
    n = int(t_max.shape[0])
    S = int(ordinal.shape[0])
    tris, _ = sweep_need(tri_f32, ranges, unroll, num_treelets, t_max,
                         ordinal, entry_t, hit_t, hit_tri)
    table = tri_f32.numel() + ranges.numel() + (
        group_boxes.numel() if group_boxes is not None else 0)
    return OPS_PER_TRI * tris, n * (28 + 8 * S + 16) + 4 * table
