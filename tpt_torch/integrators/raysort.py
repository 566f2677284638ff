"""Bounce-ray coherence keys. Counterpart of `tpt/integrators/raysort.py`.

The wavefront integrator keeps its path pool sorted by a (direction
cone, origin-cell morton) key before every extension cast, so rays that
traverse the same part of the BVH sit in neighbouring lanes: on the TPU
they share packets, on the GPU they share warps and cache lines. Dead
lanes get the largest key and gather at the tail of the pool.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.vec import Vec3


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (standard morton magic), in int64 words
    masked to 32 bits."""
    m = 0xFFFFFFFF
    v = ((v * 0x00010001) & m) & 0xFF0000FF
    v = ((v * 0x00000101) & m) & 0x0F00F00F
    v = ((v * 0x00000011) & m) & 0xC30C30C3
    v = ((v * 0x00000005) & m) & 0x49249249
    return v


def _quantize(c: torch.Tensor, lo: torch.Tensor, inv_extent: torch.Tensor,
              bits: int) -> torch.Tensor:
    n = (1 << bits) - 1
    return ((c - lo) * inv_extent * (1 << bits)).to(torch.int32).clamp(
        0, n).to(torch.int64)


def coherence_key(ori: Vec3, d: Vec3, world_lo: Vec3, world_inv: Vec3,
                  mode: str = "dir_major") -> torch.Tensor:
    """Sort key (int64 holding the reference's int32 key). Modes:
    "dir_major" (6-bit direction cone over an 18-bit origin morton) and
    "cell_major" (21-bit origin morton over the octant)."""
    octant = ((d.x >= 0).to(torch.int64) * 4 + (d.y >= 0).to(torch.int64) * 2
              + (d.z >= 0).to(torch.int64))
    if mode == "cell_major":
        qx = _expand_bits(_quantize(ori.x, world_lo.x, world_inv.x, 7))
        qy = _expand_bits(_quantize(ori.y, world_lo.y, world_inv.y, 7))
        qz = _expand_bits(_quantize(ori.z, world_lo.z, world_inv.z, 7))
        morton = (qx << 2) | (qy << 1) | qz
        return (morton << 3) | octant
    if mode != "dir_major":
        raise NotImplementedError(f"sort_key {mode!r} is not ported yet")
    ax = (torch.abs(d.x) > 0.5).to(torch.int64)
    ay = (torch.abs(d.y) > 0.5).to(torch.int64)
    az = (torch.abs(d.z) > 0.5).to(torch.int64)
    cone = (octant << 3) | (ax << 2) | (ay << 1) | az
    qx = _quantize(ori.x, world_lo.x, world_inv.x, 6)
    qy = _quantize(ori.y, world_lo.y, world_inv.y, 6)
    qz = _quantize(ori.z, world_lo.z, world_inv.z, 6)
    morton = ((_expand_bits(qx) << 2) | (_expand_bits(qy) << 1)
              | _expand_bits(qz))
    return (cone << 18) | morton


def sort_permutation(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv_perm): perm gathers into sorted order (stable); inv_perm
    maps sorted slots back to original lanes."""
    perm = torch.sort(key, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def gather_vec3(v: Vec3, idx: torch.Tensor) -> Vec3:
    return v.take(idx)


def world_bounds(mesh) -> Tuple[Vec3, Vec3]:
    """World AABB low corner and inverse extent of the scene mesh."""
    p = mesh.positions
    lo = Vec3(p.x.min(), p.y.min(), p.z.min())
    hi = Vec3(p.x.max(), p.y.max(), p.z.max())
    inv = Vec3(1.0 / torch.clamp_min(hi.x - lo.x, 1e-6),
               1.0 / torch.clamp_min(hi.y - lo.y, 1e-6),
               1.0 / torch.clamp_min(hi.z - lo.z, 1e-6))
    return lo, inv
