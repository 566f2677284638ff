"""Ray-scene intersection: the Möller–Trumbore triangle test and the
brute-force all-triangles intersector.

Counterpart of `tpt/integrators/intersect.py`. The brute-force casts are
the BRUTE_FORCE backend and the independent oracle for the traversal
kernels: every ray is tested against every triangle, with the same
float32 arithmetic and the same first-minimum tie rule as the JAX
package. Rays and triangles go in chunks so memory stays bounded at any
ray count; a ray is tested against a triangle chunk only if it meets the
chunk's padded bounding box (no hierarchy, and no result changes).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.vec import Vec3
from ..scene.structs import MeshData

FLT_MAX = 3.4e38  # float32-representable miss distance, as the reference's
RAY_CHUNK = 4096
TRI_CHUNK = 512


@dataclass(frozen=True)
class HitRecord:
    t: torch.Tensor    # f32[N], FLT_MAX = miss
    tri: torch.Tensor  # int32[N], -1 = miss
    u: torch.Tensor    # f32[N] barycentric
    v: torch.Tensor    # f32[N]

    @property
    def hit_mask(self):
        return self.tri >= 0


def moller_trumbore(ori: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3,
                    eps: float = 1e-9):
    """Möller–Trumbore, lane-parallel over broadcast rays x triangles.
    Returns (t, u, v, hit) with t > 1e-4 on hit."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    ok = torch.abs(det) > eps
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = ori - v0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    return t, u, v, hit


def _col(v: Vec3) -> Vec3:
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


def _row(v: Vec3) -> Vec3:
    return Vec3(v.x[None, :], v.y[None, :], v.z[None, :])


@dataclass(frozen=True)
class _TriChunk:
    ids: torch.Tensor     # [C] triangle ids (clipped past the end)
    valid: torch.Tensor   # [C] bool, id < num_triangles
    v0: Vec3              # [1, C] corners
    v1: Vec3
    v2: Vec3
    lo: tuple             # padded chunk AABB, python floats
    hi: tuple


def _tri_chunks(mesh: MeshData, device):
    """Triangle chunks with a padded bounding box each. The pad (1e-3 of
    the chunk's size and position) is far beyond Möller–Trumbore's
    rounding, so a ray that misses the box cannot hit a triangle in it:
    skipping those pairs changes no result, it only saves work."""
    n_tris = mesh.num_triangles
    chunks = []
    for base in range(0, max(n_tris, 1), TRI_CHUNK):
        ids = torch.arange(base, min(base + TRI_CHUNK, max(n_tris, 1)),
                           device=device)
        v0, v1, v2 = mesh.tri_vertices(ids)
        lo, hi = [], []
        for ax in ("x", "y", "z"):
            c = torch.stack([getattr(v0, ax), getattr(v1, ax), getattr(v2, ax)])
            a, b = float(c.min()), float(c.max())
            pad = 1e-3 * (b - a + abs(a) + abs(b)) + 1e-3
            lo.append(a - pad)
            hi.append(b + pad)
        chunks.append(_TriChunk(ids, ids < n_tris, _row(v0), _row(v1),
                                _row(v2), tuple(lo), tuple(hi)))
    return chunks


def _box_rays(chunk: _TriChunk, o: Vec3, inv: Vec3) -> torch.Tensor:
    """Indices of the rays (of `o`, `inv`) whose t >= 0 segment meets the
    chunk's padded box."""
    tn = torch.zeros_like(o.x)
    tf = torch.full_like(o.x, float("inf"))
    for ax, a, b in zip(("x", "y", "z"), chunk.lo, chunk.hi):
        oc, ic = getattr(o, ax), getattr(inv, ax)
        t0 = (a - oc) * ic
        t1 = (b - oc) * ic
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return torch.nonzero(tn <= tf).squeeze(1)


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| clamped to >= 1e-12 (sign kept; -0 counts as +), the
    traversal kernels' slab-test reciprocal."""
    small = torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype)
    return 1.0 / torch.where(d.abs() > 1e-12, d, small)


def brute_force_closest_hit(mesh: MeshData, ori: Vec3, d: Vec3,
                            t_max=None) -> HitRecord:
    """Closest hit over all triangles (first minimum on exact-t ties)."""
    n = ori.shape[0]
    dev = ori.device
    if t_max is None:
        t_max = torch.full((n,), FLT_MAX, device=dev)
    best_t = torch.full((n,), FLT_MAX, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    chunks = _tri_chunks(mesh, dev)
    inv = d.map(safe_inv)
    for r0 in range(0, n, RAY_CHUNK):
        live = r0 + torch.nonzero(t_max[r0:r0 + RAY_CHUNK] > 0).squeeze(1)
        for ch in chunks:
            sel = live[_box_rays(ch, ori[live], inv[live])]
            if sel.numel() == 0:
                continue
            bt = best_t[sel]
            t, u, v, hit = moller_trumbore(_col(ori[sel]), _col(d[sel]),
                                           ch.v0, ch.v1, ch.v2)
            hit = (hit & ch.valid[None, :] & (t < bt[:, None])
                   & (t < t_max[sel][:, None]))
            t_masked = torch.where(hit, t, FLT_MAX)
            arg = torch.argmin(t_masked, dim=1)
            row = torch.arange(sel.shape[0], device=dev)
            cand_t = t_masked[row, arg]
            improved = cand_t < bt
            w = sel[improved]
            best_t[w] = cand_t[improved]
            best_tri[w] = ch.ids[arg[improved]].to(torch.int32)
            best_u[w] = u[row, arg][improved]
            best_v[w] = v[row, arg][improved]
    return HitRecord(t=best_t, tri=best_tri, u=best_u, v=best_v)


def brute_force_any_hit(mesh: MeshData, ori: Vec3, d: Vec3,
                        t_max: torch.Tensor) -> torch.Tensor:
    """Occlusion query: True where the segment [1e-4, t_max - 1e-3) is
    blocked."""
    n = ori.shape[0]
    dev = ori.device
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    limit = t_max - 1e-3
    chunks = _tri_chunks(mesh, dev)
    inv = d.map(safe_inv)
    for r0 in range(0, n, RAY_CHUNK):
        live = r0 + torch.nonzero(limit[r0:r0 + RAY_CHUNK] > 0).squeeze(1)
        for ch in chunks:
            sel = live[_box_rays(ch, ori[live], inv[live])]
            sel = sel[~occluded[sel]]
            if sel.numel() == 0:
                continue
            t, u, v, hit = moller_trumbore(_col(ori[sel]), _col(d[sel]),
                                           ch.v0, ch.v1, ch.v2)
            blocked = (hit & ch.valid[None, :]
                       & (t < limit[sel][:, None])).any(dim=1)
            occluded[sel[blocked]] = True
    return occluded
