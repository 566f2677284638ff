"""LBVH construction in plain PyTorch: a frozen copy of the Karras
builder of tpt_torch/bvh/build.py, with one change: the box refit and
the escape links sweep until they stop changing (the program stops at a
fixed count), so the reference's tree is exact at any depth.

Node layout: internal nodes [0, T-2] (root 0), leaves [T-1, 2T-2];
`prim_index[leaf]` is the original triangle id.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF

def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (standard morton magic): uint32 products
    with wrap-around, in int64 words masked to 32 bits."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """30-bit morton code (int32) from coords normalized to [0, 1]."""
    def q(c):
        # float -> uint32 truncates toward zero, as astype(uint32) does
        return torch.clamp(c * 1024.0, 0.0, 1023.0).to(torch.int64)

    code = (_expand_bits(q(x)) * 4 + _expand_bits(q(y)) * 2
            + _expand_bits(q(z))) & _U32
    return code.to(torch.int32)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the 32-bit words `x` (any integer dtype, read as
    its low 32 bits), as `jax.lax.clz` of int32: clz(0) = 32."""
    v = x.to(torch.int64) & _U32
    n = torch.zeros_like(v)
    for bits, top in ((16, 0x0000FFFF), (8, 0x00FFFFFF), (4, 0x0FFFFFFF),
                      (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        small = v <= top
        n = n + small.to(torch.int64) * bits
        v = torch.where(small, (v << bits) & _U32, v)
    return torch.where(x.to(torch.int64) & _U32 == 0, 32, n)


def _delta(morton_s: torch.Tensor, a: torch.Tensor, b: torch.Tensor, n: int):
    """LCP length proxy between sorted slots a and b; -1 out of range.
    Equal codes fall back to the slots' own bits, 32 + clz(a ^ b) (the
    reference's 64-bit morton << 32 | id key)."""
    in_range = (b >= 0) & (b < n)
    bc = b.clamp(0, n - 1)
    ma = morton_s[a.clamp(0, n - 1)]
    mb = morton_s[bc]
    x = ma ^ mb
    d = torch.where(x == 0, 32 + clz32(a ^ bc), clz32(x))
    return torch.where(in_range, d, -1)


def build_lbvh(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> dict:
    """The LBVH arrays of triangles with corners p0, p1, p2 ([T, 3] each,
    T >= 2): node boxes `amin`, `amax` [2T-1, 3], `left`, `right`,
    `escape`, `prim_index` [2T-1] int64."""
    dev = p0.device
    n = int(p0.shape[0])
    num_internal = n - 1
    total = 2 * n - 1
    i64 = dict(dtype=torch.int64, device=dev)

    tri_min = torch.minimum(torch.minimum(p0, p1), p2)
    tri_max = torch.maximum(torch.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5
    # ---- 2. world box, normalized centroids -------------------------------
    wmin = centroid.amin(dim=0)
    wmax = centroid.amax(dim=0)
    inv_ext = 1.0 / torch.clamp_min(wmax - wmin, 1e-9)
    norm_c = (centroid - wmin) * inv_ext

    # ---- 3. morton codes, stable sort by code (ties by triangle id) -------
    codes = morton3d(norm_c[:, 0], norm_c[:, 1], norm_c[:, 2])
    morton_s, prim_s = torch.sort(codes.to(torch.int64), stable=True)

    # ---- 4. Karras hierarchy emit -----------------------------------------
    i = torch.arange(num_internal, **i64)
    d_r = _delta(morton_s, i, i + 1, n)
    d_l = _delta(morton_s, i, i - 1, n)
    d = torch.where(d_r > d_l, 1, -1)
    delta_min = _delta(morton_s, i, i - d, n)

    # the range length l: the largest l with delta(i, i + l*d) > delta_min
    max_pow = max(1, (n - 1).bit_length())
    l = torch.zeros_like(i)
    for k in range(max_pow, -1, -1):
        cand = l + (1 << k)
        ok = _delta(morton_s, i, i + cand * d, n) > delta_min
        l = torch.where(ok, cand, l)
    j = i + l * d
    delta_node = _delta(morton_s, i, j, n)

    # the split s: the largest s < l with delta(i, i + s*d) > delta_node
    s = torch.zeros_like(i)
    for k in range(max_pow, -1, -1):
        cand = s + (1 << k)
        ok = (cand <= l - 1) & (_delta(morton_s, i, i + cand * d, n)
                                > delta_node)
        s = torch.where(ok, cand, s)
    gamma = i + s * d + torch.clamp_max(d, 0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    leaf_base = num_internal
    left = torch.where(lo == gamma, leaf_base + gamma, gamma)
    right = torch.where(hi == gamma + 1, leaf_base + gamma + 1, gamma + 1)

    # ---- 5. parents, full child arrays, leaf primitives --------------------
    parent = torch.full((total,), -1, **i64)
    parent[left] = i
    parent[right] = i
    left_full = torch.full((total,), -1, **i64)
    left_full[:num_internal] = left
    right_full = torch.full((total,), -1, **i64)
    right_full[:num_internal] = right
    prim_index = torch.full((total,), -1, **i64)
    prim_index[leaf_base:] = prim_s

    # ---- 6. box refit: refit_iters Jacobi sweeps, one level each -----------
    big = 3.4e38
    amin = torch.full((total, 3), big, dtype=torch.float32, device=dev)
    amax = torch.full((total, 3), -big, dtype=torch.float32, device=dev)
    amin[leaf_base:] = tri_min[prim_s]
    amax[leaf_base:] = tri_max[prim_s]
    lc = left.clamp_min(0)
    rc = right.clamp_min(0)
    while True:
        imin = torch.minimum(amin[lc], amin[rc])
        imax = torch.maximum(amax[lc], amax[rc])
        nmin = torch.cat([imin, amin[num_internal:]])
        nmax = torch.cat([imax, amax[num_internal:]])
        if torch.equal(nmin, amin) and torch.equal(nmax, amax):
            break
        amin, amax = nmin, nmax

    # escape[left] = right sibling, escape[right] = escape[parent]
    ids = torch.arange(total, **i64)
    par_c = parent.clamp_min(0)
    par_right = right_full[par_c]
    is_left = left_full[par_c] == ids
    has_parent = parent >= 0
    escape = torch.full((total,), -1, **i64)
    while True:
        nxt = torch.where(has_parent,
                          torch.where(is_left, par_right, escape[par_c]), -1)
        if torch.equal(nxt, escape):
            break
        escape = nxt
    return dict(amin=amin, amax=amax, left=left_full, right=right_full,
                escape=escape, prim_index=prim_index)
