"""Flat groups at coordinate 0: sweep tables whose triangles lie in one
axis plane at 0, where a group box has a pad of 1e-30 in that axis, and
rays aimed at the edges those triangles share. On such input a slab
test of a group box at a lane's best t is no bound on the t Möller–
Trumbore computes, so a sweep that culled rows by group boxes returned
another hit than the plain sweep (csrc/sweep.cu). No JAX here: the GPU
tests, the kernel-source emulation test and chip_smoke.py use it.

`flat_tables` + `flat_warp`: the two-triangle input, one 32-lane warp
with one live lane; `edge_pool`: 4096 rays at the shared edge of the two
triangles; `stress_tables` + `stress_pool`: a jittered grid of triangles
in the plane coordinate `axis` = 0, in 8 treelets of up to 8 chunks
(K4's group mode applies at unroll 1), and rays at its shared edges;
`grazing_case`: a triangle that Möller–Trumbore takes far outside its
padded box.
"""

import numpy as np
import torch

from tpt_torch.bvh.treelet import SweepTables, group_boxes
from tpt_torch.core.vec import Vec3

NONE_ORD = 0x7FFFFF

# two triangles in the plane y = 0 sharing the edge A[0]-A[2]
TRI_A = ((1.3696169, 0.0, -2.3021328), (-4.590265, 0.0, -4.8347235),
         (3.1327024, 0.0, 4.127556))
TRI_B = ((1.3696169, 0.0, -2.3021328), (3.1327024, 0.0, 4.127556),
         (1.0663577, 0.0, 2.2949655))
RAY_O = (-17.621433, 4.142627, 13.094973)
RAY_D = (0.88471985, -0.17894995, -0.430404)
# the plain sweep's hit on the warp, and the hit of a sweep that skips
# B's group once it holds A's t
PLAIN_T, PLAIN_TRI = 23.149635, 1
CULLED_T, CULLED_TRI = 23.149637, 0


def _rows(tris, ids):
    """tri_f32 rows (v0, e1, e2, id at col 9) of float32 triangles."""
    v = np.asarray(tris, np.float32)
    rows = np.zeros((len(v), 16), np.float32)
    rows[:, 0:3] = v[:, 0]
    rows[:, 3:6] = v[:, 1] - v[:, 0]
    rows[:, 6:9] = v[:, 2] - v[:, 0]
    rows[:, 9] = ids
    return rows


def _tables(rows_per_treelet, chunk_align, device):
    """SweepTables of 8-row chunks, one treelet per row list, padded to
    whole chunks, with group boxes."""
    start, chunks, count, blocks = [], [], [], []
    total = 0
    for rows in rows_per_treelet:
        c = -(-len(rows) // 8)
        c = -(-c // chunk_align) * chunk_align
        pad = np.zeros((c * 8, 16), np.float32)
        pad[:len(rows)] = rows
        start.append(total)
        chunks.append(c)
        count.append(len(rows))
        blocks.append(pad)
        total += c * 8
    tri = np.concatenate(blocks)
    start, chunks = np.array(start), np.array(chunks)
    boxes = np.zeros((len(start), 8), np.float32)
    for t, rows in enumerate(rows_per_treelet):
        v = np.concatenate([rows[:, 0:3], rows[:, 0:3] + rows[:, 3:6],
                            rows[:, 0:3] + rows[:, 6:9]])
        boxes[t, :3], boxes[t, 3:6] = v.min(0), v.max(0)
    gbox = group_boxes(tri, start, np.array(count), chunks, chunk_align, 8)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return SweepTables(tri_f32=dev(tri),
                       ranges=dev(np.stack([start, chunks], 1).astype(np.int32)),
                       boxes=dev(boxes), group_boxes=dev(gbox),
                       num_treelets=len(start), max_chunks=int(chunks.max()),
                       unroll=8, chunk_align=chunk_align)


def flat_tables(device):
    """Treelet 0: 8 rows of A (id 0); treelet 1: 8 rows of B (id 1);
    unroll 8, chunk_align 1."""
    return _tables([_rows([TRI_A] * 8, 0), _rows([TRI_B] * 8, 1)], 1, device)


def _vec(a, device):
    a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Vec3(a[:, 0].contiguous().to(device), a[:, 1].contiguous().to(device),
                a[:, 2].contiguous().to(device))


def _demand_all(n, T, device):
    """Slot planes [T, n] in which every lane demands every treelet at
    entry t 0."""
    s_o = torch.arange(T, dtype=torch.int32)[:, None].repeat(1, n)
    return s_o.to(device), torch.zeros((T, n), device=device)


def flat_warp(device):
    """One 32-lane warp: lane 0 carries the ray and demands both
    treelets; lanes 1-31 are dead (t_max 0). (ori, d, t_max, s_o, s_t)."""
    o = np.tile(np.asarray(RAY_O, np.float32), (32, 1))
    d = np.tile(np.asarray(RAY_D, np.float32), (32, 1))
    t_max = torch.zeros(32)
    t_max[0] = 3.4e38
    s_o, s_t = _demand_all(32, 2, device)
    return _vec(o, device), _vec(d, device), t_max.to(device), s_o, s_t


def _at_edges(p, q, n, axis, rs):
    """n rays from random origins off the plane `axis` = 0 to random
    points on the segments p[k]-q[k] (k drawn per ray), as float32."""
    k = rs.integers(0, len(p), n)
    s = rs.uniform(0.05, 0.95, (n, 1))
    target = p[k] + s * (q[k] - p[k])
    o = target + rs.normal(size=(n, 3)) * 8.0
    o[:, axis] = np.where(rs.random(n) < 0.5, 1.0, -1.0) * rs.uniform(
        0.5, 12.0, n)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def edge_pool(n, seed, device):
    """n rays from above the plane at random points of the shared edge of
    A and B, each demanding both treelets. (ori, d, t_max, s_o, s_t)."""
    rs = np.random.default_rng(seed)
    a = np.asarray(TRI_A, np.float64)
    target = a[0] + rs.uniform(0.05, 0.95, (n, 1)) * (a[2] - a[0])
    o = target + rs.normal(size=(n, 3)) * 8.0
    o[:, 1] = rs.uniform(0.5, 12.0, n)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s_o, s_t = _demand_all(n, 2, device)
    return (_vec(o, device), _vec(d, device),
            torch.full((n,), 3.4e38, device=device), s_o, s_t)


def stress_tables(axis, seed, device):
    """A jittered 12x12 grid of triangles (2 a cell) in the plane `axis` =
    0, centred on the origin, in 8 treelets of 36 rows (5 chunks each),
    chunk_align 1, with group boxes. Returns (tables, edge ends p, q)."""
    rs = np.random.default_rng(seed)
    m = 13
    u, w = np.meshgrid(np.linspace(-6, 6, m), np.linspace(-6, 6, m))
    u = u + rs.uniform(-0.3, 0.3, u.shape)
    w = w + rs.uniform(-0.3, 0.3, w.shape)
    pts = np.zeros((m, m, 3))
    ax = [a for a in range(3) if a != axis]
    pts[..., ax[0]], pts[..., ax[1]] = u, w
    pts = pts.astype(np.float32).astype(np.float64)
    tris, p, q = [], [], []
    for i in range(m - 1):
        for j in range(m - 1):
            a, b, c, e = pts[i, j], pts[i, j + 1], pts[i + 1, j], pts[i + 1, j + 1]
            tris += [(a, b, e), (a, e, c)]
            p += [a, a, b]
            q += [e, b, e]
    rows = _rows(tris, np.arange(len(tris)))
    per = len(rows) // 8
    tables = _tables([rows[k * per:(k + 1) * per] for k in range(8)], 1,
                     device)
    return tables, np.asarray(p), np.asarray(q)


def stress_pool(axis, edges, n, seed, device, lone=False):
    """n rays at the grid's shared edges, each demanding all 8 treelets;
    with `lone`, each ray is lane 0 of a warp whose 31 other lanes are
    dead, so that the warp culls as its one lane would (32n lanes).
    (ori, d, t_max, s_o, s_t)."""
    rs = np.random.default_rng(seed)
    o, d = _at_edges(edges[0], edges[1], n, axis, rs)
    t_max = np.full(n, 3.4e38, np.float32)
    if lone:
        o, d = np.repeat(o, 32, 0), np.repeat(d, 32, 0)
        t_max = np.zeros(32 * n, np.float32)
        t_max[::32] = 3.4e38
    s_o, s_t = _demand_all(len(t_max), 8, device)
    return (_vec(o, device), _vec(d, device),
            torch.from_numpy(t_max).to(device), s_o, s_t)


# a triangle (v0, e1, e2) and a ray nearly parallel to its plane: float32
# Möller–Trumbore takes it at t ~ 0.0696 where the ray enters the
# triangle's box, padded as group_boxes pads it, only at t ~ 0.249
GRAZING_TRI = ((-1.8961583375930786, 9.389633178710938, 0.14927047491073608),
               (-1.226453423500061, -12.390826225280762, 4.232151508331299),
               (7.000943660736084, -7.54730749130249, 0.37923043966293335))
GRAZING_O = (-3.042226552963257, -3.2233798503875732, 4.428260326385498)
GRAZING_D = (0.2792690396308899, 0.8907871842384338, -0.35847875475883484)


def grazing_case():
    """(tri_f32 row [1, 16], group box [8] of that one triangle as
    group_boxes builds it, ray origin [3], direction [3]), float32."""
    row = np.zeros((8, 16), np.float32)
    row[0, 0:9] = np.asarray(GRAZING_TRI, np.float32).reshape(-1)
    gbox = group_boxes(row, np.array([0]), np.array([1]), np.array([1]), 1, 8)
    return (row[:1], gbox[0], np.asarray(GRAZING_O, np.float32),
            np.asarray(GRAZING_D, np.float32))


def flat_pack(device, arity=4):
    """A wide pack (K1/K2) of A and B: a root whose slot 0 is one cluster
    of the two triangles, A first; its other slots are empty."""
    from tpt_torch.bvh.pack import PacketBVH, encode_cluster

    rows = np.concatenate([_rows([TRI_A], 0), _rows([TRI_B], 1)])
    v = np.concatenate([rows[:, 0:3], rows[:, 0:3] + rows[:, 3:6],
                        rows[:, 0:3] + rows[:, 6:9]])
    node_f32 = np.full((1, 6 * arity), 3e38, np.float32)
    node_f32[0, 0:3], node_f32[0, 3:6] = v.min(0), v.max(0)
    node_child = np.full((1, 16), -1, np.int32)
    node_child[0, 0] = encode_cluster(0, 2)
    order = sum(s << (4 * s) for s in range(arity))
    node_child[0, 8:16] = np.uint32(order).view(np.int32)
    tri = np.zeros((16, 16), np.float32)
    tri[:2] = rows
    dev = lambda a: torch.from_numpy(a).to(device)
    return PacketBVH(node_f32=dev(node_f32), node_child=dev(node_child),
                     tri_f32=dev(tri), num_nodes=1, num_triangles=2,
                     max_cluster=16, arity=arity)
