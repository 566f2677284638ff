"""Ray pools for the treelet kernels' tests (K9/K10/K11): rays through the
Cornell box with dead lanes and degenerate directions, and rays at edges
that two triangles of different treelets share (equal-t ties that the
packet's drain order decides). Imports neither JAX nor tpt."""

import numpy as np
import torch

from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.core.vec import Vec3


def treelet_rays(data, n, seed, device):
    """n rays inside the box, every 7th lane dead, and NaN, +-0
    directions and a NaN origin among the first lanes."""
    pos = data.mesh.positions
    lo = [float(c.min()) for c in (pos.x, pos.y, pos.z)]
    hi = [float(c.max()) for c in (pos.x, pos.y, pos.z)]
    rs = np.random.default_rng(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    special = [(0.0, -0.0, 1.0), (-0.0, 1.0, 0.0), (np.nan, 0.5, 0.5),
               (0.0, 0.0, -1.0)]
    for k, v in enumerate(special[:max(0, n - 1)]):
        d[1 + k] = v
    if n > 6:
        o[6] = (np.nan, 0.0, 0.0)
    tm = np.full(n, 3.4e38, np.float32)
    tm[7::7] = -1.0
    v = lambda a: Vec3.from_stacked(torch.from_numpy(a).to(device))
    return v(o), v(d), torch.from_numpy(tm).to(device)


def _cluster_treelets(pack):
    """Treelet index of each tri_f32 row that lies in a treelet whose root
    is a single cluster (a code < -1: rows [v >> 8, (v >> 8) + (v & 255)),
    v = -(code + 1)); -1 elsewhere."""
    codes = pack.top_tref.cpu().numpy().ravel()
    rows = np.full(pack.tri_f32.shape[0], -1, np.int64)
    for k, c in enumerate(np.unique(codes[codes < -1])):
        v = -(int(c) + 1)
        rows[v >> 8:(v >> 8) + (v & 255)] = k
    return rows


def tie_pool(data, n, seed, device):
    """n rays aimed at points of edges shared by two triangles that lie in
    different (cluster-rooted) treelets, from 20-200 units off the first
    triangle's plane: many hit both triangles at the same t, and which of
    the two a packet finds is the one of the treelet it drains first.
    Returns (o, d, t_max, ties): ties counts the lanes that hit both
    triangles at an equal t."""
    pack, mesh = data.pack, data.mesh
    tri_rows = pack.tri_f32.cpu()
    row_treelet = _cluster_treelets(pack)
    n_tri = mesh.i0.shape[0]
    treelet_of = np.full(n_tri, -1, np.int64)
    row_of = np.zeros(n_tri, np.int64)
    ids = tri_rows[:, 9].numpy().astype(np.int64)
    for r in np.nonzero(row_treelet >= 0)[0]:
        treelet_of[ids[r]] = row_treelet[r]
        row_of[ids[r]] = r
    pos = np.stack([c.cpu().numpy() for c in (mesh.positions.x,
                                              mesh.positions.y,
                                              mesh.positions.z)], -1)
    idx = np.stack([a.cpu().numpy() for a in (mesh.i0, mesh.i1, mesh.i2)], -1)
    edges = {}
    for t in range(n_tri):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            pa, pb = pos[idx[t, a]].tobytes(), pos[idx[t, b]].tobytes()
            edges.setdefault(min(pa, pb) + max(pa, pb), []).append(
                (t, idx[t, a], idx[t, b]))
    pairs = [(v[0], v[1]) for v in edges.values() if len(v) == 2
             and treelet_of[v[0][0]] >= 0 and treelet_of[v[1][0]] >= 0
             and treelet_of[v[0][0]] != treelet_of[v[1][0]]]
    assert pairs, "no shared edge between two cluster-rooted treelets"
    rs = np.random.default_rng(seed)
    pick = rs.integers(0, len(pairs), n)
    gn = np.stack([c.cpu().numpy() for c in (mesh.geom_normals.x,
                                             mesh.geom_normals.y,
                                             mesh.geom_normals.z)], -1)
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    a_row = np.zeros(n, np.int64)
    b_row = np.zeros(n, np.int64)
    for k, p in enumerate(pick):
        (ta, va, vb), (tb, _, _) = pairs[p]
        s = rs.uniform(0.25, 0.75)
        x = pos[va] + s * (pos[vb] - pos[va])
        side = rs.choice([-1.0, 1.0])
        orig = x + side * gn[ta] * rs.uniform(20, 200) + rs.normal(size=3) * 10
        dd = x - orig
        o[k] = orig
        d[k] = dd / np.linalg.norm(dd)
        a_row[k], b_row[k] = row_of[ta], row_of[tb]
    v = lambda a: Vec3.from_stacked(torch.from_numpy(a))
    ov, dv = v(o), v(d)
    cols = lambda w: (w.x, w.y, w.z)
    ta_, _, _, ha = pt._mt_rows(tri_rows[torch.from_numpy(a_row)], cols(ov),
                                cols(dv))
    tb_, _, _, hb = pt._mt_rows(tri_rows[torch.from_numpy(b_row)], cols(ov),
                                cols(dv))
    ties = int((ha & hb & (ta_ == tb_)).sum())
    tm = torch.full((n,), 3.4e38)
    to = lambda w: Vec3(w.x.to(device), w.y.to(device), w.z.to(device))
    return to(ov), to(dv), tm.to(device), ties
