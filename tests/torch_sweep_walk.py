"""The union a demand sweep walks, for tests of the sweeps' work counts.

`walked_unions` replays K4's/K7's union walk block by block with the
plain sweep itself: a block's next treelet is the smallest ordinal above
the last that one of its live lanes still demands, and the budgets after
the walk up to ordinal c are those of the plain sweep given only the
slots <= c (the walk over the rest of the slots is the same walk, cut at
c). `union_tests` is the triangle-test count of a sweep that tests every
row of the walked union against every live lane of the block, as the
kernels did before they culled by group boxes. No JAX here: the GPU
tests use it.
"""

import torch

from tpt_torch.bvh import sweep as sw
from tpt_torch.integrators.intersect import FLT_MAX


def walked_unions(tables, ori, d, t_max, o, e, lanes, rpc, any_hit=False):
    """[blocks, T] bool: the ordinals each block's demand sweep visits."""
    n = t_max.numel()
    S = o.shape[0]
    T = tables.num_treelets
    dev = t_max.device
    nb = max(1, -(-n // lanes))
    blk = torch.arange(n, device=dev) // lanes
    alive = t_max > 0
    tm = torch.where(alive, t_max, 0.0)
    bt0 = torch.clamp_max(tm, FLT_MAX)
    budget = bt0
    live_o = torch.where(alive[None], o, sw.NONE_ORD)
    cur = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    walked = torch.zeros((nb, T), dtype=torch.bool, device=dev)
    if e is None:        # no demand drop: every requested slot is walked
        keep = live_o != sw.NONE_ORD
        walked[blk[None].expand(S, n)[keep], live_o[keep].long()] = True
        return walked
    while True:
        demand = live_o > cur[blk][None]
        if e is not None:
            demand &= e < budget[None]
        cand = torch.where(demand, live_o, sw.NONE_ORD).reshape(-1)
        nxt = torch.full((nb,), sw.NONE_ORD, dtype=torch.int32, device=dev)
        nxt = nxt.scatter_reduce(0, blk.repeat(S), cand, "amin")
        act = nxt < sw.NONE_ORD
        if not bool(act.any()):
            return walked
        walked[act, nxt[act].long()] = True
        cur = torch.where(act, nxt, sw.NONE_ORD)
        upto = torch.where(o <= cur[blk][None], o, sw.NONE_ORD)
        hit = sw._sweep_plain(tables, ori, d, t_max, upto, e, lanes, rpc,
                              any_hit, 0)
        bt = torch.where(hit.tri >= 0, hit.t, bt0)
        budget = (torch.where(bt < tm - 1e-3, -float("inf"), bt) if any_hit
                  else bt)


def union_tests(tables, ori, d, t_max, o, e, lanes, rpc, any_hit=False):
    """Rows of each block's walked union times its live lanes, summed."""
    walked = walked_unions(tables, ori, d, t_max, o, e, lanes, rpc, any_hit)
    n = t_max.numel()
    nb = walked.shape[0]
    alive = torch.zeros(nb * lanes, dtype=torch.bool, device=t_max.device)
    alive[:n] = t_max > 0
    nlive = alive.reshape(nb, lanes).sum(1)
    rows = tables.ranges[:, 1].long() * rpc
    return int(((walked.long() * rows[None]).sum(1) * nlive).sum())
