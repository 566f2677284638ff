"""How the packets of K10's seeded bounce-1 launch share the card: the
1080p fireplace's sorted bounce-1 pool (as `chip_smoke.py`'s
`treelet_kernels` phase makes it) cast by K10 whole, then packet by
packet (each 2048-lane packet launched alone, timed by CUDA events), and
the makespan of greedy list scheduling of those times on 132 SMs, one
packet an SM at a time (the kernel's occupancy), in the launch's order
(packet index) and longest first: by the measured times and by per-packet
proxies known before the launch (live lanes, K9's candidate count). Run
on a card from the root of a checkout:

    python scripts/treelet_packet_order.py
"""

import heapq
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpt_torch.bvh import packet_traverse as pt  # noqa: E402
from tpt_torch.bvh import treelet_traverse as tlt  # noqa: E402
from tpt_torch.config import RayCastBackend, RenderConfig  # noqa: E402
from tpt_torch.core.vec import Vec3  # noqa: E402
from tpt_torch.integrators import common, wavefront  # noqa: E402
from tpt_torch.scene import procedural  # noqa: E402

SMS = 132


def makespan(order, t, m=SMS) -> float:
    free = [0.0] * m
    for i in order:
        heapq.heappush(free, heapq.heappop(free) + t[i])
    return max(free)


def main() -> int:
    dev = torch.device("cuda")
    print(f"card: {cs.nvidia_smi()}")
    pt.build_kernels()
    tlt.build_kernels()
    host = procedural.fireplace_like(resolution=cs.RES)
    scene = host.build(with_bvh=True, sweep_chunk_align=cs.SWEEP_ALIGN,
                       device=dev)
    cam, pack = host.camera, scene.pack
    cfg = RenderConfig(backend=RayCastBackend.BVH_TREELET,
                       trace_depth=cs.DEPTH)
    grabbed = {}
    seed_sort = wavefront._treelet_seed_sort

    def grab(scn, c, pool):
        grabbed["out"] = seed_sort(scn, c, pool)
        return grabbed["out"]

    wavefront._treelet_seed_sort = grab
    rc = common.make_raycaster(scene, cfg)
    vp = wavefront.camera_view_proj(cam)
    carry = wavefront.batched_raygen(cam, cfg, 1, dev)
    for depth in range(2):
        carry = wavefront._bounce_body(scene, rc, cam, cfg, vp, vp, depth,
                                       carry)
    wavefront._treelet_seed_sort = seed_sort
    spool, seed, hard, _ = grabbed["out"]
    ori, d, alive = spool[0], spool[1], spool[5]
    easy = torch.where(hard | ~alive, -1.0, 3.4e38)
    n, L = easy.numel(), 1024 * cfg.trav_group
    P = -(-n // L)
    whole = cs.kernel_ms(lambda: tlt.treelet_closest_hit(
        pack, ori, d, easy, group=cfg.trav_group, seed=seed), 3)
    times = np.zeros(P)
    drains = np.zeros(P)
    for p in range(P):
        s = slice(p * L, min(n, (p + 1) * L))
        sub = lambda v: Vec3(v.x[s].contiguous(), v.y[s].contiguous(),
                             v.z[s].contiguous())
        args = (pack, sub(ori), sub(d), easy[s].contiguous())
        sd = tuple(x[s].contiguous() for x in seed)
        st = torch.zeros(6, dtype=torch.int64, device=dev)
        tlt.treelet_closest_hit(*args, group=cfg.trav_group, seed=sd, stats=st)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        tlt.treelet_closest_hit(*args, group=cfg.trav_group, seed=sd)
        b.record()
        b.synchronize()
        times[p], drains[p] = a.elapsed_time(b), int(st[3])
    cnt = tlt.treelet_scan(pack, ori, d, easy, group=cfg.trav_group)[4]

    def per_packet(x, how):
        x = torch.nn.functional.pad(x.float(), (0, P * L - n)).view(P, L)
        return getattr(x, how)(1).cpu().numpy()

    live = easy > 0
    ovf = seed[2] > 0
    proxies = {"live lanes": per_packet(live, "sum"),
               "sum of K9 counts": per_packet(cnt * live, "sum"),
               "max K9 count": per_packet(cnt * live, "amax"),
               "seeded lanes that overflowed": per_packet(ovf & live, "sum"),
               "packet index, last first": np.arange(P, dtype=np.float64)}
    print(f"K10 whole pool: {whole:.3f} ms over {P} packets of {L} lanes")
    print(f"packets alone: sum / {SMS} SMs {times.sum() / SMS:.3f} ms, "
          f"longest {times.max():.3f} ms (packet {int(times.argmax())}, "
          f"{int(drains[times.argmax()])} drains), median "
          f"{np.median(times):.3f} ms; drains vs time correlation "
          f"{np.corrcoef(drains, times)[0, 1]:.3f}")
    print(f"longest 8 packets: {np.argsort(-times)[:8].tolist()}")
    print(f"makespan in launch order {makespan(range(P), times):.3f} ms, "
          f"longest first {makespan(np.argsort(-times), times):.3f} ms")
    for k, v in proxies.items():
        print(f"  longest first by {k} (correlation "
              f"{np.corrcoef(v, times)[0, 1]:.3f}): "
              f"{makespan(np.argsort(-v, kind='stable'), times):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
