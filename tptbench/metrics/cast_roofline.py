"""The sweep casts' share of their roofline, in %: the least time that
the results of one frame's K3 scans and sweep casts (K4 with its K2
tail) need, over the device time of the kernels launched inside the
benchmark's spans around those calls (wavefront._sweep_scan_keys and
sweepcast.sweep_cast_sorted) in the traced stretch, per frame. The least
time counts, per call, the larger of the operations over the fp32
instruction peak and the bytes over the memory peak (roofline/need.py),
in one counted frame after the stretch (the camera rests, so its frames
do the same work)."""

from ..roofline.need import k3_need, k4_need, least_seconds

SCAN = "tpt_torch.integrators.wavefront:_sweep_scan_keys"
SWEEP = "tpt_torch.bvh.sweepcast:sweep_cast_sorted"


def hooks(store):
    def scan(args, kwargs, result):
        scene, cfg, pool = args[0], args[1], args[2]
        tables = scene.sweep
        ops, nbytes = k3_need(pool[5], tables.num_treelets, cfg.sweep_slots,
                              tables.boxes.numel())
        store.setdefault("cast_least_s", []).append(least_seconds(ops, nbytes))

    def sweep(args, kwargs, result):
        tables, t_max, s_o, s_t = args[1], args[4], args[5], args[6]
        hit = result[0]
        ops, nbytes = k4_need(tables.tri_f32, tables.ranges,
                              tables.group_boxes, tables.unroll,
                              tables.num_treelets, t_max, s_o, s_t, hit.t,
                              hit.tri)
        store.setdefault("cast_least_s", []).append(least_seconds(ops, nbytes))

    return {SCAN: scan, SWEEP: sweep}


def read(trace):
    least = trace.counters.get("cast_least_s")
    k = trace.launched_in(trace.spans_named(["cast.scan", "cast.sweep"]))
    if not least or not k:
        return None
    device_s = sum(o.end - o.start for o in k) / 1e6 / len(trace.frames)
    return 100.0 * sum(least) / device_s
