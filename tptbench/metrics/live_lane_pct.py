"""The share of the path pool's lanes that are live where each bounce
casts its extension rays, in %: 100 x the port's `live` counter over
its `lanes` counter (`tpt_torch.trace.frame_counters`), summed over the
bounces of one counted frame after the traced stretch. The eager shading
runs over every lane of the pool; this is the share it needs."""

FRAME = "tpt_torch.engine:Renderer.frame"


def hooks(store):
    def keep(args, kwargs, result):
        try:
            from tpt_torch import trace
        except ImportError:  # a port without counters of its own
            return
        store["frame_counters"] = trace.frame_counters()

    return {FRAME: keep}


def read(trace):
    c = trace.counters.get("frame_counters") or {}
    if not c.get("lanes"):
        return None
    return 100.0 * c.get("live", 0) / c["lanes"]
