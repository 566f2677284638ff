"""Device milliseconds a frame of the kernels that are not the port's own
CUDA kernels: PyTorch's eager shading, sorting and bookkeeping. The
port's kernels are the `__global__` functions of tpt_torch/csrc, read
from the sources of the checkout."""

import functools
import glob
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@functools.lru_cache(maxsize=1)
def port_kernel_pattern():
    names = set()
    for src in glob.glob(os.path.join(ROOT, "tpt_torch", "csrc", "*.cu")):
        with open(src) as f:
            text = f.read()
        names.update(re.findall(
            r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(?:void\s+)?(\w+)\s*\(", text))
    if not names:
        return None
    # a demangled name: "void walk_kernel<4, false>(...)" or "walk_kernel"
    return re.compile(r"(?:^|[\s:])(?:%s)\s*[<(]|^(?:%s)$" % (
        "|".join(sorted(names)), "|".join(sorted(names))))


def is_port_kernel(name: str) -> bool:
    pat = port_kernel_pattern()
    return bool(pat and pat.search(name) and "at::" not in name)


def read(trace):
    k = trace.kernels()
    if not k:
        return None
    us = sum(o.end - o.start for o in k if not is_port_kernel(o.name))
    return us / 1e3 / len(trace.frames)
