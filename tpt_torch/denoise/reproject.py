"""SVGF temporal reprojection: K6 `reproject`, the port's counterpart of
the Pallas kernel `reproject_pallas` (`tpt/denoise/pallas_reproject.py:227`).

On CUDA tensors the wrapper launches the hand-written kernel
(`tpt_torch/csrc/svgf.cu`, loaded by `stencil.py`); on CPU tensors it
runs the plain PyTorch version, `svgf._reproject_taps`. There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

The kernel computes `_reproject_taps` exactly, not the TPU kernel's
approximation: `reproject_pallas` shifts rows and columns separately and
drops history beyond +-reproject_radius pixels, both because a TPU lane
cannot gather; a CUDA thread gathers its four corners directly. So
SVGFConfig's `use_pallas_reproject` and `reproject_radius` select nothing
in the port. The two functions agree on smooth motion within the radius.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..core.vec import Vec3
from . import stencil
from .svgf import DATA_KEYS, SVGFState, _reproject_taps

# launches of the CUDA kernel in this process
LAUNCHES = {"reproject": 0}


def reproject(state: SVGFState, motion_u: torch.Tensor, motion_v: torch.Tensor,
              normal: Vec3, depth: torch.Tensor, matid: torch.Tensor
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K6: the history's consistency-tested 2x2 bilinear sums at
    (x - mu, y - mv). Returns (sums over DATA_KEYS, weight sum)."""
    hist = [state.hist_direct.x, state.hist_direct.y, state.hist_direct.z,
            state.hist_indirect.x, state.hist_indirect.y, state.hist_indirect.z,
            state.m1_dir, state.m1_ind, state.m2_dir, state.m2_ind,
            state.prev_normal.x, state.prev_normal.y, state.prev_normal.z,
            state.prev_depth]
    cur = [motion_u, motion_v, depth, normal.x, normal.y, normal.z]
    f32, i32 = torch.float32, torch.int32
    h, w = stencil.check_planes(
        hist + [state.prev_matid] + cur + [matid],
        [f32] * 14 + [i32] + [f32] * 6 + [i32], "reproject")
    dev = depth.device
    if dev.type == "cpu":
        return _reproject_taps(state, motion_u, motion_v, normal, depth, matid)
    out = [torch.empty((h, w), dtype=f32, device=dev)
           for _ in range(len(DATA_KEYS) + 1)]
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    stencil.run("reproject", dev, LAUNCHES, stencil.plane_array(hist),
                ptr(state.prev_matid), stencil.plane_array(cur), ptr(matid),
                stencil.plane_array(out), h, w)
    return dict(zip(DATA_KEYS, out[:-1])), out[-1]
