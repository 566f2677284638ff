"""The SVGF a-trous stencil: K5 `atrous`, the port's counterpart of the
Pallas kernel `atrous_pallas` (`tpt/denoise/pallas_stencil.py:180`).

On CUDA tensors the wrapper launches the hand-written kernel
(`tpt_torch/csrc/svgf.cu`, built with nvcc for sm_90a on first use and
bound with ctypes); on CPU tensors it runs the plain PyTorch version,
`svgf._atrous_once`. There is no fallback between the two: a CUDA tensor
launches the kernel or raises. The kernel computes `_atrous_once`'s
float32 operations in its order, so the two agree bit for bit.
`atrous_passes` runs a frame's passes (run_svgf's loop) in one call:
on the card through packed records a pixel, pass after pass.

This module also loads the library that holds K6 (`reproject.py`).
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import torch

from .. import _build
from ..bvh.packet_traverse import NVCC_FLAGS
from ..config import SVGFConfig
from ..core.vec import Vec3
from .svgf import _atrous_once

# launches of the CUDA kernel in this process (chip_smoke.py resets and
# reads them around the main path to show the path went through it)
LAUNCHES = {"atrous": 0}

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "svgf.cu")
BUILD_TIMEOUT_S = 600.0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("tpt_svgf", [_build.find_nvcc()] + NVCC_FLAGS,
                              [SOURCE], BUILD_TIMEOUT_S)
    if not getattr(lib, "_tpt_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tpt_atrous.restype = ctypes.c_int
        lib.tpt_atrous.argtypes = [p, p, i, i, i, f, f, f, p]
        lib.tpt_atrous_passes.restype = ctypes.c_int
        lib.tpt_atrous_passes.argtypes = [p, p, p, p, i, i, i, f, f, f, p]
        lib.tpt_reproject.restype = ctypes.c_int
        lib.tpt_reproject.argtypes = [p, p, p, p, p, i, i, p]
        lib._tpt_bound = True
    return lib


def build_kernels() -> None:
    """Compile and load the CUDA library now (otherwise at first launch)."""
    _lib()


def check_planes(planes: Sequence[torch.Tensor], dtypes, what: str) -> Tuple[int, int]:
    """Every plane a contiguous [H, W] tensor of its dtype on one device;
    returns (H, W)."""
    shape, dev = tuple(planes[0].shape), planes[0].device
    for a, dt in zip(planes, dtypes):
        if a.device != dev or a.dtype != dt or tuple(a.shape) != shape \
                or a.dim() != 2 or not a.is_contiguous():
            raise ValueError(f"{what}: planes must be contiguous [H, W] "
                             f"tensors of one shape on one device ({dt})")
    if shape[0] * shape[1] >= 2**31:
        raise ValueError(f"{what}: {shape} exceeds the kernel's int32 index")
    return shape


def plane_array(planes: Sequence[torch.Tensor]):
    """A host array of the planes' device pointers for the C interface."""
    return (ctypes.c_void_p * len(planes))(*[a.data_ptr() for a in planes])


def run(name: str, dev: torch.device, launches: dict, *args,
        count_as=None, kernels: int = 1) -> None:
    """Launch tpt_<name> on the current stream; raise on a CUDA error."""
    _build.launch(_lib, launches, name, dev, *args, count_as=count_as,
                  kernels=kernels)


def atrous_plain(ill_d: Vec3, var_d, ill_i: Vec3, var_i, depth, normal: Vec3,
                 step: int, sigma_z: float, sigma_n: float, sigma_l: float):
    """The plain version of K5 (`svgf._atrous_once`) with atrous's
    arguments, on any device."""
    cfg = SVGFConfig(sigma_z=sigma_z, sigma_n=sigma_n, sigma_l=sigma_l)
    return _atrous_once(ill_d, var_d, ill_i, var_i, depth, normal, step, cfg)


def _planes(ill_d, var_d, ill_i, var_i, depth, normal):
    planes = [ill_d.x, ill_d.y, ill_d.z, var_d, ill_i.x, ill_i.y, ill_i.z,
              var_i, depth, normal.x, normal.y, normal.z]
    return planes, check_planes(planes, [torch.float32] * 12, "atrous")


def _outputs(h: int, w: int, dev):
    return [torch.empty((h, w), dtype=torch.float32, device=dev)
            for _ in range(8)]


def _filtered(out):
    return Vec3(*out[0:3]), out[3], Vec3(*out[4:7]), out[7]


def atrous(ill_d: Vec3, var_d: torch.Tensor, ill_i: Vec3, var_i: torch.Tensor,
           depth: torch.Tensor, normal: Vec3, step: int, sigma_z: float,
           sigma_n: float, sigma_l: float):
    """K5: one a-trous pass with stride `step` over float32 [H, W] planes.
    Returns (illum_d Vec3, var_d, illum_i Vec3, var_i)."""
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    planes, (h, w) = _planes(ill_d, var_d, ill_i, var_i, depth, normal)
    dev = depth.device
    if dev.type == "cpu":
        return atrous_plain(ill_d, var_d, ill_i, var_i, depth, normal, step,
                            sigma_z, sigma_n, sigma_l)
    out = _outputs(h, w, dev)
    run("atrous", dev, LAUNCHES, plane_array(planes), plane_array(out), h, w,
        step, sigma_z, sigma_n, sigma_l)
    return _filtered(out)


def atrous_passes_plain(ill_d: Vec3, var_d, ill_i: Vec3, var_i, depth,
                        normal: Vec3, iterations: int, sigma_z: float,
                        sigma_n: float, sigma_l: float):
    """The plain version of `atrous_passes`: `iterations` plain passes."""
    cur, hist = (ill_d, var_d, ill_i, var_i), None
    for it in range(iterations):
        cur = atrous_plain(*cur, depth, normal, 1 << it, sigma_z, sigma_n,
                           sigma_l)
        if it == iterations - 2:
            hist = cur
    return cur, (cur if hist is None else hist)


def atrous_passes(ill_d: Vec3, var_d: torch.Tensor, ill_i: Vec3,
                  var_i: torch.Tensor, depth: torch.Tensor, normal: Vec3,
                  iterations: int, sigma_z: float, sigma_n: float,
                  sigma_l: float):
    """K5 over a frame: `iterations` a-trous passes at steps 1, 2, 4, ...
    (run_svgf's loop), launched by one call. Returns (the last pass's
    output, the output of pass iterations - 2, run_svgf's history; the
    last pass's below two passes), each (illum_d Vec3, var_d, illum_i
    Vec3, var_i). On the card the first pass reads the planes and writes
    a packed record a pixel, the others read and write those records;
    each pass is one launch of K5."""
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    planes, (h, w) = _planes(ill_d, var_d, ill_i, var_i, depth, normal)
    dev = depth.device
    if dev.type == "cpu" or iterations == 0:
        return atrous_passes_plain(ill_d, var_d, ill_i, var_i, depth, normal,
                                   iterations, sigma_z, sigma_n, sigma_l)
    out = _outputs(h, w, dev)
    hist = _outputs(h, w, dev) if iterations >= 2 else out
    packed = torch.empty((5, h * w, 4), dtype=torch.float32, device=dev)
    run("atrous_passes", dev, LAUNCHES, plane_array(planes),
        plane_array(out), plane_array(hist), packed.data_ptr(), h, w,
        iterations, sigma_z, sigma_n, sigma_l, count_as="atrous",
        kernels=iterations)
    return _filtered(out), _filtered(hist)
