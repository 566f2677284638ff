"""ctypes binding to the binned-SAH builder of `native/tpt_native.cpp`.

The port compiles that source itself (g++, the flags of native/Makefile)
into its own build directory, `tpt_torch/_build/`, and never writes into
`native/`. There is no fallback builder: if the compile fails, the error
carries the compiler's output."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build

SOURCE = os.path.join(_build.REPO_DIR, "native", "tpt_native.cpp")
COMPILER = ["g++", "-O3", "-fPIC", "-std=c++17", "-shared"]
BUILD_TIMEOUT_S = 180.0


def _load() -> ctypes.CDLL:
    lib = _build.load_library("tpt_native", COMPILER, [SOURCE],
                              BUILD_TIMEOUT_S)
    if not getattr(lib, "_tpt_sah_bound", False):
        f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.tpt_build_sah.restype = ctypes.c_void_p
        lib.tpt_build_sah.argtypes = [f32p, ctypes.c_int64]
        lib.tpt_sah_counts.restype = None
        lib.tpt_sah_counts.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int64)]
        lib.tpt_sah_copy.restype = None
        lib.tpt_sah_copy.argtypes = [ctypes.c_void_p] + [i32p] * 4 + [f32p] * 2
        lib.tpt_free_sah.restype = None
        lib.tpt_free_sah.argtypes = [ctypes.c_void_p]
        lib._tpt_sah_bound = True
    return lib


def build_sah_native(v012: np.ndarray):
    """Binned-SAH BVH build. v012: [T, 9] float32 triangle corners.
    Returns (left, right, parent, prim_index, aabb_min [N,3], aabb_max)
    in the standard layout (internal [0, T-2], leaves [T-1, 2T-2])."""
    lib = _load()
    v012 = np.ascontiguousarray(v012, np.float32)
    h = lib.tpt_build_sah(v012, v012.shape[0])
    if not h:
        raise RuntimeError("tpt_build_sah returned no result")
    try:
        total = ctypes.c_int64()
        lib.tpt_sah_counts(h, ctypes.byref(total))
        n = total.value
        if n == 0:
            raise RuntimeError("tpt_build_sah built an empty tree")
        left = np.empty(n, np.int32)
        right = np.empty(n, np.int32)
        parent = np.empty(n, np.int32)
        prim = np.empty(n, np.int32)
        amin = np.empty((n, 3), np.float32)
        amax = np.empty((n, 3), np.float32)
        lib.tpt_sah_copy(h, left, right, parent, prim, amin.reshape(-1),
                         amax.reshape(-1))
        return left, right, parent, prim, amin, amax
    finally:
        lib.tpt_free_sah(h)
