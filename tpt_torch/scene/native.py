"""ctypes bindings to `native/tpt_native.cpp`: the binned-SAH builder,
the OBJ parser (with exact-bits vertex dedup) and the Radiance RLE
decoder.

The port compiles that source itself (g++, the flags of native/Makefile)
into its own build directory, `tpt_torch/_build/`, and never writes into
`native/`. If the compile fails, the error carries the compiler's
output; the OBJ loader and the HDR reader also have pure-Python paths
(`obj.load_obj(use_native=False)`, and a payload the native decoder
refuses), as tpt's do."""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from .. import _build

SOURCE = os.path.join(_build.REPO_DIR, "native", "tpt_native.cpp")
COMPILER = ["g++", "-O3", "-fPIC", "-std=c++17", "-shared"]
BUILD_TIMEOUT_S = 180.0


def _load() -> ctypes.CDLL:
    lib = _build.load_library("tpt_native", COMPILER, [SOURCE],
                              BUILD_TIMEOUT_S)
    if not getattr(lib, "_tpt_bound", False):
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
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        vp = ctypes.c_void_p
        lib.tpt_parse_obj.restype = vp
        lib.tpt_parse_obj.argtypes = [ctypes.c_char_p]
        lib.tpt_mesh_error.restype = ctypes.c_char_p
        lib.tpt_mesh_error.argtypes = [vp]
        lib.tpt_mesh_counts.restype = None
        lib.tpt_mesh_counts.argtypes = [
            vp, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.tpt_mesh_copy.restype = None
        lib.tpt_mesh_copy.argtypes = [vp] + [f32p] * 3 + [i32p] * 2
        for fn in (lib.tpt_mesh_material_name, lib.tpt_mesh_mtl_file):
            fn.restype = ctypes.c_int32
            fn.argtypes = [vp, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
        lib.tpt_free_mesh.restype = None
        lib.tpt_free_mesh.argtypes = [vp]
        lib.tpt_decode_hdr_rle.restype = ctypes.c_int32
        lib.tpt_decode_hdr_rle.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32, u8p]
        lib._tpt_bound = True
    return lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


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


def parse_obj_native(path: str):
    """Returns (positions [V,3], normals [V,3], uvs [V,2], indices [T,3],
    mat_ids [T] (into names), names list, mtl_files list): the parsed,
    fan-triangulated and vertex-deduplicated OBJ file."""
    lib = _load()
    h = lib.tpt_parse_obj(path.encode())
    try:
        err = lib.tpt_mesh_error(h)
        if err:
            raise IOError(f"native obj parse failed: {err.decode()}")
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        nm = ctypes.c_int32()
        nf = ctypes.c_int32()
        lib.tpt_mesh_counts(h, ctypes.byref(nv), ctypes.byref(nt),
                            ctypes.byref(nm), ctypes.byref(nf))
        pos = np.empty((nv.value, 3), np.float32)
        nrm = np.empty((nv.value, 3), np.float32)
        uv = np.empty((nv.value, 2), np.float32)
        idx = np.empty((nt.value, 3), np.int32)
        mat = np.empty((nt.value,), np.int32)
        if nv.value:
            lib.tpt_mesh_copy(h, pos, nrm, uv, idx, mat)
        buf = ctypes.create_string_buffer(4096)
        names: List[str] = []
        for i in range(nm.value):
            lib.tpt_mesh_material_name(h, i, buf, 4096)
            names.append(buf.value.decode(errors="replace"))
        mtls: List[str] = []
        for i in range(nf.value):
            lib.tpt_mesh_mtl_file(h, i, buf, 4096)
            mtls.append(buf.value.decode(errors="replace"))
        return pos, nrm, uv, idx, mat, names, mtls
    finally:
        lib.tpt_free_mesh(h)


def decode_hdr_rle_native(data: bytes, width: int, height: int
                          ) -> Optional[np.ndarray]:
    """The RGBE bytes [height, width, 4] of a Radiance payload (RLE or
    flat scanlines), or None if the decoder refuses it."""
    lib = _load()
    arr = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    rc = lib.tpt_decode_hdr_rle(np.ascontiguousarray(arr), arr.size,
                                width, height, out)
    return out if rc == 0 else None
