"""Disk cache of the built acceleration tables, keyed by a fingerprint of
the mesh and the build parameters.

Counterpart of `tpt/scene/prepcache.py`: `HostScene.build` fingerprints
the host mesh (geometry and shading attributes, since the packed tables
carry shading rows) and the resolved build parameters, and stores or
loads the (bvh, pack, sweep) tables, so that every build after the first
of a large scene is a disk read. The port keeps its own directory and
its own format: one `.npz` of plain numpy arrays per entry, read with
pickling disabled. It never reads tpt's cache files or the repository's
`benchmarks/prebuilt/` tables (pickled JAX pytrees).

Opt out with TPT_NO_CACHE=1 or `build(prep_cache=False)`; point
elsewhere with TPT_TORCH_SCENE_CACHE_DIR.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import zipfile
from typing import Optional

import numpy as np
import torch

from ..bvh.pack import PacketBVH
from ..bvh.treelet import SweepTables
from ..core.vec import Vec3
from .structs import LBVHData

# bump when any builder changes its output layout (bvh/sah.py,
# bvh/build.py, bvh/pack.py, bvh/treelet.py) or this file's format
_VERSION = 1

_DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                            "tpt_torch_scene")
_KINDS = (("bvh", LBVHData), ("pack", PacketBVH), ("sweep", SweepTables))


def cache_dir() -> Optional[str]:
    if os.environ.get("TPT_NO_CACHE") == "1":
        return None
    return os.environ.get("TPT_TORCH_SCENE_CACHE_DIR") or _DEFAULT_DIR


def fingerprint(mesh, **params) -> str:
    """sha256 over the host mesh arrays and the build parameters."""
    h = hashlib.sha256()
    h.update(f"tpt_torch v{_VERSION}".encode())
    for a in (mesh.positions, mesh.normals, mesh.uvs, mesh.tangents,
              mesh.indices, mesh.material_ids):
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(repr(sorted(params.items())).encode())
    return h.hexdigest()


def _path(d: str, key: str) -> str:
    return os.path.join(d, key + ".npz")


def _flatten(tables) -> dict:
    """{kind.field: numpy array} of every tensor, Vec3 (as [N, 3]) and int
    field of the present tables."""
    flat = {}
    for (kind, _), obj in zip(_KINDS, tables):
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, Vec3):
                v = v.stacked()
            if isinstance(v, torch.Tensor):
                flat[f"{kind}.{f.name}"] = v.cpu().numpy()
            elif isinstance(v, (int, np.integer)):
                flat[f"{kind}.{f.name}"] = np.asarray(int(v), np.int64)
    return flat


def _rebuild(flat: dict, device) -> tuple:
    out = []
    for kind, cls in _KINDS:
        fields = {k.split(".", 1)[1]: v for k, v in flat.items()
                  if k.split(".", 1)[0] == kind}
        if not fields:
            out.append(None)
            continue
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in fields:
                continue
            v = fields[f.name]
            if v.ndim == 0:
                kw[f.name] = int(v)
                continue
            t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
            kw[f.name] = (Vec3.from_stacked(t) if f.name.startswith("aabb_")
                          else t)
        out.append(cls(**kw))
    return tuple(out)


def load(key: str, device) -> Optional[tuple]:
    """The (bvh, pack, sweep) tables of `key` on `device`, or None when
    there is no readable entry (a corrupt one counts as a miss)."""
    d = cache_dir()
    if d is None:
        return None
    try:
        with np.load(_path(d, key), allow_pickle=False) as f:
            flat = {k: f[k] for k in f.files}
        return _rebuild(flat, device)
    except (OSError, ValueError, KeyError, TypeError, EOFError,
            zipfile.BadZipFile):
        return None


def store(key: str, tables) -> None:
    """Write the (bvh, pack, sweep) tables atomically (a temporary file,
    then a rename)."""
    d = cache_dir()
    if d is None:
        return
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **_flatten(tables))
        os.replace(tmp, _path(d, key))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
