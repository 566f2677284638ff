"""Build-on-first-use for the port's native libraries.

Each library is compiled by one compiler call (g++ for the host SAH
builder, nvcc for the CUDA kernels) into a plain shared library with a C
interface, loaded with ctypes. Nothing includes PyTorch's headers, so a
build takes seconds. Outputs go to `tpt_torch/_build/` (git-ignored),
named by a hash of the sources and the command, so a changed source or
flag never loads a stale library; concurrent builders (test workers)
each write a private temporary file and publish it with an atomic
rename. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_loaded: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling in this process and the compiler's messages, by
# library name (chip_smoke.py reports them in its build phase)
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _digest(cmd: Sequence[str], files: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in files:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library(name: str, compiler: List[str], sources: Sequence[str],
                  timeout: float, headers: Sequence[str] = ()) -> str:
    """Compile `sources` with `compiler + [-o out] + sources` unless a
    library of the same sources, headers and command exists; return its
    path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _digest(compiler, list(sources) + list(headers))
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(compiler + ["-o", tmp] + list(sources),
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"building {name} exceeded {timeout:.0f} s: "
                           f"{' '.join(compiler)}") from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"building {name} failed (rc {proc.returncode}):\n"
            f"{' '.join(compiler)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stdout + proc.stderr
    return out


def load_library(name: str, compiler: List[str], sources: Sequence[str],
                 timeout: float, headers: Sequence[str] = ()) -> ctypes.CDLL:
    """build_library + ctypes.CDLL, once per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(
            build_library(name, compiler, sources, timeout, headers))
    return _loaded[name]
