"""Pinhole camera with the reference's derived-vector conventions and
jittered primary-ray generation. Counterpart of `tpt/core/camera.py`:
the same host-side `Camera` and the same float32 ray arithmetic, so the
rays are bit-identical to the JAX package's."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import rng
from .vec import Vec3


@dataclass(frozen=True)
class Camera:
    """Host-side camera description."""

    resolution: Tuple[int, int]  # (width, height)
    position: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fovy_deg: float

    # derived (filled by `build`)
    view: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    right: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    true_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    pixel_length: Tuple[float, float] = (0.0, 0.0)
    fovx_deg: float = 0.0

    @staticmethod
    def build(resolution, position, look_at, up, fovy_deg) -> "Camera":
        w, h = int(resolution[0]), int(resolution[1])
        pos = np.asarray(position, np.float64)
        tgt = np.asarray(look_at, np.float64)
        upv = np.asarray(up, np.float64)

        yscaled = math.tan(math.radians(fovy_deg * 0.5))
        xscaled = yscaled * w / h
        fovx = math.degrees(math.atan(xscaled)) * 2.0

        view = tgt - pos
        view /= np.linalg.norm(view)
        right = np.cross(view, upv)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, view)
        true_up /= np.linalg.norm(true_up)

        return Camera(
            resolution=(w, h),
            position=tuple(float(v) for v in pos),
            look_at=tuple(float(v) for v in tgt),
            up=tuple(float(v) for v in upv),
            fovy_deg=float(fovy_deg),
            view=tuple(float(v) for v in view),
            right=tuple(float(v) for v in right),
            true_up=tuple(float(v) for v in true_up),
            pixel_length=(2.0 * xscaled / w, 2.0 * yscaled / h),
            fovx_deg=float(fovx),
        )

    @property
    def num_pixels(self) -> int:
        return self.resolution[0] * self.resolution[1]

    def moved(self, position=None, look_at=None) -> "Camera":
        return Camera.build(
            self.resolution,
            position if position is not None else self.position,
            look_at if look_at is not None else self.look_at,
            self.up,
            self.fovy_deg,
        )


def _f32(v: float) -> float:
    """A Python float rounded to float32 (the reference's weak-typed
    scalars enter its arithmetic as float32)."""
    return float(np.float32(v))


def generate_camera_rays(cam: Camera, iteration: int, jitter: bool = True,
                         pix: Optional[torch.Tensor] = None,
                         device: DeviceLike = None):
    """Primary rays for every pixel (or for the given pixel indices).

    Returns (origin: Vec3[N], direction: Vec3[N], rng_state: int64[N])
    with pixel index = y*W + x; the jitter re-hashes the path seed twice
    so the shading stream stays aligned with the reference's."""
    w, h = cam.resolution
    if pix is None:
        dev = resolve_device(device)
        pix = torch.arange(w * h, dtype=torch.int64, device=dev)
    else:
        dev = pix.device
        pix = rng.as_u32(pix)
    n = pix.shape[0]
    x = (pix % w).to(torch.float32)
    y = (pix // w).to(torch.float32)

    seed = rng.path_seed(pix, iteration)
    if jitter:
        s1 = rng.wang_hash(seed)
        s2 = rng.wang_hash(s1)
        jx = rng.hash_to_unit_float(s1) - 0.5
        jy = rng.hash_to_unit_float(s2) - 0.5
    else:
        jx = torch.zeros_like(x)
        jy = torch.zeros_like(y)

    view = [_f32(c) for c in cam.view]
    right = [_f32(c) for c in cam.right]
    up = [_f32(c) for c in cam.true_up]
    plx, ply = _f32(cam.pixel_length[0]), _f32(cam.pixel_length[1])
    half_w, half_h = _f32(0.5 * w), _f32(0.5 * h)

    sx = plx * (x + jx - half_w)
    sy = ply * (y + jy - half_h)
    d = Vec3(view[0] + right[0] * sx - up[0] * sy,
             view[1] + right[1] * sx - up[1] * sy,
             view[2] + right[2] * sx - up[2] * sy).normalize()

    origin = Vec3.splat(cam.position, (n,), dev)
    return origin, d, seed
