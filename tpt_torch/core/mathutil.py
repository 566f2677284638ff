"""Shared math: constants, reflection, MIS heuristic and the host-side
TRS and projection matrices. Counterpart of `tpt/core/mathutil.py`; the
constants are the reference's (EPSILON ray offset, PDF_DIRAC_DELTA
sentinel)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .vec import Vec3

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
INV_TWO_PI = 1.0 / TWO_PI
EPSILON = 1e-3  # geometric ray-offset epsilon
PDF_DIRAC_DELTA = 1e10  # sentinel pdf marking delta (perfect-specular) lobes
DELTA_THRESHOLD = 1e9  # pdf above this is treated as a delta lobe


def power_heuristic(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2) with the reference's tie-break epsilon."""
    f2 = f * f
    return f2 / (f2 + g * g + 1e-5)


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror direction; `d` points *into* the surface."""
    return d - n * (2.0 * d.dot(n))


def build_trs_matrix(translation, rotation_deg, scale) -> np.ndarray:
    """Host-side 4x4 TRS (T * Rx * Ry * Rz * S), row-major float32 numpy,
    the reference scene convention."""
    tx, ty, tz = translation
    rx, ry, rz = (math.radians(r) for r in rotation_deg)
    sx, sy, sz = scale

    def rot_x(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                         [0, 0, 0, 1]], np.float64)

    def rot_y(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                         [0, 0, 0, 1]], np.float64)

    def rot_z(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]], np.float64)

    t = np.eye(4)
    t[:3, 3] = [tx, ty, tz]
    s = np.diag([sx, sy, sz, 1.0])
    return (t @ rot_x(rx) @ rot_y(ry) @ rot_z(rz) @ s).astype(np.float32)


def perspective_look_at(eye, center, up, fovy_deg, aspect, znear=0.1,
                        zfar=1000.0) -> np.ndarray:
    """view_proj = perspective(fovy) @ lookAt, host-side numpy with GL
    clip conventions (used for first-bounce motion vectors)."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)

    f = center - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3] = s
    view[1, :3] = u
    view[2, :3] = -f
    view[0, 3] = -s.dot(eye)
    view[1, 3] = -u.dot(eye)
    view[2, 3] = f.dot(eye)

    t = math.tan(math.radians(fovy_deg) / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / (aspect * t)
    proj[1, 1] = 1.0 / t
    proj[2, 2] = -(zfar + znear) / (zfar - znear)
    proj[2, 3] = -(2.0 * zfar * znear) / (zfar - znear)
    proj[3, 2] = -1.0
    return (proj @ view).astype(np.float32)


def project_to_screen_uv(p: Vec3, view_proj: np.ndarray):
    """World point -> [0,1]^2 screen UV under the float32 4x4 `view_proj`.
    Returns (u, v, valid) with v flipped to image convention."""
    vp = [[float(view_proj[r, c]) for c in range(4)] for r in range(4)]
    cx = vp[0][0] * p.x + vp[0][1] * p.y + vp[0][2] * p.z + vp[0][3]
    cy = vp[1][0] * p.x + vp[1][1] * p.y + vp[1][2] * p.z + vp[1][3]
    cw = vp[3][0] * p.x + vp[3][1] * p.y + vp[3][2] * p.z + vp[3][3]
    valid = torch.abs(cw) > 1e-8
    inv_w = torch.where(valid, 1.0 / torch.where(valid, cw, 1.0), 0.0)
    u = cx * inv_w * 0.5 + 0.5
    v = 1.0 - (cy * inv_w * 0.5 + 0.5)
    return u, v, valid
