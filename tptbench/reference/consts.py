"""Constants and small helpers of the plain reference: the material
classes and the renderer's ray-offset, delta-lobe and MIS conventions
(copied from tpt_torch/core/mathutil.py and tpt_torch/scene/structs.py)."""

from __future__ import annotations

from enum import IntEnum

import torch

from .vec import Vec3

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
EPSILON = 1e-3            # geometric ray-offset epsilon
PDF_DIRAC_DELTA = 1e10    # sentinel pdf marking delta (perfect-specular) lobes
DELTA_THRESHOLD = 1e9     # pdf above this is treated as a delta lobe
FLT_MAX = 3.4e38          # miss distance


class MaterialType(IntEnum):
    MICROFACET_PBR = 0
    DIFFUSE = 1
    SPECULAR_REFLECTION = 2
    SPECULAR_REFRACTION = 3


def power_heuristic(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2) with the renderer's tie-break epsilon."""
    f2 = f * f
    return f2 / (f2 + g * g + 1e-5)


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror direction; `d` points into the surface."""
    return d - n * (2.0 * d.dot(n))
