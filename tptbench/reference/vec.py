"""Frozen copy of tpt_torch/core/vec.py (the plain reference imports
nothing of the program): a structure-of-arrays 3-vector of torch tensors."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

Scalar = Union[float, int, torch.Tensor]


@dataclass(frozen=True)
class Vec3:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # ---- constructors -------------------------------------------------
    @staticmethod
    def full(shape, value: Scalar, device, dtype=torch.float32) -> "Vec3":
        return Vec3(*(torch.full(shape, value, dtype=dtype, device=device)
                      for _ in range(3)))

    @staticmethod
    def zeros(shape, device, dtype=torch.float32) -> "Vec3":
        return Vec3.full(shape, 0.0, device, dtype)

    @staticmethod
    def ones(shape, device, dtype=torch.float32) -> "Vec3":
        return Vec3.full(shape, 1.0, device, dtype)

    @staticmethod
    def splat(v, shape, device) -> "Vec3":
        """Broadcast a length-3 constant to `shape` (float32-rounded
        first, as the reference's jnp.asarray(c, float32) does)."""
        comps = [torch.full(shape, float(torch.tensor(float(v[i]),
                                                      dtype=torch.float32)),
                            dtype=torch.float32, device=device)
                 for i in range(3)]
        return Vec3(*comps)

    @staticmethod
    def from_stacked(arr: torch.Tensor) -> "Vec3":
        """(..., 3) tensor -> Vec3 of contiguous (...,) components."""
        return Vec3(arr[..., 0].contiguous(), arr[..., 1].contiguous(),
                    arr[..., 2].contiguous())

    def stacked(self) -> torch.Tensor:
        """Vec3 -> (..., 3) tensor (IO and interop only)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    # ---- basic properties ---------------------------------------------
    @property
    def shape(self):
        return tuple(self.x.shape)

    @property
    def device(self) -> torch.device:
        return self.x.device

    # ---- arithmetic ----------------------------------------------------
    def _bin(self, other, op) -> "Vec3":
        if isinstance(other, Vec3):
            return Vec3(op(self.x, other.x), op(self.y, other.y), op(self.z, other.z))
        return Vec3(op(self.x, other), op(self.y, other), op(self.z, other))

    def __add__(self, o): return self._bin(o, torch.add)
    def __radd__(self, o): return self._bin(o, torch.add)
    def __sub__(self, o): return self._bin(o, torch.sub)
    def __mul__(self, o): return self._bin(o, torch.mul)
    def __rmul__(self, o): return self._bin(o, torch.mul)
    def __neg__(self): return Vec3(-self.x, -self.y, -self.z)

    # ---- geometry ------------------------------------------------------
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.length_sq())

    def normalize(self, eps: float = 1e-20) -> "Vec3":
        inv = torch.rsqrt(torch.clamp_min(self.length_sq(), eps))
        return self * inv

    def max_component(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def sum(self) -> torch.Tensor:
        return self.x + self.y + self.z

    def mean(self) -> torch.Tensor:
        return self.sum() * (1.0 / 3.0)

    # ---- structural ops -------------------------------------------------
    def take(self, idx: torch.Tensor) -> "Vec3":
        """Gather components at `idx` (clipped to range, as jnp.take's
        mode='clip')."""
        i = idx.clamp(0, self.x.shape[0] - 1)
        return Vec3(self.x[i], self.y[i], self.z[i])

    def __getitem__(self, k) -> "Vec3":
        return Vec3(self.x[k], self.y[k], self.z[k])

    def map(self, fn) -> "Vec3":
        return Vec3(fn(self.x), fn(self.y), fn(self.z))


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Componentwise select between two Vec3."""
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))
