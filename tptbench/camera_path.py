"""The one camera-path generator every traffic mix uses. A mix is a data
file under traffic/ whose "camera" object gives the path's parameters:

- "yaw_step_deg" s, "yaw_amplitude_deg" a: the camera yaws about the up
  axis through the configuration's look-at point, s degrees at each move,
  back and forth between -a and +a degrees (a triangle wave, so it stays
  in the room). With s = 0 it keeps the yaw it starts at.
- "moves" m, "rests" r: a cycle of m frames that each move the camera
  (`Renderer.move_camera` before the frame, which restarts the
  accumulation and SVGF's history) then r frames that leave it where it
  is (the accumulation and the history build up). m = 0 never moves it
  after the first frame.

The seed picks where on the triangle wave a run starts (so with s = 0 the
camera's one yaw) and where in the cycle, so every seed sees the same kind
of views and histories in another order. Frame 0 always places the camera
at its starting yaw.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


def yawed_position(position, look_at, up, deg: float):
    """`position` turned by `deg` degrees about the axis `up` through
    `look_at` (Rodrigues' rotation)."""
    axis = np.asarray(up, np.float64)
    axis = axis / np.linalg.norm(axis)
    pivot = np.asarray(look_at, np.float64)
    v = np.asarray(position, np.float64) - pivot
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    rot = v * c + np.cross(axis, v) * s + axis * axis.dot(v) * (1.0 - c)
    return tuple(float(x) for x in pivot + rot)


def orbit_angle(step_deg: float, amplitude_deg: float, phase: float,
                k: int) -> float:
    """The yaw after k steps on the triangle wave of period
    4 * amplitude_deg that starts `phase` degrees along it."""
    period = 4.0 * amplitude_deg
    x = (phase + k * step_deg) % period
    if x < 2.0 * amplitude_deg:
        return x - amplitude_deg
    return 3.0 * amplitude_deg - x


@dataclass(frozen=True)
class CameraPath:
    step_deg: float
    amplitude_deg: float
    moves: int
    rests: int
    phase: float
    offset: int

    def moved(self, k: int) -> bool:
        """Whether the camera moves before frame k."""
        if k == 0:
            return True
        if self.moves == 0:
            return False
        return (k - 1 + self.offset) % (self.moves + self.rests) < self.moves

    def steps(self, k: int) -> int:
        """Moves made after frame 0, up to and including frame k."""
        cycle = self.moves + self.rests
        # positions i in [0, n) of the cycle with i % cycle < moves
        upto = lambda n: (n // cycle) * self.moves + min(n % cycle, self.moves)
        return upto(self.offset + k) - upto(self.offset)

    def yaw(self, k: int) -> float:
        """Frame k's yaw in degrees (apply with `yawed_position`)."""
        if self.amplitude_deg == 0.0:
            return 0.0
        return orbit_angle(self.step_deg, self.amplitude_deg, self.phase,
                           self.steps(k))

    def history(self, k: int) -> Tuple[float, int]:
        """(frame k's yaw, frames rendered from that view since the last
        move, frame k included)."""
        j = k
        while not self.moved(j):
            j -= 1
        return self.yaw(k), k - j + 1


def camera_path(spec: dict, seed: int) -> CameraPath:
    step = float(spec["yaw_step_deg"])
    amp = float(spec["yaw_amplitude_deg"])
    moves, rests = int(spec["moves"]), int(spec["rests"])
    if step < 0.0 or amp < 0.0 or moves < 0 or rests < 0 \
            or moves + rests < 1 or (step > 0.0 and amp == 0.0):
        raise ValueError(f"not a camera path: {spec}")
    draw = np.random.default_rng(seed)
    phase = float(draw.uniform(0.0, 4.0 * amp))
    offset = int(draw.integers(0, moves + rests))
    return CameraPath(step, amp, moves, rests, phase, offset)
