"""Frozen copy of tpt_torch/core/rng.py: the Wang-hash-seeded per-path
xorshift32 stream, 32-bit words held in int64 tensors."""
from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
_INV_2_32 = 2.3283064365386963e-10  # 1 / 2^32


def as_u32(x) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits."""
    return x.to(torch.int64) & MASK32


def wang_hash(seed: torch.Tensor) -> torch.Tensor:
    """Wang hash over 32-bit lanes."""
    seed = as_u32(seed)
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & MASK32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & MASK32
    seed = seed ^ (seed >> 15)
    return seed


def path_seed(pixel_idx: torch.Tensor, iteration: int) -> torch.Tensor:
    """Per-path stream seed (same mixing constants as the reference);
    zero seeds are bumped to 1 because xorshift32 has a fixed point at 0."""
    pix = as_u32(pixel_idx)
    it = int(iteration) & MASK32
    seed = wang_hash((pix * 19990303 + it * 719393) & MASK32)
    return torch.where(seed == 0, torch.ones_like(seed), seed)


def xorshift32(state: torch.Tensor) -> torch.Tensor:
    state = state ^ ((state << 13) & MASK32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & MASK32)
    return state


def rand_float(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance each lane's stream; return (new_state, uniform in [0, 1))."""
    state = xorshift32(state)
    return state, state.to(torch.float32) * _INV_2_32


def rand_float2(state):
    state, u1 = rand_float(state)
    state, u2 = rand_float(state)
    return state, u1, u2


def rand_float3(state):
    state, u1 = rand_float(state)
    state, u2 = rand_float(state)
    state, u3 = rand_float(state)
    return state, u1, u2, u3


def hash_to_unit_float(seed: torch.Tensor) -> torch.Tensor:
    """32-bit word -> [0,1) float without advancing a stream (camera
    jitter re-hashes the seed, as the reference does)."""
    return seed.to(torch.float32) * _INV_2_32
