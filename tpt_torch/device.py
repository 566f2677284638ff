"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    There is no silent fallback: with no GPU present, a caller that did
    not ask for the CPU gets an error, so a measurement can never run on
    the wrong device unnoticed."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpt_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
