"""Texture atlas: host packing of LDR images into one RGBA sheet, and
lane-parallel bilinear wrap sampling.

Counterpart of `tpt/scene/texture.py`: the same shelf packer (so the
texels and placements equal tpt's) and the same sampling arithmetic.
One atlas means one gather source for every lane, whatever texture it
needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.vec import Vec3
from ..device import DeviceLike, resolve_device
from .structs import TextureAtlas


@dataclass
class AtlasBuilder:
    """Host-side accumulation of textures; shelf-packing into one sheet."""

    images: List[np.ndarray] = field(default_factory=list)  # each [h, w, 4] f32
    paths: dict = field(default_factory=dict)  # path -> tex id (dedup cache)

    def add(self, img: np.ndarray, path: Optional[str] = None) -> int:
        """Register an RGBA float image (values 0..1); returns texture id."""
        if path is not None and path in self.paths:
            return self.paths[path]
        if img.ndim == 2:
            img = np.repeat(img[..., None], 4, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        tex_id = len(self.images)
        self.images.append(np.ascontiguousarray(img, np.float32))
        if path is not None:
            self.paths[path] = tex_id
        return tex_id

    def build(self, device: DeviceLike = None) -> TextureAtlas:
        """The packed atlas on `device` (the CUDA card unless the caller
        asks for another); the empty atlas when no texture was added."""
        dev = resolve_device(device)
        if not self.images:
            return TextureAtlas.empty(dev)
        # shelf packer: sort by height desc, fill rows of a fixed width
        order = sorted(range(len(self.images)),
                       key=lambda i: -self.images[i].shape[0])
        sheet_w = max(128, max(int(im.shape[1]) for im in self.images))
        sheet_w = int(np.ceil(sheet_w / 128) * 128)
        x = y = shelf_h = 0
        place = [None] * len(self.images)
        for i in order:
            h, w = self.images[i].shape[:2]
            if x + w > sheet_w:
                y += shelf_h
                x = 0
                shelf_h = 0
            place[i] = (x, y)
            x += w
            shelf_h = max(shelf_h, h)
        sheet_h = y + shelf_h
        sheet_h = int(np.ceil(max(sheet_h, 8) / 8) * 8)

        sheet = np.zeros((sheet_h, sheet_w, 4), np.float32)
        for i, im in enumerate(self.images):
            px, py = place[i]
            h, w = im.shape[:2]
            sheet[py:py + h, px:px + w] = im
        cols = lambda k: [p[k] for p in place]
        return atlas_from_arrays(
            sheet, cols(0), cols(1), [im.shape[1] for im in self.images],
            [im.shape[0] for im in self.images], device=dev)


def atlas_from_arrays(sheet, x0, y0, width, height, *, device) -> TextureAtlas:
    """TextureAtlas on `device` from the numpy sheet [AH, AW, 4] (or the
    four planes stacked last) and the [Ntex] placements."""
    sheet = np.asarray(sheet, np.float32)
    plane = lambda c: torch.as_tensor(np.ascontiguousarray(sheet[..., c]),
                                      device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64),
                                    device=device)
    return TextureAtlas(r=plane(0), g=plane(1), b=plane(2), a=plane(3),
                        x0=i64(x0), y0=i64(y0), width=i64(width),
                        height=i64(height))


def _gather2d(plane: torch.Tensor, iy: torch.Tensor,
              ix: torch.Tensor) -> torch.Tensor:
    """plane[iy, ix] lane-parallel through one flat gather (indices
    clipped to the plane, as tpt's take(mode="clip"))."""
    flat = plane.reshape(-1)
    return flat[(iy * plane.shape[1] + ix).clamp(0, flat.shape[0] - 1)]


def sample_atlas(atlas: TextureAtlas, tex_id: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> Tuple[Vec3, torch.Tensor]:
    """Bilinear, wrap-mode texture fetch per lane: normalized coordinates,
    texel centres at (i + 0.5) / size (the CUDA linear-filter convention).

    Lanes with `tex_id < 0` return (1, 1, 1, 1): callers multiply, so no
    texture is the identity."""
    valid = tex_id >= 0
    tid = tex_id.to(torch.int64).clamp(0, atlas.num_textures - 1)
    tw = atlas.width[tid].to(torch.float32)
    th = atlas.height[tid].to(torch.float32)
    tx0 = atlas.x0[tid]
    ty0 = atlas.y0[tid]

    # wrap to [0, 1)
    uw = u - torch.floor(u)
    vw = v - torch.floor(v)

    # texel space: sample at coord * size - 0.5
    fx = uw * tw - 0.5
    fy = vw * th - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = fx - x0
    ay = fy - y0

    def wrap(i, n):
        return torch.remainder(i.to(torch.int32).to(torch.int64),
                               n.to(torch.int64).clamp_min(1))

    gx0 = tx0 + wrap(x0, tw)
    gx1 = tx0 + wrap(x0 + 1, tw)
    gy0 = ty0 + wrap(y0, th)
    gy1 = ty0 + wrap(y0 + 1, th)

    w00 = (1 - ax) * (1 - ay)
    w10 = ax * (1 - ay)
    w01 = (1 - ax) * ay
    w11 = ax * ay

    def bilinear(plane):
        return (_gather2d(plane, gy0, gx0) * w00
                + _gather2d(plane, gy0, gx1) * w10
                + _gather2d(plane, gy1, gx0) * w01
                + _gather2d(plane, gy1, gx1) * w11)

    r = bilinear(atlas.r)
    g = bilinear(atlas.g)
    b = bilinear(atlas.b)
    a = bilinear(atlas.a)
    one = torch.ones_like(r)
    rgb = Vec3(torch.where(valid, r, one), torch.where(valid, g, one),
               torch.where(valid, b, one))
    return rgb, torch.where(valid, a, one)
