"""The hero scene's files, written without the JAX package.

`scenes/hero.json` names an OBJ, its MTL, an HDR sky and four PNG
textures. The OBJ, MTL, HDR and JSON are tracked in `scenes/`; the PNGs
are not (`.gitignore` lists `*.png`) and `scenes/make_scenes.py`, which
makes them, imports the JAX package. `write_hero_assets(out_dir)` makes
the four textures with copies of `make_scenes.py`'s generators (numpy
only), writes them with the port's PNG writer, and copies the tracked
files beside them, so `load_scene(os.path.join(out_dir, "hero.json"))`
loads the hero scene. It never writes into `scenes/`.

    python -m tpt_torch.scene.hero_assets OUT_DIR
"""

from __future__ import annotations

import math
import os
import shutil
import sys

import numpy as np

from .._build import REPO_DIR
from ..io.image import write_png

SCENES_DIR = os.path.join(REPO_DIR, "scenes")
TRACKED = ("hero.json", "hero_studio.obj", "hero_studio.mtl", "hero_env.hdr")
TEXTURES = ("hero_checker.png", "hero_bricks.png", "hero_normal.png",
            "hero_mr.png")


def checker(size=256, tiles=8, c0=(0.82, 0.78, 0.72), c1=(0.28, 0.26, 0.30)):
    """The floor's checker albedo, uint8 [size, size, 3]."""
    y, x = np.mgrid[0:size, 0:size]
    t = ((x * tiles // size) + (y * tiles // size)) % 2
    rng = np.random.default_rng(5)
    noise = rng.uniform(0.93, 1.0, (size, size, 1)).astype(np.float32)
    img = np.where(t[..., None] == 0, np.float32(c0), np.float32(c1)) * noise
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def bricks(size=256, rows=8, cols=4):
    """The wall's brick albedo, uint8 [size, size, 3]."""
    y, x = np.mgrid[0:size, 0:size]
    ry = (y * rows) // size
    shift = (ry % 2) * (size // (2 * cols))
    bx = ((x + shift) * cols) // size
    mortar = (((y * rows) % size < size * 0.06)
              | (((x + shift) * cols) % size < size * 0.08))
    brick = np.float32([0.62, 0.28, 0.20]) * (
        0.85 + 0.15 * np.cos(bx * 2.1 + ry * 1.3))[..., None]
    img = np.where(mortar[..., None], np.float32([0.75, 0.73, 0.70]), brick)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def ripple_normal_map(size=256, freq=3.0, amp=0.08):
    """Tangent-space normal map of an analytic ripple height field,
    uint8 [size, size, 3]."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    h = amp * np.sin(2 * math.pi * freq * x) * np.sin(2 * math.pi * freq * y)
    dhdx = np.gradient(h, axis=1) * size
    dhdy = np.gradient(h, axis=0) * size
    n = np.stack([-dhdx, -dhdy, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((n * 0.5 + 0.5) * 255).astype(np.uint8)


def metallic_roughness():
    """The metal sphere's map, uint8 [64, 64, 3]: G scales roughness
    (a checker of 90 and 210), B metallic (255)."""
    mr = np.zeros((64, 64, 3), np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    mr[..., 1] = 90 + 120 * ((xx // 16 + yy // 16) % 2)
    mr[..., 2] = 255
    return mr


def write_hero_assets(out_dir: str) -> str:
    """Write the hero scene's textures and copies of its tracked files
    into `out_dir` (made if missing); returns the path of its hero.json."""
    if os.path.realpath(out_dir) == os.path.realpath(SCENES_DIR):
        raise ValueError("write_hero_assets does not write into scenes/")
    os.makedirs(out_dir, exist_ok=True)
    for name, img in zip(TEXTURES, (checker(), bricks(), ripple_normal_map(),
                                    metallic_roughness())):
        write_png(os.path.join(out_dir, name), img)
    for name in TRACKED:
        shutil.copyfile(os.path.join(SCENES_DIR, name),
                        os.path.join(out_dir, name))
    return os.path.join(out_dir, "hero.json")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m tpt_torch.scene.hero_assets OUT_DIR")
    print(write_hero_assets(sys.argv[1]))
