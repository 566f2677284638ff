"""HDR environment map: load, the pdf map and Vose alias table (host),
and lane-parallel equirect radiance and pdf lookup and O(1) alias-method
direction sampling.

Counterpart of `tpt/scene/envmap.py`: flux weights are luminance *
sin(theta), the pdf map stores solid-angle pdfs with the factor
N / (total * 2 * pi^2), directions use the Y-up lat-long mapping, and
`sample_env` drives environment NEE. The host part is tpt's numpy,
operation for operation, so the alias table equals tpt's bit for bit.

`read_hdr` reads Radiance RGBE files (RLE or flat scanlines) only: tpt
reads other formats through imageio, which the port does not use, so
they raise here and name the format.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch

from ..core.mathutil import INV_PI, INV_TWO_PI, PI, TWO_PI
from ..core.vec import Vec3
from ..device import DeviceLike, resolve_device
from .structs import EnvMap


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr (RGBE) file -> float32 [H, W, 3]: the native
    RLE decoder of native/tpt_native.cpp, or the numpy one where the
    native decoder refuses the payload."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".hdr":
        raise ValueError(f"{path}: {ext or 'no extension'} environment maps "
                         "are not read by the port, only Radiance .hdr "
                         "(RGBE)")

    with open(path, "rb") as f:
        data = f.read()

    # header
    pos = data.index(b"\n\n") + 2 if b"\n\n" in data else 0
    if pos == 0:
        # some writers use \n \n with headers; scan line by line
        lines_end = 0
        while True:
            nl = data.index(b"\n", lines_end)
            if nl == lines_end:
                pos = nl + 1
                break
            lines_end = nl + 1
    res_end = data.index(b"\n", pos)
    res_line = data[pos:res_end].decode("ascii").split()
    # expect: -Y H +X W
    h = int(res_line[1])
    w = int(res_line[3])
    payload = data[res_end + 1:]

    from .native import decode_hdr_rle_native

    rgbe = decode_hdr_rle_native(payload, w, h)
    if rgbe is None:
        rgbe = _decode_rgbe(np.frombuffer(payload, np.uint8), w, h)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))  # 2^(e-128-8)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    return rgb.astype(np.float32)


def _decode_rgbe(raw: np.ndarray, w: int, h: int) -> np.ndarray:
    """The RGBE bytes [h, w, 4] of an RLE or flat scanline payload."""
    rgbe = np.zeros((h, w, 4), np.uint8)
    off = 0
    for y in range(h):
        if off + 4 <= raw.size and raw[off] == 2 and raw[off + 1] == 2 and \
                (int(raw[off + 2]) << 8 | int(raw[off + 3])) == w:
            # adaptive RLE scanline
            off += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(raw[off])
                    off += 1
                    if count > 128:
                        count -= 128
                        rgbe[y, x:x + count, c] = raw[off]
                        off += 1
                    else:
                        rgbe[y, x:x + count, c] = raw[off:off + count]
                        off += count
                    x += count
        else:
            # flat scanline
            rgbe[y] = raw[off:off + w * 4].reshape(w, 4)
            off += w * 4
    return rgbe


def build_vose_alias(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose's O(N) alias-table construction. Returns (alias int32, prob
    float32)."""
    n = weights.size
    total = weights.sum()
    if total <= 0:
        return np.zeros(n, np.int32), np.ones(n, np.float32)
    p = weights.astype(np.float64) * (n / total)
    alias = np.zeros(n, np.int64)
    prob = np.ones(n, np.float64)
    small = list(np.nonzero(p < 1.0)[0][::-1])
    large = list(np.nonzero(p >= 1.0)[0][::-1])
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for l in large:
        prob[l] = 1.0
    for s in small:
        prob[s] = 1.0
    return alias.astype(np.int32), prob.astype(np.float32)


def envmap_from_arrays(r, g, b, pdf, alias, prob, *, device,
                       enabled: bool = True) -> EnvMap:
    """EnvMap on `device` from numpy planes [H, W] and the [H*W] table."""
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    return EnvMap(r=f32(r), g=f32(g), b=f32(b), pdf=f32(pdf),
                  alias=torch.as_tensor(np.asarray(alias).astype(np.int64),
                                        device=device),
                  prob=f32(prob), enabled=enabled)


def build_envmap(rgb: np.ndarray, device: DeviceLike = None) -> EnvMap:
    """The EnvMap of an equirect float image [H, W, 3], on `device` (the
    CUDA card unless the caller asks for another)."""
    h, w = rgb.shape[:2]
    lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    theta = (np.arange(h, dtype=np.float64) + 0.5) / h * math.pi
    sin_theta = np.sin(theta)
    flux = lum.astype(np.float64) * sin_theta[:, None]
    total = flux.sum()
    n = h * w
    # pdf(w) = flux / (total * texel solid angle), the texel solid angle
    # (2 pi / w)(pi / h) sin(theta): N / (total * 2 * pi^2) * lum
    pdf = (lum.astype(np.float64) * n / max(total, 1e-20) / (2.0 * math.pi ** 2))
    alias, prob = build_vose_alias(flux.ravel())
    return envmap_from_arrays(rgb[..., 0], rgb[..., 1], rgb[..., 2],
                              pdf.astype(np.float32), alias, prob,
                              device=resolve_device(device))


def load_envmap(path: str, device: DeviceLike = None) -> EnvMap:
    return build_envmap(read_hdr(path), device)


# ---------------------------------------------------------------------------
# Lane-parallel evaluation
# ---------------------------------------------------------------------------

def _dir_to_uv(d: Vec3):
    phi = torch.atan2(d.z, d.x)
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    theta = torch.acos(torch.clamp(d.y, -1.0, 1.0))
    return phi * INV_TWO_PI, theta * INV_PI


def _bilinear(plane: torch.Tensor, u, v):
    h, w = plane.shape
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = fx - x0
    ay = fy - y0
    xi = x0.to(torch.int32).to(torch.int64)
    yi = y0.to(torch.int32).to(torch.int64)
    xi0 = torch.remainder(xi, w)
    xi1 = torch.remainder(xi + 1, w)
    yi0 = yi.clamp(0, h - 1)
    yi1 = (yi + 1).clamp(0, h - 1)
    flat = plane.reshape(-1)

    def g(yi, xi):
        return flat[(yi * w + xi).clamp(0, flat.shape[0] - 1)]

    return (g(yi0, xi0) * (1 - ax) * (1 - ay)
            + g(yi0, xi1) * ax * (1 - ay)
            + g(yi1, xi0) * (1 - ax) * ay
            + g(yi1, xi1) * ax * ay)


def env_radiance(env: EnvMap, d: Vec3) -> Vec3:
    """Equirect lookup of the environment radiance along direction `d`."""
    u, v = _dir_to_uv(d)
    return Vec3(_bilinear(env.r, u, v), _bilinear(env.g, u, v),
                _bilinear(env.b, u, v))


def env_pdf(env: EnvMap, d: Vec3) -> torch.Tensor:
    u, v = _dir_to_uv(d)
    return _bilinear(env.pdf, u, v)


def sample_env(env: EnvMap, u1: torch.Tensor, u2: torch.Tensor):
    """O(1) alias-method direction sample per lane: (dir Vec3, radiance
    Vec3, pdf). u1 picks both the slot and the coin, as tpt's does; u2 is
    drawn by the caller and not used."""
    h, w = env.shape
    n = h * w
    scaled = u1 * n
    slot = scaled.to(torch.int32).to(torch.int64).clamp(0, n - 1)
    xi = scaled - slot.to(torch.float32)
    texel = torch.where(xi < env.prob[slot], slot, env.alias[slot])

    py = texel // w
    px = texel % w
    u = (px.to(torch.float32) + 0.5) / w
    v = (py.to(torch.float32) + 0.5) / h
    phi = u * TWO_PI
    theta = v * PI
    sin_t = torch.sin(theta)
    d = Vec3(sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi))
    pdf = _bilinear(env.pdf, u, v)
    rad = Vec3(_bilinear(env.r, u, v), _bilinear(env.g, u, v),
               _bilinear(env.b, u, v))
    return d, rad, pdf
