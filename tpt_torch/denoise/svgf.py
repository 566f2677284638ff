"""SVGF spatiotemporal denoiser (Schied 2017) over separate direct and
indirect channels. Counterpart of `tpt/denoise/svgf.py`: demodulation,
motion-vector temporal reprojection with consistency-tested 2x2 bilinear
taps and EMA alpha = max(0.1, 1/history), temporal variance from moments
when history >= 4 with a 7x7 geometry-weighted spatial fallback, 3x3
gaussian variance blur, 5 sparse-3x3 a-trous passes (step 1 << i) whose
normal weight is applied twice, albedo re-modulation, and the reference's
ping-pong: the 4th a-trous output becomes next frame's history.

Every expression keeps tpt's float32 operation order, so the plain
versions here and the CUDA kernels give the same bits. `_reproject_taps`
and `_atrous_once` are the plain versions of K6 and K5; `run_svgf` calls
them through their wrappers, `reproject.reproject` and
`stencil.atrous_passes` (the frame's a-trous passes in one call), which
launch the CUDA kernels on CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import SVGFConfig
from ..core.vec import Vec3, where as vwhere

# the history sums run_svgf reads (tpt's reproject_pallas DATA_KEYS; the
# dvar/ivar history is carried in SVGFState but never consumed)
DATA_KEYS = ("dir_r", "dir_g", "dir_b", "ind_r", "ind_g", "ind_b",
             "m1d", "m1i", "m2d", "m2i")


# ---------------------------------------------------------------------------
# plane helpers
# ---------------------------------------------------------------------------

def _shift(p: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """out[y, x] = p[y + dy, x + dx]; out-of-range reads produce `fill`."""
    if dy == 0 and dx == 0:
        return p
    h, w = p.shape
    out = torch.full_like(p, fill)
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y0 < y1 and x0 < x1:
        out[y0:y1, x0:x1] = p[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def _shift_valid(shape, dy: int, dx: int, device) -> torch.Tensor:
    """True where (y + dy, x + dx) lies in the image."""
    h, w = shape
    ok = torch.zeros((h, w), dtype=torch.bool, device=device)
    ok[max(0, -dy):min(h, h - dy), max(0, -dx):min(w, w - dx)] = True
    return ok


def _luminance(v: Vec3) -> torch.Tensor:
    return 0.2126 * v.x + 0.7152 * v.y + 0.0722 * v.z


def _shift_vec3(v: Vec3, dy, dx) -> Vec3:
    return Vec3(_shift(v.x, dy, dx), _shift(v.y, dy, dx), _shift(v.z, dy, dx))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SVGFState:
    """Cross-frame history (the reference's ping-pong and prev buffers),
    [H, W] tensors on one device."""

    hist_direct: Vec3       # integrated direct illumination
    hist_direct_var: torch.Tensor
    hist_indirect: Vec3
    hist_indirect_var: torch.Tensor
    m1_dir: torch.Tensor    # moment buffers (lum, lum^2 per channel)
    m1_ind: torch.Tensor
    m2_dir: torch.Tensor
    m2_ind: torch.Tensor
    history_len: torch.Tensor  # int32
    prev_depth: torch.Tensor
    prev_normal: Vec3
    prev_matid: torch.Tensor   # int32

    @staticmethod
    def zeros(h: int, w: int, device) -> "SVGFState":
        z = lambda: torch.zeros((h, w), device=device)
        return SVGFState(
            hist_direct=Vec3.zeros((h, w), device), hist_direct_var=z(),
            hist_indirect=Vec3.zeros((h, w), device), hist_indirect_var=z(),
            m1_dir=z(), m1_ind=z(), m2_dir=z(), m2_ind=z(),
            history_len=torch.zeros((h, w), dtype=torch.int32, device=device),
            prev_depth=torch.full((h, w), -1000.0, device=device),
            prev_normal=Vec3.zeros((h, w), device),
            prev_matid=torch.full((h, w), -1, dtype=torch.int32, device=device),
        )

    def leaves(self) -> List[torch.Tensor]:
        """The 18 planes in tpt's pytree leaf order (fields in order, a
        Vec3 as x, y, z): the checkpoint's svgf_0 .. svgf_17."""
        out = []
        for f in fields(self):
            v = getattr(self, f.name)
            out += [v.x, v.y, v.z] if isinstance(v, Vec3) else [v]
        return out


_VEC3_FIELDS = ("hist_direct", "hist_indirect", "prev_normal")
_INT_FIELDS = ("history_len", "prev_matid")


def svgf_state_from_numpy(arrays: Sequence[np.ndarray], device) -> SVGFState:
    """An SVGFState from its 18 leaves in tpt's order (as `leaves()` gives
    them and tpt's checkpoint stores them), on `device`."""
    arrays = list(arrays)
    if len(arrays) != 18:
        raise ValueError(f"an SVGFState has 18 leaves, got {len(arrays)}")
    shape = np.shape(arrays[0])
    if len(shape) != 2 or any(np.shape(a) != shape for a in arrays):
        raise ValueError("SVGFState leaves must be [H, W] arrays of one shape")
    it = iter(arrays)
    kw = {}
    for f in fields(SVGFState):
        dtype = np.int32 if f.name in _INT_FIELDS else np.float32
        t = lambda: torch.from_numpy(
            np.ascontiguousarray(next(it), dtype)).to(device)
        kw[f.name] = Vec3(t(), t(), t()) if f.name in _VEC3_FIELDS else t()
    return SVGFState(**kw)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _demodulate(raw: Vec3, albedo: Vec3, sky: torch.Tensor,
                threshold: float) -> Vec3:
    def dem(c, a):
        big = a > threshold
        return torch.where(big, c / torch.where(big, a, 1.0), c)

    out = Vec3(dem(raw.x, albedo.x), dem(raw.y, albedo.y), dem(raw.z, albedo.z))
    return vwhere(sky, raw, out)


def _reproject_taps(state: SVGFState, motion_u, motion_v, normal: Vec3,
                    depth, matid) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The plain version of K6: the 2x2 consistency-tested bilinear fetch
    of the history at (x - mu, y - mv). Returns (weighted sums over
    DATA_KEYS, valid weight sum).

    tpt clips the flat tap index into range; where the motion is NaN it
    is undefined there and every tap is masked to weight 0. Here a NaN
    index becomes 0, so no gather reads out of range."""
    h, w = depth.shape
    dev = depth.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    sx = xs - motion_u
    sy = ys - motion_v
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0

    flat = lambda p: p.reshape(-1)
    data = [flat(p) for p in (
        state.hist_direct.x, state.hist_direct.y, state.hist_direct.z,
        state.hist_indirect.x, state.hist_indirect.y, state.hist_indirect.z,
        state.m1_dir, state.m1_ind, state.m2_dir, state.m2_ind)]
    guides = [flat(p) for p in (state.prev_normal.x, state.prev_normal.y,
                                state.prev_normal.z, state.prev_depth)]
    prev_m = flat(state.prev_matid)
    matid_f = matid.to(torch.float32)

    sums = [torch.zeros((h, w), device=dev) for _ in DATA_KEYS]
    wsum = torch.zeros((h, w), device=dev)
    for j in (0, 1):
        for i in (0, 1):
            tx = x0 + i
            ty = y0 + j
            wbil = (fx if i else 1.0 - fx) * (fy if j else 1.0 - fy)
            inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            fidx = torch.clamp(ty, 0, h - 1) * w + torch.clamp(tx, 0, w - 1)
            idx = torch.where(torch.isnan(fidx), 0.0, fidx).to(torch.int64)
            idx = idx.reshape(-1)
            tap = lambda p: p[idx].reshape(h, w)
            tap_n = Vec3(tap(guides[0]), tap(guides[1]), tap(guides[2]))
            consistent = (
                inb & (wbil > 1e-6)
                & (normal.dot(tap_n) > 0.95)
                & (torch.abs(depth - tap(guides[3])) < 2.0)
                & (matid_f == tap(prev_m).to(torch.float32))
            )
            wv = torch.where(consistent, wbil, 0.0)
            wsum = wsum + wv
            for k, p in enumerate(data):
                sums[k] = sums[k] + wv * tap(p)
    return dict(zip(DATA_KEYS, sums)), wsum


def _spatial_variance(m1d, m1i, m2d, m2i, depth, normal: Vec3,
                      cfg: SVGFConfig):
    """7x7 geometry-weighted moment average -> variance (fallback path)."""
    h, w = depth.shape
    eps = 1e-6
    dzdx = _shift(depth, 0, 1, fill=0.0) - depth
    dzdy = _shift(depth, 1, 0, fill=0.0) - depth

    sum_w = torch.ones((h, w), device=depth.device)
    s1d, s1i, s2d, s2i = m1d, m1i, m2d, m2i
    r = 3
    for j in range(-r, r + 1):
        for i in range(-r, r + 1):
            if i == 0 and j == 0:
                continue
            valid = _shift_valid((h, w), j, i, depth.device)
            nd = _shift(depth, j, i)
            nn = _shift_vec3(normal, j, i)
            dz = torch.abs(depth - nd)
            thr = torch.abs(dzdx * i + dzdy * j) + eps
            w_z = torch.exp(-dz / (cfg.sigma_z * thr))
            w_n = torch.clamp_min(normal.dot(nn), 0.0) ** cfg.sigma_n
            wv = torch.where(valid, w_z * w_n, 0.0)
            sum_w = sum_w + wv
            s1d = s1d + wv * _shift(m1d, j, i)
            s1i = s1i + wv * _shift(m1i, j, i)
            s2d = s2d + wv * _shift(m2d, j, i)
            s2i = s2i + wv * _shift(m2i, j, i)
    sum_w = torch.clamp_min(sum_w, eps)
    a1d, a1i, a2d, a2i = s1d / sum_w, s1i / sum_w, s2d / sum_w, s2i / sum_w
    return (torch.clamp_min(a2d - a1d * a1d, 0.0),
            torch.clamp_min(a2i - a1i * a1i, 0.0))


def _gaussian3(var: torch.Tensor) -> torch.Tensor:
    k = [(0.0625, -1, -1), (0.125, -1, 0), (0.0625, -1, 1),
         (0.125, 0, -1), (0.25, 0, 0), (0.125, 0, 1),
         (0.0625, 1, -1), (0.125, 1, 0), (0.0625, 1, 1)]
    # edge-clamped like the CUDA reference (min/max indexing)
    h, w = var.shape
    out = torch.zeros((h, w), device=var.device)
    for wgt, dy, dx in k:
        tap = _shift(var, dy, dx)
        valid = _shift_valid((h, w), dy, dx, var.device)
        clamped = torch.where(valid, tap, var)  # clamp == center fallback
        out = out + wgt * clamped
    return out


def _atrous_once(illum_d: Vec3, var_d, illum_i: Vec3, var_i,
                 depth, normal: Vec3, step: int, cfg: SVGFConfig):
    """The plain version of K5: one a-trous pass with stride `step`."""
    h, w = depth.shape
    dev = depth.device
    eps = 1e-6
    sky = depth < 0.0

    lum_d = _luminance(illum_d)
    lum_i = _luminance(illum_i)
    denom_d = 1.0 / (cfg.sigma_l * torch.sqrt(torch.clamp_min(var_d, 0.0)) + eps)
    denom_i = 1.0 / (cfg.sigma_l * torch.sqrt(torch.clamp_min(var_i, 0.0)) + eps)

    # edge-clamped gradient (reference: idx_r = min(x+1, w-1))
    dzdx = torch.where(_shift_valid((h, w), 0, 1, dev),
                       _shift(depth, 0, 1) - depth, 0.0)
    dzdy = torch.where(_shift_valid((h, w), 1, 0, dev),
                       _shift(depth, 1, 0) - depth, 0.0)
    dzdx = torch.where(torch.abs(dzdx) < eps, eps, dzdx)
    dzdy = torch.where(torch.abs(dzdy) < eps, eps, dzdy)

    sum_wd = torch.ones((h, w), device=dev)
    sum_wi = torch.ones((h, w), device=dev)
    acc_d = illum_d
    acc_vd = var_d
    acc_i = illum_i
    acc_vi = var_i

    for j in (-1, 0, 1):
        for i in (-1, 0, 1):
            if i == 0 and j == 0:
                continue
            dy, dx = j * step, i * step
            valid = _shift_valid((h, w), dy, dx, dev)
            nd = _shift(depth, dy, dx)
            nn = _shift_vec3(normal, dy, dx)
            n_ill_d = _shift_vec3(illum_d, dy, dx)
            n_var_d = _shift(var_d, dy, dx)
            n_ill_i = _shift_vec3(illum_i, dy, dx)
            n_var_i = _shift(var_i, dy, dx)

            d_approx = dzdx * dx + dzdy * dy
            w_z = torch.exp(-torch.abs(depth - nd)
                            / (cfg.sigma_z * torch.abs(d_approx) + eps))
            w_n = torch.clamp_min(normal.dot(nn), 0.0) ** cfg.sigma_n
            n_lum_d = _luminance(n_ill_d)
            n_lum_i = _luminance(n_ill_i)
            # reference applies w_n twice (EdgeStoppingWeightsWithDenom)
            w_l_d = w_n * torch.exp(-torch.abs(lum_d - n_lum_d) * denom_d)
            w_l_i = w_n * torch.exp(-torch.abs(lum_i - n_lum_i) * denom_i)
            w_d = torch.where(valid, w_z * w_n * w_l_d, 0.0)
            w_i = torch.where(valid, w_z * w_n * w_l_i, 0.0)

            sum_wd = sum_wd + w_d
            acc_d = acc_d + n_ill_d * w_d
            acc_vd = acc_vd + n_var_d * w_d
            sum_wi = sum_wi + w_i
            acc_i = acc_i + n_ill_i * w_i
            acc_vi = acc_vi + n_var_i * w_i

    out_d = acc_d * (1.0 / sum_wd)
    out_vd = acc_vd / sum_wd
    out_i = acc_i * (1.0 / sum_wi)
    out_vi = acc_vi / sum_wi
    # sky passthrough
    out_d = vwhere(sky, illum_d, out_d)
    out_vd = torch.where(sky, var_d, out_vd)
    out_i = vwhere(sky, illum_i, out_i)
    out_vi = torch.where(sky, var_i, out_vi)
    return out_d, out_vd, out_i, out_vi


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def run_svgf(cfg: SVGFConfig, state: SVGFState,
             raw_direct: Vec3, raw_indirect: Vec3,
             albedo: Vec3, depth: torch.Tensor, normal: Vec3,
             matid: torch.Tensor, motion_u: torch.Tensor,
             motion_v: torch.Tensor) -> Tuple[Vec3, SVGFState]:
    """One denoised frame. All inputs are [H, W] planes (matid int32).

    Returns (final rgb Vec3[H, W], next SVGFState). K6 and K5 run through
    their wrappers, looked up here at call time."""
    from . import reproject, stencil

    sky = depth < 0.0

    # 1. demodulation
    ill_d = _demodulate(raw_direct, albedo, sky, cfg.demodulate_threshold)
    ill_i = _demodulate(raw_indirect, albedo, sky, cfg.demodulate_threshold)

    # 2. temporal reprojection (K6) + EMA
    lum_d = _luminance(ill_d)
    lum_i = _luminance(ill_i)
    m1d_c, m1i_c = lum_d, lum_i
    m2d_c, m2i_c = lum_d * lum_d, lum_i * lum_i

    sums, wsum = reproject.reproject(state, motion_u, motion_v, normal,
                                     depth, matid)
    valid = (wsum > 1e-4) & ~sky
    inv_w = 1.0 / torch.clamp_min(wsum, 1e-8)

    hist_len = torch.where(valid, state.history_len + 1, 0)
    alpha = torch.clamp_min(
        1.0 / torch.clamp_min(hist_len.to(torch.float32), 1.0),
        cfg.temporal_alpha_min)

    def ema(prev_sum, cur):
        prev = prev_sum * inv_w
        mixed = prev + (cur - prev) * alpha
        return torch.where(valid, mixed, cur)

    ill_d = Vec3(ema(sums["dir_r"], ill_d.x), ema(sums["dir_g"], ill_d.y),
                 ema(sums["dir_b"], ill_d.z))
    ill_i = Vec3(ema(sums["ind_r"], ill_i.x), ema(sums["ind_g"], ill_i.y),
                 ema(sums["ind_b"], ill_i.z))
    m1d = ema(sums["m1d"], m1d_c)
    m1i = ema(sums["m1i"], m1i_c)
    m2d = ema(sums["m2d"], m2d_c)
    m2i = ema(sums["m2i"], m2i_c)

    enough_history = valid & (hist_len >= cfg.history_threshold)
    var_d = torch.where(enough_history,
                        torch.clamp_min(m2d - m1d * m1d, 0.0), 1.0)
    var_i = torch.where(enough_history,
                        torch.clamp_min(m2i - m1i * m1i, 0.0), 1.0)
    var_d = torch.where(sky, 1.0, var_d)
    var_i = torch.where(sky, 1.0, var_i)

    # 3. spatial variance fallback for short history, only when some pixel
    # needs it (tpt's lax.cond; the selected values are the same either
    # way, because need_spatial masks every pixel the fallback writes)
    need_spatial = ~enough_history & ~sky
    if bool(need_spatial.any()):
        sp_var_d, sp_var_i = _spatial_variance(m1d, m1i, m2d, m2i, depth,
                                               normal, cfg)
        var_d = torch.where(need_spatial, sp_var_d, var_d)
        var_i = torch.where(need_spatial, sp_var_i, var_i)

    # 4. gaussian blur on variance
    var_d = _gaussian3(var_d)
    var_i = _gaussian3(var_i)

    # 5. a-trous passes (K5); the reference's history tap is the output of
    # pass index iterations - 2 (the buffer last written to the ping slot)
    (ill_d, var_d, ill_i, var_i), hist_tap = stencil.atrous_passes(
        ill_d, var_d, ill_i, var_i, depth, normal, cfg.atrous_iterations,
        cfg.sigma_z, cfg.sigma_n, cfg.sigma_l)

    # 6. modulation (+ sky passthrough of indirect)
    rgb = (ill_d + ill_i) * albedo
    rgb = vwhere(sky, ill_i, rgb)

    new_state = SVGFState(
        hist_direct=hist_tap[0], hist_direct_var=hist_tap[1],
        hist_indirect=hist_tap[2], hist_indirect_var=hist_tap[3],
        m1_dir=m1d, m1_ind=m1i, m2_dir=m2d, m2_ind=m2i,
        history_len=hist_len,
        prev_depth=depth, prev_normal=normal, prev_matid=matid,
    )
    return rgb, new_state
