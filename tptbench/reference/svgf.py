"""SVGF in plain PyTorch: a frozen copy of the plain stages of
tpt_torch/denoise/svgf.py (demodulation, the 2x2 consistency-tested
reprojection of the history and its EMA, the temporal variance from the
moments or the 7x7 spatial fallback, the 3x3 variance blur, the a-trous
passes, the re-modulation). `denoise` takes one frame and the history
the frames before it left (None after a camera move, which clears it)
and returns the image and the history it leaves."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .vec import Vec3, where as vwhere


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


def _demodulate(raw: Vec3, albedo: Vec3, sky: torch.Tensor,
                threshold: float) -> Vec3:
    def dem(c, a):
        big = a > threshold
        return torch.where(big, c / torch.where(big, a, 1.0), c)

    out = Vec3(dem(raw.x, albedo.x), dem(raw.y, albedo.y), dem(raw.z, albedo.z))
    return vwhere(sky, raw, out)


def _spatial_variance(m1d, m1i, m2d, m2i, depth, normal: Vec3,
                      cfg):
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
                 depth, normal: Vec3, step: int, cfg):
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


@dataclass(frozen=True)
class State:
    """The history a denoised frame leaves for the next ([H, W] planes)."""

    hist_direct: Vec3
    hist_indirect: Vec3
    m1_dir: torch.Tensor
    m1_ind: torch.Tensor
    m2_dir: torch.Tensor
    m2_ind: torch.Tensor
    history_len: torch.Tensor  # int32
    prev_depth: torch.Tensor
    prev_normal: Vec3
    prev_matid: torch.Tensor   # int32

    @staticmethod
    def cleared(h: int, w: int, device) -> "State":
        z = lambda: torch.zeros((h, w), device=device)
        return State(Vec3.zeros((h, w), device), Vec3.zeros((h, w), device),
                     z(), z(), z(), z(),
                     torch.zeros((h, w), dtype=torch.int32, device=device),
                     torch.full((h, w), -1000.0, device=device),
                     Vec3.zeros((h, w), device),
                     torch.full((h, w), -1, dtype=torch.int32, device=device))


def _reproject(state: State, motion_u, motion_v, normal: Vec3, depth, matid):
    """The 2x2 consistency-tested bilinear fetch of the history at
    (x - mu, y - mv): (weighted sums of the ten history planes, the
    valid weight sum). A NaN tap index reads index 0 with weight 0."""
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
    sums = [torch.zeros((h, w), device=dev) for _ in data]
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
                & (matid_f == tap(prev_m).to(torch.float32)))
            wv = torch.where(consistent, wbil, 0.0)
            wsum = wsum + wv
            for k, p in enumerate(data):
                sums[k] = sums[k] + wv * tap(p)
    return sums, wsum


def denoise(cfg, state: Optional[State], raw_direct: Vec3, raw_indirect: Vec3,
            albedo: Vec3, depth: torch.Tensor, normal: Vec3,
            matid: torch.Tensor, motion_u: torch.Tensor,
            motion_v: torch.Tensor):
    """One denoised frame: [H, W] planes in (matid int32), (the final rgb
    Vec3[H, W], the history it leaves) out. `state` None is a cleared
    history. `cfg` has the SVGF settings as attributes (sigma_z, sigma_n,
    sigma_l, atrous_iterations, history_threshold, temporal_alpha_min,
    demodulate_threshold)."""
    h, w = depth.shape
    if state is None:
        state = State.cleared(h, w, depth.device)
    sky = depth < 0.0
    ill_d = _demodulate(raw_direct, albedo, sky, cfg.demodulate_threshold)
    ill_i = _demodulate(raw_indirect, albedo, sky, cfg.demodulate_threshold)
    lum_d = _luminance(ill_d)
    lum_i = _luminance(ill_i)
    m1d_c, m1i_c = lum_d, lum_i
    m2d_c, m2i_c = lum_d * lum_d, lum_i * lum_i

    sums, wsum = _reproject(state, motion_u, motion_v, normal, depth, matid)
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

    ill_d = Vec3(ema(sums[0], ill_d.x), ema(sums[1], ill_d.y),
                 ema(sums[2], ill_d.z))
    ill_i = Vec3(ema(sums[3], ill_i.x), ema(sums[4], ill_i.y),
                 ema(sums[5], ill_i.z))
    m1d = ema(sums[6], m1d_c)
    m1i = ema(sums[7], m1i_c)
    m2d = ema(sums[8], m2d_c)
    m2i = ema(sums[9], m2i_c)

    enough = valid & (hist_len >= cfg.history_threshold)
    var_d = torch.where(enough, torch.clamp_min(m2d - m1d * m1d, 0.0), 1.0)
    var_i = torch.where(enough, torch.clamp_min(m2i - m1i * m1i, 0.0), 1.0)
    var_d = torch.where(sky, 1.0, var_d)
    var_i = torch.where(sky, 1.0, var_i)
    need_spatial = ~enough & ~sky
    if bool(need_spatial.any()):
        sp_var_d, sp_var_i = _spatial_variance(m1d, m1i, m2d, m2i, depth,
                                               normal, cfg)
        var_d = torch.where(need_spatial, sp_var_d, var_d)
        var_i = torch.where(need_spatial, sp_var_i, var_i)
    var_d = _gaussian3(var_d)
    var_i = _gaussian3(var_i)
    # the history keeps the output of pass iterations - 2 (the last one
    # written to the ping slot), or of the only pass
    hist = None
    for k in range(cfg.atrous_iterations):
        ill_d, var_d, ill_i, var_i = _atrous_once(
            ill_d, var_d, ill_i, var_i, depth, normal, 1 << k, cfg)
        if k == cfg.atrous_iterations - 2:
            hist = (ill_d, ill_i)
    if hist is None:
        hist = (ill_d, ill_i)
    rgb = (ill_d + ill_i) * albedo
    rgb = vwhere(sky, ill_i, rgb)
    return rgb, State(hist[0], hist[1], m1d, m1i, m2d, m2i, hist_len, depth,
                      normal, matid)
