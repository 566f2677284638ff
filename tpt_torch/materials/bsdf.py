"""Lane-parallel BSDF library: eval / pdf / sample for the four material
classes (GGX microfacet PBR, Lambertian diffuse, perfect mirror,
dielectric refraction).

Counterpart of `tpt/materials/bsdf.py`, with the same formulas in the
same float32 order. Every lane evaluates all four lobes and selects by
material type, and each sample consumes exactly three uniforms whatever
the type, so per-path RNG streams stay aligned across materials (the
invariant that makes the integrators agree with the reference's
streams).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..core import rng
from ..core.mathutil import EPSILON, INV_PI, PDF_DIRAC_DELTA, TWO_PI, PI, reflect
from ..core.vec import Vec3, where as vwhere
from ..scene.structs import MaterialTable, MaterialType


@dataclass(frozen=True)
class MaterialLanes:
    """Per-lane material parameters gathered from the MaterialTable."""

    basecolor: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    emittance: torch.Tensor
    ior: torch.Tensor
    mtype: torch.Tensor
    tex_diffuse: torch.Tensor
    tex_metallic_roughness: torch.Tensor
    tex_normal: torch.Tensor


def gather_materials(table: MaterialTable, mat_id: torch.Tensor) -> MaterialLanes:
    """One row gather of the packed [M, 16] material table."""
    idx = mat_id.clamp(0, table.num_materials - 1)
    row = table.packed[idx]
    return MaterialLanes(
        basecolor=Vec3(row[:, 0], row[:, 1], row[:, 2]),
        metallic=row[:, 3],
        roughness=row[:, 4],
        emittance=row[:, 5],
        ior=row[:, 6],
        mtype=row[:, 7].to(torch.int32),
        tex_diffuse=row[:, 8].to(torch.int32),
        tex_metallic_roughness=row[:, 9].to(torch.int32),
        tex_normal=row[:, 10].to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Shading frame (the reference's LocalToWorld axis-pick thresholds)
# ---------------------------------------------------------------------------

_SQRT13 = 0.57735027


def local_to_world(lx, ly, lz, n: Vec3) -> Vec3:
    use_x = torch.abs(n.x) < _SQRT13
    use_y = ~use_x & (torch.abs(n.y) < _SQRT13)
    one, zero = torch.ones_like(n.x), torch.zeros_like(n.x)
    helper = Vec3(torch.where(use_x, one, zero), torch.where(use_y, one, zero),
                  torch.where(use_x | use_y, zero, one))
    t = n.cross(helper).normalize()
    b = n.cross(t).normalize()
    return t * lx + b * ly + n * lz


# ---------------------------------------------------------------------------
# Microfacet pieces
# ---------------------------------------------------------------------------

def fresnel_schlick(f0: Vec3, cos_theta) -> Vec3:
    x = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    x5 = x * x * x * x * x
    one = torch.ones_like(x5)
    return f0 + (Vec3(one, one, one) - f0) * x5


def fresnel_schlick_scalar(f0, cos_theta):
    x = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    x5 = x * x * x * x * x
    return f0 + (1.0 - f0) * x5


def distribution_ggx(n_dot_h, roughness):
    a = roughness * roughness
    a2 = a * a
    nh2 = torch.clamp_min(n_dot_h, 0.0) ** 2
    denom = nh2 * (a2 - 1.0) + 1.0
    denom = PI * denom * denom
    return a2 / torch.clamp_min(denom, 1e-7)


def geometry_schlick_ggx(n_dot_v, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    return n_dot_v / (n_dot_v * (1.0 - k) + k)


def geometry_smith(n_dot_v, n_dot_l, roughness):
    return geometry_schlick_ggx(torch.clamp_min(n_dot_v, 0.0), roughness) * \
        geometry_schlick_ggx(torch.clamp_min(n_dot_l, 0.0), roughness)


def base_f0(m: MaterialLanes) -> Vec3:
    g = torch.full_like(m.metallic, 0.04)
    grey = Vec3(g, g, g)
    return grey + (m.basecolor - grey) * m.metallic


def specular_probability(m: MaterialLanes, n: Vec3, v: Vec3):
    f0 = base_f0(m)
    f = fresnel_schlick(f0, torch.clamp_min(n.dot(v), 0.0))
    p = f.mean()
    p = p + (1.0 - p) * m.metallic  # mix(p, 1, metallic)
    return torch.clamp(p, 0.001, 0.999)


# ---------------------------------------------------------------------------
# Eval / pdf
# ---------------------------------------------------------------------------

def _zeros3(like: torch.Tensor) -> Vec3:
    z = torch.zeros_like(like)
    return Vec3(z, z, z)


def eval_pbr(wo: Vec3, wi: Vec3, n: Vec3, m: MaterialLanes) -> Vec3:
    n_dot_l = n.dot(wi)
    n_dot_v = n.dot(wo)
    h = (wo + wi).normalize()
    v_dot_h = torch.clamp_min(wo.dot(h), 0.0)
    rough = torch.clamp(m.roughness, 0.01, 1.0)

    f0 = base_f0(m)
    f = fresnel_schlick(f0, v_dot_h)
    d = distribution_ggx(n.dot(h), rough)
    g = geometry_smith(n_dot_v, n_dot_l, rough)
    spec = f * (d * g / (4.0 * n_dot_v * n_dot_l + EPSILON))

    one = torch.ones_like(m.metallic)
    kd = (Vec3(one, one, one) - f) * (1.0 - m.metallic)
    diffuse = kd * m.basecolor * INV_PI

    result = diffuse + spec
    return vwhere(n_dot_l > 0.0, result, _zeros3(n_dot_l))


def pdf_pbr(wo: Vec3, wi: Vec3, n: Vec3, m: MaterialLanes):
    n_dot_l = n.dot(wi)
    h = (wo + wi).normalize()
    v_dot_h = torch.clamp_min(wo.dot(h), 0.0)
    rough = torch.clamp(m.roughness, 0.01, 1.0)

    pdf_diff = torch.clamp_min(n_dot_l, 0.0) * INV_PI
    d = distribution_ggx(n.dot(h), rough)
    n_dot_h = torch.clamp_min(n.dot(h), 0.0)
    pdf_spec = (d * n_dot_h) / (4.0 * v_dot_h + 1e-7)

    p_spec = specular_probability(m, n, wo)
    pdf = p_spec * pdf_spec + (1.0 - p_spec) * pdf_diff
    return torch.where(n_dot_l > 0.0, pdf, 0.0)


def eval_bsdf(wo: Vec3, wi: Vec3, n: Vec3, m: MaterialLanes) -> Vec3:
    """Dispatch over material type (delta lobes evaluate to 0)."""
    pbr = eval_pbr(wo, wi, n, m)
    n_dot_l = n.dot(wi)
    zero = _zeros3(n_dot_l)
    diff = vwhere(n_dot_l > 0.0, m.basecolor * INV_PI, zero)
    is_pbr = m.mtype == MaterialType.MICROFACET_PBR
    is_diff = m.mtype == MaterialType.DIFFUSE
    return vwhere(is_pbr, pbr, vwhere(is_diff, diff, zero))


def pdf_bsdf(wo: Vec3, wi: Vec3, n: Vec3, m: MaterialLanes):
    n_dot_l = n.dot(wi)
    p_pbr = pdf_pbr(wo, wi, n, m)
    p_diff = torch.where(n_dot_l > 0.0, torch.clamp_min(n_dot_l, 0.0) * INV_PI, 0.0)
    is_pbr = m.mtype == MaterialType.MICROFACET_PBR
    is_diff = m.mtype == MaterialType.DIFFUSE
    return torch.where(is_pbr, p_pbr, torch.where(is_diff, p_diff, PDF_DIRAC_DELTA))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def cosine_weighted_dir(n: Vec3, u1, u2) -> Vec3:
    up = torch.sqrt(u1)  # cos(theta)
    over = torch.sqrt(torch.clamp_min(1.0 - up * up, 0.0))
    around = u2 * TWO_PI
    return local_to_world(torch.cos(around) * over, torch.sin(around) * over, up, n)


def ggx_ndf_sample_dir(n: Vec3, wo: Vec3, roughness, u1, u2) -> Vec3:
    """Sample the GGX NDF half-vector, return the reflected wi."""
    a = roughness * roughness
    phi = TWO_PI * u1
    cos_t = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    h = local_to_world(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t, n)
    return reflect(-1.0 * wo, h)


@dataclass(frozen=True)
class BSDFSample:
    wi: Vec3
    pdf: torch.Tensor          # solid-angle pdf (PDF_DIRAC_DELTA for deltas)
    attenuation: Vec3          # f * cos / pdf  (or Fresnel weight for deltas)
    is_transmission: torch.Tensor  # bool per lane


def sample_bsdf(wo: Vec3, n: Vec3, m: MaterialLanes, state: torch.Tensor
                ) -> Tuple[torch.Tensor, BSDFSample]:
    """Sample all four lobes lane-parallel and select by material type;
    consumes exactly three uniforms per lane."""
    state, u1, u2, u3 = rng.rand_float3(state)
    zero3 = _zeros3(u1)

    # ---- PBR --------------------------------------------------------------
    rough = torch.clamp(m.roughness, 0.01, 1.0)
    p_spec = specular_probability(m, n, wo)
    wi_spec = ggx_ndf_sample_dir(n, wo, rough, u1, u2)
    wi_diff = cosine_weighted_dir(n, u1, u2)
    wi_pbr = vwhere(u3 < p_spec, wi_spec, wi_diff).normalize()
    pbr_valid = n.dot(wi_pbr) > 0.0
    pdf_pbr_v = torch.where(pbr_valid, pdf_pbr(wo, wi_pbr, n, m), 0.0)
    f_pbr = eval_pbr(wo, wi_pbr, n, m)
    att_pbr = f_pbr * (torch.clamp_min(n.dot(wi_pbr), 0.0)
                       / torch.clamp_min(pdf_pbr_v, EPSILON))
    att_pbr = vwhere(pbr_valid, att_pbr, zero3)

    # ---- Diffuse ------------------------------------------------------------
    wi_d = wi_diff
    d_valid = n.dot(wi_d) > 0.0
    pdf_d = torch.where(d_valid, torch.clamp_min(n.dot(wi_d), 0.0) * INV_PI, 0.0)
    att_d = m.basecolor * INV_PI * (torch.clamp_min(n.dot(wi_d), 0.0)
                                    / torch.clamp_min(pdf_d, EPSILON))
    att_d = vwhere(d_valid, att_d, zero3)

    # ---- Perfect mirror ------------------------------------------------------
    wi_r = reflect(-1.0 * wo, n)
    f0 = base_f0(m)
    att_r = fresnel_schlick(f0, torch.clamp_min(n.dot(wi_r), 0.0))

    # ---- Dielectric refraction ----------------------------------------------
    inside = wo.dot(n) < 0.0
    n1 = torch.where(inside, m.ior, 1.0)
    n2 = torch.where(inside, 1.0, m.ior)
    n_eff = vwhere(inside, -1.0 * n, n)
    eta = n1 / n2
    cos_i = torch.clamp(wo.dot(n_eff), 0.0, 1.0)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    fr = fresnel_schlick_scalar(r0, cos_i)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    reflect_branch = (sin2_t >= 1.0) | (u3 < fr)
    wi_tir = reflect(-1.0 * wo, n_eff)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wi_refr = (-1.0 * wo) * eta + n_eff * (eta * cos_i - cos_t)
    wi_x = vwhere(reflect_branch, wi_tir, wi_refr)
    radiance_scale = (n2 * n2) / (n1 * n1)
    one = torch.ones_like(u1)
    att_x = vwhere(reflect_branch, Vec3(one, one, one), m.basecolor * radiance_scale)
    trans_x = ~reflect_branch

    # ---- Select by material type --------------------------------------------
    is_pbr = m.mtype == MaterialType.MICROFACET_PBR
    is_diff = m.mtype == MaterialType.DIFFUSE
    is_refl = m.mtype == MaterialType.SPECULAR_REFLECTION

    wi = vwhere(is_pbr, wi_pbr, vwhere(is_diff, wi_d, vwhere(is_refl, wi_r, wi_x)))
    pdf = torch.where(is_pbr, pdf_pbr_v, torch.where(is_diff, pdf_d, PDF_DIRAC_DELTA))
    att = vwhere(is_pbr, att_pbr, vwhere(is_diff, att_d, vwhere(is_refl, att_r, att_x)))
    is_trans = (m.mtype == MaterialType.SPECULAR_REFRACTION) & trans_x
    return state, BSDFSample(wi=wi, pdf=pdf, attenuation=att, is_transmission=is_trans)
