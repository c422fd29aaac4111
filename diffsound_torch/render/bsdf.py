"""Differentiable PBR BSDFs.

Counterpart of `diffsound_tpu/render/bsdf.py`: Lambert and Frostbite
diffuse, GGX specular with height-correlated Smith masking and Schlick
Fresnel, Phong, and shading-normal preparation (two-sided bend and
tangent-space perturbation).  Autograd gives every backward.

Conventions: directions are unit vectors with a trailing dim of 3; `wi`
points toward the light, `wo` toward the viewer."""

from __future__ import annotations

import math

import torch

from .util import dot, reflect, safe_normalize

NORMAL_THRESHOLD = 0.1
SPECULAR_EPSILON = 1e-4


def bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading: bool = True):
    """Flip normals on backfacing surfaces and blend smooth -> geometric as
    the view grazes the surface."""
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(front, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


def perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl: bool = True):
    """Tangent-space normal map application (OpenGL flips the bitangent)."""
    smooth_bitang = safe_normalize(torch.linalg.cross(smooth_tng, smooth_nrm))
    bsign = -1.0 if opengl else 1.0
    shading_nrm = (
        smooth_tng * perturbed_nrm[..., 0:1]
        + bsign * smooth_bitang * perturbed_nrm[..., 1:2]
        + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3], min=0.0)
    )
    return safe_normalize(shading_nrm)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm, smooth_tng, geom_nrm,
                           two_sided_shading: bool = True, opengl: bool = True):
    smooth_nrm = safe_normalize(smooth_nrm)
    smooth_tng = safe_normalize(smooth_tng)
    view_vec = safe_normalize(view_pos - pos)
    if perturbed_nrm is None:
        shading_nrm = smooth_nrm
    else:
        shading_nrm = perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl)
    return bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)


def lambert(nrm, wi):
    return torch.clamp(dot(nrm, wi), min=0.0) / math.pi


def fresnel_schlick(f0, f90, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - c) ** 5.0


def frostbite(nrm, wi, wo, linear_roughness):
    """Frostbite's energy-conserving diffuse (Lagarde & de Rousiers 2014)."""
    wi_dot_n = dot(wi, nrm)
    wo_dot_n = dot(wo, nrm)
    h = safe_normalize(wo + wi)
    wi_dot_h = dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_dot_h * wi_dot_h * linear_roughness
    res = fresnel_schlick(1.0, f90, wi_dot_n) * fresnel_schlick(1.0, f90, wo_dot_n) * energy_factor
    return torch.where((wi_dot_n > 0.0) & (wo_dot_n > 0.0), res, torch.zeros_like(res))


def ndf_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    c_sqr = c * c
    tan_sqr = (1.0 - c_sqr) / c_sqr
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan_sqr) - 1.0)


def masking_smith_ggx_correlated(alpha_sqr, cos_theta_i, cos_theta_o):
    return 1.0 / (1.0 + lambda_ggx(alpha_sqr, cos_theta_i) + lambda_ggx(alpha_sqr, cos_theta_o))


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness: float = 0.08):
    alpha_sqr = torch.clamp(alpha, min_roughness * min_roughness, 1.0) ** 2
    h = safe_normalize(wo + wi)
    wo_dot_n = dot(wo, nrm)
    wi_dot_n = dot(wi, nrm)
    D = ndf_ggx(alpha_sqr, dot(nrm, h))
    G = masking_smith_ggx_correlated(alpha_sqr, wo_dot_n, wi_dot_n)
    F = fresnel_schlick(col, 1.0, dot(wo, h))
    w = F * D * G * 0.25 / torch.clamp(wo_dot_n, min=SPECULAR_EPSILON)
    frontfacing = (wo_dot_n > SPECULAR_EPSILON) & (wi_dot_n > SPECULAR_EPSILON)
    return torch.where(frontfacing, w, torch.zeros_like(w))


def phong(nrm, wo, wi, n_exp):
    """Phong specular lobe."""
    dp_r = torch.clamp(dot(reflect(wo, nrm), wi), 0.0, 1.0)
    dp_l = torch.clamp(dot(nrm, wi), 0.0, 1.0)
    return (dp_r**n_exp) * dp_l * (n_exp + 2.0) / (2.0 * math.pi)


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos, min_roughness: float = 0.08,
             diffuse: str = "lambert"):
    """Point-light PBR evaluation: kd albedo, arm = (occlusion, roughness,
    metallic)."""
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)
    spec_str, roughness, metallic = arm[..., 0:1], arm[..., 1:2], arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd_eff = kd * (1.0 - metallic)
    if diffuse == "lambert":
        diff = kd_eff * lambert(nrm, wi)
    else:
        diff = kd_eff * frostbite(nrm, wi, wo, roughness)
    return diff + pbr_specular(ks, nrm, wo, wi, roughness * roughness, min_roughness)
