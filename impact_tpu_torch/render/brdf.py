"""Microfacet BRDF evaluation (port of ``impact_tpu/render/brdf.py``; ref:
impact_rendering brdf.rs and the omnidirectional light shader templates —
Hammon diffuse-GGX fit, GGX specular, spherical area-light emulation, and a
split-sum ambient term with Karis's analytic environment-BRDF fit)."""

from __future__ import annotations

import torch


def _saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def _clamp0(x):
    return torch.clamp(x, min=0.0)


def _fresnel_incidence_factor(c):
    om = 1.0 - c
    om2 = om * om
    return om2 * om2 * om


def fresnel_schlick(v_dot_h, f0):
    return f0 + (1.0 - f0) * _fresnel_incidence_factor(_saturate(v_dot_h))


def reflection_dots(normal, view_dir, light_dir):
    """(VdotN, LdotN, LdotV, NdotH, LdotH) with H from L+V unnormalized."""
    v_dot_n = (view_dir * normal).sum(dim=-1)
    l_dot_n = (light_dir * normal).sum(dim=-1)
    l_dot_v = (light_dir * view_dir).sum(dim=-1)
    one_plus_lv = torch.clamp(1.0 + l_dot_v, min=1e-6)
    inv_h = 1.0 / torch.sqrt(2.0 * one_plus_lv)
    n_dot_h = (l_dot_n + v_dot_n) * inv_h
    l_dot_h = one_plus_lv * inv_h
    return v_dot_n, l_dot_n, l_dot_v, n_dot_h, l_dot_h


def area_light_dots(tan_r, v_dot_n, l_dot_n, l_dot_v):
    """Representative-point direction for a spherical area light."""
    cos_r = 1.0 / torch.sqrt(1.0 + tan_r * tan_r)
    sin_r = tan_r * cos_r
    l_dot_r = 2.0 * v_dot_n * l_dot_n - l_dot_v
    s = sin_r / torch.sqrt(torch.clamp(1.0 - l_dot_r * l_dot_r, min=1e-6))
    new_ln = cos_r * l_dot_n + (v_dot_n - l_dot_r * l_dot_n) * s
    new_lv = cos_r * l_dot_v + (2.0 * v_dot_n * v_dot_n - 1.0 - l_dot_r * l_dot_v) * s
    inv_h = 1.0 / torch.sqrt(2.0 * torch.clamp(1.0 + new_lv, min=1e-6))
    n_dot_h = (new_ln + v_dot_n) * inv_h
    l_dot_h = (1.0 + new_lv) * inv_h
    inside = l_dot_r >= cos_r
    one = torch.ones_like(n_dot_h)
    n_dot_h = torch.where(inside, one, n_dot_h)
    l_dot_h = torch.where(inside, v_dot_n, l_dot_h)
    new_ln = torch.where(inside, v_dot_n, new_ln)
    new_lv = torch.where(inside, 2.0 * v_dot_n * v_dot_n - 1.0, new_lv)
    return new_ln, new_lv, n_dot_h, l_dot_h


def area_light_luminance_scale(tan_r, roughness):
    modified = _saturate(roughness + 0.333333333 * tan_r)
    return roughness * roughness / (modified * modified + 1e-4)


def evaluate_brdf_dots(v_dot_n, l_dot_n, l_dot_v, n_dot_h, l_dot_h, albedo, f0, roughness):
    """(diffuse + specular BRDF)·π · clamped(LdotN)/π; ``roughness`` is GGX alpha."""
    cl_vn = _clamp0(v_dot_n)
    cl_ln = _clamp0(l_dot_n)
    r = roughness
    smooth = (
        1.05 * (1.0 - f0)
        * (1.0 - _fresnel_incidence_factor(cl_ln))[..., None]
        * (1.0 - _fresnel_incidence_factor(cl_vn))[..., None]
    )
    half_lv = 0.5 * (1.0 + l_dot_v)
    big = n_dot_h.abs() > 1e-6
    safe_ndh = torch.where(big, n_dot_h, torch.ones_like(n_dot_h))
    rough_c = torch.where(big, half_lv * (0.9 - 0.4 * half_lv) * (1.0 + 0.5 / safe_ndh),
                          torch.zeros_like(n_dot_h))
    multi = 0.3641 * r
    diffuse_pi = (cl_vn > 0.0).to(albedo.dtype)[..., None] * albedo * (
        (1.0 - r)[..., None] * smooth + (r * rough_c)[..., None] + albedo * multi[..., None]
    )
    fresnel = fresnel_schlick(_clamp0(l_dot_h)[..., None], f0)
    g_scaled = 0.5 / ((1.0 - r) * 2.0 * cl_ln * cl_vn + r * (cl_ln + cl_vn) + 1e-6)
    r2 = r * r
    denom = 1.0 + n_dot_h * n_dot_h * (r2 - 1.0)
    d_pi = (n_dot_h > 0.0).to(r.dtype) * r2 / (denom * denom + 1e-6)
    specular_pi = fresnel * (g_scaled * d_pi)[..., None]
    inv_pi = 0.318309886
    return (diffuse_pi + specular_pi) * (cl_ln * inv_pi)[..., None]


def evaluate_brdf(normal, view_dir, light_dir, albedo, f0, roughness, tan_angular_radius=None):
    """Diffuse + specular BRDF × NdotL; with ``tan_angular_radius`` the
    spherical area-light emulation is applied."""
    v_dot_n, l_dot_n, l_dot_v, n_dot_h, l_dot_h = reflection_dots(normal, view_dir, light_dir)
    scale = 1.0
    if tan_angular_radius is not None:
        l_dot_n, l_dot_v, n_dot_h, l_dot_h = area_light_dots(
            tan_angular_radius, v_dot_n, l_dot_n, l_dot_v)
        scale = area_light_luminance_scale(tan_angular_radius, roughness)[..., None]
    return scale * evaluate_brdf_dots(v_dot_n, l_dot_n, l_dot_v, n_dot_h, l_dot_h,
                                      albedo, f0, roughness)


def ambient_brdf(normal, view_dir, albedo, f0, roughness):
    """Split-sum ambient response with Karis's analytic env-BRDF fit."""
    n_dot_v = _saturate((normal * view_dir).sum(dim=-1))[..., None]
    r = roughness[..., None]
    rx = r * -1.0 + 1.0
    ry = r * -0.0275 + 0.0425
    rz = r * -0.572 + 1.04
    rw = r * 0.022 - 0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * n_dot_v)) * rx + ry
    ab_x = -1.04 * a004 + rz
    ab_y = 1.04 * a004 + rw
    return albedo * (1.0 - f0) + (f0 * ab_x + ab_y)
