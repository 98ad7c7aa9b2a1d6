"""Microfacet BRDF evaluation (port of ``impact_tpu/render/brdf.py``; ref:
impact_rendering brdf.rs and the omnidirectional light shader templates —
Hammon diffuse-GGX fit, GGX specular, spherical area-light emulation, and a
split-sum ambient term with Karis's analytic environment-BRDF fit)."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _rounded(c: float, dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def _consts(x):
    """How this module's inexact constants meet a tensor of ``x``'s dtype:
    under bfloat16 (``tpu.bf16_shading``) each is first rounded to bfloat16,
    as JAX gives a Python scalar its operand's dtype, where torch would
    compute with it in float32; in float32 they stay as written."""
    if x.dtype == torch.float32:
        return lambda c: c
    return lambda c: _rounded(c, x.dtype)


def _dot(a, b):
    """Dot products over the last axis. Under bfloat16 the products and
    their sum stay float32 and round once, as the reference's XLA program
    computes them (a reduction fusion's output is not rounded between its
    operations); float32 is unchanged."""
    if a.dtype == torch.float32:
        return (a * b).sum(dim=-1)
    return (a.float() * b.float()).sum(dim=-1).to(a.dtype)


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
    v_dot_n = _dot(view_dir, normal)
    l_dot_n = _dot(light_dir, normal)
    l_dot_v = _dot(light_dir, view_dir)
    one_plus_lv = torch.clamp(1.0 + l_dot_v, min=_consts(l_dot_v)(1e-6))
    inv_h = 1.0 / torch.sqrt(2.0 * one_plus_lv)
    n_dot_h = (l_dot_n + v_dot_n) * inv_h
    l_dot_h = one_plus_lv * inv_h
    return v_dot_n, l_dot_n, l_dot_v, n_dot_h, l_dot_h


def area_light_dots(tan_r, v_dot_n, l_dot_n, l_dot_v):
    """Representative-point direction for a spherical area light."""
    k = _consts(v_dot_n)
    cos_r = 1.0 / torch.sqrt(1.0 + tan_r * tan_r)
    sin_r = tan_r * cos_r
    l_dot_r = 2.0 * v_dot_n * l_dot_n - l_dot_v
    s = sin_r / torch.sqrt(torch.clamp(1.0 - l_dot_r * l_dot_r, min=k(1e-6)))
    new_ln = cos_r * l_dot_n + (v_dot_n - l_dot_r * l_dot_n) * s
    new_lv = cos_r * l_dot_v + (2.0 * v_dot_n * v_dot_n - 1.0 - l_dot_r * l_dot_v) * s
    inv_h = 1.0 / torch.sqrt(2.0 * torch.clamp(1.0 + new_lv, min=k(1e-6)))
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
    k = _consts(roughness)
    modified = _saturate(roughness + k(0.333333333) * tan_r)
    return roughness * roughness / (modified * modified + k(1e-4))


def evaluate_brdf_dots(v_dot_n, l_dot_n, l_dot_v, n_dot_h, l_dot_h, albedo, f0, roughness):
    """(diffuse + specular BRDF)·π · clamped(LdotN)/π; ``roughness`` is GGX alpha."""
    k = _consts(v_dot_n)
    cl_vn = _clamp0(v_dot_n)
    cl_ln = _clamp0(l_dot_n)
    r = roughness
    smooth = (
        k(1.05) * (1.0 - f0)
        * (1.0 - _fresnel_incidence_factor(cl_ln))[..., None]
        * (1.0 - _fresnel_incidence_factor(cl_vn))[..., None]
    )
    half_lv = 0.5 * (1.0 + l_dot_v)
    big = n_dot_h.abs() > k(1e-6)
    safe_ndh = torch.where(big, n_dot_h, torch.ones_like(n_dot_h))
    rough_c = torch.where(big, half_lv * (k(0.9) - k(0.4) * half_lv) * (1.0 + 0.5 / safe_ndh),
                          torch.zeros_like(n_dot_h))
    multi = k(0.3641) * r
    diffuse_pi = (cl_vn > 0.0).to(albedo.dtype)[..., None] * albedo * (
        (1.0 - r)[..., None] * smooth + (r * rough_c)[..., None] + albedo * multi[..., None]
    )
    fresnel = fresnel_schlick(_clamp0(l_dot_h)[..., None], f0)
    g_scaled = 0.5 / ((1.0 - r) * 2.0 * cl_ln * cl_vn + r * (cl_ln + cl_vn) + k(1e-6))
    r2 = r * r
    denom = 1.0 + n_dot_h * n_dot_h * (r2 - 1.0)
    d_pi = (n_dot_h > 0.0).to(r.dtype) * r2 / (denom * denom + k(1e-6))
    specular_pi = fresnel * (g_scaled * d_pi)[..., None]
    inv_pi = k(0.318309886)
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
    n_dot_v = _saturate(_dot(normal, view_dir))[..., None]
    r = roughness[..., None]
    k = _consts(r)
    rx = r * -1.0 + 1.0
    ry = r * k(-0.0275) + k(0.0425)
    rz = r * k(-0.572) + k(1.04)
    rw = r * k(0.022) - k(0.04)
    a004 = torch.minimum(rx * rx, torch.exp2(k(-9.28) * n_dot_v)) * rx + ry
    ab_x = k(-1.04) * a004 + rz
    ab_y = k(1.04) * a004 + rw
    return albedo * (1.0 - f0) + (f0 * ab_x + ab_y)
