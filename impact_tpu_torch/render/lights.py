"""Light pools, shadow maps and deferred shading.

Port of ``impact_tpu/render/lights.py`` for the slice's light kinds: ambient,
shadowable omnidirectional lights (6-face depth cubemaps) and shadowable
unidirectional lights (one orthographic map covering the scene), sampled with
the quad-packed bilinear 4-tap PCF. Shadow views are rasterized with K1's
depth variant (``raster_backend="kernel"``) or with the plain tile raster
(``"raster"``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.projection import orthographic_projection_matrix, perspective_projection_matrix
from . import raster as rasterlib
from .brdf import ambient_brdf, evaluate_brdf


class LightPools(NamedTuple):
    ambient_luminance: torch.Tensor  # f32[3]
    omni_position: torch.Tensor  # f32[L,3]
    omni_intensity: torch.Tensor  # f32[L,3]
    omni_extent: torch.Tensor  # f32[L]
    omni_shadowable: torch.Tensor  # bool[L]
    omni_mask: torch.Tensor  # bool[L]
    uni_direction: torch.Tensor  # f32[D,3] direction light travels
    uni_illuminance: torch.Tensor  # f32[D,3]
    uni_extent: torch.Tensor  # f32[D] angular extent (degrees)
    uni_shadowable: torch.Tensor  # bool[D]
    uni_mask: torch.Tensor  # bool[D]


OMNI_SHADOW_FAR = 100.0

CUBE_FACE_DIRS = np.array(
    [[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
     [0.0, -1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)
CUBE_FACE_UPS = np.array(
    [[0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0],
     [0.0, 0.0, -1.0], [0.0, -1.0, 0.0], [0.0, -1.0, 0.0]], np.float32)


def _look_view_matrix(eye, fwd, up):
    """World→view matrix for a camera at eye looking along fwd."""
    f = fwd / torch.clamp(torch.linalg.vector_norm(fwd), min=1e-9)
    r = torch.linalg.cross(f, up)
    r = r / torch.clamp(torch.linalg.vector_norm(r), min=1e-9)
    u = torch.linalg.cross(r, f)
    m = torch.zeros((4, 4), dtype=torch.float32, device=eye.device)
    m[0, :3] = r
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -torch.dot(r, eye)
    m[1, 3] = -torch.dot(u, eye)
    m[2, 3] = torch.dot(f, eye)
    m[3, 3] = 1.0
    return m


def _raster_depth(tri_pos9, tri_active, vp, resolution, backend, k_per_tile, big_budget,
                  tiles_per_chunk):
    """One depth view → (depth [S,S], n_drop)."""
    if backend == "kernel":
        from .raster_pallas import rasterize_depth_pos

        return rasterize_depth_pos(
            tri_pos9, tri_active, vp, resolution, resolution, cull_backfaces=False,
            tile=32, k_per_range=256, return_drops=True)
    from .pipeline import project_corners

    target, _, _ = rasterlib.rasterize(
        project_corners(tri_pos9, vp), tri_active, resolution, resolution,
        cull_backfaces=False, k_per_tile=k_per_tile, big_budget=big_budget,
        tiles_per_chunk=tiles_per_chunk)
    # the plain tile raster keeps the nearest-K per tile without counting
    return target.depth, torch.zeros((), dtype=torch.int64, device=tri_pos9.device)


def render_omni_shadow_cubemap(light_pos, tri_pos9, tri_active, resolution: int, near=0.05,
                               far=None, backend: str = "kernel"):
    """6-face depth cubemap for one point light → (depths [6,S,S], vps [6,4,4], n_drop)."""
    far = OMNI_SHADOW_FAR if far is None else far
    dev = tri_pos9.device
    proj = perspective_projection_matrix(1.0, math.pi / 2, near, far, device=dev)
    ds, vs = [], []
    n_drop = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(6):
        view = _look_view_matrix(light_pos, torch.as_tensor(CUBE_FACE_DIRS[i], device=dev),
                                 torch.as_tensor(CUBE_FACE_UPS[i], device=dev))
        vp = proj @ view
        d, nd = _raster_depth(tri_pos9, tri_active, vp, resolution, backend,
                              k_per_tile=256, big_budget=256, tiles_per_chunk=32)
        ds.append(d)
        vs.append(vp)
        n_drop = n_drop + nd
    return torch.stack(ds), torch.stack(vs), n_drop


def render_uni_shadow_map(light_dir, scene_center, scene_radius, tri_pos9, tri_active,
                          resolution: int, backend: str = "kernel"):
    """Orthographic shadow map covering the scene's bounding sphere →
    (depth [S,S], vp [4,4], n_drop)."""
    dev = tri_pos9.device
    eye = scene_center - light_dir * (2.0 * scene_radius)
    up = torch.where(light_dir[1].abs() < 0.95, torch.tensor([0.0, 1.0, 0.0], device=dev),
                     torch.tensor([1.0, 0.0, 0.0], device=dev))
    view = _look_view_matrix(eye, light_dir, up)
    r = scene_radius
    proj = orthographic_projection_matrix(-r, r, -r, r, 0.05, 4.0 * r, device=dev)
    vp = proj @ view
    d, nd = _raster_depth(tri_pos9, tri_active, vp, resolution, backend,
                          k_per_tile=256, big_budget=64, tiles_per_chunk=64)
    return d, vp, nd


def quad_pack(depth_map):
    """[...,S,S] depth → [...,S,S,4]: channel c = depth[y+dy, x+dx] (edge-clamped)."""
    d00 = depth_map
    d10 = torch.cat([depth_map[..., :, 1:], depth_map[..., :, -1:]], dim=-1)
    d01 = torch.cat([depth_map[..., 1:, :], depth_map[..., -1:, :]], dim=-2)
    d11 = torch.cat([d01[..., :, 1:], d01[..., :, -1:]], dim=-1)
    return torch.stack([d00, d10, d01, d11], dim=-1)


def _pcf_4tap_quad(quad_at, base, size, depth_ref, bias=2e-3):
    """Bilinear 4-tap PCF from a quad-packed map; ``quad_at(p)`` gathers the
    [...,4] row at integer texel p [...,2]."""
    b0f = torch.floor(base)
    f = base - b0f
    p = torch.clamp(b0f.to(torch.int64), 0, size - 1)
    q = quad_at(p)
    lit = (depth_ref[..., None] - bias <= q).to(torch.float32)
    wx, wy = f[..., 0], f[..., 1]
    return (lit[..., 0] * (1 - wx) * (1 - wy) + lit[..., 1] * wx * (1 - wy)
            + lit[..., 2] * (1 - wx) * wy + lit[..., 3] * wx * wy)


def omni_shadow_visibility(light_pos, shadow_quads, shadow_vps, world_pos):
    """Visibility from a quad-packed point-light cubemap [6,S,S,4] at world
    positions [...,3] (dominant-axis face, then 4-tap PCF)."""
    v = world_pos - light_pos
    av = v.abs()
    dev = world_pos.device

    inner = torch.where(av[..., 1] >= av[..., 2],
                        torch.where(v[..., 1] >= 0, torch.tensor(2, device=dev),
                                    torch.tensor(3, device=dev)),
                        torch.where(v[..., 2] >= 0, torch.tensor(4, device=dev),
                                    torch.tensor(5, device=dev)))
    face = torch.where((av[..., 0] >= av[..., 1]) & (av[..., 0] >= av[..., 2]),
                       torch.where(v[..., 0] >= 0, torch.tensor(0, device=dev),
                                   torch.tensor(1, device=dev)),
                       inner)
    wx, wy, wz = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]

    def proj_face(f, row):
        m = shadow_vps[f]
        return m[row, 0] * wx + m[row, 1] * wy + m[row, 2] * wz + m[row, 3]

    def select_by_face(row):
        out = proj_face(0, row)
        for f in range(1, 6):
            out = torch.where(face == f, proj_face(f, row), out)
        return out

    cxp, cyp, czp = select_by_face(0), select_by_face(1), select_by_face(2)
    iwp = 1.0 / torch.clamp(select_by_face(3), min=1e-8)
    uv = torch.stack([cxp * iwp * 0.5 + 0.5, 0.5 - cyp * iwp * 0.5], -1)
    depth_ref = czp * iwp
    s = shadow_quads.shape[-2]
    base = uv * s - 0.5
    flat = shadow_quads.reshape(6 * s * s, 4)
    fbase = face * (s * s)
    return _pcf_4tap_quad(lambda p: flat[fbase + p[..., 1] * s + p[..., 0]], base, s, depth_ref)


def uni_cascade_visibility(quads, vps, view_depth, world_pos, normal):
    """PCF visibility from a single-cascade quad-packed map [1,S,S,4] with a
    normal-offset bias of 1.5 shadow texels."""
    if quads.shape[0] != 1:
        raise NotImplementedError("the port renders one directional cascade")
    s = quads.shape[-2]
    radius = 1.0 / torch.clamp(vps[0, 0, 0].abs(), min=1e-9)
    texel_world = 2.0 * radius / s
    world_pos = world_pos + normal * (1.5 * texel_world)
    wx, wy, wz = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]
    m = vps[0]
    ndc_x = m[0, 0] * wx + m[0, 1] * wy + m[0, 2] * wz + m[0, 3]
    ndc_y = m[1, 0] * wx + m[1, 1] * wy + m[1, 2] * wz + m[1, 3]
    ndc_z = m[2, 0] * wx + m[2, 1] * wy + m[2, 2] * wz + m[2, 3]
    uv = torch.stack([ndc_x * 0.5 + 0.5, 0.5 - ndc_y * 0.5], -1)
    in_map = torch.all((uv >= 0.0) & (uv <= 1.0), dim=-1)
    base = uv * s - 0.5
    flat = quads.reshape(s * s, 4)
    vis = _pcf_4tap_quad(lambda p: flat[p[..., 1] * s + p[..., 0]], base, s, ndc_z)
    return torch.where(in_map, vis, torch.ones_like(vis))


def shade(lights: LightPools, world_pos, normal, albedo, f0, roughness, emissive, occlusion,
          camera_pos, valid, omni_shadows=None, uni_shadows=None, view_depth=None,
          shadow_downsample: int = 1):
    """Deferred shading: ambient + omni + uni lights → HDR luminance [H,W,3].
    Shadow visibility is evaluated on a 1/k pixel grid and nearest-upsampled
    when ``shadow_downsample`` = k > 1."""
    h, w = world_pos.shape[:2]
    s = shadow_downsample

    def at_vis_res(x):
        return x[::s, ::s] if s > 1 else x

    def upsample(vis):
        if s == 1:
            return vis
        return vis.repeat_interleave(s, dim=0).repeat_interleave(s, dim=1)[:h, :w]

    view_dir = camera_pos - world_pos
    view_dir = view_dir / torch.clamp(torch.linalg.vector_norm(view_dir, dim=-1, keepdim=True),
                                      min=1e-9)
    lum = emissive + ambient_brdf(normal, view_dir, albedo, f0, roughness) * (
        lights.ambient_luminance * occlusion[..., None])

    zero = torch.zeros((), device=world_pos.device)
    for li in range(lights.omni_mask.shape[0]):
        lvec = lights.omni_position[li] - world_pos
        dist2 = (lvec * lvec).sum(dim=-1)
        inv_dist = 1.0 / torch.clamp(torch.sqrt(dist2), min=1e-9)
        ldir = lvec * inv_dist[..., None]
        illum = lights.omni_intensity[li] / torch.clamp(dist2, min=1e-6)[..., None]
        tan_r = 0.5 * lights.omni_extent[li] * inv_dist
        contrib = evaluate_brdf(normal, view_dir, ldir, albedo, f0, roughness,
                                tan_angular_radius=tan_r) * illum
        if omni_shadows is not None:
            quads, vps = omni_shadows
            vis = upsample(omni_shadow_visibility(
                lights.omni_position[li], quads[li], vps[li], at_vis_res(world_pos)))
            vis = torch.where(lights.omni_shadowable[li], vis, torch.ones_like(vis))
            contrib = contrib * vis[..., None]
        lum = lum + torch.where(lights.omni_mask[li], contrib, zero)

    for li in range(lights.uni_mask.shape[0]):
        ldir = -lights.uni_direction[li]
        tan_r = torch.tan(0.5 * lights.uni_extent[li] * (math.pi / 180.0))
        b = evaluate_brdf(normal, view_dir, ldir, albedo, f0, roughness,
                          tan_angular_radius=tan_r)
        if uni_shadows is not None:
            quads, vps, _splits = uni_shadows
            vis = upsample(uni_cascade_visibility(
                quads[li], vps[li], at_vis_res(view_depth), at_vis_res(world_pos),
                at_vis_res(normal)))
            vis = torch.where(lights.uni_shadowable[li], vis, torch.ones_like(vis))
            b = b * vis[..., None]
        lum = lum + torch.where(lights.uni_mask[li], b * lights.uni_illuminance[li], zero)

    return torch.where(valid[..., None], lum, zero).to(torch.float32)
