"""Light pools, shadow maps and deferred shading.

Port of ``impact_tpu/render/lights.py``: ambient, omnidirectional lights
(6-face depth cubemaps when shadowable) and unidirectional lights (one
orthographic map covering the scene, or up to four cascades fit to the
camera's sub-frusta), sampled with the quad-packed bilinear 4-tap PCF, or,
with soft shadows on, a 4-tap PCF whose radius grows with the light's extent
and the blocker distance (PCSS-style penumbras). Shadow views are
rasterized with K1's depth variant (``raster_backend="kernel"``) or with
the plain tile raster (``"raster"``).
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


def empty_light_pools(n_omni: int = 4, n_uni: int = 2, device=None) -> LightPools:
    """Light pools with every slot masked off, unidirectional lights
    pointing down."""
    return LightPools(
        ambient_luminance=torch.zeros(3, device=device),
        omni_position=torch.zeros((n_omni, 3), device=device),
        omni_intensity=torch.zeros((n_omni, 3), device=device),
        omni_extent=torch.zeros(n_omni, device=device),
        omni_shadowable=torch.zeros(n_omni, dtype=torch.bool, device=device),
        omni_mask=torch.zeros(n_omni, dtype=torch.bool, device=device),
        uni_direction=torch.tensor([[0.0, -1.0, 0.0]], device=device).repeat(n_uni, 1),
        uni_illuminance=torch.zeros((n_uni, 3), device=device),
        uni_extent=torch.zeros(n_uni, device=device),
        uni_shadowable=torch.zeros(n_uni, dtype=torch.bool, device=device),
        uni_mask=torch.zeros(n_uni, dtype=torch.bool, device=device),
    )


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


def _raster_depth(tri_pos9, tri_active, vp, resolution, backend, big_budget):
    """One depth view → (depth [S,S], n_drop)."""
    if backend == "kernel":
        from .raster_pallas import rasterize_depth_pos

        # windows fit to the view, as the G-buffer's (render/pipeline.py)
        return rasterize_depth_pos(
            tri_pos9, tri_active, vp, resolution, resolution, cull_backfaces=False,
            tile=32, k_per_range=None, return_drops=True)
    from .pipeline import project_corners

    # tile lists fit to the view, as K1's windows (the reference keeps the
    # nearest 256 a tile)
    target, _, _ = rasterlib.rasterize(
        project_corners(tri_pos9, vp), tri_active, resolution, resolution,
        cull_backfaces=False, big_budget=big_budget, fit_k=True)
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
        d, nd = _raster_depth(tri_pos9, tri_active, vp, resolution, backend, big_budget=256)
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
    d, nd = _raster_depth(tri_pos9, tri_active, vp, resolution, backend, big_budget=64)
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


def _pcf_4tap(sample, base, size, depth_ref, radius, bias=2e-3):
    """Bilinear 4-tap PCF with taps ``radius`` texels (per pixel) from the
    centre; ``sample(p)`` gathers the depth at integer texel p [...,2]."""
    f = base - torch.floor(base)
    vis = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            off = torch.stack([(dx - 0.5) * 2.0 * radius, (dy - 0.5) * 2.0 * radius], dim=-1)
            p = torch.clamp(torch.round(base + off).to(torch.int64), 0, size - 1)
            wx = f[..., 0] if dx else 1.0 - f[..., 0]
            wy = f[..., 1] if dy else 1.0 - f[..., 1]
            vis = vis + wx * wy * (depth_ref - bias <= sample(p))
    return vis


def omni_shadow_visibility(light_pos, shadow_quads, shadow_vps, world_pos, source_extent=None):
    """Visibility from a quad-packed point-light cubemap [6,S,S,4] at world
    positions [...,3] (dominant-axis face, then 4-tap PCF). ``source_extent``
    (the light's size) turns on the soft variant: the blocker depth at the
    centre tap sets the PCF radius."""
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
    if source_extent is not None:
        def sample(p):
            return flat[fbase + p[..., 1] * s + p[..., 0], 0]

        pc = torch.clamp(torch.round(base).to(torch.int64), 0, s - 1)
        d_blocker = sample(pc)
        penumbra = (source_extent * torch.clamp(depth_ref - d_blocker, min=0.0)
                    / torch.clamp(d_blocker, min=1e-3))
        radius = torch.clamp(0.5 + penumbra * s * 8.0, 0.5, 8.0)
        return _pcf_4tap(sample, base, s, depth_ref, radius)
    return _pcf_4tap_quad(lambda p: flat[fbase + p[..., 1] * s + p[..., 0]], base, s, depth_ref)


MAX_SHADOW_MAP_CASCADES = 4  # ref: lib.rs:340


def cascade_partition_depths(near, far, n_cascades: int, blend: float = 0.75):
    """[C + 1] view-space split depths: a blend of the linear and the
    logarithmic partition (PSSM)."""
    i = torch.arange(n_cascades + 1, dtype=torch.float32, device=near.device) / n_cascades
    linear = near + (far - near) * i
    logarithmic = near * (far / near) ** i
    return blend * logarithmic + (1.0 - blend) * linear


def _frustum_corners_world(cam_pos, cam_orientation, vertical_fov, aspect, d0, d1):
    """The 8 world-space corners of the camera's sub-frustum between depths
    d0 and d1."""
    from ..math import quaternion as quat

    ty = torch.tan(0.5 * vertical_fov)
    tx = ty * aspect
    local = torch.stack([torch.stack([sx * tx * d, sy * ty * d, -d])
                         for d in (d0, d1) for sy in (-1.0, 1.0) for sx in (-1.0, 1.0)])
    return quat.rotate(cam_orientation[None, :], local) + cam_pos[None, :]


def render_uni_shadow_cascades(light_dir, cam_pos, cam_orientation, vertical_fov, aspect, near,
                               far, tri_pos9, tri_active, resolution: int, n_cascades: int,
                               backend: str = "kernel"):
    """``n_cascades`` directional shadow maps, each fit to a camera
    sub-frustum (one K1 depth view each on the kernel backend) →
    (depths [C,S,S], vps [C,4,4], splits [C+1], n_drop)."""
    splits = cascade_partition_depths(near, far, n_cascades)
    ds, vs = [], []
    n_drop = torch.zeros((), dtype=torch.int64, device=tri_pos9.device)
    for c in range(n_cascades):
        corners = _frustum_corners_world(cam_pos, cam_orientation, vertical_fov, aspect,
                                         splits[c], splits[c + 1])
        center = corners.mean(dim=0)
        radius = torch.linalg.vector_norm(corners - center, dim=-1).amax() + 1e-3
        d, v, nd = render_uni_shadow_map(light_dir, center, radius, tri_pos9, tri_active,
                                         resolution, backend=backend)
        ds.append(d)
        vs.append(v)
        n_drop = n_drop + nd
    return torch.stack(ds), torch.stack(vs), splits, n_drop


def uni_cascade_visibility(quads, vps, splits, view_depth, world_pos, normal=None,
                           angular_extent=None):
    """Cascade-selected PCF visibility from quad-packed maps [C,S,S,4]: the
    first cascade whose far split exceeds the pixel's view depth, receivers
    offset along the normal by 1.5 of that cascade's shadow texels.
    ``angular_extent`` (radians) turns on the soft variant."""
    n_cascades = quads.shape[0]
    if n_cascades > 1:
        idx = (view_depth[..., None] > splits[1:-1]).to(torch.int64).sum(dim=-1)
        idx = torch.clamp(idx, 0, n_cascades - 1)
    else:
        idx = torch.zeros(view_depth.shape, dtype=torch.int64, device=view_depth.device)
    s = quads.shape[-2]
    if normal is not None:
        radii = 1.0 / torch.clamp(vps[:, 0, 0].abs(), min=1e-9)
        radius_px = radii[0]
        for c in range(1, n_cascades):
            radius_px = torch.where(idx == c, radii[c], radius_px)
        texel_world = 2.0 * radius_px / s
        world_pos = world_pos + normal * (1.5 * texel_world)[..., None]
    wx, wy, wz = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]

    def proj_c(c, row):
        m = vps[c]
        return m[row, 0] * wx + m[row, 1] * wy + m[row, 2] * wz + m[row, 3]

    def select_c(row):
        out = proj_c(0, row)
        for c in range(1, n_cascades):
            out = torch.where(idx == c, proj_c(c, row), out)
        return out

    ndc_x, ndc_y, ndc_z = select_c(0), select_c(1), select_c(2)
    uv = torch.stack([ndc_x * 0.5 + 0.5, 0.5 - ndc_y * 0.5], -1)
    in_map = torch.all((uv >= 0.0) & (uv <= 1.0), dim=-1)
    base = uv * s - 0.5
    flat = quads.reshape(n_cascades * s * s, 4)
    cbase = idx * (s * s)
    if angular_extent is not None:
        def sample(p):
            return flat[cbase + p[..., 1] * s + p[..., 0], 0]

        pc = torch.clamp(torch.round(base).to(torch.int64), 0, s - 1)
        d_blocker = sample(pc)
        penumbra = angular_extent * torch.clamp(ndc_z - d_blocker, min=0.0)
        radius = torch.clamp(0.5 + penumbra * s * 4.0, 0.5, 8.0)
        vis = _pcf_4tap(sample, base, s, ndc_z, radius)
    else:
        vis = _pcf_4tap_quad(lambda p: flat[cbase + p[..., 1] * s + p[..., 0]], base, s, ndc_z)
    return torch.where(in_map, vis, torch.ones_like(vis))


def shade(lights: LightPools, world_pos, normal, albedo, f0, roughness, emissive, occlusion,
          camera_pos, valid, omni_shadows=None, uni_shadows=None, view_depth=None,
          shadow_downsample: int = 1, soft_shadows: bool = False, bf16: bool = False):
    """Deferred shading: ambient + omni + uni lights → HDR luminance [H,W,3].
    Shadow visibility is evaluated on a 1/k pixel grid and nearest-upsampled
    when ``shadow_downsample`` = k > 1; ``soft_shadows`` widens the PCF
    with each light's extent. ``bf16`` evaluates the BRDF math in bfloat16
    with the reference's casts: the normal, view direction, material inputs
    and occlusion, each light's direction, illuminance and angular radius,
    and the visibility go to bfloat16; positions and shadow projections stay
    float32. The BRDF rounds as the reference's XLA program does
    (``render/brdf.py``: dot products summed in float32, constants rounded
    to bfloat16)."""
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
    if bf16:
        bt = torch.bfloat16
        normal, view_dir, albedo, f0, roughness, emissive, occlusion = (
            x.to(bt) for x in (normal, view_dir, albedo, f0, roughness, emissive, occlusion))
    dt = normal.dtype
    lum = emissive + ambient_brdf(normal, view_dir, albedo, f0, roughness) * (
        lights.ambient_luminance.to(dt) * occlusion[..., None])

    zero = torch.zeros((), device=world_pos.device)
    for li in range(lights.omni_mask.shape[0]):
        lvec = lights.omni_position[li] - world_pos
        dist2 = (lvec * lvec).sum(dim=-1)
        inv_dist = 1.0 / torch.clamp(torch.sqrt(dist2), min=1e-9)
        ldir = (lvec * inv_dist[..., None]).to(dt)
        illum = (lights.omni_intensity[li] / torch.clamp(dist2, min=1e-6)[..., None]).to(dt)
        tan_r = (0.5 * lights.omni_extent[li] * inv_dist).to(dt)
        contrib = evaluate_brdf(normal, view_dir, ldir, albedo, f0, roughness,
                                tan_angular_radius=tan_r) * illum
        if omni_shadows is not None:
            quads, vps = omni_shadows
            vis = upsample(omni_shadow_visibility(
                lights.omni_position[li], quads[li], vps[li], at_vis_res(world_pos),
                source_extent=lights.omni_extent[li] if soft_shadows else None))
            vis = torch.where(lights.omni_shadowable[li], vis, torch.ones_like(vis))
            contrib = contrib * vis[..., None].to(dt)
        lum = lum + torch.where(lights.omni_mask[li], contrib, zero)

    for li in range(lights.uni_mask.shape[0]):
        ldir = (-lights.uni_direction[li]).to(dt)
        tan_r = torch.tan(0.5 * lights.uni_extent[li] * (math.pi / 180.0)).to(dt)
        b = evaluate_brdf(normal, view_dir, ldir, albedo, f0, roughness,
                          tan_angular_radius=tan_r)
        if uni_shadows is not None:
            quads, vps, splits = uni_shadows
            vis = upsample(uni_cascade_visibility(
                quads[li], vps[li], splits[li], at_vis_res(view_depth), at_vis_res(world_pos),
                at_vis_res(normal),
                angular_extent=(lights.uni_extent[li] * (math.pi / 180.0) if soft_shadows
                                else None)))
            vis = torch.where(lights.uni_shadowable[li], vis, torch.ones_like(vis))
            b = b * vis[..., None].to(dt)
        lum = lum + torch.where(lights.uni_mask[li], b * lights.uni_illuminance[li].to(dt), zero)

    return torch.where(valid[..., None], lum, zero).to(torch.float32)
