"""Skybox: per-pixel sky luminance for geometry-free pixels (port of
``impact_tpu/render/sky.py``: procedural gradient sky with an optional sun
disk; ref: impact_scene skybox.rs)."""

from __future__ import annotations

import torch

from ..math import quaternion as quat


def pixel_view_directions(cam_orientation, vertical_fov, width: int, height: int):
    """Unit world-space view ray per pixel [H,W,3] (camera looks along −z)."""
    dev = cam_orientation.device
    ty = torch.tan(0.5 * torch.as_tensor(vertical_fov, device=dev))
    tx = ty * width / height
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height * 2.0
    dx = (xs[None, :] * tx).expand(height, width)
    dy = (ys[:, None] * ty).expand(height, width)
    local = torch.stack([dx, dy, -torch.ones((height, width), device=dev)], dim=-1)
    local = local / torch.linalg.vector_norm(local, dim=-1, keepdim=True)
    return quat.rotate(cam_orientation[None, None, :], local)


def procedural_sky(view_dir, zenith_luminance=(3000.0, 4500.0, 9000.0),
                   horizon_luminance=(8000.0, 8500.0, 9500.0),
                   ground_luminance=(1500.0, 1400.0, 1300.0), sun_direction=None,
                   sun_luminance=(5e7, 4.6e7, 4e7), sun_cos_radius: float = 0.9999):
    """Gradient sky + optional sun disk at world directions [...,3]."""
    dev = view_dir.device

    def vec(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    up = view_dir[..., 1]
    t = torch.clamp(up, 0.0, 1.0) ** 0.6
    sky = vec(horizon_luminance) * (1.0 - t[..., None]) + vec(zenith_luminance) * t[..., None]
    below = torch.clamp(-up, 0.0, 1.0) ** 0.4
    lum = sky * (1.0 - below[..., None]) + vec(ground_luminance) * below[..., None]
    if sun_direction is not None:
        sd = -torch.as_tensor(sun_direction, dtype=torch.float32, device=dev)
        sd = sd / torch.clamp(torch.linalg.vector_norm(sd), min=1e-9)
        c = (view_dir * sd).sum(dim=-1)
        disk = torch.clamp((c - sun_cos_radius) / max(1.0 - sun_cos_radius, 1e-9), 0.0, 1.0)
        lum = lum + vec(sun_luminance) * disk[..., None]
    return lum


def sample_sky_cubemap(cubemap, view_dir):
    """A [6,S,S,3] cubemap at world directions [...,3]: the nearest texel,
    faces laid out as ``lights.CUBE_FACE_DIRS`` (+x, −x, +y, −y, +z, −z)."""
    v = view_dir
    av = v.abs()
    face = torch.where(
        (av[..., 0] >= av[..., 1]) & (av[..., 0] >= av[..., 2]),
        torch.where(v[..., 0] >= 0, 0, 1),
        torch.where(av[..., 1] >= av[..., 2], torch.where(v[..., 1] >= 0, 2, 3),
                    torch.where(v[..., 2] >= 0, 4, 5)))
    x, y, z = v[..., 0], v[..., 1], v[..., 2]

    def pick(*per_face):
        return torch.gather(torch.stack(per_face, -1), -1, face[..., None])[..., 0]

    ax = pick(x, -x, y, -y, z, -z)
    u = pick(-z, z, x, x, x, -x)
    w = pick(-y, -y, z, -z, -y, -y)
    inv = 1.0 / torch.clamp(ax, min=1e-9)
    s = cubemap.shape[1]
    iu = torch.clamp(((u * inv * 0.5 + 0.5) * s).to(torch.int64), 0, s - 1)
    iv = torch.clamp(((w * inv * 0.5 + 0.5) * s).to(torch.int64), 0, s - 1)
    return cubemap[face, iv, iu]
