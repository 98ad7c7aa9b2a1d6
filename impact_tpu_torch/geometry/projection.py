"""Camera projection matrices (port of ``impact_tpu/geometry/projection.py``):
right-handed camera looking down −z, clip depth in [0, 1], near plane at
depth 0, far at depth 1."""

from __future__ import annotations

import torch


def perspective_projection_matrix(aspect_ratio, vertical_fov, near, far, device="cuda"):
    """[4,4] perspective projection. Scalars may be floats or 0-d tensors."""
    vertical_fov, near, far = (
        torch.as_tensor(x, dtype=torch.float32, device=device)
        for x in (vertical_fov, near, far)
    )
    f = 1.0 / torch.tan(0.5 * vertical_fov)
    m22 = -far / (far - near)
    m = torch.zeros((4, 4), dtype=torch.float32, device=f.device)
    m[0, 0] = f / aspect_ratio
    m[1, 1] = f
    m[2, 2] = m22
    m[2, 3] = m22 * near
    m[3, 2] = -1.0
    return m


def orthographic_projection_matrix(left, right, bottom, top, near, far, device="cuda"):
    """[4,4] orthographic projection onto [-1,1]² × [0,1] looking down −z."""
    left, right, bottom, top, near, far = (
        torch.as_tensor(x, dtype=torch.float32, device=device)
        for x in (left, right, bottom, top, near, far)
    )
    m = torch.zeros((4, 4), dtype=torch.float32, device=left.device)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -near / (far - near)
    m[3, 3] = 1.0
    return m


def project_points(proj, points_view):
    """View-space points [...,3] through a projection matrix → (NDC [...,3]:
    x, y in [-1,1], depth in [0,1]; clip-space w [...])."""
    hp = torch.cat([points_view, torch.ones_like(points_view[..., :1])], -1)
    clip = torch.einsum("ij,...j->...i", proj, hp)
    w = clip[..., 3]
    ndc = clip[..., :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)[..., None]
    return ndc, w


def view_z_from_depth(depth, near, far):
    """Invert the perspective depth mapping: depth ∈ [0,1] → view-space −z."""
    depth = torch.as_tensor(depth)
    return far * near / torch.clamp(far - depth * (far - near), min=1e-12)
