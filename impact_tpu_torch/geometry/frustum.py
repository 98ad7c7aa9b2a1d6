"""View frustum planes and sphere culling (port of
``impact_tpu/geometry/frustum.py``). Planes point inward: a point is inside
iff n·p − d ≥ 0 for all six (left, right, bottom, top, near, far)."""

from __future__ import annotations

import torch


def frustum_planes_from_view_proj(view_proj):
    r0, r1, r2, r3 = view_proj[0], view_proj[1], view_proj[2], view_proj[3]
    rows = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r2, r3 - r2])
    normals = rows[:, :3]
    d = -rows[:, 3]
    inv_len = 1.0 / torch.clamp(
        torch.linalg.vector_norm(normals, dim=-1, keepdim=True), min=1e-12
    )
    return normals * inv_len, d * inv_len.squeeze(-1)


def sphere_inside_frustum(normals, displacements, centers, radii):
    """True for spheres not entirely outside any plane. centers [...,3]."""
    sd = torch.einsum("pk,...k->...p", normals, centers) - displacements
    return torch.all(sd >= -radii[..., None], dim=-1)


def aabb_inside_frustum(normals, displacements, lo, hi):
    """Conservative AABB-vs-frustum: each box's corner furthest along each
    plane's normal (the p-vertex) against every plane. lo/hi [...,3]
    broadcast against the 6 planes."""
    corner = torch.where(normals > 0, hi[..., None, :], lo[..., None, :])
    sd = (normals * corner).sum(dim=-1) - displacements
    return torch.all(sd >= 0.0, dim=-1)
