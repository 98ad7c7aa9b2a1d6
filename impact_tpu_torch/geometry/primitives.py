"""Closest-point queries on segments and the capsule SDF (port of the part
of ``impact_tpu/geometry/primitives.py`` the narrow phase and the absorbers
use)."""

from __future__ import annotations

import torch


def plane_signed_distance(normal, displacement, p):
    """Signed distance of point(s) to plane(s): positive on the normal side."""
    return (normal * p).sum(dim=-1) - displacement


def closest_point_on_segment(a, b, p, eps=1e-12):
    """Closest point to ``p`` on segment a→b, and its clamped parameter t."""
    ab = b - a
    denom = (ab * ab).sum(dim=-1)
    t = torch.clamp(((p - a) * ab).sum(dim=-1) / torch.clamp(denom, min=eps), 0.0, 1.0)
    return a + t[..., None] * ab, t


def capsule_sdf(a, b, radius, p):
    cp, _ = closest_point_on_segment(a, b, p)
    return torch.linalg.vector_norm(p - cp, dim=-1) - radius


def segment_segment_closest_points(p1, q1, p2, q2, eps=1e-9):
    """Closest points between segments p1→q1 and p2→q2 (Ericson, Real-Time
    Collision Detection §5.1.9, branch-free)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = (d1 * d1).sum(dim=-1)
    e = (d2 * d2).sum(dim=-1)
    f = (d2 * r).sum(dim=-1)
    c = (d1 * r).sum(dim=-1)
    b = (d1 * d2).sum(dim=-1)
    denom = a * e - b * b
    s = torch.where(denom > eps,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=eps), 0.0, 1.0), 0.0)
    t = (b * s + f) / torch.clamp(e, min=eps)
    t_clamped = torch.clamp(t, 0.0, 1.0)
    s = torch.where(t != t_clamped,
                    torch.clamp((t_clamped * b - c) / torch.clamp(a, min=eps), 0.0, 1.0), s)
    return p1 + s[..., None] * d1, p2 + t_clamped[..., None] * d2


def sphere_sdf(center, radius, p):
    return torch.linalg.vector_norm(p - center, dim=-1) - radius


def box_sdf(half_extents, p):
    """SDF of an axis-aligned box centred at the origin (exact)."""
    q = p.abs() - half_extents
    outside = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(q.amax(dim=-1), max=0.0)
    return outside + inside
