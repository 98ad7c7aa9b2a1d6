"""Axis-aligned bounding boxes, batched (port of ``impact_tpu/geometry/aabb.py``;
ref: impact_geometry/src/axis_aligned_box.rs). The broad phase over a pool is
the dense masked all-pairs overlap matrix."""

from __future__ import annotations

import torch


def from_points(points, axis=-2):
    """AABB (lower, upper) of points along ``axis``."""
    return points.amin(dim=axis), points.amax(dim=axis)


def union(lo_a, hi_a, lo_b, hi_b):
    return torch.minimum(lo_a, lo_b), torch.maximum(hi_a, hi_b)


def center(lo, hi):
    return 0.5 * (lo + hi)


def half_extents(lo, hi):
    return 0.5 * (hi - lo)


def contains_point(lo, hi, p):
    return torch.all((p >= lo) & (p <= hi), dim=-1)


def overlaps(lo_a, hi_a, lo_b, hi_b):
    """Elementwise AABB-vs-AABB overlap test (broadcasts)."""
    return torch.all((lo_a <= hi_b) & (lo_b <= hi_a), dim=-1)


def pairwise_overlap_matrix(lo, hi, mask):
    """Dense broad phase: [N, N] bool, entry (i, j) true iff i < j, both
    alive and the boxes overlap (ref: hierarchy.rs
    for_each_intersecting_bounding_volume_pair)."""
    n = lo.shape[0]
    o = overlaps(lo[:, None, :], hi[:, None, :], lo[None, :, :], hi[None, :, :])
    pair_mask = mask[:, None] & mask[None, :]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=lo.device), diagonal=1)
    return o & pair_mask & upper


def aabb_of_sphere(center_, radius):
    r = radius[..., None]
    return center_ - r, center_ + r


def aabb_of_transformed_box(lo, hi, rotation_matrix, translation):
    """AABB of a rotated and translated AABB (the |R| trick)."""
    c = center(lo, hi)
    e = half_extents(lo, hi)
    new_c = torch.einsum("...ij,...j->...i", rotation_matrix, c) + translation
    new_e = torch.einsum("...ij,...j->...i", rotation_matrix.abs(), e)
    return new_c - new_e, new_c + new_e
