"""Geometric primitives and queries (port of ``impact_tpu/geometry``; ref:
engine/crates/impact_geometry): bounding volumes as batched tensors, every
query vectorized over whole pools."""

from . import aabb, frustum, primitives, projection
from .projection import orthographic_projection_matrix, perspective_projection_matrix

__all__ = [
    "aabb",
    "frustum",
    "primitives",
    "projection",
    "perspective_projection_matrix",
    "orthographic_projection_matrix",
]
