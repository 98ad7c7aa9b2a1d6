"""Math foundation (port of ``impact_tpu/math``; ref: engine/crates/impact_math)."""

from . import morton, quaternion, random, transform
from .transform import Isometry, Similarity

__all__ = [
    "quaternion",
    "transform",
    "random",
    "morton",
    "Isometry",
    "Similarity",
]
