"""3D Morton (Z-order) codes, vectorized (port of ``impact_tpu/math/morton.py``;
ref: impact_math/src/morton.rs).

torch's ``uint32`` lacks a full set of bitwise and shift operations on the
card, so the codes are computed in ``int64`` with the reference's masks:
every intermediate stays below 2³², so the 30-bit codes are exact and equal
the reference's ``uint32`` ones.
"""

from __future__ import annotations

import torch


def _part1by2(x):
    """Spread the low 10 bits of x so there are two zero bits between each."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode_3d(ix, iy, iz):
    """Interleave three 10-bit integer coordinates into a 30-bit Morton code
    (int64)."""
    return _part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)


def morton_codes_for_points(points, lo, hi, bits: int = 10):
    """Quantize points [...,3] into the AABB (lo, hi), truncating toward zero
    after the clip as the reference's ``astype(uint32)`` does, and
    Morton-encode them."""
    scale = (1 << bits) - 1
    t = (points - lo) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(t * scale, 0, scale).to(torch.int64)
    return morton_encode_3d(q[..., 0], q[..., 1], q[..., 2])
