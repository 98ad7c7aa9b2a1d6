"""Implicit bounding-volume hierarchy over scene objects (port of
``impact_tpu/geometry/bvh.py``; ref: impact_intersection/src/bounding_volume/
hierarchy.rs, the BoundingVolumeHierarchy gizmo's tree).

Objects are sorted by the Morton code of their bounding-sphere centres
(a stable sort, as ``jnp.argsort``'s, so dead objects, all coded
0xFFFFFFFF, and tied codes keep their slot order); node (level ℓ, index i)
covers the sorted range [i·⌈N/2^ℓ⌉, (i+1)·⌈N/2^ℓ⌉), so each level is one
min/max reduction over a reshape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math.morton import morton_codes_for_points

BIG = 3.0e38
DEAD_CODE = 0xFFFFFFFF


class ObjectBVH(NamedTuple):
    """Per-level node AABBs; level ℓ has 2^ℓ nodes (root = level 0)."""

    lo: tuple  # tuple of f32[2^ℓ,3]
    hi: tuple  # tuple of f32[2^ℓ,3]
    active: tuple  # tuple of bool[2^ℓ]
    order: torch.Tensor  # i64[N] Morton-sorted object order (the leaves)


def build_object_bvh(centers, radii, alive, n_levels: int = 4) -> ObjectBVH:
    """An implicit LBVH over object bounding spheres: centers f32[N,3],
    radii f32[N], alive bool[N]; ``n_levels`` levels of internal nodes
    (root + n_levels − 1 splits), fewer when a level would have more nodes
    than objects."""
    n = centers.shape[0]
    dev = centers.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    r = torch.where(alive, radii, 0.0)[:, None]
    lo_pt = torch.where(alive[:, None], centers - r, big)
    hi_pt = torch.where(alive[:, None], centers + r, -big)

    scene_lo = torch.where(alive[:, None], centers, big).amin(dim=0)
    scene_hi = torch.where(alive[:, None], centers, -big).amax(dim=0)
    codes = morton_codes_for_points(centers, scene_lo, scene_hi)
    # dead objects sort last so live ranges stay contiguous
    codes = torch.where(alive, codes, DEAD_CODE)
    order = torch.argsort(codes, stable=True)

    lo_s, hi_s, act_s = lo_pt[order], hi_pt[order], alive[order]
    los, his, acts = [], [], []
    for level in range(n_levels):
        k = 1 << level
        if k > n:
            break
        pad = (-n) % k
        shape = (k, (n + pad) // k, 3)
        lo_p = torch.cat([lo_s, big.expand(pad, 3)]).reshape(shape)
        hi_p = torch.cat([hi_s, (-big).expand(pad, 3)]).reshape(shape)
        a_p = torch.cat([act_s, torch.zeros(pad, dtype=torch.bool, device=dev)]).reshape(shape[:2])
        los.append(lo_p.amin(dim=1))
        his.append(hi_p.amax(dim=1))
        acts.append(a_p.any(dim=1))
    return ObjectBVH(tuple(los), tuple(his), tuple(acts), order)
