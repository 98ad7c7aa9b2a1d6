"""Voxel object pool with dense per-object grids (port of the parts of
``impact_tpu/voxel/object.py`` the render slice reads).

Voxel (i,j,k) center sits at ``(ijk + 0.5) * voxel_extent + origin`` in the
object's body frame; a voxel is part of the object iff sdf < 0."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sdf as sdflib
from .encoding import sdf_world


class VoxelObjectPool(NamedTuple):
    alive: torch.Tensor  # bool[O]
    body_index: torch.Tensor  # i64[O] rigid body slot
    voxel_extent: torch.Tensor  # f32[O]
    origin: torch.Tensor  # f32[O,3] grid-origin offset in body frame
    sdf: torch.Tensor  # i8 codes or f32 world units [O,G,G,G]
    vtype: torch.Tensor  # i32[O,G,G,G] material index
    casts_shadows: torch.Tensor  # bool[O]

    @property
    def grid_size(self) -> int:
        return self.sdf.shape[-1]


def grid_coords(grid_size: int, device=None):
    """Voxel centers in grid units: [G,G,G,3] of (i+0.5, j+0.5, k+0.5)."""
    r = torch.arange(grid_size, dtype=torch.float32, device=device) + 0.5
    i, j, k = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([i, j, k], dim=-1)


def generate_sdf_grid(graph, grid_size: int, voxel_extent: float, center=True,
                      device=None):
    """Evaluate an SDF graph over a grid centred on the graph origin.
    Returns (sdf [G,G,G] clamped to ±2 voxel extents, origin [3])."""
    coords = grid_coords(grid_size, device) * voxel_extent
    if center:
        origin = -torch.full((3,), 0.5 * grid_size * voxel_extent, device=device)
    else:
        origin = torch.zeros(3, device=device)
    d = sdflib.evaluate(graph, coords + origin)
    clamp = 2.0 * voxel_extent
    return torch.clamp(d, -clamp, clamp), origin


def occupancy(pool: VoxelObjectPool):
    """bool[O,G,G,G]: voxel belongs to the object."""
    return (sdf_world(pool.sdf, pool.voxel_extent) < 0.0) & pool.alive[:, None, None, None]



def voxel_positions_local(pool: VoxelObjectPool):
    """[O,G,G,G,3] voxel centers in each object's body frame."""
    coords = grid_coords(pool.grid_size, pool.sdf.device)
    return (
        coords[None] * pool.voxel_extent[:, None, None, None, None]
        + pool.origin[:, None, None, None, :]
    )
