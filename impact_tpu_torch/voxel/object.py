"""Voxel object pool with dense per-object grids (port of
``impact_tpu/voxel/object.py`` without the chunk codes of the chunked path).

Voxel (i,j,k) center sits at ``(ijk + 0.5) * voxel_extent + origin`` in the
object's body frame; a voxel is part of the object iff sdf < 0."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sdf as sdflib
from .encoding import sdf_world

CHUNK_SIZE = 16  # ref: object.rs:199-207; the two-level labelling's chunk


class VoxelObjectPool(NamedTuple):
    alive: torch.Tensor  # bool[O]
    body_index: torch.Tensor  # i64[O] rigid body slot
    voxel_extent: torch.Tensor  # f32[O]
    origin: torch.Tensor  # f32[O,3] grid-origin offset in body frame
    sdf: torch.Tensor  # i8 codes or f32 world units [O,G,G,G]
    vtype: torch.Tensor  # i32[O,G,G,G] material index
    mesh_dirty: torch.Tensor  # bool[O] re-mesh (and inertia/probe sync) needed
    split_pending: torch.Tensor  # bool[O] connectivity re-check needed
    casts_shadows: torch.Tensor  # bool[O]

    @property
    def n_objects(self) -> int:
        return self.alive.shape[0]

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


def nonempty_counts(pool: VoxelObjectPool):
    return occupancy(pool).sum(dim=(1, 2, 3))


def _shift(occ, axis: int, step: int):
    """occ moved by ``step`` (±1) along ``axis``, zero-filled: out[i] =
    occ[i + step]."""
    n = occ.shape[axis]
    pad = torch.zeros_like(occ.narrow(axis, 0, 1))
    if step > 0:
        return torch.cat([occ.narrow(axis, 1, n - 1), pad], dim=axis)
    return torch.cat([pad, occ.narrow(axis, 0, n - 1)], dim=axis)


def adjacency_masks(occ):
    """Per-voxel face adjacency of [..., G,G,G] occupancy (ref: lib.rs
    VoxelFlags HAS_ADJACENT_*): ``{x,y,z}_{dn,up}`` is True where the
    neighbour at −1 / +1 along that axis is occupied."""
    out = {}
    for axis, name in ((-3, "x"), (-2, "y"), (-1, "z")):
        out[f"{name}_dn"] = _shift(occ, axis, -1)
        out[f"{name}_up"] = _shift(occ, axis, 1)
    return out


def surface_mask(occ):
    """Occupied voxels with at least one empty face neighbour."""
    adj = adjacency_masks(occ)
    covered = adj["x_dn"] & adj["x_up"] & adj["y_dn"] & adj["y_up"] & adj["z_dn"] & adj["z_up"]
    return occ & ~covered

def voxel_positions_local(pool: VoxelObjectPool):
    """[O,G,G,G,3] voxel centers in each object's body frame."""
    coords = grid_coords(pool.grid_size, pool.sdf.device)
    return (
        coords[None] * pool.voxel_extent[:, None, None, None, None]
        + pool.origin[:, None, None, None, :]
    )
