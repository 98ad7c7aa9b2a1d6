"""Voxel object pool with dense per-object grids and the derived per-chunk
occupancy codes (port of ``impact_tpu/voxel/object.py``).

Voxel (i,j,k) center sits at ``(ijk + 0.5) * voxel_extent + origin`` in the
object's body frame; a voxel is part of the object iff sdf < 0."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sdf as sdflib
from .encoding import sdf_world

CHUNK_SIZE = 16  # ref: object.rs:199-207; the two-level labelling's chunk

# chunk occupancy codes (ref: object.rs:75-101 Void/Uniform/NonUniform)
CHUNK_VOID = 0
CHUNK_UNIFORM = 1
CHUNK_NON_UNIFORM = 2


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


def empty_voxel_object_pool(n_objects: int, grid_size: int, sdf_dtype=torch.float32,
                            device="cuda") -> VoxelObjectPool:
    """A pool of ``n_objects`` dead slots of [G,G,G] grids: far SDF (127
    codes for an int8 pool, 1e3 otherwise), type 0, shadow casters."""
    g = grid_size
    if sdf_dtype == torch.int8:
        sdf0 = torch.full((n_objects, g, g, g), 127, dtype=torch.int8, device=device)
    else:
        sdf0 = torch.full((n_objects, g, g, g), 1e3, dtype=torch.float32, device=device)
    return VoxelObjectPool(
        alive=torch.zeros(n_objects, dtype=torch.bool, device=device),
        body_index=torch.zeros(n_objects, dtype=torch.int64, device=device),
        voxel_extent=torch.ones(n_objects, dtype=torch.float32, device=device),
        origin=torch.zeros((n_objects, 3), dtype=torch.float32, device=device),
        sdf=sdf0,
        vtype=torch.zeros((n_objects, g, g, g), dtype=torch.int32, device=device),
        mesh_dirty=torch.zeros(n_objects, dtype=torch.bool, device=device),
        split_pending=torch.zeros(n_objects, dtype=torch.bool, device=device),
        casts_shadows=torch.ones(n_objects, dtype=torch.bool, device=device))


def grid_coords(grid_size: int, device="cuda", x0: int = 0, gx: int | None = None):
    """Voxel centers in grid units: [G,G,G,3] of (i+0.5, j+0.5, k+0.5); with
    ``x0``/``gx`` only the slab of x planes [x0, x0+gx), [gx,G,G,3]."""
    r = torch.arange(grid_size, dtype=torch.float32, device=device) + 0.5
    rx = r if gx is None else r[x0:x0 + gx]
    i, j, k = torch.meshgrid(rx, r, r, indexing="ij")
    return torch.stack([i, j, k], dim=-1)


def generate_sdf_grid(graph, grid_size: int, voxel_extent: float, center=True,
                      device="cuda"):
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


def chunk_codes(pool: VoxelObjectPool):
    """Per-chunk occupancy codes [O, G/16, G/16, G/16]: void, uniform
    (every voxel occupied) or non-uniform (the surface crosses it)."""
    c = pool.grid_size // CHUNK_SIZE
    occ = occupancy(pool).reshape(pool.n_objects, c, CHUNK_SIZE, c, CHUNK_SIZE, c, CHUNK_SIZE)
    filled = occ.sum(dim=(2, 4, 6))
    return torch.where(filled == 0, CHUNK_VOID,
                       torch.where(filled == CHUNK_SIZE ** 3, CHUNK_UNIFORM, CHUNK_NON_UNIFORM))


def occupied_chunk_counts(pool: VoxelObjectPool):
    """Per-object count of non-void 16³ chunks."""
    return (chunk_codes(pool) != CHUNK_VOID).sum(dim=(1, 2, 3))


def surface_chunk_counts(pool: VoxelObjectPool):
    """Per-object count of non-uniform (surface-crossing) 16³ chunks, the
    chunks the incremental mesher visits (ref: mesh.rs:360)."""
    return (chunk_codes(pool) == CHUNK_NON_UNIFORM).sum(dim=(1, 2, 3))


def _shift(occ, axis: int, step: int):
    """occ moved by ``step`` (±1) along ``axis``, zero-filled: out[i] =
    occ[i + step]."""
    n = occ.shape[axis]
    pad = torch.zeros_like(occ.narrow(axis, 0, 1))
    if step > 0:
        return torch.cat([occ.narrow(axis, 1, n - 1), pad], dim=axis)
    return torch.cat([pad, occ.narrow(axis, 0, n - 1)], dim=axis)


def adjacency_masks(occ, halo=None):
    """Per-voxel face adjacency of [..., G,G,G] occupancy (ref: lib.rs
    VoxelFlags HAS_ADJACENT_*): ``{x,y,z}_{dn,up}`` is True where the
    neighbour at −1 / +1 along that axis is occupied. ``halo``: the
    occupancy planes [..., 1, G, G] just left and right of a slab of x
    planes (empty past the grid), read by the x neighbours of its faces."""
    out = {}
    for axis, name in ((-3, "x"), (-2, "y"), (-1, "z")):
        out[f"{name}_dn"] = _shift(occ, axis, -1)
        out[f"{name}_up"] = _shift(occ, axis, 1)
    if halo is not None:
        n = occ.shape[-3]
        out["x_dn"] = torch.cat([halo[0], occ.narrow(-3, 0, n - 1)], dim=-3)
        out["x_up"] = torch.cat([occ.narrow(-3, 1, n - 1), halo[1]], dim=-3)
    return out


def surface_mask(occ, halo=None):
    """Occupied voxels with at least one empty face neighbour (``halo`` as
    ``adjacency_masks``)."""
    adj = adjacency_masks(occ, halo)
    covered = adj["x_dn"] & adj["x_up"] & adj["y_dn"] & adj["y_up"] & adj["z_dn"] & adj["z_up"]
    return occ & ~covered


def voxel_positions_local(pool: VoxelObjectPool, x0: int = 0):
    """[O,G,G,G,3] voxel centers in each object's body frame; on a pool of
    slabs [O,gx,G,G] (x planes [x0, x0+gx)), [O,gx,G,G,3]."""
    coords = grid_coords(pool.grid_size, pool.sdf.device, x0, pool.sdf.shape[-3])
    return (
        coords[None] * pool.voxel_extent[:, None, None, None, None]
        + pool.origin[:, None, None, None, :]
    )
