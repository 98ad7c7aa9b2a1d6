"""Inertial properties of voxel objects from their grids (port of
``impact_tpu/voxel/inertia.py``; ref: impact_voxel/src/object/inertia.rs):
point-mass-per-voxel sums plus each voxel's own cube inertia, recomputed
whenever a grid changes."""

from __future__ import annotations

import torch

from .object import VoxelObjectPool, occupancy, voxel_positions_local


def voxel_masses(pool: VoxelObjectPool, type_densities):
    occ = occupancy(pool)
    t = torch.clamp(pool.vtype.long(), 0, type_densities.shape[0] - 1)
    density = type_densities[t]
    vol = (pool.voxel_extent ** 3)[:, None, None, None]
    return torch.where(occ, density * vol, torch.zeros((), device=occ.device))


def inertial_properties(pool: VoxelObjectPool, type_densities):
    """(mass [O], com [O,3] body frame, inertia [O,3,3] about the COM)."""
    m = voxel_masses(pool, type_densities)
    pos = voxel_positions_local(pool)
    mass = m.sum(dim=(1, 2, 3))
    com = torch.einsum("oijk,oijkc->oc", m, pos) / torch.clamp(mass, min=1e-12)[:, None]
    rel = pos - com[:, None, None, None, :]
    x, y, z = rel.unbind(-1)

    def total(a):
        return a.sum(dim=(1, 2, 3))

    ixx = total(m * (y * y + z * z))
    iyy = total(m * (x * x + z * z))
    izz = total(m * (x * x + y * y))
    ixy = -total(m * x * y)
    ixz = -total(m * x * z)
    iyz = -total(m * y * z)
    self_term = total(m) * pool.voxel_extent ** 2 / 6.0  # (1/6) m h² per cube
    inertia = torch.stack([
        torch.stack([ixx + self_term, ixy, ixz], -1),
        torch.stack([ixy, iyy + self_term, iyz], -1),
        torch.stack([ixz, iyz, izz + self_term], -1),
    ], dim=-2)
    return mass, com, inertia
