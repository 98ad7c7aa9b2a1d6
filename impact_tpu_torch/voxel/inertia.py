"""Voxel-object mass and centre of mass (port of the part of
``impact_tpu/voxel/inertia.py`` scene setup needs: the body origin sits at
the object's COM)."""

from __future__ import annotations

import torch

from .object import VoxelObjectPool, occupancy, voxel_positions_local


def voxel_masses(pool: VoxelObjectPool, type_densities):
    occ = occupancy(pool)
    t = torch.clamp(pool.vtype.long(), 0, type_densities.shape[0] - 1)
    density = type_densities[t]
    vol = (pool.voxel_extent ** 3)[:, None, None, None]
    return torch.where(occ, density * vol, torch.zeros((), device=occ.device))


def mass_and_com(pool: VoxelObjectPool, type_densities):
    """(mass [O], com [O,3] in the body frame)."""
    m = voxel_masses(pool, type_densities)
    pos = voxel_positions_local(pool)
    mass = m.sum(dim=(1, 2, 3))
    com = torch.einsum("oijk,oijkc->oc", m, pos) / torch.clamp(mass, min=1e-12)[:, None]
    return mass, com
