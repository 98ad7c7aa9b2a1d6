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


def first_moment_sums(pool: VoxelObjectPool, type_densities, x0: int = 0):
    """(voxel masses, voxel positions, [O,4] sums of mass and first
    moment) of the pool's grids, or of its slabs of x planes [x0, x0+gx)."""
    m = voxel_masses(pool, type_densities)
    pos = voxel_positions_local(pool, x0)
    return m, pos, torch.cat([m.sum(dim=(1, 2, 3))[:, None],
                              torch.einsum("oijk,oijkc->oc", m, pos)], dim=1)


def center_of_mass(first_sums):
    return first_sums[:, 1:] / torch.clamp(first_sums[:, 0], min=1e-12)[:, None]


def second_moment_sums(m, pos, com):
    """[O,7] sums of m(y²+z²), m(x²+z²), m(x²+y²), m·xy, m·xz, m·yz about
    ``com`` and of the mass."""
    rel = pos - com[:, None, None, None, :]
    x, y, z = rel.unbind(-1)

    def total(a):
        return a.sum(dim=(1, 2, 3))

    return torch.stack([total(m * (y * y + z * z)), total(m * (x * x + z * z)),
                        total(m * (x * x + y * y)), total(m * x * y), total(m * x * z),
                        total(m * y * z), total(m)], dim=1)


def inertia_from_sums(first_sums, second_sums, voxel_extent):
    """(mass [O], com [O,3], inertia [O,3,3] about the COM) from the sums."""
    ixx, iyy, izz, sxy, sxz, syz, m_sum = second_sums.unbind(1)
    ixy, ixz, iyz = -sxy, -sxz, -syz
    self_term = m_sum * voxel_extent ** 2 / 6.0  # (1/6) m h² per cube
    inertia = torch.stack([
        torch.stack([ixx + self_term, ixy, ixz], -1),
        torch.stack([ixy, iyy + self_term, iyz], -1),
        torch.stack([ixz, iyz, izz + self_term], -1),
    ], dim=-2)
    return first_sums[:, 0], center_of_mass(first_sums), inertia


def inertial_properties(pool: VoxelObjectPool, type_densities, x0: int = 0, reduce=None):
    """(mass [O], com [O,3] body frame, inertia [O,3,3] about the COM).

    On a pool of slabs [O,gx,G,G] (x planes [x0, x0+gx)), ``reduce`` sums a
    tensor of per-object partial sums over the object's slabs: mass and first
    moment first, then the moments about the COM. The slabs' sums add in
    another order than one sum over the grid, so the results agree with the
    whole grid's to rounding, not bitwise."""
    m, pos, first = first_moment_sums(pool, type_densities, x0)
    if reduce is not None:
        first = reduce(first)
    second = second_moment_sums(m, pos, center_of_mass(first))
    if reduce is not None:
        second = reduce(second)
    return inertia_from_sums(first, second, pool.voxel_extent)
