"""Explicit halo exchange for grids sharded along x (port of
``impact_tpu/parallel/halo.py``).

The reference's pair of ``ppermute``s becomes one batch of point-to-point
transfers in the ``space`` group (``Comm.halo``): each rank sends its first
x-plane to its left neighbour and its last to its right one. The boundary
is closed: the edge ranks receive a +inf plane (empty space) on their open
side and send nothing that would wrap around.
"""

from __future__ import annotations

import torch

from .mesh import OBJECTS_SPACE, DeviceMesh


def exchange_halo_x(local, mesh: DeviceMesh, axis: str = "space"):
    """Given a local block [..., Gx_local, Gy, Gz], return the (left, right)
    1-plane halos received from the neighbours along ``axis``; an edge
    shard receives +inf on its open side."""
    send_left = local[..., :1, :, :]
    send_right = local[..., -1:, :, :]
    from_left, from_right = mesh.comm.halo(send_left, send_right, axis)
    if from_left is None:
        from_left = torch.full_like(send_left, torch.inf)
    if from_right is None:
        from_right = torch.full_like(send_right, torch.inf)
    return from_left, from_right


def sharded_grid_spec(mesh: DeviceMesh):
    """The placements of [O, Gx, Gy, Gz] voxel grids on the standard mesh:
    objects over the first axis, x over the second."""
    return OBJECTS_SPACE


def make_sharded_min_filter_x(mesh: DeviceMesh):
    """The 3-point min filter along x of a grid sharded as
    ``sharded_grid_spec``: ``min_filter(local block) -> local block``, the
    neighbours' planes read through the halo exchange (the communication
    pattern of a sharded label propagation)."""

    def min_filter(grid):
        left, right = exchange_halo_x(grid, mesh, "space")
        padded = torch.cat([left, grid, right], dim=-3)
        return torch.minimum(torch.minimum(padded[..., :-2, :, :], padded[..., 1:-1, :, :]),
                             padded[..., 2:, :, :])

    return min_filter
