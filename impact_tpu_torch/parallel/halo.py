"""Explicit halo exchange for grids sharded along x (port of
``impact_tpu/parallel/halo.py``).

The reference's pair of ``ppermute``s becomes one batch of point-to-point
transfers in the ``space`` group (``Comm.halo``): each rank sends its first
x-planes to its left neighbour and its last to its right one. The boundary
is closed: the edge ranks receive a fill (+inf for an SDF: empty space) on
their open side and send nothing that would wrap around.
"""

from __future__ import annotations

import torch

from .mesh import OBJECTS_SPACE, DeviceMesh


def _as_bytes(t):
    """[..., Gz] of any dtype → u8 [..., Gz·itemsize]."""
    return t.contiguous().view(torch.uint8)


def exchange_halo_x(local, mesh: DeviceMesh, axis: str = "space", fill=torch.inf,
                    left: int = 1, right: int = 1):
    """Given a local block [..., Gx_local, Gy, Gz], return the (left, right)
    halos received from the neighbours along ``axis``: the left neighbour's
    last ``left`` x-planes and the right neighbour's first ``right`` ones; an
    edge shard receives ``fill`` on its open side. A side of 0 planes is
    not exchanged and comes back None (``right``-only for the x+1
    stencils).

    ``local`` may be a list of blocks (any dtypes, same leading dims): they
    travel in one transfer each way, and the halos and ``fill`` are lists."""
    many = isinstance(local, (list, tuple))
    blocks = list(local) if many else [local]
    fills = list(fill) if many else [fill]
    widths = [_as_bytes(b).shape[-1] for b in blocks]

    def planes(sl):
        if not many:  # one block travels as it is
            return blocks[0][..., sl, :, :]
        return torch.cat([_as_bytes(b[..., sl, :, :]) for b in blocks], dim=-1)

    send_left = planes(slice(0, right)) if right else None
    send_right = planes(slice(-left, None)) if left else None
    got = mesh.comm.halo(send_left, send_right, axis)
    out = []
    for side, n, recv in (("left", left, got[0]), ("right", right, got[1])):
        if not n:
            out.append(None)
            continue
        halves = []
        if recv is not None and not many:
            halves.append(recv)
        elif recv is not None:
            for b, part in zip(blocks, recv.split(widths, dim=-1)):
                halves.append(part.contiguous().view(b.dtype))
        else:
            for b, f in zip(blocks, fills):
                shape = b.shape[:-3] + (n,) + b.shape[-2:]
                halves.append(torch.full(shape, f, dtype=b.dtype, device=b.device))
        out.append(halves if many else halves[0])
    return out[0], out[1]


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
