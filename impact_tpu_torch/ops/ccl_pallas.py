"""K2: connected-component min-label propagation, the CUDA kernel's wrapper
and its plain PyTorch version (replaces the Pallas TPU kernel
``impact_tpu/ops/ccl_pallas.py:_ccl_kernel``).

Labels: every occupied voxel of a [G,G,G] grid ends with the minimum linear
index (i·G² + j·G + k) of its 6-connected component; empty voxels hold
``big`` = G³ inside the sweeps and −1 on output. One sweep is a Jacobi step
over all voxels: new = min(own, six face neighbours) for occupied voxels,
``big`` past the grid border and for empty voxels — the sweep of the
reference's XLA path (``impact_tpu/voxel/interaction.py``
``connected_component_labels``). The reference's Pallas kernel composes its
three axis passes through the intermediate minimum, which lets a label
cross an empty voxel along a diagonal; its labels differ from the XLA path's
wherever two components touch only along an edge or corner (ROADMAP Queue
3). The port keeps the 6-connected labels.

``ccl_sweeps`` runs up to ``max_sweeps`` sweeps on a batch of grids and stops
a grid at the first sweep that changes nothing (its fixpoint), so a run with
``max_sweeps`` ≥ the distance the labels travel returns the labels. On CUDA
tensors it launches K2 (``csrc/ccl.cu``): for G³ ≤ 65535 (G ≤ 40) the
shared-memory kernel (one thread block per grid, both label buffers in
shared memory as u16, the fixpoint test on the card); for larger grids
K2-wide (i32 labels in two global-memory buffers, one launch per sweep, the
host reading the grids' "changed" flags once per 16 sweeps, as the
reference's fixpoint loop does). On CPU tensors it runs the plain version
below, at any G. There is no fallback.
"""

from __future__ import annotations

import torch

from ..render.raster_pallas import LaunchCounter

LAUNCHES = LaunchCounter(k2_ccl=0, k2_ccl_wide=0)
# labels and ``big`` = G³ must fit the shared-memory kernel's u16 buffers;
# larger grids take K2-wide
MAX_GRID_VOXELS = 65535
# sweeps per K2-wide call: the host reads the fixpoint flags once per group
WIDE_GROUP = 16


def initial_labels(occ):
    """Linear index where occupied, ``big`` = G³ elsewhere (i32)."""
    g = occ.shape[-1]
    lin = torch.arange(g ** 3, dtype=torch.int32, device=occ.device).reshape(g, g, g)
    return torch.where(occ, lin, g ** 3)


def min_sweep(occ, labels, big: int, axes=(1, 2, 3)):
    """One Jacobi 6-neighbour min sweep of [B,G,G,G] labels: ``big`` past
    the border of each of ``axes`` (the chunks' axes of a reshaped grid
    confine the sweep to chunks) and for empty voxels."""
    m = labels
    for axis in axes:
        n = labels.shape[axis]
        pad = torch.full_like(labels.narrow(axis, 0, 1), big)
        fwd = torch.cat([labels.narrow(axis, 1, n - 1), pad], dim=axis)
        bwd = torch.cat([pad, labels.narrow(axis, 0, n - 1)], dim=axis)
        m = torch.minimum(m, torch.minimum(fwd, bwd))
    return torch.where(occ, m, big)


def ccl_sweeps_plain(occ, labels, max_sweeps: int):
    """The kernel's function in plain PyTorch: (labels i32 [B,G,G,G],
    sweeps i32 [B]). Grid b stops after the first sweep that leaves it
    unchanged (that sweep counted) or after ``max_sweeps`` sweeps."""
    big = occ.shape[-1] ** 3
    running = torch.ones(occ.shape[0], dtype=torch.bool, device=occ.device)
    sweeps = torch.zeros(occ.shape[0], dtype=torch.int32, device=occ.device)
    for _ in range(max_sweeps):
        new = min_sweep(occ, labels, big)
        changed = (new != labels).flatten(1).any(dim=1)
        labels = torch.where(running[:, None, None, None], new, labels)
        sweeps = sweeps + running.to(torch.int32)
        running = running & changed
        if not bool(running.any()):
            break
    return labels, sweeps


def _check(occ, labels):
    if occ.ndim != 4 or occ.shape[1:] != (occ.shape[-1],) * 3:
        raise ValueError(f"occupancy must be [B,G,G,G], got {tuple(occ.shape)}")
    if occ.dtype != torch.bool or labels.dtype != torch.int32:
        raise ValueError(f"K2 takes bool occupancy and i32 labels, got {occ.dtype}, "
                         f"{labels.dtype}")
    if labels.shape != occ.shape or labels.device != occ.device:
        raise ValueError("labels must match the occupancy's shape and device")


def ccl_sweeps(occ, labels, max_sweeps: int):
    """K2 on CUDA tensors (K2-wide where G³ > 65535), its plain version on
    CPU tensors. ``occ`` bool [B,G,G,G]; ``labels`` i32 [B,G,G,G] with values
    in [0, G³]. Returns (labels, sweeps) as ``ccl_sweeps_plain``."""
    _check(occ, labels)
    if occ.device.type == "cpu":
        return ccl_sweeps_plain(occ, labels, max_sweeps)
    if occ.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {occ.device}")
    nb, g = occ.shape[0], occ.shape[-1]
    if nb == 0:
        return torch.empty_like(labels), torch.empty(0, dtype=torch.int32, device=occ.device)
    if g ** 3 > MAX_GRID_VOXELS:
        return _ccl_sweeps_wide(occ, labels, max_sweeps)
    from .. import _build

    lib = _build.load()
    out = torch.empty_like(labels)
    sweeps = torch.empty(nb, dtype=torch.int32, device=occ.device)
    occ_u8 = occ.to(torch.uint8).contiguous()
    lab_in = labels.contiguous()
    rc = lib.k2_ccl_sweeps(occ_u8.data_ptr(), lab_in.data_ptr(), out.data_ptr(),
                           sweeps.data_ptr(), nb, g, int(max_sweeps),
                           torch.cuda.current_stream(occ.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"k2_ccl_sweeps launch failed: cudaError {rc}")
    LAUNCHES["k2_ccl"] += 1
    return out, sweeps


def _ccl_sweeps_wide(occ, labels, max_sweeps: int):
    """K2-wide: groups of up to ``WIDE_GROUP`` sweeps, one ``k2_ccl_wide``
    call each, until no grid runs (one host read per group) or
    ``max_sweeps`` sweeps ran."""
    from .. import _build

    lib = _build.load()
    nb, g = occ.shape[0], occ.shape[-1]
    dev = occ.device
    occ_u8 = occ.to(torch.uint8).contiguous()
    bufs = (labels.contiguous().clone(), torch.empty_like(labels))
    flags = torch.empty((WIDE_GROUP + 1) * nb, dtype=torch.int32, device=dev)
    running = torch.ones(nb, dtype=torch.int32, device=dev)
    sweeps = torch.zeros(nb, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    done = 0
    while done < max_sweeps:
        n = min(WIDE_GROUP, max_sweeps - done)
        rc = lib.k2_ccl_wide(occ_u8.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
                             flags.data_ptr(), running.data_ptr(), sweeps.data_ptr(), nb, g,
                             done % 2, n, stream)
        if rc != 0:
            raise RuntimeError(f"k2_ccl_wide launch failed: cudaError {rc}")
        LAUNCHES["k2_ccl_wide"] += 1
        done += n
        if not bool(running.any()):
            break
    # a stopped grid holds its labels in both buffers; running ones in the last written
    return bufs[done % 2], sweeps


def connected_component_labels_batched(occ):
    """Labels of each grid of a bool batch [B,G,G,G]: i32, −1 where empty.
    One K2 launch runs every grid to its fixpoint (capped at G³ sweeps, the
    longest path through a grid)."""
    g = occ.shape[-1]
    labels, _ = ccl_sweeps(occ, initial_labels(occ), g ** 3)
    return torch.where(occ, labels, -1)


def bound_ms(occ, sweeps) -> tuple:
    """Least time an H100 (3.35 TB/s HBM; 67 T/s non-tensor operations, the
    data sheet's float32 rate, taken for integer min on the same cores) could take
    for one ``ccl_sweeps`` call: bytes = occupancy (1 B) + labels in and out
    (4 B each) per voxel + 4 B of sweep count per grid; operations = 8 per
    voxel and sweep run (6 mins, the select and the change test), counting
    the sweeps this call's data needed. Returns (ms, "bytes"|"operations")."""
    nb, g = occ.shape[0], occ.shape[-1]
    n_bytes = nb * g ** 3 * 9 + nb * 4
    n_ops = 8 * g ** 3 * int(sweeps.sum())
    t_bytes = n_bytes / 3.35e12 * 1e3
    t_ops = n_ops / 67e12 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
