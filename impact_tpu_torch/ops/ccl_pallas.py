"""K2: connected-component labelling, the CUDA kernels' wrappers and their
plain PyTorch versions (replaces the Pallas TPU kernel
``impact_tpu/ops/ccl_pallas.py:_ccl_kernel`` and its fixpoint loop).

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

``connected_component_labels_batched`` returns the labels, the sweeps'
fixpoint. On CUDA tensors it launches the labels kernel (``csrc/ccl.cu``
``k2_ccl_labels``: a union-find whose roots are component minima, three
launches at any G and no host read); on CPU tensors it runs the plain
fixpoint sweep.

``ccl_sweeps`` runs up to ``max_sweeps`` sweeps from arbitrary labels on a
batch of grids and stops a grid at the first sweep that changes nothing (its
fixpoint), with sweep counts: the port of ``ccl_propagate_sweeps``. On CUDA
tensors it launches the sweep kernels: the shared-memory kernel (one thread
block per grid, both label buffers in shared memory as u16, the fixpoint
test on the card) while its buffers fit a block's shared memory (G ≤ 38,
``k2_fits_shared``); K2-wide for larger grids (i32 labels in two
global-memory buffers, one launch per sweep, the host reading the grids'
"changed" flags once per 16 sweeps, as the reference's fixpoint loop does).
On CPU tensors it runs the plain version below, at any G. There is no
fallback.
"""

from __future__ import annotations

import torch

from ..utils.launches import LaunchCounter

LAUNCHES = LaunchCounter(k2_ccl=0, k2_ccl_wide=0, k2_labels=0, k2_labels_slab=0)
# labels and ``big`` = G³ must fit the shared-memory kernel's u16 buffers
MAX_GRID_VOXELS = 65535
# dynamic shared memory one block may opt into on the H100 (227 KB)
MAX_BLOCK_SHARED_BYTES = 232448
# sweeps per K2-wide call: the host reads the fixpoint flags once per group
WIDE_GROUP = 16


def _voxels(occ) -> int:
    """Voxels of one grid (G³, or gx·G² of a slab)."""
    return occ.shape[-3] * occ.shape[-2] * occ.shape[-1]


def initial_labels(occ):
    """Linear index where occupied, ``big`` = G³ elsewhere (i32); of a slab
    [..,gx,G,G], its own linear index and gx·G²."""
    n = _voxels(occ)
    lin = torch.arange(n, dtype=torch.int32, device=occ.device).reshape(occ.shape[-3:])
    return torch.where(occ, lin, n)


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
    big = _voxels(occ)
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


def k2_shared_bytes(g: int) -> int:
    """Dynamic shared memory of the shared-memory sweep kernel at grid size
    G: two u16 label buffers and a G³-bit occupancy mask."""
    n = g ** 3
    return 2 * 2 * n + 4 * ((n + 31) // 32)


def k2_fits_shared(g: int) -> bool:
    """Whether the shared-memory sweep kernel can take a G³ grid (G ≤ 38,
    which also keeps G³ within the u16 labels); larger grids take K2-wide."""
    return k2_shared_bytes(g) <= MAX_BLOCK_SHARED_BYTES


def _check(occ, labels):
    if occ.ndim != 4 or occ.shape[1:] != (occ.shape[-1],) * 3:
        raise ValueError(f"occupancy must be [B,G,G,G], got {tuple(occ.shape)}")
    if occ.dtype != torch.bool or labels.dtype != torch.int32:
        raise ValueError(f"K2 takes bool occupancy and i32 labels, got {occ.dtype}, "
                         f"{labels.dtype}")
    if labels.shape != occ.shape or labels.device != occ.device:
        raise ValueError("labels must match the occupancy's shape and device")


def ccl_sweeps(occ, labels, max_sweeps: int):
    """K2 on CUDA tensors (K2-wide where ``k2_fits_shared`` does not hold),
    its plain version on CPU tensors. ``occ`` bool [B,G,G,G]; ``labels`` i32
    [B,G,G,G] with values in [0, G³]. Returns (labels, sweeps) as
    ``ccl_sweeps_plain``."""
    _check(occ, labels)
    if occ.device.type == "cpu":
        return ccl_sweeps_plain(occ, labels, max_sweeps)
    if occ.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {occ.device}")
    nb, g = occ.shape[0], occ.shape[-1]
    if nb == 0:
        return torch.empty_like(labels), torch.empty(0, dtype=torch.int32, device=occ.device)
    if not k2_fits_shared(g):
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


def connected_component_labels_plain(occ):
    """The labels kernel's function in plain PyTorch: the fixpoint sweep
    (capped at G³ sweeps, the longest path through a grid), −1 where empty."""
    labels, _ = ccl_sweeps_plain(occ, initial_labels(occ), _voxels(occ))
    return torch.where(occ, labels, -1)


def connected_component_labels_batched(occ):
    """Labels of each grid of a contiguous bool batch [B,G,G,G]: i32, the
    minimum linear index of each 6-connected component, −1 where empty. The
    labels kernel on CUDA tensors, its plain version on CPU tensors.

    A batch of slabs [B,gx,G,G] (x planes of larger grids, gx < G) is
    labelled as grids of that extent: each label the slab's own linear index
    (i·G² + j·G + k), components cut at the slab's faces; on the card the
    kernel's slab entry (``k2_ccl_labels_slab``) labels it."""
    if occ.ndim != 4 or occ.shape[2] != occ.shape[3] or not 0 < occ.shape[1] <= occ.shape[3]:
        raise ValueError(f"occupancy must be [B,G,G,G] or [B,gx,G,G], got {tuple(occ.shape)}")
    if occ.dtype != torch.bool or not occ.is_contiguous():
        raise ValueError(f"the labels take contiguous bool occupancy, got {occ.dtype}"
                         f"{'' if occ.is_contiguous() else ' (not contiguous)'}")
    if occ.numel() >= 2 ** 31:
        raise ValueError(f"the labels index a batch with i32: {occ.numel()} voxels")
    dev = occ.device
    if dev.type == "cpu":
        return connected_component_labels_plain(occ)
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {dev}")
    out = torch.empty(occ.shape, dtype=torch.int32, device=dev)
    if occ.shape[0] == 0:
        return out
    from .. import _build

    stream = torch.cuda.current_stream(dev).cuda_stream
    nb, gx, g = occ.shape[0], occ.shape[1], occ.shape[-1]
    if gx == g:
        rc = _build.load().k2_ccl_labels(occ.data_ptr(), out.data_ptr(), nb, g, stream)
        if rc != 0:
            raise RuntimeError(f"k2_ccl_labels launch failed: cudaError {rc}")
        LAUNCHES["k2_labels"] += 1
        return out
    rc = _build.load().k2_ccl_labels_slab(occ.data_ptr(), out.data_ptr(), nb, gx, g, stream)
    if rc != 0:
        raise RuntimeError(f"k2_ccl_labels_slab launch failed: cudaError {rc}")
    LAUNCHES["k2_labels_slab"] += 1
    return out


def ccl_propagate_sweeps(occ, labels, n_sweeps: int = 16):
    """Up to ``n_sweeps`` 6-neighbour min sweeps of one label grid (the
    reference's name for a call of its sweep kernel): ``occ`` bool
    [G,G,G], ``labels`` i32 [G,G,G] with ``big`` = G³ on empty voxels.
    Launches the sweep kernel ``k2_ccl_sweeps`` (K2-wide past
    ``k2_fits_shared``) on CUDA tensors, through ``ccl_sweeps``; the plain
    sweeps on CPU tensors. A grid stops at its fixpoint, which further
    sweeps would not change."""
    out, _ = ccl_sweeps(occ[None].contiguous(), labels[None].to(torch.int32).contiguous(),
                        n_sweeps)
    return out[0]


def connected_component_labels_pallas(occ, max_iters: int | None = None, n_sweeps: int = 16):
    """Labels of one grid [G,G,G] (the reference's name for its kernel's
    fixpoint loop): i32, −1 where empty. With ``max_iters`` None, the labels
    kernel ``k2_ccl_labels`` (through ``connected_component_labels_batched``)
    on CUDA tensors and its plain fixpoint on CPU tensors; with a bound, at
    most ``max_iters`` × ``n_sweeps`` sweeps of the sweep kernel
    (``ccl_propagate_sweeps``), the labels reached by then."""
    if max_iters is None:
        return connected_component_labels_batched(occ[None].contiguous())[0]
    labels = ccl_propagate_sweeps(occ, initial_labels(occ), max_iters * n_sweeps)
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


def labels_bound_ms(occ) -> tuple:
    """Least time an H100 (3.35 TB/s HBM; 67 T/s non-tensor operations)
    could take for one ``connected_component_labels_batched`` call, whatever
    implements it: bytes = occupancy in (1 B) and labels out (4 B) per
    voxel, the start labels being implicit; operations = 3 per voxel (the
    test of each face-neighbour pair); voxels counted as [B,gx,G,G], so a
    batch of slabs counts its own. Returns (ms, "bytes"|"operations")."""
    n = occ.shape[0] * _voxels(occ)
    t_bytes = 5 * n / 3.35e12 * 1e3
    t_ops = 3 * n / 67e12 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
