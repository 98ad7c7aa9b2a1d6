"""Voxel deformation: absorption, split detection, region extraction and
fracturing (port of ``impact_tpu/voxel/interaction.py``; ref:
impact_voxel/src/interaction/absorption.rs, object/split_detection.rs,
object/extraction.rs, interaction/fracturing.rs).

* Absorption subtracts the absorbers' SDFs from the objects they overlap:
  sdf ← max(sdf, −sdf_absorber). The dense pass carves whole grids, the
  object-gated pass only the ≤cap objects whose bounding spheres overlap an
  absorber, and the chunk-gated pass (the chunked engine path) only the
  ≤budget (object, 16³ chunk) windows whose padded windows may overlap one;
  what a gate leaves out is deferred to later steps and counted.
* Split detection labels occupied voxels with the fixpoint of min-label
  propagation. On the card that is the hand-written labels kernel
  (``ops/ccl_pallas.py``, a min-root union-find) at every G. CPU tensors at
  G ≥ 64 with G a multiple of 16 take the reference's two-level labelling
  (plain PyTorch, as the reference's is XLA), the flat sweep at other G.
* Extraction moves a disconnected component into a free pooled object slot
  with masks; the rigid-body pool gains a body the same way.
* Fracturing assigns each voxel within the fracture radius to its nearest
  Voronoi seed and moves every non-empty cell but the first into a free
  slot. Randomness is split from the geometry: ``draw_fracture_uniforms``
  draws from a ``torch.Generator``, ``sample_fracture_seeds`` is a pure
  function of those uniforms (the tests feed it the uniforms JAX drew).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry.primitives import capsule_sdf
from ..math import quaternion as quat
from ..math.quaternion import cross
from ..ops.ccl_pallas import (ccl_sweeps, connected_component_labels_batched, initial_labels,
                               min_sweep)
from .collision import bounding_radii, stable_topk
from .encoding import encode_sdf_i8, far_value, is_encoded, sdf_scale, sdf_world
from .object import CHUNK_SIZE, VoxelObjectPool, occupancy, voxel_positions_local

# --- absorption ----------------------------------------------------------------

_SQRT3_F32 = float(torch.tensor(3.0).sqrt())  # √3 rounded to float32, as the reference's


class AbsorberPools(NamedTuple):
    """Absorbing spheres and capsules in their parent body's frame (ref:
    absorption.rs VoxelAbsorbingSphere/Capsule)."""

    sph_body: torch.Tensor  # i64[A] parent body slot
    sph_offset: torch.Tensor  # f32[A,3] centre in the parent frame
    sph_radius: torch.Tensor  # f32[A]
    sph_rate: torch.Tensor  # f32[A]
    sph_mask: torch.Tensor  # bool[A]
    cap_body: torch.Tensor  # i64[A]
    cap_start: torch.Tensor  # f32[A,3] segment start in the parent frame
    cap_end: torch.Tensor  # f32[A,3]
    cap_radius: torch.Tensor  # f32[A]
    cap_rate: torch.Tensor  # f32[A]
    cap_mask: torch.Tensor  # bool[A]


def empty_absorber_pools(cap: int = 8, device="cuda") -> AbsorberPools:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def one():
        return torch.ones(cap, device=device)

    return AbsorberPools(
        sph_body=z(cap, dtype=torch.int64), sph_offset=z(cap, 3), sph_radius=one(),
        sph_rate=one(), sph_mask=z(cap, dtype=torch.bool),
        cap_body=z(cap, dtype=torch.int64), cap_start=z(cap, 3), cap_end=z(cap, 3),
        cap_radius=one(), cap_rate=one(), cap_mask=z(cap, dtype=torch.bool),
    )


def _absorber_frames(absorbers: AbsorberPools, body_position, body_orientation):
    """World sphere centres and capsule end points, [A,3] each."""
    def world(body, local):
        return body_position[body] + quat.rotate(body_orientation[body], local)

    return (world(absorbers.sph_body, absorbers.sph_offset),
            world(absorbers.cap_body, absorbers.cap_start),
            world(absorbers.cap_body, absorbers.cap_end))


def _absorber_sdf_at(absorbers: AbsorberPools, body_position, body_orientation, pos_world):
    """Minimum SDF over the active absorbers at world points [...,3] → [...]
    (+inf where none is active)."""
    c_w, a_w, b_w = _absorber_frames(absorbers, body_position, body_orientation)
    d = torch.linalg.vector_norm(pos_world[..., None, :] - c_w, dim=-1) - absorbers.sph_radius
    d = torch.where(absorbers.sph_mask, d, math.inf).amin(dim=-1)
    d_cap = capsule_sdf(a_w, b_w, absorbers.cap_radius, pos_world[..., None, :])
    d_cap = torch.where(absorbers.cap_mask, d_cap, math.inf).amin(dim=-1)
    return torch.minimum(d, d_cap)


def _absorber_overlap_mask(pool: VoxelObjectPool, absorbers: AbsorberPools, body_position,
                           body_orientation):
    """bool[O]: the object's bounding sphere intersects an active absorber."""
    centers = body_position[pool.body_index]
    radii = bounding_radii(pool)
    c_w, a_w, b_w = _absorber_frames(absorbers, body_position, body_orientation)
    d_sph = (torch.linalg.vector_norm(centers[:, None, :] - c_w[None], dim=-1)
             - absorbers.sph_radius[None, :] - radii[:, None])
    hit = ((d_sph < 0.0) & absorbers.sph_mask[None, :]).any(dim=1)
    d_cap = capsule_sdf(a_w[None], b_w[None], absorbers.cap_radius[None, :],
                        centers[:, None, :]) - radii[:, None]
    hit = hit | ((d_cap < 0.0) & absorbers.cap_mask[None, :]).any(dim=1)
    return hit & pool.alive


def _apply_absorption_dense(pool: VoxelObjectPool, absorbers: AbsorberPools, body_position,
                            body_orientation, x0: int = 0) -> VoxelObjectPool:
    """Per-voxel absorption over every object of the (sub-)pool; on a pool of
    slabs [O,gx,G,G] (x planes [x0, x0+gx)), of the slabs (``mesh_dirty``
    and ``split_pending`` then mark the objects whose slab changed)."""
    bi = pool.body_index
    pos_world = (quat.rotate(body_orientation[bi][:, None, None, None, :],
                             voxel_positions_local(pool, x0))
                 + body_position[bi][:, None, None, None, :])
    d_abs = _absorber_sdf_at(absorbers, body_position, body_orientation, pos_world)
    if is_encoded(pool.sdf):
        world = sdf_world(pool.sdf, pool.voxel_extent)
        new_sdf = encode_sdf_i8(torch.maximum(world, -d_abs),
                                pool.voxel_extent[:, None, None, None])
        changed = (new_sdf != pool.sdf).flatten(1).any(dim=1)
    else:
        new_sdf = torch.maximum(pool.sdf, -d_abs)
        changed = ((new_sdf - pool.sdf).abs() > 1e-7).flatten(1).any(dim=1)
    changed = changed & pool.alive
    return pool._replace(sdf=torch.where(pool.alive[:, None, None, None], new_sdf, pool.sdf),
                         mesh_dirty=pool.mesh_dirty | changed,
                         split_pending=pool.split_pending | changed)


def _apply_absorption_gated(pool: VoxelObjectPool, absorbers: AbsorberPools, body_position,
                            body_orientation, gate_cap: int) -> VoxelObjectPool:
    """Absorb densely on the ≤gate_cap absorber-overlapping objects (lowest
    slots first) and scatter the results back; the others are deferred."""
    hit = _absorber_overlap_mask(pool, absorbers, body_position, body_orientation)
    order = torch.argsort((~hit).to(torch.uint8), stable=True)[:gate_cap]
    sel = hit[order]
    sub = VoxelObjectPool(*(a[order] for a in pool))
    sub2 = _apply_absorption_dense(sub, absorbers, body_position, body_orientation)

    def put(full, new, old):
        s = sel.reshape((-1,) + (1,) * (new.ndim - 1))
        return full.index_copy(0, order, torch.where(s, new, old))

    return pool._replace(sdf=put(pool.sdf, sub2.sdf, sub.sdf),
                         mesh_dirty=put(pool.mesh_dirty, sub2.mesh_dirty, sub.mesh_dirty),
                         split_pending=put(pool.split_pending, sub2.split_pending,
                                           sub.split_pending))


def apply_absorption(pool: VoxelObjectPool, absorbers: AbsorberPools, body_position,
                     body_orientation, gate_cap: int | None = None) -> VoxelObjectPool:
    """Subtract the absorbers' SDFs from the objects they overlap (ref:
    absorption.rs:434). With ``gate_cap`` below the pool size only the
    ≤gate_cap objects whose bounding spheres overlap an absorber are carved
    (the rest wait a step); otherwise every object is."""
    if gate_cap is not None and gate_cap < pool.n_objects:
        return _apply_absorption_gated(pool, absorbers, body_position, body_orientation,
                                       gate_cap)
    return _apply_absorption_dense(pool, absorbers, body_position, body_orientation)


def deferred_absorption_count(pool: VoxelObjectPool, absorbers: AbsorberPools, body_position,
                              body_orientation, gate_cap: int):
    """i64[]: absorber-overlapping objects beyond ``gate_cap``, the objects
    the gated pass defers to the next step (0 on the dense path)."""
    hit = _absorber_overlap_mask(pool, absorbers, body_position, body_orientation)
    if gate_cap >= pool.n_objects:
        return torch.zeros((), dtype=torch.int64, device=hit.device)
    return torch.clamp(hit.sum() - gate_cap, min=0)


def _chunk_absorber_hit(pool: VoxelObjectPool, absorbers: AbsorberPools, body_position,
                        body_orientation):
    """bool[O,C]: the chunk's padded 18³ mesh window may intersect an active
    absorber (tested by the window's bounding sphere). Every voxel an
    absorber can change lies in the padded windows of every chunk whose
    remesh reads it, so carving and marking by this mask misses none."""
    nc = pool.grid_size // CHUNK_SIZE
    dev = pool.sdf.device
    r = torch.arange(nc, dtype=torch.float32, device=dev) * CHUNK_SIZE + CHUNK_SIZE / 2.0
    ci, cj, ck = torch.meshgrid(r, r, r, indexing="ij")
    centers_grid = torch.stack([ci, cj, ck], dim=-1).reshape(-1, 3)  # [C,3]
    ext = pool.voxel_extent
    centers_local = centers_grid[None] * ext[:, None, None] + pool.origin[:, None, :]
    bi = pool.body_index
    centers_world = (quat.rotate(body_orientation[bi][:, None, :], centers_local)
                     + body_position[bi][:, None, :])
    win_r = 9.0 * _SQRT3_F32 * ext[:, None]  # the 18³ window's half-diagonal
    d = _absorber_sdf_at(absorbers, body_position, body_orientation, centers_world)
    return (d < win_r) & pool.alive[:, None]


def apply_absorption_chunk_gated(pool: VoxelObjectPool, absorbers: AbsorberPools,
                                 body_position, body_orientation, pair_budget: int,
                                 rotation=0):
    """Carve only the ≤``pair_budget`` (object, chunk) 16³ windows whose
    padded windows overlap an active absorber (ref: absorption.rs:434). The
    pick takes the hits of highest rank (flat index + ``rotation``) mod O·C,
    so a ``rotation`` that advances by the budget each step round-robins
    the hits. Sets ``split_pending`` on changed objects, not ``mesh_dirty``.

    Returns ``(pool, changed bool[O], dirty_chunks bool[O,C], deferred
    i64[])``: ``dirty_chunks`` marks every absorber-overlapped chunk of a
    changed object; ``deferred`` counts the overlapped chunks beyond the
    budget."""
    g = pool.grid_size
    nc = g // CHUNK_SIZE
    c = nc ** 3
    o_max = pool.n_objects
    dev = pool.sdf.device
    hit = _chunk_absorber_hit(pool, absorbers, body_position, body_orientation)  # [O,C]
    flat = hit.reshape(-1)
    n_flat = o_max * c
    budget = min(pair_budget, n_flat)
    rank = (torch.arange(n_flat, device=dev) + rotation) % n_flat
    picks = stable_topk(torch.where(flat, rank + 1, 0), budget)  # ties: lowest index first
    sel = flat[picks]
    o_idx = picks // c
    ch = picks % c
    cz, cy, cx = ch % nc, (ch // nc) % nc, ch // (nc * nc)

    ar = torch.arange(CHUNK_SIZE, device=dev)
    gx = (cx[:, None] * CHUNK_SIZE + ar)[:, :, None, None]
    gy = (cy[:, None] * CHUNK_SIZE + ar)[:, None, :, None]
    gz = (cz[:, None] * CHUNK_SIZE + ar)[:, None, None, :]
    oo = o_idx[:, None, None, None]
    win = pool.sdf[oo, gx, gy, gz]  # [B,16,16,16]

    arf = ar.to(torch.float32) + 0.5
    wi, wj, wk = torch.meshgrid(arf, arf, arf, indexing="ij")
    base = torch.stack([cx, cy, cz], dim=-1).to(torch.float32) * CHUNK_SIZE
    grid_pos = torch.stack([wi, wj, wk], dim=-1)[None] + base[:, None, None, None, :]
    ext = pool.voxel_extent[o_idx]
    pos_local = (grid_pos * ext[:, None, None, None, None]
                 + pool.origin[o_idx][:, None, None, None, :])
    bidx = pool.body_index[o_idx]
    pos_world = (quat.rotate(body_orientation[bidx][:, None, None, None, :], pos_local)
                 + body_position[bidx][:, None, None, None, :])
    d_abs = _absorber_sdf_at(absorbers, body_position, body_orientation, pos_world)
    if is_encoded(pool.sdf):
        world = win.to(torch.float32) * sdf_scale(ext)[:, None, None, None]
        new_win = encode_sdf_i8(torch.maximum(world, -d_abs), ext[:, None, None, None])
    else:
        new_win = torch.maximum(win, -d_abs)
    changed_pair = sel & (new_win != win).flatten(1).any(dim=1)

    # the picks are distinct chunks, so their windows never overlap: every
    # window is written back, unselected ones unchanged (no host read)
    sdf = pool.sdf.clone()
    sdf[oo, gx, gy, gz] = torch.where(sel[:, None, None, None], new_win, win)
    changed = torch.zeros(o_max, dtype=torch.int32, device=dev).scatter_reduce(
        0, o_idx, changed_pair.to(torch.int32), "amax") > 0
    dirty_chunks = hit & changed[:, None]
    deferred = torch.clamp(hit.sum() - sel.sum(), min=0)
    return pool._replace(sdf=sdf, split_pending=pool.split_pending | changed), changed, \
        dirty_chunks, deferred


# --- split detection ----------------------------------------------------------------


def connected_component_labels(occ, max_iters: int | None = None):
    """Labels of a bool [G,G,G] grid or [B,G,G,G] batch: i32, the minimum
    linear index of each 6-connected component, −1 where empty. On the card
    every G goes to the labels kernel. On the CPU the routing is the
    reference's (interaction.py:connected_component_labels): the two-level
    labelling for G ≥ 64 with G a multiple of the chunk size, the flat
    sweep for every other G. A finite ``max_iters`` stops the flat sweep
    after that many sweeps, as the reference's does (the sweep kernel on the
    card); the two-level labelling ignores it, as the reference's does."""
    batch = occ if occ.ndim == 4 else occ[None]
    g = occ.shape[-1]
    two_level = g >= 64 and g % CHUNK_SIZE == 0
    if occ.device.type == "cpu" and two_level:
        labels = connected_component_labels_two_level(batch)
    elif max_iters is None or two_level:
        labels = connected_component_labels_batched(batch)
    else:
        swept, _ = ccl_sweeps(batch.contiguous(), initial_labels(batch), max_iters)
        labels = torch.where(batch, swept, -1)
    return labels if occ.ndim == 4 else labels[0]


def connected_component_labels_two_level(occ):
    """Two-level labelling of a bool [B,G,G,G] batch, G a multiple of
    ``CHUNK_SIZE`` (port of the reference's XLA function of that name; ref:
    split_detection.rs:15-35). Phase 1 sweeps each 16³ chunk to its own
    fixpoint; phase 2 takes each chunk component's label as a graph node,
    relaxes the edges across chunk faces by scatter-min and pointer-jumps
    the label table to its fixpoint. Labels equal the flat sweep's: the
    minimum linear index of each component, −1 where empty."""
    nb, g = occ.shape[0], occ.shape[-1]
    ch = CHUNK_SIZE
    nc = g // ch
    n = g ** 3
    dev = occ.device
    occ6 = occ.reshape(nb, nc, ch, nc, ch, nc, ch)
    labels = initial_labels(occ).reshape(occ6.shape)
    for _ in range(ch ** 3):  # the within-chunk serpentine bound
        new = min_sweep(occ6, labels, n, axes=(2, 4, 6))
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    labels = labels.reshape(nb, g, g, g)

    # phase 2: edges (la, lb) between chunk-component labels across chunk
    # faces, offset by b·(n + 1) into one table of every grid's labels plus
    # a sink slot per grid for the empty ends
    hi = torch.arange(ch - 1, g - 1, ch, device=dev)
    lo = hi + 1
    la = torch.cat([labels.index_select(ax, hi).flatten(1) for ax in (1, 2, 3)], dim=1)
    lb = torch.cat([labels.index_select(ax, lo).flatten(1) for ax in (1, 2, 3)], dim=1)
    both = (la < n) & (lb < n)
    off = (torch.arange(nb, device=dev) * (n + 1))[:, None]
    ia = (torch.where(both, la, n) + off).flatten().long()
    ib = (torch.where(both, lb, n) + off).flatten().long()
    both = both.flatten()
    table = torch.arange(n + 1, dtype=torch.int32, device=dev).repeat(nb)
    for _ in range(n):
        m = torch.where(both, torch.minimum(table[ia], table[ib]), n)
        t2 = table.scatter_reduce(0, ia, m, "amin").scatter_reduce(0, ib, m, "amin")
        t2 = t2.reshape(nb, n + 1)
        t2 = torch.minimum(t2, torch.gather(t2, 1, t2.long()))  # pointer jumping
        t2 = t2.flatten()
        changed = bool((t2 != table).any())
        table = t2
        if not changed:
            break
    final = torch.gather(table.reshape(nb, n + 1), 1, labels.flatten(1).long())
    return torch.where(occ, final.reshape(nb, g, g, g), -1)


def connected_component_labels_slab(occ, x0: int, left_plane, gather):
    """The whole grids' labels (``connected_component_labels``) of slabs
    ``occ`` [B,gx,G,G] of x planes [x0, x0+gx), every slab of the grids
    calling this with its own. ``left_plane(t)``: the left neighbour's last
    x plane of ``t`` [B,gx,G,G] ([B,1,G,G], −1 at the first slab);
    ``gather(t)``: [S,...] the slabs' ``t`` in slab order.

    Each slab labels its voxels with the labels kernel (the slab's own
    linear index, offset by x0·G² into the grid's: the layout is x-major),
    takes the label pairs of occupied neighbours across its left face (at
    most G² a face), and every slab resolves the gathered pairs with the
    same pointer-jumped min table over the labels they name; each label
    then becomes the minimum of its set, the minimum linear index of its
    component in the grid."""
    nb, _, g, _ = occ.shape
    n = g ** 3
    local = connected_component_labels_batched(occ.contiguous())
    lab = torch.where(local >= 0, local + x0 * g * g, -1)
    left = left_plane(lab)[:, 0].reshape(nb, -1)
    first = lab[:, 0].reshape(nb, -1)
    both = (left >= 0) & (first >= 0)
    pairs = torch.stack([torch.where(both, left, -1), torch.where(both, first, -1)], dim=-1)
    pairs = gather(pairs).transpose(0, 1).reshape(nb, -1, 2)  # [B, S·G², 2]
    off = (torch.arange(nb, device=occ.device, dtype=torch.int64) * n)[:, None]
    ok = pairs[..., 0] >= 0
    pa = (pairs[..., 0].long() + off)[ok]
    pb = (pairs[..., 1].long() + off)[ok]
    if pa.numel() == 0:
        return lab
    nodes, inv = torch.unique(torch.cat([pa, pb]), return_inverse=True)
    ia, ib = inv[:pa.numel()], inv[pa.numel():]
    parent = torch.arange(nodes.numel(), device=occ.device)
    while True:  # nodes sort as their labels, so the least index is the least label
        m = torch.minimum(parent[ia], parent[ib])
        new = parent.scatter_reduce(0, ia, m, "amin").scatter_reduce(0, ib, m, "amin")
        new = new[new]  # pointer jumping
        if torch.equal(new, parent):
            break
        parent = new
    key = torch.where(lab >= 0, lab.long() + off[:, :, None, None], -1)
    pos = torch.clamp(torch.searchsorted(nodes, key.flatten()), max=nodes.numel() - 1)
    hit = (nodes[pos] == key.flatten()).reshape(key.shape)
    root = (nodes[parent[pos]].reshape(key.shape) - off[:, :, None, None]).to(torch.int32)
    return torch.where(hit, root, lab)


def _set_row(t, i, value, cond):
    """t with row i replaced by ``value`` where the 0-d ``cond`` holds."""
    out = t.clone()
    out[i] = torch.where(cond, value, t[i])
    return out


def split_off_disconnected_region(pool: VoxelObjectPool, obj_index, free_slot):
    """Move one disconnected region of object ``obj_index`` into
    ``free_slot`` (ref: extraction.rs:78/:121): the component of the minimum
    label or the rest of the object, whichever is smaller (the minimum-label
    component on a tie). No-op when the object is connected, when
    ``free_slot`` < 0 or when that slot is alive. Both slots are marked
    dirty and split-pending. Returns (pool, did_split bool[],
    disconnected bool[]); ``disconnected`` stays true when the move is
    blocked on the slot."""
    occ = occupancy(pool)[obj_index]
    labels = connected_component_labels(occ)
    dev = occ.device
    min_label = torch.where(occ, labels, 1 << 30).min()
    in_min = occ & (labels == min_label)
    n_min, n_tot = in_min.sum(), occ.sum()
    disconnected = (n_min > 0) & (n_min < n_tot)
    free_slot = torch.as_tensor(free_slot, device=dev)
    slot = torch.clamp(free_slot, min=0)
    can = disconnected & (free_slot >= 0) & ~pool.alive[slot]
    region = torch.where(n_min <= n_tot - n_min, in_min, occ & ~in_min)
    src_sdf = pool.sdf[obj_index]
    far = far_value(pool.sdf.dtype, pool.voxel_extent[obj_index])
    true = torch.ones((), dtype=torch.bool, device=dev)
    pending = _set_row(_set_row(pool.split_pending, obj_index, true, can), slot, true, can)
    dirty = _set_row(_set_row(pool.mesh_dirty, obj_index, true, can), slot, true, can)
    sdf = _set_row(pool.sdf, obj_index, torch.where(region, far, src_sdf), can)
    sdf = _set_row(sdf, slot, torch.where(region, src_sdf, far), can)
    pool = pool._replace(
        split_pending=pending, sdf=sdf,
        vtype=_set_row(pool.vtype, slot, pool.vtype[obj_index], can),
        voxel_extent=_set_row(pool.voxel_extent, slot, pool.voxel_extent[obj_index], can),
        origin=_set_row(pool.origin, slot, pool.origin[obj_index], can),
        alive=_set_row(pool.alive, slot, true, can),
        mesh_dirty=dirty)
    return pool, can, disconnected


def split_off_disconnected_regions(pool: VoxelObjectPool, obj_index: int, free_slots,
                                   labels=None):
    """Extract up to ``len(free_slots)`` disconnected regions of object
    ``obj_index`` from one labelling (ref: extraction.rs:78), in order of
    component label. ``free_slots`` i64[R] distinct free slots (−1 = none);
    ``labels`` the object's labels if already computed. Each extracted
    region is one component, so new slots are not split-pending; the
    source's pending flag records whether components remain.
    Returns (pool, n_split i64[], disconnected_after bool[])."""
    occ = occupancy(pool)[obj_index]
    if labels is None:
        labels = connected_component_labels(occ)
    src_sdf = pool.sdf[obj_index]
    far = far_value(pool.sdf.dtype, pool.voxel_extent[obj_index])
    big = 1 << 30
    remaining = occ
    new_src_sdf = src_sdf
    n_split = torch.zeros((), dtype=torch.int64, device=occ.device)
    sdf, vtype, extent, origin = pool.sdf, pool.vtype, pool.voxel_extent, pool.origin
    alive, dirty, pending = pool.alive, pool.mesh_dirty, pool.split_pending
    true = torch.ones((), dtype=torch.bool, device=occ.device)
    for r in range(free_slots.shape[0]):
        lmin = torch.where(remaining, labels, big).min()
        lmax = torch.where(remaining, labels, -1).max()
        slot = free_slots[r]
        slotc = torch.clamp(slot, min=0)
        can = (lmin < lmax) & (slot >= 0) & ~alive[slotc]
        region = remaining & (labels == lmin)
        sdf = _set_row(sdf, slotc, torch.where(region, new_src_sdf, far), can)
        vtype = _set_row(vtype, slotc, pool.vtype[obj_index], can)
        extent = _set_row(extent, slotc, pool.voxel_extent[obj_index], can)
        origin = _set_row(origin, slotc, pool.origin[obj_index], can)
        alive = _set_row(alive, slotc, true, can)
        dirty = _set_row(dirty, slotc, true, can)
        pending = _set_row(pending, slotc, ~true, can)
        new_src_sdf = torch.where(can & region, far, new_src_sdf)
        remaining = torch.where(can, remaining & ~region, remaining)
        n_split = n_split + can.to(torch.int64)

    did_any = n_split > 0
    disconnected_after = (torch.where(remaining, labels, big).min()
                          < torch.where(remaining, labels, -1).max())
    sdf = _set_row(sdf, obj_index, new_src_sdf, did_any)
    dirty = _set_row(dirty, obj_index, true, did_any)
    pending = _set_row(pending, obj_index, disconnected_after, true)
    return (pool._replace(sdf=sdf, vtype=vtype, voxel_extent=extent, origin=origin,
                          alive=alive, mesh_dirty=dirty, split_pending=pending),
            n_split, disconnected_after)


# --- fracturing -----------------------------------------------------------------


def draw_fracture_uniforms(generator: torch.Generator, n_seeds: int):
    """The three uniform draws of one fracture event: polar and azimuthal
    jitter in [−0.5, 0.5) and radial u in [0, 1), each f32[S] (the reference
    draws them from split threefry keys, interaction.py:744-758)."""
    dev = generator.device
    ju = torch.rand(n_seeds, generator=generator, device=dev) - 0.5
    jv = torch.rand(n_seeds, generator=generator, device=dev) - 0.5
    ur = torch.rand(n_seeds, generator=generator, device=dev)
    return ju, jv, ur


def sample_fracture_seeds(uniforms, impact_point_local, inward_dir, fracture_radius,
                          n_seeds: int, boundary_polar_grid_size: int = 3,
                          boundary_azimuthal_grid_size: int = 6,
                          boundary_angular_jitter: float = 0.8,
                          boundary_radial_jitter: float = 0.2, radial_falloff_power: float = 2.0,
                          angular_falloff_power: float = 0.5):
    """Voronoi seed positions about an impact, body frame [S,3]
    (ref: fracturing.rs:42-45,878-935): jittered polar × azimuthal boundary
    grids about the inward direction, with radial and angular falloff."""
    ju, jv, u_r = uniforms
    dev = impact_point_local.device
    i = torch.arange(n_seeds, device=dev)
    npol = max(1, boundary_polar_grid_size)
    nazi = max(1, boundary_azimuthal_grid_size)
    pol = (i % npol).to(torch.float32)
    azi = ((i // npol) % nazi).to(torch.float32)
    u_theta = torch.clamp((pol + 0.5 + boundary_angular_jitter * ju) / npol, 0.0, 1.0)
    theta = (0.5 * math.pi) * u_theta ** (1.0 / (1.0 + angular_falloff_power))
    phi = (azi + 0.5 + boundary_angular_jitter * jv) / nazi * (2.0 * math.pi)
    u_r = torch.clamp(u_r * (1.0 + boundary_radial_jitter), 0.0, 1.0)
    r = fracture_radius * u_r ** ((1.0 + radial_falloff_power) / 3.0)

    z = inward_dir / torch.clamp(torch.linalg.vector_norm(inward_dir), min=1e-9)
    helper = torch.where(z[0].abs() < 0.9, torch.tensor([1.0, 0.0, 0.0], device=dev),
                         torch.tensor([0.0, 1.0, 0.0], device=dev))
    x = cross(helper, z)
    x = x / torch.clamp(torch.linalg.vector_norm(x), min=1e-9)
    y = cross(z, x)
    st, ct = torch.sin(theta), torch.cos(theta)
    dirs = (st[:, None] * torch.cos(phi)[:, None] * x[None]
            + st[:, None] * torch.sin(phi)[:, None] * y[None] + ct[:, None] * z[None])
    return impact_point_local[None, :] + r[:, None] * dirs


def fracture_object(pool: VoxelObjectPool, obj_index: int, impact_point_local, uniforms,
                    free_slots, fracture_radius, n_seeds: int, impact_cfg=None) -> VoxelObjectPool:
    """Voronoi-fragment the part of object ``obj_index`` within
    ``fracture_radius`` of the impact point (body frame). Fragment s > 0 moves
    into free_slots[s−1] (−1 = unavailable: it stays with the source);
    fragment 0 stays in the source (ref: fracturing.rs:338-935). Every
    dirtied, alive object becomes split-pending."""
    occ = occupancy(pool)[obj_index]
    pos = voxel_positions_local(pool)[obj_index]  # [G,G,G,3]
    kw = {}
    if impact_cfg is not None:
        kw = dict(boundary_polar_grid_size=impact_cfg.boundary_polar_grid_size,
                  boundary_azimuthal_grid_size=impact_cfg.boundary_azimuthal_grid_size,
                  boundary_angular_jitter=impact_cfg.boundary_angular_jitter,
                  boundary_radial_jitter=impact_cfg.boundary_radial_jitter,
                  radial_falloff_power=impact_cfg.radial_falloff_power,
                  angular_falloff_power=impact_cfg.angular_falloff_power)
    seeds = sample_fracture_seeds(uniforms, impact_point_local, -impact_point_local,
                                  fracture_radius, n_seeds, **kw)

    # squared distances summed as ((dx² + dy²) + dz²), one rounding per
    # operation: no contracted multiply-add, so near-ties break as on the CPU
    diff = pos[:, :, :, None, :] - seeds[None, None, None, :, :]
    sq = diff * diff
    d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]  # [G,G,G,S]
    del diff, sq
    assignment = torch.argmin(d2, dim=-1)
    del d2
    rel = pos - impact_point_local[None, None, None, :]
    in_radius = torch.sqrt((rel * rel).sum(dim=-1)) <= fracture_radius
    frag_region = occ & in_radius

    src_sdf = pool.sdf[obj_index]
    far = far_value(pool.sdf.dtype, pool.voxel_extent[obj_index])
    frag_ids = torch.arange(1, n_seeds, device=occ.device)
    region_s = frag_region[None] & (assignment[None] == frag_ids[:, None, None, None])
    any_s = region_s.flatten(1).any(dim=1)
    ok = (free_slots >= 0) & ~pool.alive[torch.clamp(free_slots, min=0)] & any_s
    # disabled fragments write a spare row past the pool, then dropped
    o = pool.n_objects
    slots = torch.where(ok, torch.clamp(free_slots, min=0), o)

    def scatter(t, rows):
        spare = torch.cat([t, t[:1]])
        return spare.index_copy(0, slots, rows)[:o]

    frag_sdf = torch.where(region_s, src_sdf[None], torch.as_tensor(far, dtype=src_sdf.dtype,
                                                                    device=src_sdf.device))
    sdf_all = scatter(pool.sdf, frag_sdf)
    vt_all = scatter(pool.vtype, pool.vtype[obj_index][None].expand_as(region_s))
    origin = scatter(pool.origin, pool.origin[obj_index][None].expand(n_seeds - 1, 3))
    extent = scatter(pool.voxel_extent, pool.voxel_extent[obj_index].expand(n_seeds - 1))
    ones = torch.ones(n_seeds - 1, dtype=torch.bool, device=occ.device)
    alive = scatter(pool.alive, ones)
    dirty = scatter(pool.mesh_dirty, ones)

    moved = (region_s & ok[:, None, None, None]).any(dim=0)
    sdf_all[obj_index] = torch.where(moved, far, src_sdf)
    dirty[obj_index] = True
    return pool._replace(sdf=sdf_all, vtype=vt_all, alive=alive, mesh_dirty=dirty,
                         split_pending=pool.split_pending | (dirty & alive), origin=origin,
                         voxel_extent=extent)
