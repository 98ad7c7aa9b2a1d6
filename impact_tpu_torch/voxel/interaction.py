"""Voxel deformation: split detection, region extraction and fracturing
(port of ``impact_tpu/voxel/interaction.py`` without absorption; ref:
impact_voxel/src/object/split_detection.rs, object/extraction.rs,
interaction/fracturing.rs).

* Split detection labels occupied voxels with the fixpoint of min-label
  propagation; on the card that is the hand-written labels kernel
  (``ops/ccl_pallas.py``, a min-root union-find) at any G. Grids of G ≥ 64
  with G a multiple of 16 take the reference's two-level labelling instead,
  in plain PyTorch as the reference's is XLA.
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

import torch

from ..math.quaternion import cross
from ..ops.ccl_pallas import connected_component_labels_batched, initial_labels, min_sweep
from .encoding import far_value
from .object import CHUNK_SIZE, VoxelObjectPool, occupancy, voxel_positions_local


def connected_component_labels(occ):
    """Labels of a bool [G,G,G] grid or [B,G,G,G] batch: i32, the minimum
    linear index of each 6-connected component, −1 where empty. Routed as
    the reference routes (interaction.py:connected_component_labels): the
    two-level labelling for G ≥ 64 with G a multiple of the chunk size, the
    flat labels (the labels kernel on the card) for every other G."""
    batch = occ if occ.ndim == 4 else occ[None]
    g = occ.shape[-1]
    if g >= 64 and g % CHUNK_SIZE == 0:
        labels = connected_component_labels_two_level(batch)
    else:
        labels = connected_component_labels_batched(batch)
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


def _set_row(t, i, value, cond):
    """t with row i replaced by ``value`` where the 0-d ``cond`` holds."""
    out = t.clone()
    out[i] = torch.where(cond, value, t[i])
    return out


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
