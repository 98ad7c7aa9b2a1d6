"""Chunk-gated incremental voxel meshing (port of
``impact_tpu/voxel/chunk_mesh.py``; ref: impact_voxel/src/object/sdf.rs:156
18³ padded chunk windows, mesh.rs:50-58,360 per-chunk submeshes re-meshed
only when invalidated).

A fixed pool of S chunk-submesh slots is shared by every object, each slot
holding a corner-major triangle block of fixed capacity. A step re-meshes up
to ``budget`` dirty chunks: their 18³ windows are gathered from the
1-voxel-padded pool as one batch, meshed by the same Surface Nets,
compaction and material bake as the dense path, and scattered into their
slots, so the cost follows the surface-chunk count, not the grid volume.

The picks are the reference's: the budget goes to the dirty chunks of
highest priority (surface chunks first), lowest flat index first among ties
(``stable_topk``, the order of ``jax.lax.top_k``), and the k-th chunk that
needs a slot takes the k-th free slot in slot order. Quad merging stays
chunk-local. Each slot carries its corners' baked materials and, as the
reference's pool does, their top-2 type blend (``tri_type2``,
``tri_blend``), from which ``bake_mesh_materials`` rebakes the pool for
another voxel-type registry (the pool keeps no vertex census).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..math import quaternion as quat
from .collision import stable_topk
from .encoding import is_encoded, sdf_scale
from .mesh import bake_mesh_materials, compact_mesh, surface_nets
from .object import CHUNK_NON_UNIFORM, CHUNK_SIZE, VoxelObjectPool, chunk_codes

WIN = CHUNK_SIZE + 2  # the 18³ padded window


class ChunkMeshPool(NamedTuple):
    """S shared chunk-submesh slots (corner-major render layout)."""

    owner: torch.Tensor  # i64[S] object slot (undefined when ~active)
    chunk: torch.Tensor  # i64[S] flat chunk id within the owner
    active: torch.Tensor  # bool[S]
    slot_of: torch.Tensor  # i64[O,C] chunk → slot (−1 = unmeshed or empty)
    chunk_dirty: torch.Tensor  # bool[O,C] remesh pending
    tri_active: torch.Tensor  # bool[S,ctc]
    tri_pos: torch.Tensor  # f32[S,ctc,9] object grid units
    tri_normal: torch.Tensor  # f32[S,ctc,9]
    tri_type: torch.Tensor  # i32[S,ctc,3]
    tri_type2: torch.Tensor  # i32[S,ctc,3]
    tri_blend: torch.Tensor  # f32[S,ctc,3]
    tri_albedo: torch.Tensor  # f32[S,ctc,9] (baked)
    tri_f0: torch.Tensor  # f32[S,ctc,9]
    tri_rough: torch.Tensor  # f32[S,ctc,3]
    tri_emissive: torch.Tensor  # f32[S,ctc,9]
    # cumulative overflow counters: triangles beyond a slot's capacity,
    # vertices beyond the per-chunk cap, dirty surface chunks that found no
    # free slot (they stay dirty and retry)
    n_dropped_verts: torch.Tensor  # i64[]
    n_dropped_tris: torch.Tensor  # i64[]
    n_dropped_chunks: torch.Tensor  # i64[]

    @property
    def n_slots(self) -> int:
        return self.active.shape[0]

    @property
    def tri_cap(self) -> int:
        return self.tri_active.shape[1]


def n_chunks_per_object(grid_size: int) -> int:
    return (grid_size // CHUNK_SIZE) ** 3


def empty_chunk_mesh_pool(n_slots: int, tri_cap: int, n_objects: int, grid_size: int,
                          device=None) -> ChunkMeshPool:
    c = n_chunks_per_object(grid_size)
    s, t = n_slots, tri_cap

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ChunkMeshPool(
        owner=z(s, dtype=torch.int64), chunk=z(s, dtype=torch.int64),
        active=z(s, dtype=torch.bool),
        slot_of=torch.full((n_objects, c), -1, dtype=torch.int64, device=device),
        chunk_dirty=z(n_objects, c, dtype=torch.bool), tri_active=z(s, t, dtype=torch.bool),
        tri_pos=z(s, t, 9), tri_normal=z(s, t, 9), tri_type=z(s, t, 3, dtype=torch.int32),
        tri_type2=z(s, t, 3, dtype=torch.int32), tri_blend=z(s, t, 3),
        tri_albedo=z(s, t, 9), tri_f0=z(s, t, 9), tri_rough=z(s, t, 3),
        tri_emissive=z(s, t, 9), n_dropped_verts=z(dtype=torch.int64),
        n_dropped_tris=z(dtype=torch.int64), n_dropped_chunks=z(dtype=torch.int64),
    )


def _chunk_coords(chunk_idx, nc: int):
    return chunk_idx // (nc * nc), (chunk_idx // nc) % nc, chunk_idx % nc


def extract_chunk_windows(pool: VoxelObjectPool, obj_idx, chunk_idx):
    """18³ SDF windows (f32 world units) and type windows [K,18,18,18] of the
    (object, chunk) pairs, from the pool padded by one far voxel (i8 code
    127 or 1e3) and type 0."""
    nc = pool.grid_size // CHUNK_SIZE
    pad_val = 127 if is_encoded(pool.sdf) else 1e3
    sdf_p = F.pad(pool.sdf, (1, 1, 1, 1, 1, 1), value=pad_val)
    typ_p = F.pad(pool.vtype, (1, 1, 1, 1, 1, 1))
    cx, cy, cz = _chunk_coords(chunk_idx, nc)
    ar = torch.arange(WIN, device=pool.sdf.device)
    oo = obj_idx[:, None, None, None]
    gx = (cx[:, None] * CHUNK_SIZE + ar)[:, :, None, None]
    gy = (cy[:, None] * CHUNK_SIZE + ar)[:, None, :, None]
    gz = (cz[:, None] * CHUNK_SIZE + ar)[:, None, None, :]
    win_sdf = sdf_p[oo, gx, gy, gz]
    win_typ = typ_p[oo, gx, gy, gz]
    if is_encoded(pool.sdf):
        scale = sdf_scale(pool.voxel_extent[obj_idx])[:, None, None, None]
        win_sdf = win_sdf.to(torch.float32) * scale
    return win_sdf, win_typ


def remesh_chunks(cpool: ChunkMeshPool, pool: VoxelObjectPool, material_table, budget: int,
                  vert_cap: int, merge_levels: int = 0) -> ChunkMeshPool:
    """Re-mesh up to ``budget`` dirty chunks gathered across all objects.

    Chunks whose windows give triangles get (or keep) a slot; chunks left
    without a surface free theirs. The processed chunks' dirty flags clear,
    except a surface chunk that found no free slot: it stays dirty and is
    counted in ``n_dropped_chunks``."""
    nc = pool.grid_size // CHUNK_SIZE
    c = nc ** 3
    o_max = pool.n_objects
    s_max = cpool.n_slots
    dev = pool.sdf.device
    budget = min(budget, o_max * c)
    dirty = cpool.chunk_dirty & pool.alive[:, None]
    is_surface = (chunk_codes(pool) == CHUNK_NON_UNIFORM).reshape(o_max, c)
    flat_dirty = dirty.reshape(-1)
    # surface chunks first, so the budget goes to real work
    prio = flat_dirty.to(torch.int32) + (flat_dirty & is_surface.reshape(-1)).to(torch.int32)
    picks = stable_topk(prio, budget)
    sel = flat_dirty[picks]
    obj_idx = picks // c
    chunk_idx = picks % c

    # every pick is meshed (a void or uniform window is cheap and gives no
    # triangle), as one batch of windows
    win_sdf, win_typ = extract_chunk_windows(pool, obj_idx, chunk_idx)
    sub = compact_mesh(surface_nets(win_sdf, win_typ, merge_levels), vert_cap, cpool.tri_cap)
    sub = bake_mesh_materials(sub, material_table)

    # window grid units → object grid units: window voxel w is voxel
    # w + 16·chunk − 1 of the object
    cx, cy, cz = _chunk_coords(chunk_idx, nc)
    off = torch.stack([cx, cy, cz], dim=-1).to(torch.float32) * CHUNK_SIZE - 1.0
    off9 = off.repeat(1, 3)[:, None, :]
    tri_act = sub.tri_active & sel[:, None]
    tri_pos = torch.where(tri_act[..., None], sub.tri_pos + off9, 0.0)

    has_tris = tri_act.any(dim=-1)
    existing = cpool.slot_of.reshape(-1)[picks]
    need_alloc = sel & has_tris & (existing < 0)
    keep = sel & has_tris & (existing >= 0)
    release = sel & ~has_tris & (existing >= 0)

    # the k-th allocating pick takes the k-th free slot
    free_rank = torch.cumsum(need_alloc.to(torch.int64), 0) - 1
    free_order = torch.argsort(cpool.active.to(torch.uint8), stable=True)
    n_free = (~cpool.active).sum()
    can_alloc = need_alloc & (free_rank < n_free)
    new_slot = free_order[torch.clamp(free_rank, 0, s_max - 1)]
    slot = torch.where(can_alloc, new_slot, torch.where(keep, existing, -1))
    write = can_alloc | keep
    # scatters send the picks that write nothing to a spare row past the end,
    # dropped after (no host read); the written slots are distinct (kept
    # slots are unique per chunk, new ones come by rank)
    wslot = torch.where(write, slot, s_max)

    def scatter(dst, idx, src, spare):
        """dst with rows idx ← src, where idx == spare drops the row."""
        return torch.cat([dst, dst[:1]]).index_copy(0, idx, src.to(dst.dtype))[:spare]

    def put(dst, src):
        return scatter(dst, wslot, src, s_max)

    n_flat = o_max * c
    active = scatter(cpool.active, torch.where(release, existing, s_max),
                     torch.zeros_like(release), s_max)
    active = scatter(active, wslot, torch.ones_like(write), s_max)
    slot_of = scatter(cpool.slot_of.reshape(-1), torch.where(sel, picks, n_flat),
                      torch.where(write, slot, -1), n_flat)
    blocked = need_alloc & ~can_alloc
    cleared = sel & ~blocked
    chunk_dirty = scatter(dirty.reshape(-1), torch.where(cleared, picks, n_flat),
                          torch.zeros_like(cleared), n_flat)
    # slots of dead objects are freed
    active = active & pool.alive[torch.clamp(cpool.owner, 0, o_max - 1)]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return cpool._replace(
        owner=put(cpool.owner, obj_idx),
        chunk=put(cpool.chunk, chunk_idx),
        active=active,
        slot_of=slot_of.reshape(o_max, c),
        chunk_dirty=chunk_dirty.reshape(o_max, c),
        tri_active=put(cpool.tri_active, tri_act),
        tri_pos=put(cpool.tri_pos, tri_pos),
        tri_normal=put(cpool.tri_normal, sub.tri_normal),
        tri_type=put(cpool.tri_type, sub.tri_type),
        tri_type2=put(cpool.tri_type2, sub.tri_type2),
        tri_blend=put(cpool.tri_blend, sub.tri_blend),
        tri_albedo=put(cpool.tri_albedo, sub.tri_albedo),
        tri_f0=put(cpool.tri_f0, sub.tri_f0),
        tri_rough=put(cpool.tri_rough, sub.tri_rough),
        tri_emissive=put(cpool.tri_emissive, sub.tri_emissive),
        n_dropped_verts=cpool.n_dropped_verts + torch.where(sel, sub.n_dropped_verts, zero).sum(),
        n_dropped_tris=cpool.n_dropped_tris + torch.where(sel, sub.n_dropped_tris, zero).sum(),
        n_dropped_chunks=cpool.n_dropped_chunks + blocked.sum(),
    )


def mark_chunks_dirty(cpool: ChunkMeshPool, chunk_mask) -> ChunkMeshPool:
    """Flag the chunks of ``chunk_mask`` bool[O,C] for remesh."""
    return cpool._replace(chunk_dirty=cpool.chunk_dirty | chunk_mask)


def mark_objects_dirty(cpool: ChunkMeshPool, obj_mask) -> ChunkMeshPool:
    """Flag every chunk of the masked objects for remesh (their slots are
    kept and rewritten in place)."""
    return cpool._replace(chunk_dirty=cpool.chunk_dirty | obj_mask[:, None])


def reset_objects(cpool: ChunkMeshPool, obj_mask) -> ChunkMeshPool:
    """Detach the masked objects from the pool: free their slots, clear
    their slot maps and mark all their chunks dirty. An object slot reused
    for a new object (a fragment, a split region) needs this, or its old
    slot map would alias recycled slots."""
    o_max = cpool.slot_of.shape[0]
    owned = obj_mask[torch.clamp(cpool.owner, 0, o_max - 1)] & cpool.active
    return cpool._replace(
        active=cpool.active & ~owned,
        slot_of=torch.where(obj_mask[:, None], -1, cpool.slot_of),
        chunk_dirty=cpool.chunk_dirty | obj_mask[:, None],
    )


def _rotate9(q, p9):
    return torch.cat([quat.rotate(q, p9[..., 3 * c:3 * c + 3]) for c in range(3)], dim=-1)


def chunk_mesh_scene_fields(cpool: ChunkMeshPool, pool: VoxelObjectPool, body_position,
                            body_orientation, body_position_prev, body_orientation_prev) -> dict:
    """Corner-major render-scene fields of the chunk-submesh pool, each
    slot posed by its owner object's body."""
    o_max = pool.n_objects
    owner = torch.clamp(cpool.owner, 0, o_max - 1)
    ok_slot = cpool.active & pool.alive[owner]
    ext = pool.voxel_extent[owner][:, None, None]
    org = pool.origin[owner].repeat(1, 3)[:, None, :]
    local9 = cpool.tri_pos * ext + org
    bidx = pool.body_index[owner]
    q = body_orientation[bidx][:, None, :]
    x = body_position[bidx].repeat(1, 3)[:, None, :]
    qp = body_orientation_prev[bidx][:, None, :]
    xp = body_position_prev[bidx].repeat(1, 3)[:, None, :]
    world9 = _rotate9(q, local9) + x
    world9_prev = _rotate9(qp, local9) + xp
    normal9 = _rotate9(q, cpool.tri_normal)
    tri_ok = cpool.tri_active & ok_slot[:, None]
    mat3 = torch.where(tri_ok[..., None], cpool.tri_type, -1)
    shadows = ok_slot & pool.casts_shadows[owner]
    return dict(
        tri_pos=world9.reshape(-1, 9),
        tri_pos_prev=world9_prev.reshape(-1, 9),
        tri_normal=normal9.reshape(-1, 9),
        tri_albedo=cpool.tri_albedo.reshape(-1, 9),
        tri_f0=cpool.tri_f0.reshape(-1, 9),
        tri_roughness=cpool.tri_rough.reshape(-1, 3),
        tri_emissive=cpool.tri_emissive.reshape(-1, 9),
        tri_material=mat3.reshape(-1, 3),
        tri_active=tri_ok.reshape(-1),
        tri_shadow=(cpool.tri_active & shadows[:, None]).reshape(-1),
    )
