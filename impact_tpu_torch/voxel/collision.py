"""Voxel-object collision: probe points against planes, spheres and other
voxel objects (port of ``impact_tpu/voxel/collision.py``; ref:
impact_voxel/src/collidable.rs).

Probes are a fixed [O, B³] pool (B = G/4 blocks per axis), one surface voxel
per 4³ block. Probe contacts are dense masked tensors; voxel-vs-voxel
contacts sample the other object's SDF by trilinear interpolation of i8
corners packed four to an i32 word. Broad phase: dense all-pairs below
GRID_BROAD_PHASE_MIN_OBJECTS objects, a conservative shifted uniform grid
at and above it. Keys sit above the analytic ranges so warm-start joins stay
sorted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import quaternion as quat
from ..math.quaternion import cross
from ..physics.collision import (
    EMPTY_KEY,
    CollidablePools,
    ContactBuffer,
    combine_response,
    compact_contacts,
)
from .encoding import QUANTIZATION_STEP_SIZE, is_encoded
from .object import VoxelObjectPool, adjacency_masks, occupancy, surface_mask, voxel_positions_local

PROBE_BLOCK = 4  # ref: collidable.rs:85, one probe per 4³ block
VOXEL_KEY_BASE = 0x40000000
GRID_BROAD_PHASE_MIN_OBJECTS = 64
MORTON_BROAD_PHASE_MIN_OBJECTS = GRID_BROAD_PHASE_MIN_OBJECTS  # the reference's older name
INTERLOCK_ALIGNMENT_THRESHOLD = 0.1  # ref: contact.rs:611
_BIG = 3.0e38


class VoxelProbes(NamedTuple):
    active: torch.Tensor  # bool[O,P]
    pos_local: torch.Tensor  # f32[O,P,3] body-frame probe positions
    response: torch.Tensor  # f32[O,P,3] per-object contact response


def _blocks(x, o, b, bx=None):
    """[O,G,G,G,...] → [O,B,B,B,64,...] (4³ blocks, voxel-major inside); a
    slab [O,gx,G,G,...] → [O,bx,B,B,64,...]."""
    bx = b if bx is None else bx
    tail = x.shape[4:]
    x = x.reshape(o, bx, PROBE_BLOCK, b, PROBE_BLOCK, b, PROBE_BLOCK, *tail)
    perm = (0, 1, 3, 5, 2, 4, 6) + tuple(range(7, 7 + len(tail)))
    return x.permute(perm).reshape(o, bx, b, b, PROBE_BLOCK ** 3, *tail)


def extract_probes(pool: VoxelObjectPool, response_params, x0: int = 0,
                   halo=None) -> VoxelProbes:
    """One probe per 4³ block: the surface voxel with the fewest occupied
    face neighbours (corners beat face centres), ties broken by |sdf| and
    then by the lowest index in the block.

    On a pool of slabs [O,gx,G,G] (x planes [x0, x0+gx), gx a multiple of
    4) the probes of the slab's blocks, [O, gx/4·(G/4)², ...]: x-major, so
    the slabs' probes side by side are the whole grid's. ``halo``: the
    occupancy planes just left and right of the slab (``adjacency_masks``)."""
    o, g = pool.n_objects, pool.grid_size
    b = g // PROBE_BLOCK
    bx = pool.sdf.shape[-3] // PROBE_BLOCK
    occ = occupancy(pool)
    adj = adjacency_masks(occ, halo)
    n_neighbors = sum(a.to(torch.int32) for a in adj.values()).to(torch.float32)
    score = torch.where(surface_mask(occ, halo),
                        n_neighbors * 10.0 + pool.sdf.to(torch.float32).abs(), float("inf"))
    score_b = _blocks(score, o, b, bx)
    best_score, best = torch.min(score_b, dim=-1)
    pos_b = _blocks(voxel_positions_local(pool, x0), o, b, bx)
    probe_pos = torch.gather(pos_b, -2, best[..., None, None].expand(o, bx, b, b, 1, 3))[..., 0, :]
    p = bx * b * b
    return VoxelProbes(
        active=(torch.isfinite(best_score) & pool.alive[:, None, None, None]).reshape(o, p),
        pos_local=probe_pos.reshape(o, p, 3),
        response=response_params[:, None, :].expand(o, p, 3),
    )


def pack_cell_corners_i8(sdf_i8):
    """[..., G,G,G] i8 → [..., (G-1)³, 2] i32 packed cell-corner words:
    word0 holds corners (dx,dy,0) at byte dx+2·dy, word1 corners (dx,dy,1).
    Any [..., X,Y,Z] → [..., (X-1)(Y-1)(Z-1), 2] (a slab with its right halo
    plane gives its own cells)."""
    nx, ny, nz = sdf_i8.shape[-3:]
    u = sdf_i8.view(torch.uint8).to(torch.int64)

    def corner(dx, dy, dz):
        return u[..., dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]

    def word(dz):
        w = (corner(0, 0, dz) | (corner(1, 0, dz) << 8) | (corner(0, 1, dz) << 16)
             | (corner(1, 1, dz) << 24))
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    w = torch.stack([word(0), word(1)], dim=-1)
    return w.reshape(*sdf_i8.shape[:-3], (nx - 1) * (ny - 1) * (nz - 1), 2)


def unpack_byte_i8(word, k: int):
    """Byte k of an i32 word → f32 value of the stored i8 (the shift is
    arithmetic; the mask keeps the byte, then two's complement)."""
    b = (word >> (8 * k)) & 0xFF
    return torch.where(b >= 128, b - 256, b).to(torch.float32)


def _trilinear_from_corners(c000, c100, c010, c110, c001, c101, c011, c111, f):
    """(value, unit gradient) of the trilinear form given its 8 corners."""
    fx, fy, fz = f.unbind(-1)
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    value = c0 * (1 - fz) + c1 * fz
    dx00, dx10 = c100 - c000, c110 - c010
    dx01, dx11 = c101 - c001, c111 - c011
    gx = (dx00 * (1 - fy) + dx10 * fy) * (1 - fz) + (dx01 * (1 - fy) + dx11 * fy) * fz
    gy = ((c10 - c00) * (1 - fz)) + ((c11 - c01) * fz)
    gz = c1 - c0
    grad = torch.stack([gx, gy, gz], dim=-1)
    grad = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-9)
    return value, grad


def sample_packed_sdf_pairs(packed_flat, obj_idx, pts_grid, g: int, x0: int = 0,
                            gx: int | None = None):
    """(value, unit gradient) of the trilinear interpolant from packed corner
    words. ``packed_flat`` [O·(G-1)³, 2] i32, ``obj_idx`` [...] object per
    sample, ``pts_grid`` [...,3] grid-space points. Cell starts clamp to
    [0, G-2]. With ``gx``: the words of slabs' cells [x0, x0+gx) ×
    [0, G-1)², [O·gx·(G-1)², 2]; samples whose cell lies outside read a
    clamped cell (``sample_cell_x`` says which are the slab's)."""
    q = pts_grid - 0.5
    q0f = torch.floor(q)
    f = q - q0f
    cell = torch.clamp(q0f.to(torch.int64), 0, g - 2)
    nx = g - 1 if gx is None else gx
    cx = cell[..., 0] if gx is None else torch.clamp(cell[..., 0] - x0, 0, gx - 1)
    flat = obj_idx * (nx * (g - 1) ** 2) + (cx * (g - 1) + cell[..., 1]) * (g - 1) + cell[..., 2]
    w = packed_flat[flat]
    w0, w1 = w[..., 0], w[..., 1]
    return _trilinear_from_corners(
        unpack_byte_i8(w0, 0), unpack_byte_i8(w0, 1), unpack_byte_i8(w0, 2),
        unpack_byte_i8(w0, 3), unpack_byte_i8(w1, 0), unpack_byte_i8(w1, 1),
        unpack_byte_i8(w1, 2), unpack_byte_i8(w1, 3), f)


def sample_sdf_trilinear_with_gradient(sdf, obj_idx, pts_grid, x0: int = 0):
    """(value, unit gradient) of the trilinear interpolant of f32 grids
    ``sdf`` [O,G,G,G] at grid-space points of object ``obj_idx``. With
    ``x0``: ``sdf`` holds slabs with their right halo plane, x planes
    [x0, x0+gx] of [O,G,G,G] grids; samples whose lower corner plane
    lies outside the slab read clamped planes (``sample_cell_x``)."""
    g = sdf.shape[-1]
    nx = sdf.shape[-3]
    q = pts_grid - 0.5
    q0f = torch.floor(q)
    f = q - q0f
    q0 = q0f.to(torch.int64)

    def at(dx, dy, dz):
        i = torch.clamp(torch.clamp(q0[..., 0] + dx, 0, g - 1) - x0, 0, nx - 1)
        j = torch.clamp(q0[..., 1] + dy, 0, g - 1)
        k = torch.clamp(q0[..., 2] + dz, 0, g - 1)
        return sdf[obj_idx, i, j, k].to(torch.float32)

    return _trilinear_from_corners(at(0, 0, 0), at(1, 0, 0), at(0, 1, 0), at(1, 1, 0),
                                   at(0, 0, 1), at(1, 0, 1), at(0, 1, 1), at(1, 1, 1), f)


def sample_sdf_trilinear(sdf, pts_grid):
    """One [G,G,G] grid trilinearly sampled at grid-space points [...,3]
    (voxel centres at idx + 0.5, clamped to the edge)."""
    obj = torch.zeros(pts_grid.shape[:-1], dtype=torch.int64, device=pts_grid.device)
    return sample_sdf_trilinear_with_gradient(sdf[None], obj, pts_grid)[0]


def sample_sdf_gradient(sdf, pts_grid, eps=0.5):
    """Unit gradient of one [G,G,G] grid's trilinear interpolant at
    grid-space points [...,3] (analytic partials; ``eps`` is not used, as in
    the reference)."""
    obj = torch.zeros(pts_grid.shape[:-1], dtype=torch.int64, device=pts_grid.device)
    return sample_sdf_trilinear_with_gradient(sdf[None], obj, pts_grid)[1]


def sample_cell_x(pts_grid, g: int, encoded: bool):
    """The x plane of each sample's lower corners, as the samplers clamp it:
    [0, G-2] for packed words, [0, G-1] for f32 grids. A sample belongs to
    the slab that holds that plane."""
    q0 = torch.floor(pts_grid[..., 0] - 0.5).to(torch.int64)
    return torch.clamp(q0, 0, g - 2 if encoded else g - 1)


def bounding_radii(pool: VoxelObjectPool):
    """Conservative bounding-sphere radius about the body origin (the grid
    box diagonal)."""
    half = 0.5 * pool.grid_size * pool.voxel_extent
    return torch.linalg.vector_norm(pool.origin + half[:, None], dim=-1) + half * (3.0 ** 0.5)


def stable_topk(values, k: int):
    """Indices of the k largest values, lowest index first among ties (the
    order of ``jax.lax.top_k``)."""
    return torch.sort(values, descending=True, stable=True)[1][:k]


def broad_phase_pairs(centers, radii, alive, max_pairs: int, window: int = 32,
                      large_count: int = 4, margin=0.0):
    """Conservative candidate object pairs on a shifted uniform grid (ref:
    the BVH pair query of hierarchy.rs:14-26 returns all intersecting pairs).

    Cell size c = 2·d_max, where d_max bounds the centre distance of any
    overlapping small-small pair; 8 passes offset by {0, c/2}³ guarantee
    every overlapping pair shares a cell in one pass. Within a pass objects
    are sorted by packed cell key and tested against their ``window``
    successors; a same-cell run longer than the window is counted in
    ``n_overflow``. The ``large_count`` largest objects are tested densely
    against everyone. Pairs are directional (both (a,b) and (b,a)).

    Returns (pair_a i64[max_pairs], pair_b, valid bool[max_pairs],
    n_overflow i64[])."""
    n = centers.shape[0]
    dev = centers.device
    i = torch.arange(n, device=dev)
    m_obj = torch.as_tensor(margin, dtype=torch.float32, device=dev)
    if m_obj.ndim == 0:
        m_obj = m_obj.expand(n)

    def overlap(a, b):
        sep = torch.linalg.vector_norm(centers[a] - centers[b], dim=-1)
        return sep < radii[a] + radii[b] + 0.5 * (m_obj[a] + m_obj[b])

    # large lane: the biggest alive objects against everyone
    k_large = min(large_count, n)
    large_idx = stable_topk(torch.where(alive, radii, float("-inf")), k_large)
    is_large = torch.zeros(n, dtype=torch.bool, device=dev)
    is_large[large_idx] = alive[large_idx]
    la = large_idx[:, None].expand(k_large, n)
    lb = i[None, :].expand(k_large, n)
    dup = is_large[lb] & (lb < la)  # keep one representative of large-large pairs
    ok_l = alive[la] & alive[lb] & (la != lb) & ~dup & overlap(la, lb)

    # shifted-grid lane over the small objects
    small = alive & ~is_large
    r_small_max = torch.where(small, radii, 0.0).max()
    m_small_max = torch.where(small, m_obj, 0.0).max()
    d_max = 2.0 * r_small_max + m_small_max
    c = torch.clamp(2.0 * d_max, min=1e-6) * (1.0 + 1e-6)
    offs = torch.tensor([[(x & 1), (x >> 1) & 1, (x >> 2) & 1] for x in range(8)],
                        dtype=torch.float32, device=dev) * 0.5
    cells = torch.floor(centers[None, :, :] / c + offs[:, None, :]).to(torch.int32)  # [8,N,3]
    cl = cells.to(torch.int64) & 0x3FF
    key = (cl[..., 0] << 20) | (cl[..., 1] << 10) | cl[..., 2]
    key = torch.where(small[None, :], key, EMPTY_KEY)  # [8,N]

    def same_cell(p, a, b):
        return torch.all(cells[p, a] == cells[p, b], dim=-1) & small[a] & small[b]

    w = min(window, max(n - 1, 1))
    d = torch.arange(1, w + 1, device=dev)
    pair_as, pair_bs, pair_ok = [], [], []
    n_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(8):
        sorted_key, order = torch.sort(key[p], stable=True)
        ai = i[:, None].expand(n, w)
        bi = ai + d[None, :]
        a_obj = order[ai]
        b_obj = order[torch.clamp(bi, max=n - 1)]
        here = same_cell(p, a_obj, b_obj)
        seen_before = torch.zeros_like(here)  # emit in the first sharing pass only
        for q in range(p):
            seen_before |= same_cell(q, a_obj, b_obj)
        ok = (bi < n) & here & ~seen_before & overlap(a_obj, b_obj)
        pair_as.append(a_obj.reshape(-1))
        pair_bs.append(b_obj.reshape(-1))
        pair_ok.append(ok.reshape(-1))
        if n > w:
            lo, hi = sorted_key[:n - w], sorted_key[w:]
            n_overflow = n_overflow + ((lo == hi) & (lo != EMPTY_KEY)).sum()

    ga, gb, gv = torch.cat(pair_as), torch.cat(pair_bs), torch.cat(pair_ok)
    va = torch.cat([ga, gb, la.reshape(-1), lb.reshape(-1)])
    vb = torch.cat([gb, ga, lb.reshape(-1), la.reshape(-1)])
    vv = torch.cat([gv, gv, ok_l.reshape(-1), ok_l.reshape(-1)])
    take = torch.argsort((~vv).to(torch.uint8), stable=True)[:max_pairs]
    return va[take], vb[take], vv[take], n_overflow


def separating_contacts_for_interlocked(pos, normal, depth, active, com_a, com_b):
    """Per-manifold interlock analysis (ref: contact.rs:610-780): a manifold
    whose penetration vectors cancel (|Σ d·n|²/(Σ d)² < 0.1) is replaced by
    one contact separating along the axis of least contact-point extent,
    oriented to push A's COM away from B's. The diameter uses the 2-pass
    farthest-point approximation, as the reference package does.
    Returns (interlocked bool[MP], sep_pos [MP,3], sep_axis [MP,3],
    sep_depth [MP])."""
    pen = torch.where(active & (depth > 0.0), depth, 0.0)
    pen_sum = pen.sum(dim=-1)
    vec_sum = (pen[..., None] * normal).sum(dim=1)
    alignment = (vec_sum * vec_sum).sum(dim=-1) / torch.clamp(pen_sum * pen_sum, min=1e-12)
    interlocked = (pen_sum >= 1e-6) & (alignment < INTERLOCK_ALIGNMENT_THRESHOLD)
    inval = ~active

    def row(pts, idx):
        return torch.gather(pts, 1, idx[:, None, None].expand(-1, 1, 3))[:, 0]

    def farthest_from(ref_pt, pts):
        d2 = ((pts - ref_pt[:, None, :]) ** 2).sum(dim=-1)
        return row(pts, torch.argmax(torch.where(inval, -_BIG, d2), dim=-1))

    def diameter_axis(pts):
        w = active.to(torch.float32)
        centroid = (pts * w[..., None]).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)[..., None]
        p1 = farthest_from(centroid, pts)
        return farthest_from(p1, pts) - p1

    def normalized_if_above(v, eps):
        nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return torch.where(nv > eps, v / torch.clamp(nv, min=1e-12), 0.0), nv[..., 0] > eps

    major, has_major = normalized_if_above(diameter_axis(pos), 1e-6)
    proj = pos - (pos * major[:, None, :]).sum(dim=-1, keepdim=True) * major[:, None, :]
    middle, has_middle = normalized_if_above(diameter_axis(proj), 1e-6)
    minor, has_minor = normalized_if_above(cross(major, middle), 1e-4)

    def contact_along(axis):
        flip = (axis * (com_a - com_b)).sum(dim=-1) < 0.0
        ax = torch.where(flip[:, None], -axis, axis)
        disp = (pos * ax[:, None, :]).sum(dim=-1)
        lo = torch.where(inval, _BIG, disp)
        dmin, imin = torch.min(lo, dim=-1)
        sep = torch.where(inval, -_BIG, disp).max(dim=-1).values - dmin
        return sep > 1e-6, row(pos, imin), ax, sep

    ok_mi, pos_mi, ax_mi, sep_mi = contact_along(minor)
    ok_md, pos_md, ax_md, sep_md = contact_along(middle)
    ok_ma, pos_ma, ax_ma, sep_ma = contact_along(major)
    ok_mi = ok_mi & has_minor & has_middle & has_major
    ok_md = ok_md & has_middle & has_major
    ok_ma = ok_ma & has_major
    # first valid of minor → middle → major (the reference's fallback chain)
    sep_pos = torch.where(ok_md[:, None], pos_md, pos_ma)
    sep_ax = torch.where(ok_md[:, None], ax_md, ax_ma)
    sep_dep = torch.where(ok_md, sep_md, sep_ma)
    sep_pos = torch.where(ok_mi[:, None], pos_mi, sep_pos)
    sep_ax = torch.where(ok_mi[:, None], ax_mi, sep_ax)
    sep_dep = torch.where(ok_mi, sep_mi, sep_dep)
    return interlocked & (ok_mi | ok_md | ok_ma), sep_pos, sep_ax, sep_dep


def voxel_contacts(pool: VoxelObjectPool, probes: VoxelProbes, collidables: CollidablePools,
                   body_position, body_orientation, max_contacts: int,
                   max_pairs: int | None = None, shard: tuple[int, int] | None = None,
                   slab: tuple | None = None) -> ContactBuffer:
    """Probe contacts against planes, spheres and the broad-phase pairs of
    voxel objects → a compacted ContactBuffer with keys ≥ VOXEL_KEY_BASE.

    ``shard=(lo, hi)``: the pool's vectors and the probes are whole but its
    grids hold only slots [lo, hi) (``parallel/step.py``). Then only the
    contacts of those slots are emitted: their plane and sphere contacts,
    and the pairs whose sampled object B is one of them. Every value is
    computed as on the whole pool, so the shards' buffers merged by key
    equal the whole pool's.

    ``slab=(x0, right, reduce)``: the grids are slabs [.., gx, G, G] of x
    planes [x0, x0+gx), ``right`` their right halo planes [.., 1, G, G] and
    ``reduce`` sums a tensor over the object's slabs. Each slab samples the
    pair samples whose lower corner plane it holds and leaves the others
    0; the one sum then gives every slab the whole sample set, equal to
    the whole grids' bit for bit (one term of each sum is not 0), so the
    interlock test and the emitted buffer are the whole pool's."""
    o, p = probes.active.shape
    dev = probes.active.device
    if max_pairs is None:
        max_pairs = min(o * o, max(16, 4 * o))
    owned = None
    if shard is not None:
        ar_o = torch.arange(o, device=dev)
        owned = (ar_o >= shard[0]) & (ar_o < shard[1])
    body_idx = pool.body_index
    q_b = body_orientation[body_idx]
    x_b = body_position[body_idx]
    probe_world = quat.rotate(q_b[:, None, :], probes.pos_local) + x_b[:, None, :]
    parts = []
    key_cursor = VOXEL_KEY_BASE

    def emit(key, active, ba, bb, pos, nrm, dep, resp):
        shape = active.shape
        parts.append((key.expand(shape).reshape(-1), active.reshape(-1),
                      ba.expand(shape).reshape(-1), bb.expand(shape).reshape(-1),
                      pos.expand(shape + (3,)).reshape(-1, 3),
                      nrm.expand(shape + (3,)).reshape(-1, 3), dep.expand(shape).reshape(-1),
                      resp.expand(shape + (3,)).reshape(-1, 3)))

    # probes vs planes (A = voxel object, B = plane)
    npl = collidables.pln_mask.shape[0]
    pn = quat.rotate(body_orientation[collidables.pln_body], collidables.pln_normal)
    pd = collidables.pln_disp + (pn * body_position[collidables.pln_body]).sum(dim=-1)
    sd = torch.einsum("opc,lc->opl", probe_world, pn) - pd[None, None, :]
    dep = 0.5 * pool.voxel_extent[:, None, None] - sd
    active = probes.active[:, :, None] & collidables.pln_mask[None, None, :] & (dep >= 0.0)
    if owned is not None:
        active = active & owned[:, None, None]
    nrm = pn[None, None].expand(o, p, npl, 3)
    resp = combine_response(probes.response[:, :, None, :],
                            collidables.pln_response[None, None].expand(o, p, npl, 3))
    key = key_cursor + torch.arange(o * p * npl, dtype=torch.int64, device=dev).reshape(o, p, npl)
    emit(key, active, body_idx[:, None, None], collidables.pln_body[None, None, :],
         probe_world[:, :, None, :] - sd[..., None] * nrm, nrm, dep, resp)
    key_cursor += o * p * npl

    # probes vs spheres (A = voxel object, B = sphere)
    ns = collidables.sph_mask.shape[0]
    sc = body_position[collidables.sph_body] + quat.rotate(
        body_orientation[collidables.sph_body], collidables.sph_center)
    disp = probe_world[:, :, None, :] - sc[None, None, :, :]
    dist = torch.linalg.vector_norm(disp, dim=-1)
    nrm = disp / torch.clamp(dist, min=1e-9)[..., None]
    dep = (collidables.sph_radius[None, None, :] + 0.5 * pool.voxel_extent[:, None, None]
           - dist)
    active = (probes.active[:, :, None] & collidables.sph_mask[None, None, :] & (dep >= 0.0)
              & (body_idx[:, None, None] != collidables.sph_body[None, None, :]))
    if owned is not None:
        active = active & owned[:, None, None]
    resp = combine_response(probes.response[:, :, None, :],
                            collidables.sph_response[None, None].expand(o, p, ns, 3))
    key = key_cursor + torch.arange(o * p * ns, dtype=torch.int64, device=dev).reshape(o, p, ns)
    emit(key, active, body_idx[:, None, None], collidables.sph_body[None, None, :],
         sc[None, None] + collidables.sph_radius[None, None, :, None] * nrm, nrm, dep, resp)
    key_cursor += o * p * ns

    # probes vs other voxel objects (A = probe owner, B = sampled object)
    q_inv = quat.conjugate(q_b)
    encoded = is_encoded(pool.sdf)
    g = pool.grid_size
    x0, gx = 0, None
    grids = pool.sdf
    if slab is not None:
        x0, gx = slab[0], pool.sdf.shape[-3]
        grids = torch.cat([pool.sdf, slab[1]], dim=-3)
    if encoded:
        sdf_unit = pool.voxel_extent * QUANTIZATION_STEP_SIZE
        packed_flat = pack_cell_corners_i8(grids).reshape(-1, 2)  # the shard's grids
    else:
        sdf_unit = torch.ones_like(pool.voxel_extent)

    radii = bounding_radii(pool)
    if o >= GRID_BROAD_PHASE_MIN_OBJECTS:
        pair_a, pair_b, pair_valid, _ = broad_phase_pairs(
            x_b, radii, pool.alive, max_pairs, margin=pool.voxel_extent)
        # warm-start joins need ascending keys: re-sort the selected pairs
        pkey = torch.where(pair_valid, pair_a * o + pair_b, EMPTY_KEY)
        reorder = torch.sort(pkey, stable=True)[1]
        pair_a, pair_b, pair_valid = pair_a[reorder], pair_b[reorder], pair_valid[reorder]
    else:
        sep = torch.linalg.vector_norm(x_b[:, None, :] - x_b[None, :, :], dim=-1)
        margin = 0.5 * (pool.voxel_extent[:, None] + pool.voxel_extent[None, :])
        ar = torch.arange(o, device=dev)
        valid_pair = (pool.alive[:, None] & pool.alive[None, :] & (ar[:, None] != ar[None, :])
                      & (sep < radii[:, None] + radii[None, :] + margin))
        flat_valid = valid_pair.reshape(-1)
        order = torch.argsort((~flat_valid).to(torch.uint8), stable=True)[:max_pairs]
        pair_valid = flat_valid[order]
        pair_a, pair_b = order // o, order % o

    # A's probes in B's grid space, sampled
    local = quat.rotate(q_inv[pair_b][:, None, :], probe_world[pair_a] - x_b[pair_b][:, None, :])
    pts = (local - pool.origin[pair_b][:, None, :]) / pool.voxel_extent[pair_b][:, None, None]
    obj_b = pair_b[:, None].expand(-1, p)
    if owned is not None:
        # B's grid lives on its owner: other pairs sample a clamped slot and
        # are not emitted
        obj_b = torch.clamp(obj_b - shard[0], 0, shard[1] - shard[0] - 1)
    if encoded:
        d_ab, g_local = sample_packed_sdf_pairs(packed_flat, obj_b, pts, g, x0, gx)
    else:
        d_ab, g_local = sample_sdf_trilinear_with_gradient(grids, obj_b, pts, x0)
    if slab is not None:
        cx = sample_cell_x(pts, g, encoded)
        here = (cx >= x0) & (cx < x0 + gx)
        vals = torch.where(here[..., None], torch.cat([d_ab[..., None], g_local], dim=-1), 0.0)
        d_ab, g_local = slab[2](vals).split([1, 3], dim=-1)
        d_ab = d_ab[..., 0]
    d_ab = d_ab * sdf_unit[pair_b][:, None]
    n_ab = quat.rotate(q_b[pair_b][:, None, :], g_local)
    dep = 0.5 * pool.voxel_extent[pair_a][:, None] - d_ab
    active = probes.active[pair_a] & pair_valid[:, None] & (dep >= 0.0)
    pos = probe_world[pair_a]
    mp = pair_a.shape[0]
    resp = combine_response(probes.response[pair_a], probes.response[pair_b][:, :1, :].expand(
        mp, p, 3))
    pair_key = pair_a * o + pair_b
    key = key_cursor + pair_key[:, None] * p + torch.arange(p, dtype=torch.int64,
                                                            device=dev)[None, :]
    ba = body_idx[pair_a][:, None].expand(mp, p)
    bb = body_idx[pair_b][:, None].expand(mp, p)
    # an interlocked manifold is replaced by one synthetic separating contact
    # (ref: constraint.rs:241)
    interlocked, sep_pos, sep_ax, sep_dep = separating_contacts_for_interlocked(
        pos, n_ab, dep, active, x_b[pair_a], x_b[pair_b])
    if owned is not None:
        mine = owned[pair_b]
        active_out, interlocked_out = active & mine[:, None], interlocked & mine
    else:
        active_out, interlocked_out = active, interlocked
    emit(key, active_out & ~interlocked[:, None], ba, bb, pos, n_ab, dep, resp)
    key_cursor += o * o * p
    # restitution 0, "infinite" friction (ref: contact.rs:644)
    sep_resp = torch.tensor([0.0, 1e9, 1e9], device=dev).expand(mp, 3)
    emit(key_cursor + pair_key, interlocked_out, body_idx[pair_a], body_idx[pair_b], sep_pos,
         sep_ax, sep_dep, sep_resp)

    return compact_contacts(*[torch.cat(c) for c in zip(*parts)], max_contacts)


def merge_contact_buffers(a: ContactBuffer, b: ContactBuffer, max_contacts: int) -> ContactBuffer:
    """Merge two compacted buffers preserving key order (a's keys < b's)."""
    cat = {f: torch.cat([getattr(a, f), getattr(b, f)]) for f in ContactBuffer._fields}
    return compact_contacts(max_contacts=max_contacts, **cat)
