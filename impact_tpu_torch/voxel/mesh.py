"""Surface Nets meshing with render-exact quad merging, mesh compaction and
the remesh-time material bake.

Port of ``impact_tpu/voxel/mesh.py`` (ref: impact_voxel
object/sdf/surface_nets.rs): one vertex per surface-crossing cell at the
centroid of its edge zero-crossings, normals from the corner-difference
gradient, two triangles per sign-changing lattice edge. The mesh is
fixed-capacity and slot-addressed exactly like the reference's, so slot
order — and with it compaction order — is the same in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

_CORNER_OFFSETS = [
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
    (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1),
]

_EDGES = [
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


class SurfaceNetsMesh(NamedTuple):
    """Dense slot-addressed mesh (C = (G-1)³ cell slots); positions in grid units."""

    vert_active: torch.Tensor  # bool[C]
    vert_pos: torch.Tensor  # f32[C,3]
    vert_normal: torch.Tensor  # f32[C,3]
    vert_type: torch.Tensor  # i32[C]
    vert_type2: torch.Tensor  # i32[C]
    vert_blend: torch.Tensor  # f32[C]
    vert_ctype: torch.Tensor  # i32[C,8] corner voxel materials
    vert_cweight: torch.Tensor  # f32[C,8] normalized depth weights
    tri_active: torch.Tensor  # bool[T]
    tri_indices: torch.Tensor  # i64[T,3] cell-slot indices


def _corner_offsets(device):
    """``_CORNER_OFFSETS`` as f32 [8,3], built on the device (no upload)."""
    i = torch.arange(8, device=device)
    return torch.stack([i & 1, (i >> 1) & 1, (i >> 2) & 1], dim=-1).to(torch.float32)


def _corner_sign(axis, device):
    return _corner_offsets(device)[:, axis] * 2.0 - 1.0


def _take_last(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def surface_nets(sdf, vtype, merge_levels: int = 0) -> SurfaceNetsMesh:
    """Mesh one [G,G,G] f32 SDF grid, or a batch [B,G,G,G] (then every field
    has a leading B: the reference's ``make_surface_nets_batched``);
    ``merge_levels`` > 0 collapses exactly planar 2×2 quad blocks per level
    (render-identical, see the reference)."""
    if sdf.ndim == 3:
        return SurfaceNetsMesh(*(f[0] for f in surface_nets(sdf[None], vtype[None],
                                                             merge_levels)))
    nb = sdf.shape[0]
    g = sdf.shape[-1]
    gc = g - 1
    dev = sdf.device

    def cut(grid, off):
        return grid[:, off[0]:off[0] + gc, off[1]:off[1] + gc, off[2]:off[2] + gc]

    corners = torch.stack([cut(sdf, o) for o in _CORNER_OFFSETS], dim=-1)
    inside = corners < 0.0
    n_inside = inside.sum(dim=-1)
    cell_active = (n_inside > 0) & (n_inside < 8)

    crossings_sum = torch.zeros((nb, gc, gc, gc, 3), dtype=torch.float32, device=dev)
    crossings_cnt = torch.zeros((nb, gc, gc, gc), dtype=torch.float32, device=dev)
    offsets = _corner_offsets(dev)
    for (a, b) in _EDGES:
        da, db = corners[..., a], corners[..., b]
        crossing = (da < 0.0) != (db < 0.0)
        diff = da - db
        t = da / torch.where(diff.abs() < 1e-12, torch.full_like(diff, 1e-12), diff)
        t = torch.clamp(t, 0.0, 1.0)
        point = offsets[a] + t[..., None] * (offsets[b] - offsets[a])
        crossings_sum = crossings_sum + torch.where(crossing[..., None], point, 0.0)
        crossings_cnt = crossings_cnt + crossing
    centroid = crossings_sum / torch.clamp(crossings_cnt, min=1.0)[..., None]
    ar = torch.arange(gc, dtype=torch.float32, device=dev)
    cell_ijk = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1)
    vert_pos = cell_ijk + centroid + 0.5

    gx = (corners * _corner_sign(0, dev)).sum(dim=-1)
    gy = (corners * _corner_sign(1, dev)).sum(dim=-1)
    gz = (corners * _corner_sign(2, dev)).sum(dim=-1)
    normal = torch.stack([gx, gy, gz], dim=-1)
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-12
    )

    corner_types = torch.stack([cut(vtype, o) for o in _CORNER_OFFSETS], dim=-1)
    w_corner = torch.where(inside, torch.clamp(-corners, min=1e-6), 0.0)
    same = corner_types[..., :, None] == corner_types[..., None, :]
    w_type = torch.where(same, w_corner[..., None, :], 0.0).sum(dim=-1)
    del same
    w_type = torch.where(inside, w_type, -1.0)
    best = torch.argmax(w_type, dim=-1)
    vert_type = _take_last(corner_types, best)
    w1 = _take_last(w_type, best)
    other = corner_types != vert_type[..., None]
    w_other = torch.where(other & inside, w_type, -1.0)
    best2 = torch.argmax(w_other, dim=-1)
    w2 = torch.clamp(_take_last(w_other, best2), min=0.0)
    vert_type2 = torch.where(w2 > 0.0, _take_last(corner_types, best2), vert_type)
    vert_blend = w2 / torch.clamp(w1 + w2, min=1e-9)
    vert_cweight = w_corner / torch.clamp(w_corner.sum(dim=-1, keepdim=True), min=1e-9)

    c = gc * gc * gc
    cell_linear = torch.arange(c, dtype=torch.int64, device=dev).reshape(1, gc, gc, gc)
    cell_linear = cell_linear.expand(nb, gc, gc, gc)

    tris_idx = []
    tris_act = []
    for axis in range(3):
        d0 = sdf[:, 1:gc, 1:gc, 1:gc]
        shifted = [slice(1, gc)] * 3
        shifted[axis] = slice(2, gc + 1)
        d1 = sdf[(slice(None), *shifted)]
        crossing = (d0 < 0.0) != (d1 < 0.0)
        flip = d0 < 0.0

        others = [(axis + 1) % 3, (axis + 2) % 3]
        offs = []
        for u in (-1, 0):
            for v in (-1, 0):
                off = [0, 0, 0]
                off[others[0]] = u
                off[others[1]] = v
                offs.append(off)

        def at(grid, off):
            return grid[(slice(None), *(slice(1 + off[a], gc + off[a]) for a in range(3)))]

        quad = {
            "emit": crossing,
            "flip": flip,
            "c00": at(cell_linear, offs[0]),
            "c01": at(cell_linear, offs[1]),
            "c10": at(cell_linear, offs[2]),
            "c11": at(cell_linear, offs[3]),
        }
        if merge_levels > 0:
            pos_c = [at(vert_pos, o) for o in offs]
            nrm_c = [at(normal, o) for o in offs]
            t_c = [at(vert_type, o) for o in offs]
            t2_c = [at(vert_type2, o) for o in offs]
            b_c = [at(vert_blend, o) for o in offs]
            ct_c = [at(corner_types, o) for o in offs]
            cw_c = [at(vert_cweight, o) for o in offs]
            eps = 1e-3
            uni = (
                (torch.linalg.vector_norm(nrm_c[1] - nrm_c[0], dim=-1) < eps)
                & (torch.linalg.vector_norm(nrm_c[2] - nrm_c[0], dim=-1) < eps)
                & (torch.linalg.vector_norm(nrm_c[3] - nrm_c[0], dim=-1) < eps)
            )
            for k in (1, 2, 3):
                uni = uni & (t_c[k] == t_c[0]) & (t2_c[k] == t2_c[0])
                uni = uni & ((b_c[k] - b_c[0]).abs() < eps)
                uni = uni & torch.all(ct_c[k] == ct_c[0], dim=-1)
                uni = uni & torch.all((cw_c[k] - cw_c[0]).abs() < eps, dim=-1)
            quad.update(
                mergeable=crossing & uni,
                p00=pos_c[0], p01=pos_c[1], p10=pos_c[2], p11=pos_c[3],
            )

        levels = [quad]
        axis_u, axis_v = others[0] + 1, others[1] + 1  # batch axis leads
        for _ in range(merge_levels):
            levels.append(_merge_quads(levels[-1], axis_u, axis_v))

        for q in levels:
            f = q["flip"][..., None]
            t1 = torch.where(
                f,
                torch.stack([q["c00"], q["c11"], q["c01"]], dim=-1),
                torch.stack([q["c00"], q["c01"], q["c11"]], dim=-1),
            )
            t2 = torch.where(
                f,
                torch.stack([q["c00"], q["c10"], q["c11"]], dim=-1),
                torch.stack([q["c00"], q["c11"], q["c10"]], dim=-1),
            )
            tris_idx.append(t1.reshape(nb, -1, 3))
            tris_idx.append(t2.reshape(nb, -1, 3))
            tris_act.append(q["emit"].reshape(nb, -1))
            tris_act.append(q["emit"].reshape(nb, -1))

    return SurfaceNetsMesh(
        vert_active=cell_active.reshape(nb, -1),
        vert_pos=vert_pos.reshape(nb, -1, 3),
        vert_normal=normal.reshape(nb, -1, 3),
        vert_type=vert_type.reshape(nb, -1),
        vert_type2=vert_type2.reshape(nb, -1),
        vert_blend=vert_blend.reshape(nb, -1),
        vert_ctype=corner_types.reshape(nb, -1, 8),
        vert_cweight=vert_cweight.reshape(nb, -1, 8),
        tri_active=torch.cat(tris_act, dim=1),
        tri_indices=torch.cat(tris_idx, dim=1),
    )


def _merge_quads(child, axis_u, axis_v, eps: float = 1e-3):
    """One 2×2 → 1 quad-merge level; clears ``child["emit"]`` where merged."""

    def sub(x, ou, ov):
        nu = (x.shape[axis_u] // 2) * 2
        nv = (x.shape[axis_v] // 2) * 2
        sl = [slice(None)] * x.ndim
        sl[axis_u] = slice(ou, nu, 2)
        sl[axis_v] = slice(ov, nv, 2)
        return x[tuple(sl)]

    A = {k: sub(v, 0, 0) for k, v in child.items()}
    B = {k: sub(v, 0, 1) for k, v in child.items()}
    C = {k: sub(v, 1, 0) for k, v in child.items()}
    D = {k: sub(v, 1, 1) for k, v in child.items()}

    p00, p02, p20, p22 = A["p00"], B["p01"], C["p10"], D["p11"]

    def norm(x):
        return torch.linalg.vector_norm(x, dim=-1)

    def on_mid(p, q, r):
        return norm(p - 0.5 * (q + r)) < eps

    center_ok = norm(A["p11"] - 0.25 * (p00 + p02 + p20 + p22)) < eps
    n = torch.linalg.cross(p02 - p00, p20 - p00)
    n = n / torch.clamp(norm(n)[..., None], min=1e-12)
    coplanar = (n * (p22 - p00)).sum(dim=-1).abs() < eps

    merged = (
        A["mergeable"] & B["mergeable"] & C["mergeable"] & D["mergeable"]
        & (A["flip"] == B["flip"]) & (A["flip"] == C["flip"])
        & (A["flip"] == D["flip"])
        & on_mid(A["p01"], p00, p02)
        & on_mid(C["p11"], p20, p22)
        & on_mid(A["p10"], p00, p20)
        & on_mid(B["p11"], p02, p22)
        & center_ok
        & coplanar
    )

    ex = merged.repeat_interleave(2, dim=axis_u).repeat_interleave(2, dim=axis_v)
    pad = [0, 0] * ex.ndim  # F.pad order: last dim first
    pad[2 * (ex.ndim - 1 - axis_u) + 1] = child["emit"].shape[axis_u] - ex.shape[axis_u]
    pad[2 * (ex.ndim - 1 - axis_v) + 1] = child["emit"].shape[axis_v] - ex.shape[axis_v]
    ex = F.pad(ex.to(torch.uint8), pad).bool()
    child["emit"] = child["emit"] & ~ex

    return {
        "emit": merged,
        "mergeable": merged,
        "flip": A["flip"],
        "c00": A["c00"], "c01": B["c01"], "c10": C["c10"], "c11": D["c11"],
        "p00": p00, "p01": p02, "p10": p20, "p11": p22,
    }


def mesh_counts(mesh: SurfaceNetsMesh):
    """Active vertices and triangles of a mesh (per object when batched)."""
    return mesh.vert_active.sum(dim=-1), mesh.tri_active.sum(dim=-1)


class CompactMesh(NamedTuple):
    """Fixed-capacity mesh with active vertices/triangles packed to the
    front and a corner-major render layout ([:, 3c:3c+3] is corner c)."""

    vert_active: torch.Tensor  # bool[Vc]
    vert_pos: torch.Tensor  # f32[Vc,3] grid units
    vert_normal: torch.Tensor  # f32[Vc,3]
    vert_ctype: torch.Tensor  # i32[Vc,8]
    vert_cweight: torch.Tensor  # f32[Vc,8]
    tri_active: torch.Tensor  # bool[Tc]
    tri_indices: torch.Tensor  # i64[Tc,3] into the compacted vertex slots
    tri_pos: torch.Tensor  # f32[Tc,9] grid units
    tri_normal: torch.Tensor  # f32[Tc,9]
    tri_type: torch.Tensor  # i32[Tc,3]
    tri_albedo: torch.Tensor  # f32[Tc,9] (baked by bake_mesh_materials)
    tri_f0: torch.Tensor  # f32[Tc,9]
    tri_rough: torch.Tensor  # f32[Tc,3]
    tri_emissive: torch.Tensor  # f32[Tc,9]
    n_dropped_verts: torch.Tensor  # i64[]
    n_dropped_tris: torch.Tensor  # i64[]


def _take_rows(x, idx):
    """x [B,N,...] at rows idx [B,K] → [B,K,...]."""
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), dim=1)


def compact_mesh(mesh: SurfaceNetsMesh, vert_cap: int, tri_cap: int) -> CompactMesh:
    """Pack active vertices/triangles into fixed-capacity buffers (stable
    order); overflow is dropped and counted. Takes one mesh or a batch with a
    leading B (the reference's ``compact_mesh_batched``)."""
    if mesh.vert_active.ndim == 1:
        return CompactMesh(*(f[0] for f in compact_mesh(
            SurfaceNetsMesh(*(f[None] for f in mesh)), vert_cap, tri_cap)))
    nb, v = mesh.vert_active.shape
    dev = mesh.vert_active.device
    vorder = torch.argsort((~mesh.vert_active).to(torch.uint8), dim=1, stable=True)
    new_of_old = torch.empty_like(vorder).scatter_(
        1, vorder, torch.arange(v, dtype=torch.int64, device=dev).expand(nb, v))
    vsel = vorder[:, :vert_cap]
    vact = torch.gather(mesh.vert_active, 1, vsel)

    torder = torch.argsort((~mesh.tri_active).to(torch.uint8), dim=1, stable=True)
    tsel = torder[:, :tri_cap]
    tact = torch.gather(mesh.tri_active, 1, tsel)
    tidx = torch.gather(new_of_old, 1, _take_rows(mesh.tri_indices, tsel).reshape(nb, -1))
    tidx = tidx.reshape(nb, -1, 3)
    tact = tact & torch.all(tidx < vert_cap, dim=-1)
    tidx = torch.clamp(tidx, 0, vert_cap - 1)

    vpos = _take_rows(mesh.vert_pos, vsel)
    vnrm = _take_rows(mesh.vert_normal, vsel)
    vtype = torch.gather(mesh.vert_type, 1, vsel)
    flat = tidx.reshape(nb, -1)
    tri_pos = _take_rows(vpos, flat).reshape(nb, -1, 9)
    tri_normal = _take_rows(vnrm, flat).reshape(nb, -1, 9)
    tri_type = torch.gather(vtype, 1, flat).reshape(nb, -1, 3)
    n_t = tidx.shape[1]
    z9 = torch.zeros((nb, n_t, 9), dtype=torch.float32, device=dev)
    return CompactMesh(
        vert_active=vact,
        vert_pos=vpos,
        vert_normal=vnrm,
        vert_ctype=_take_rows(mesh.vert_ctype, vsel),
        vert_cweight=_take_rows(mesh.vert_cweight, vsel),
        tri_active=tact,
        tri_indices=tidx,
        tri_pos=tri_pos,
        tri_normal=tri_normal,
        tri_type=tri_type,
        tri_albedo=z9,
        tri_f0=z9.clone(),
        tri_rough=torch.zeros((nb, n_t, 3), dtype=torch.float32, device=dev),
        tri_emissive=z9.clone(),
        n_dropped_verts=mesh.vert_active.sum(dim=1) - vact.sum(dim=1),
        n_dropped_tris=mesh.tri_active.sum(dim=1) - tact.sum(dim=1),
    )


def bake_mesh_materials(mesh: CompactMesh, material_table) -> CompactMesh:
    """Fill the corner materials from the packed [T,10] table: per vertex the
    exact weighted blend over its ≤8 corner materials, gathered corner-major.
    Works on single [Tc,...] or batched [O,Tc,...] meshes."""
    n_types = material_table.shape[0]
    props = material_table[torch.clamp(mesh.vert_ctype.long(), 0, n_types - 1)]
    vm = (props * mesh.vert_cweight[..., None]).sum(dim=-2)  # [...,Vc,10]
    lead = vm.shape[:-2]
    vc = vm.shape[-2]
    tc3 = mesh.tri_indices.shape[-2] * 3
    idx = torch.clamp(mesh.tri_indices.reshape(lead + (tc3, 1)), 0, vc - 1)
    m = torch.gather(vm, -2, idx.expand(lead + (tc3, 10))).reshape(lead + (tc3 // 3, 3, 10))
    lead_t = m.shape[:-2]
    return mesh._replace(
        tri_albedo=m[..., :, 0:3].reshape(lead_t + (9,)),
        tri_f0=m[..., :, 3:6].reshape(lead_t + (9,)),
        tri_rough=m[..., :, 6],
        tri_emissive=m[..., :, 7:10].reshape(lead_t + (9,)),
    )
