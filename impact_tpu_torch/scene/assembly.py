"""Per-frame render-scene assembly (port of ``impact_tpu/scene/assembly.py``;
ref: impact_scene lib.rs:160).

Each voxel object's compacted, material-baked mesh (or, in chunked mode,
each chunk-submesh slot) is transformed by its rigid body's current and
previous pose, the static geometry's corner-major fields (baked once at
setup) are appended, and so are the mesh-model entities, each posed by its
rigid body (or its static frame) — elementwise work only, no per-frame
triangle-index gathers."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import quaternion as quat
from ..render.pipeline import RenderScene
from ..voxel.chunk_mesh import ChunkMeshPool, chunk_mesh_scene_fields
from ..voxel.mesh import CompactMesh
from ..voxel.object import VoxelObjectPool


class StaticGeometry(NamedTuple):
    """Non-voxel geometry (ground planes) with its corner-major bake."""

    vert_pos: torch.Tensor  # f32[Vs,3] world
    vert_normal: torch.Tensor  # f32[Vs,3]
    vert_albedo: torch.Tensor  # f32[Vs,3]
    vert_f0: torch.Tensor  # f32[Vs,3]
    vert_roughness: torch.Tensor  # f32[Vs]
    vert_emissive: torch.Tensor  # f32[Vs,3]
    vert_material: torch.Tensor  # i32[Vs]
    tri_indices: torch.Tensor  # i64[Ts,3]
    tri_active: torch.Tensor  # bool[Ts]
    corners: dict | None = None  # tri_pos/tri_normal/... [Ts,9|3]


class MeshInstancePool(NamedTuple):
    """Renderable mesh-model entities with uniform materials (ref:
    impact_model lib.rs:25-50, impact_material setup/physical.rs:36-214): a
    fixed-capacity pool of local-space meshes, each posed per frame by its
    rigid body (``body_index`` ≥ 0) or its static frame."""

    vert_pos: torch.Tensor  # f32[M,Vm,3] local
    vert_normal: torch.Tensor  # f32[M,Vm,3]
    vert_active: torch.Tensor  # bool[M,Vm]
    tri_indices: torch.Tensor  # i64[M,Tm,3]
    tri_active: torch.Tensor  # bool[M,Tm]
    albedo: torch.Tensor  # f32[M,3]
    f0: torch.Tensor  # f32[M,3]
    roughness: torch.Tensor  # f32[M]
    emissive: torch.Tensor  # f32[M,3]
    body_index: torch.Tensor  # i64[M] rigid body slot, -1 = static pose
    position: torch.Tensor  # f32[M,3] static pose
    orientation: torch.Tensor  # f32[M,4]
    alive: torch.Tensor  # bool[M]
    casts_shadows: torch.Tensor  # bool[M]
    material: torch.Tensor | None = None  # i32[M] texture layer, -1 = uniform only
    corner_pos: torch.Tensor | None = None  # f32[M,Tm,9] local, baked at setup
    corner_normal: torch.Tensor | None = None  # f32[M,Tm,9]


def empty_mesh_instances(m: int, vm: int, tm: int, device="cuda") -> MeshInstancePool:
    return MeshInstancePool(
        vert_pos=torch.zeros((m, vm, 3), device=device),
        vert_normal=torch.zeros((m, vm, 3), device=device),
        vert_active=torch.zeros((m, vm), dtype=torch.bool, device=device),
        tri_indices=torch.zeros((m, tm, 3), dtype=torch.int64, device=device),
        tri_active=torch.zeros((m, tm), dtype=torch.bool, device=device),
        albedo=torch.zeros((m, 3), device=device),
        f0=torch.zeros((m, 3), device=device),
        roughness=torch.ones(m, device=device),
        emissive=torch.zeros((m, 3), device=device),
        body_index=torch.full((m,), -1, dtype=torch.int64, device=device),
        position=torch.zeros((m, 3), device=device),
        orientation=torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device).repeat(m, 1),
        alive=torch.zeros(m, dtype=torch.bool, device=device),
        casts_shadows=torch.ones(m, dtype=torch.bool, device=device),
        material=torch.full((m,), -1, dtype=torch.int32, device=device),
    )


def bake_mesh_instance_corners(mi: MeshInstancePool) -> MeshInstancePool:
    """Corner-major local geometry of a finished pool, gathered once at
    setup: the frame then reads ``corner_pos``/``corner_normal``."""
    m, tm = mi.tri_indices.shape[:2]
    rows = torch.arange(m, device=mi.vert_pos.device)[:, None, None]
    return mi._replace(corner_pos=mi.vert_pos[rows, mi.tri_indices].reshape(m, tm, 9),
                       corner_normal=mi.vert_normal[rows, mi.tri_indices].reshape(m, tm, 9))


def empty_static_geometry(device="cuda") -> StaticGeometry:
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
    return StaticGeometry(
        vert_pos=z3, vert_normal=z3, vert_albedo=z3, vert_f0=z3,
        vert_roughness=torch.zeros(0, device=device), vert_emissive=z3,
        vert_material=torch.zeros(0, dtype=torch.int32, device=device),
        tri_indices=torch.zeros((0, 3), dtype=torch.int64, device=device),
        tri_active=torch.zeros(0, dtype=torch.bool, device=device),
    )


def ground_plane_geometry(y: float = 0.0, half_size: float = 100.0,
                          albedo=(0.35, 0.35, 0.38), roughness: float = 0.9,
                          device="cuda") -> StaticGeometry:
    """A 2-triangle y-up quad wound so its +y face survives backface culling."""
    v = torch.tensor([[-half_size, y, -half_size], [half_size, y, -half_size],
                      [half_size, y, half_size], [-half_size, y, half_size]],
                     dtype=torch.float32, device=device)
    return StaticGeometry(
        vert_pos=v,
        vert_normal=torch.tensor([[0.0, 1.0, 0.0]], device=device).repeat(4, 1),
        vert_albedo=torch.tensor([albedo], dtype=torch.float32, device=device).repeat(4, 1),
        vert_f0=torch.full((4, 3), 0.04, device=device),
        vert_roughness=torch.full((4,), roughness, device=device),
        vert_emissive=torch.zeros((4, 3), device=device),
        vert_material=torch.full((4,), -1, dtype=torch.int32, device=device),
        tri_indices=torch.tensor([[0, 2, 1], [0, 3, 2]], device=device),
        tri_active=torch.ones(2, dtype=torch.bool, device=device),
    )


def concat_static_geometry(parts) -> StaticGeometry:
    """Concatenate StaticGeometry parts with vertex-index offsets."""
    out = parts[0]
    for p in parts[1:]:
        base = out.vert_pos.shape[0]
        out = StaticGeometry(*(torch.cat([a, b]) for a, b in zip(out[:7], p[:7])),
                             tri_indices=torch.cat([out.tri_indices, p.tri_indices + base]),
                             tri_active=torch.cat([out.tri_active, p.tri_active]))
    return out


def bake_static_geometry_corners(sg: StaticGeometry) -> StaticGeometry:
    """Precompute the corner-major field dict once at setup."""
    ti = sg.tri_indices

    def g(a):
        parts = [a[ti[:, c]] for c in range(3)]
        return torch.stack(parts, dim=-1) if a.ndim == 1 else torch.cat(parts, dim=-1)

    pos = g(sg.vert_pos)
    return sg._replace(corners=dict(
        tri_pos=pos, tri_pos_prev=pos, tri_normal=g(sg.vert_normal),
        tri_albedo=g(sg.vert_albedo), tri_f0=g(sg.vert_f0),
        tri_roughness=g(sg.vert_roughness), tri_emissive=g(sg.vert_emissive),
        tri_material=g(sg.vert_material),
    ))


def static_geometry_corners(sg: StaticGeometry) -> dict:
    if sg.corners is None:
        sg = bake_static_geometry_corners(sg)
    return dict(**sg.corners, tri_active=sg.tri_active,
                tri_shadow=torch.ones_like(sg.tri_active))


def _rotate9(q, pos9):
    return torch.cat([quat.rotate(q, pos9[..., 3 * c:3 * c + 3]) for c in range(3)], dim=-1)


def _mesh_instance_corners(mi: MeshInstancePool, body_position, body_orientation,
                           body_position_prev, body_orientation_prev) -> dict:
    """Posed corner-major fields of the mesh-model entities, current and
    previous pose (ref: impact_model transform.rs)."""
    m, tm = mi.tri_active.shape
    use_body = (mi.body_index >= 0)[:, None]
    bi = torch.clamp(mi.body_index, min=0)
    q = torch.where(use_body, body_orientation[bi], mi.orientation)[:, None, :]
    x = torch.where(use_body, body_position[bi], mi.position)
    qp = torch.where(use_body, body_orientation_prev[bi], mi.orientation)[:, None, :]
    xp = torch.where(use_body, body_position_prev[bi], mi.position)
    local9, nrm9 = mi.corner_pos, mi.corner_normal
    if local9 is None:
        baked = bake_mesh_instance_corners(mi)
        local9, nrm9 = baked.corner_pos, baked.corner_normal
    world9 = _rotate9(q, local9) + x.repeat(1, 3)[:, None, :]
    world9_prev = _rotate9(qp, local9) + xp.repeat(1, 3)[:, None, :]
    tri_ok = mi.tri_active & mi.alive[:, None]

    def per_tri9(a):  # [M,3] uniform → [M*Tm, 9]
        return a.repeat(1, 3)[:, None, :].expand(m, tm, 9).reshape(-1, 9)

    return dict(
        tri_pos=world9.reshape(-1, 9),
        tri_pos_prev=world9_prev.reshape(-1, 9),
        tri_normal=_rotate9(q, nrm9).reshape(-1, 9),
        tri_albedo=per_tri9(mi.albedo),
        tri_f0=per_tri9(mi.f0),
        tri_roughness=mi.roughness[:, None, None].expand(m, tm, 3).reshape(-1, 3),
        tri_emissive=per_tri9(mi.emissive),
        tri_material=mi.material[:, None, None].expand(m, tm, 3).reshape(-1, 3),
        tri_active=tri_ok.reshape(-1),
        tri_shadow=(tri_ok & mi.casts_shadows[:, None]).reshape(-1),
    )


def build_render_scene(pool: VoxelObjectPool, meshes: CompactMesh, body_position,
                       body_orientation, body_position_prev, body_orientation_prev,
                       static_geometry: StaticGeometry,
                       mesh_instances: MeshInstancePool | None = None,
                       tris_per_object: int = 0,
                       voxel_texture_layers: bool = True) -> RenderScene:
    """Flatten voxel meshes [O,Tc,...], static geometry and the mesh-model
    entities into one corner-major RenderScene. ``tris_per_object`` > 0
    keeps only each object's leading triangle slots (compaction packs
    actives to the front). ``meshes`` may be a ChunkMeshPool: its slots are
    surface chunks already, so the per-object slice does not apply. Voxel
    corners carry their voxel type as texture layer, or −1 (untextured)
    when ``voxel_texture_layers`` is off (the scene's texture set then has
    no voxel-type layers, as with ``tpu.textured_voxels`` off)."""
    extra = []
    if static_geometry.tri_active.shape[0] > 0:
        extra.append(static_geometry_corners(static_geometry))
    if mesh_instances is not None and mesh_instances.alive.shape[0] > 0:
        extra.append(_mesh_instance_corners(mesh_instances, body_position, body_orientation,
                                            body_position_prev, body_orientation_prev))
    if isinstance(meshes, ChunkMeshPool):
        voxel = chunk_mesh_scene_fields(meshes, pool, body_position, body_orientation,
                                        body_position_prev, body_orientation_prev)
        if not voxel_texture_layers:
            voxel["tri_material"] = torch.full_like(voxel["tri_material"], -1)
        return _concat_scene([voxel] + extra)
    if 0 < tris_per_object < meshes.tri_pos.shape[1]:
        k = tris_per_object
        meshes = meshes._replace(**{
            f: getattr(meshes, f)[:, :k]
            for f in ("tri_active", "tri_pos", "tri_normal", "tri_type", "tri_type2",
                      "tri_blend", "tri_albedo", "tri_f0", "tri_rough", "tri_emissive")
        })
    local9 = (meshes.tri_pos * pool.voxel_extent[:, None, None]
              + pool.origin.repeat(1, 3)[:, None, :])
    bi = pool.body_index
    q = body_orientation[bi][:, None, :]
    x = body_position[bi].repeat(1, 3)[:, None, :]
    qp = body_orientation_prev[bi][:, None, :]
    xp = body_position_prev[bi].repeat(1, 3)[:, None, :]
    world9 = _rotate9(q, local9) + x
    world9_prev = _rotate9(qp, local9) + xp
    normal9 = _rotate9(q, meshes.tri_normal)
    tri_ok = meshes.tri_active & pool.alive[:, None]
    if voxel_texture_layers:
        mat3 = torch.where(tri_ok[..., None], meshes.tri_type, -1)
    else:
        mat3 = torch.full_like(meshes.tri_type, -1)
    voxel = dict(
        tri_pos=world9.reshape(-1, 9),
        tri_pos_prev=world9_prev.reshape(-1, 9),
        tri_normal=normal9.reshape(-1, 9),
        tri_albedo=meshes.tri_albedo.reshape(-1, 9),
        tri_f0=meshes.tri_f0.reshape(-1, 9),
        tri_roughness=meshes.tri_rough.reshape(-1, 3),
        tri_emissive=meshes.tri_emissive.reshape(-1, 9),
        tri_material=mat3.reshape(-1, 3),
        tri_active=tri_ok.reshape(-1),
        tri_shadow=(tri_ok & pool.casts_shadows[:, None]).reshape(-1),
    )
    return _concat_scene([voxel] + extra)


def _concat_scene(parts) -> RenderScene:
    return RenderScene(**{k: torch.cat([p[k].to(parts[0][k].dtype) for p in parts])
                          for k in parts[0]})


def render_scene_from_indexed(vert_pos, vert_normal, vert_albedo, vert_f0, vert_roughness,
                              vert_emissive, vert_material, tri_indices, tri_active,
                              tri_shadow=None) -> RenderScene:
    """A corner-major RenderScene from indexed geometry (one-off paths such
    as the voxel generator's preview)."""
    t = tri_indices.long()

    def corners(a):
        parts = [a[t[:, c]] for c in range(3)]
        return torch.stack(parts, dim=-1) if a.ndim == 1 else torch.cat(parts, dim=-1)

    pos = corners(vert_pos)
    return RenderScene(
        tri_pos=pos, tri_pos_prev=pos, tri_normal=corners(vert_normal),
        tri_albedo=corners(vert_albedo), tri_f0=corners(vert_f0),
        tri_roughness=corners(vert_roughness), tri_emissive=corners(vert_emissive),
        tri_material=corners(vert_material), tri_active=tri_active,
        tri_shadow=tri_active if tri_shadow is None else tri_shadow,
    )
