"""Scene compilation: a plain-data scene → the device state the render reads.

Port of ``impact_tpu/runtime/setup.py:compile_scene`` for the component kinds
the tumbler uses — camera, ambient light, shadowable omni and unidirectional
lights, y-up ground planes and voxel boxes — plus ``_build_static_geometry``
and ``render_config_from_engine_config``. Slot layout follows the reference:
voxel object i binds body ``max_bodies - max_voxel_objects + i``; each
object's body origin is moved to its centre of mass (the grid origin
compensates); identical shapes are voxelized and meshed once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..math import quaternion as quatlib
from ..render.camera import Camera
from ..render.lights import LightPools
from ..render.pipeline import RenderConfig, RenderState, init_render_state
from ..scene.assembly import (
    StaticGeometry,
    bake_static_geometry_corners,
    concat_static_geometry,
    empty_static_geometry,
    ground_plane_geometry,
)
from ..scene.materials import VoxelTypeRegistry, default_registry, material_corner_table
from ..utils.config import EngineConfig
from ..voxel import sdf as sdflib
from ..voxel.encoding import encode_sdf_i8, sdf_world
from ..voxel.inertia import mass_and_com
from ..voxel.mesh import CompactMesh, bake_mesh_materials, compact_mesh, surface_nets
from ..voxel.object import VoxelObjectPool, generate_sdf_grid


@dataclass
class SceneBuild:
    """Everything ``HeadlessRuntime.render`` reads (the render-side part of
    the reference's SceneBuildResult: sim.voxels/meshes/bodies/render and
    params.lights/camera/static_geometry/material_table)."""

    pool: VoxelObjectPool
    meshes: CompactMesh  # batched [O, ...]
    body_position: torch.Tensor  # f32[N,3]
    body_orientation: torch.Tensor  # f32[N,4]
    prev_position: torch.Tensor
    prev_orientation: torch.Tensor
    lights: LightPools
    camera: Camera
    static_geometry: StaticGeometry
    material_table: torch.Tensor  # f32[T,10]
    render: RenderState
    info: dict


def _build_static_geometry(ground_planes, device) -> StaticGeometry:
    """Render quads for the y-up planar collidables, baked corner-major."""
    parts = [ground_plane_geometry(y=y, device=device) for y in ground_planes]
    if not parts:
        return empty_static_geometry(device)
    return bake_static_geometry_corners(concat_static_geometry(parts))


def _stack_meshes(meshes):
    return CompactMesh(*(torch.stack(f) for f in zip(*meshes)))


def compile_scene(scene, config: EngineConfig, registry: VoxelTypeRegistry | None = None,
                  device="cuda") -> SceneBuild:
    """Lower a :class:`~impact_tpu_torch.models.scenes.Scene` into device state."""
    dev = torch.device(device)
    registry = registry or default_registry(dev)
    tc = config.tpu
    o_max = tc.max_voxel_objects
    g = tc.voxel_grid_size
    n_regular = tc.max_bodies - o_max
    if n_regular <= 0:
        raise ValueError("max_bodies must exceed max_voxel_objects")
    if len(scene.boxes) > o_max:
        raise ValueError("voxel object pool exhausted")
    i8 = tc.sdf_encoding == "i8"

    position = torch.zeros((tc.max_bodies, 3), device=dev)
    orientation = quatlib.identity((tc.max_bodies,), device=dev)
    alive = torch.zeros(o_max, dtype=torch.bool, device=dev)
    extent = torch.ones(o_max, device=dev)
    origin = torch.zeros((o_max, 3), device=dev)
    if i8:
        sdf = torch.full((o_max, g, g, g), 127, dtype=torch.int8, device=dev)
    else:
        sdf = torch.full((o_max, g, g, g), 1e3, dtype=torch.float32, device=dev)
    vtype = torch.zeros((o_max, g, g, g), dtype=torch.int32, device=dev)
    body_index = torch.arange(o_max, device=dev) + n_regular

    # --- voxel objects (identical shapes voxelized once) ------------------------
    cache: dict = {}
    uniq: list = []  # (sdf codes, vtype, extent)
    uidx = []
    for oi, box in enumerate(scene.boxes):
        ve = float(box.voxel_extent)
        sig = (box.extent_x, box.extent_y, box.extent_z, ve, box.voxel_type)
        if sig not in cache:
            graph = sdflib.box((box.extent_x * ve, box.extent_y * ve, box.extent_z * ve))
            grid, org = generate_sdf_grid(graph, g, ve, device=dev)
            if i8:
                grid = encode_sdf_i8(grid, ve)
            cache[sig] = len(uniq)
            uniq.append((grid, torch.full((g, g, g), int(box.voxel_type), dtype=torch.int32,
                                          device=dev), ve, org))
        ui = cache[sig]
        uidx.append(ui)
        grid, vt, _, org = uniq[ui]
        alive[oi] = True
        extent[oi] = ve
        origin[oi] = org
        sdf[oi] = grid
        vtype[oi] = vt
        bi = n_regular + oi
        position[bi] = torch.tensor(box.position, dtype=torch.float32, device=dev)
        orientation[bi] = torch.tensor(box.orientation, dtype=torch.float32, device=dev)
    casts = torch.tensor([b.casts_shadows for b in scene.boxes]
                         + [True] * (o_max - len(scene.boxes)), device=dev)
    pool = VoxelObjectPool(alive=alive, body_index=body_index, voxel_extent=extent,
                           origin=origin, sdf=sdf, vtype=vtype, casts_shadows=casts)

    # --- body origin at the centre of mass (ref: engine._sync_voxel_bodies) ----
    mass, com = mass_and_com(pool, registry.mass_density)
    sm = (alive & (mass > 1e-9))[:, None]
    new_pos = position[body_index] + quatlib.rotate(orientation[body_index], com)
    position[body_index] = torch.where(sm, new_pos, position[body_index])
    pool = pool._replace(origin=torch.where(sm, pool.origin - com, pool.origin))

    # --- lights + camera ----------------------------------------------------------
    amb = torch.tensor(scene.ambient_illuminance, dtype=torch.float32, device=dev)
    n_omni = max(1, len(scene.omni_lights))
    n_uni = max(1, len(scene.uni_lights))

    def pool_of(n, rows, width, default):
        out = torch.tensor([default] * n, dtype=torch.float32, device=dev)
        for j, r in enumerate(rows):
            out[j] = torch.tensor(r, dtype=torch.float32, device=dev)
        return out if width else out.reshape(n)

    uni_dirs = []
    for u in scene.uni_lights:
        d = torch.tensor(u.direction, dtype=torch.float32)
        uni_dirs.append((d / max(float(torch.linalg.vector_norm(d)), 1e-9)).tolist())
    om, un = scene.omni_lights, scene.uni_lights
    lights = LightPools(
        ambient_luminance=amb / math.pi,
        omni_position=pool_of(n_omni, [o.position for o in om], 3, [0.0] * 3),
        omni_intensity=pool_of(n_omni, [o.luminous_intensity for o in om], 3, [0.0] * 3),
        omni_extent=pool_of(n_omni, [o.source_extent for o in om], 0, 0.0),
        omni_shadowable=torch.tensor([o.shadowable for o in om] + [False] * (n_omni - len(om)),
                                     device=dev),
        omni_mask=torch.tensor([True] * len(om) + [False] * (n_omni - len(om)), device=dev),
        uni_direction=pool_of(n_uni, uni_dirs, 3, [0.0, -1.0, 0.0]),
        uni_illuminance=pool_of(n_uni, [u.perpendicular_illuminance for u in un], 3, [0.0] * 3),
        uni_extent=pool_of(n_uni, [u.angular_source_extent for u in un], 0, 0.0),
        uni_shadowable=torch.tensor([u.shadowable for u in un] + [False] * (n_uni - len(un)),
                                    device=dev),
        uni_mask=torch.tensor([True] * len(un) + [False] * (n_uni - len(un)), device=dev),
    )
    cs = scene.camera
    camera = Camera(
        torch.tensor(cs.position, dtype=torch.float32, device=dev),
        torch.tensor(cs.orientation, dtype=torch.float32, device=dev),
        torch.tensor(cs.vertical_fov, dtype=torch.float32, device=dev),
        torch.tensor(cs.near, dtype=torch.float32, device=dev),
        torch.tensor(cs.far, dtype=torch.float32, device=dev),
    )
    material_table = material_corner_table(registry)

    # --- initial meshes: each distinct shape once, gathered to object slots ----
    vert_cap = tc.mesh_vert_cap or min(4096, (g - 1) ** 3)
    tri_cap = tc.mesh_tri_cap or min(8192, 6 * (g - 1) ** 3)
    entries = [(grid, vt, ve) for grid, vt, ve, _ in uniq]
    if len(scene.boxes) < o_max:  # dead slots share one empty-SDF mesh
        far = torch.full((g, g, g), 127 if i8 else 1e3,
                         dtype=torch.int8 if i8 else torch.float32, device=dev)
        entries.append((far, torch.zeros((g, g, g), dtype=torch.int32, device=dev), 1.0))
        uidx += [len(entries) - 1] * (o_max - len(scene.boxes))
    meshes_u = []
    for grid, vt, ve in entries:
        m = compact_mesh(surface_nets(sdf_world(grid, ve), vt, tc.mesh_merge_levels),
                         vert_cap, tri_cap)
        meshes_u.append(bake_mesh_materials(m, material_table))
    meshes = _stack_meshes([meshes_u[i] for i in uidx])

    render_cfg = render_config_from_engine_config(config)
    info = dict(mesh_vert_cap=vert_cap, mesh_tri_cap=tri_cap,
                n_voxel_objects=len(scene.boxes), n_unique_shapes=len(uniq))
    return SceneBuild(
        pool=pool, meshes=meshes, body_position=position, body_orientation=orientation,
        prev_position=position.clone(), prev_orientation=orientation.clone(),
        lights=lights, camera=camera,
        static_geometry=_build_static_geometry(scene.ground_planes, dev),
        material_table=material_table, render=init_render_state(render_cfg, dev), info=info,
    )


def render_config_from_engine_config(config: EngineConfig) -> RenderConfig:
    r = config.rendering
    cc = r.capturing_camera
    cam = cc.settings
    ev, iso = 0.0, None
    if isinstance(cam.sensitivity, dict):
        ev = cam.sensitivity.get("ev_compensation", 0.0)
        iso = cam.sensitivity.get("iso")
    tone = cc.dynamic_range_compression.tone_mapping_method
    big = config.tpu.render_height >= 720
    return RenderConfig(
        raster_backend=config.tpu.raster_backend,
        view_culling=config.tpu.view_culling,
        exposure_iso=iso,
        relative_aperture=cam.relative_aperture,
        shutter_duration=cam.shutter_duration,
        width=config.tpu.render_width,
        height=config.tpu.render_height,
        shadow_map_resolution=r.shadow_mapping.omnidirectional_light_shadow_map_resolution,
        ao_enabled=r.ambient_occlusion.enabled,
        ao_sample_count=r.ambient_occlusion.sample_count,
        ao_sample_radius=r.ambient_occlusion.sample_radius,
        ao_intensity=r.ambient_occlusion.intensity,
        ao_contrast=r.ambient_occlusion.contrast,
        taa_enabled=r.temporal_anti_aliasing.enabled,
        taa_current_frame_weight=r.temporal_anti_aliasing.current_frame_weight,
        taa_variance_clipping_threshold=r.temporal_anti_aliasing.variance_clipping_threshold,
        bloom_enabled=cc.bloom.enabled,
        bloom_n_downsamplings=cc.bloom.n_downsamplings,
        bloom_blurred_luminance_weight=cc.bloom.blurred_luminance_weight,
        exposure_ev_compensation=ev,
        exposure_lower=cam.exposure_bounds.lower,
        exposure_upper=cam.exposure_bounds.upper,
        luminance_lower=cc.average_luminance_computation.luminance_bounds.lower,
        luminance_upper=cc.average_luminance_computation.luminance_bounds.upper,
        exposure_current_frame_weight=cc.average_luminance_computation.current_frame_weight,
        tone_mapping="None" if tone is None else tone,
        shadows_enabled=r.shadow_mapping.enabled,
        csm_cascades=config.tpu.csm_cascades,
        max_triangles=config.tpu.max_render_triangles,
        shadow_pcf_downsample=2 if big else 1,
        ao_downsample=2 if big else 1,
        procedural_sky=config.tpu.procedural_sky,
        orthographic=config.tpu.orthographic_camera,
        sky_luminance=tuple(config.tpu.sky_luminance),
    )
