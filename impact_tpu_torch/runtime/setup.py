"""Scene compilation: an ECS world → the simulation state and the scene
constants (port of ``impact_tpu/runtime/setup.py``; ref: engine/src/
setup.rs:18-69, the entity-setup pipeline).

``compile_scene(world, config)`` takes a :class:`~impact_tpu_torch.ecs.World`
as the reference's does. ``scene.spec.lower_world`` first reads the world in
the reference's passes and order into the lowered records of
``scene/spec.py`` (stripping the setup components it consumed), and the
compile turns those into device state: camera, ambient light, omni and
unidirectional lights (plain or shadowable), voxel boxes, spheres,
capsules, sphere unions and generated objects (an SDF graph from
``sdf_generators``, atomic or lowered from a meta graph by
``voxel.meta_sdf.lower``; dynamic, or static ones that start kinematic) with motion,
contact response, gravity, fracture properties, a multifractal noise
modifier and noise-mixed voxel types, regular bodies (dynamic by substance,
with analytic mass and inertia, or by explicit inertia, else kinematic;
sphere, capsule and plane collidables, phantoms included; constant
acceleration, local forces, dynamic gravity, detailed drag with its
drag-load map, alignment torques; the circular, harmonic, rotation and
orbital drivers; absorbing spheres and capsules), box, sphere,
hemisphere, cylinder, cone, capsule and rectangle mesh entities and OBJ/PLY
mesh files (registered by path with :func:`register_mesh_file`) with
uniform or textured materials (lowered into
texture-array layers, textures resolved by their FNV-1a ids through
:func:`register_texture`), spherical joints, distance rules and the
perspective or orthographic camera (which sets
``config.tpu.orthographic_camera``, as the reference's does) — plus
``_build_static_geometry`` and ``render_config_from_engine_config``. A
scene may be empty (no voxel object, no triangle). Slot layout and order
follow the reference: voxel object i binds body ``max_bodies -
max_voxel_objects + i``; the regular bodies take bodies 0, 1, ... in
entity order, and so do their collidables, forces, drivers and absorbers
within each pool; mesh entities take mesh-instance slots in entity order;
forces are applied once before the voxel bodies' mass sync (so the first
step's accumulated gravity uses the default unit mass, as the reference's
does); each object's body origin is moved to its centre of mass; identical
shapes are voxelized once. Floats come from the world's float32 columns, as
the reference's do. On chunked grids the surfaces are meshed into the
shared chunk-submesh pool in budgeted passes, and a pool too small for the
scene's surface chunks raises, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..physics.collision import CollidablePools
from ..physics.drag_map import get_or_build_drag_load_map
from ..physics.driven_motion import MotionDriverPools, empty_motion_driver_pools
from ..physics.forces import apply_forces_and_torques, empty_force_pools
from ..physics.inertia import capsule_inertia, capsule_mass, sphere_inertia, sphere_mass
from ..physics.solver import JointPools, empty_joint_pools
from ..physics.state import KIND_DYNAMIC, KIND_KINEMATIC, synchronize_momenta
from ..physics.step import PhysicsParams, init_physics_state
from ..render.camera import Camera, look_at
from ..render.lights import LightPools
from ..render.pipeline import RenderConfig, init_render_state
from ..scene import mesh as meshlib
from ..scene.assembly import (
    MeshInstancePool,
    StaticGeometry,
    bake_mesh_instance_corners,
    bake_static_geometry_corners,
    concat_static_geometry,
    empty_mesh_instances,
    empty_static_geometry,
    ground_plane_geometry,
)
from ..scene.materials import (
    VoxelTypeRegistry,
    default_registry,
    material_corner_table,
    registry_to,
)
from ..scene.spec import (
    CameraSpec,
    CircularTrajectorySpec,
    ConstantRotationSpec,
    HarmonicOscillationSpec,
    MeshSpec,
    OrbitalTrajectorySpec,
    lower_world,
)
from ..utils.hashing import hash_str_to_u64
from ..utils.config import EngineConfig
from ..voxel import sdf as sdflib
from ..voxel.chunk_mesh import (
    empty_chunk_mesh_pool,
    mark_objects_dirty,
    n_chunks_per_object,
    remesh_chunks,
)
from ..voxel.collision import extract_probes
from ..voxel.encoding import encode_sdf_i8, sdf_world
from ..voxel.interaction import empty_absorber_pools
from ..voxel.mesh import CompactMesh, bake_mesh_materials, compact_mesh, surface_nets
from ..voxel.object import VoxelObjectPool, generate_sdf_grid
from .engine import (
    DistanceRulePools,
    EngineParams,
    SimState,
    _sync_voxel_bodies,
    empty_distance_rule_pools,
)


@dataclass
class SceneBuild:
    """The compiled scene: ``sim`` (the state the engine step advances),
    ``params`` (scene constants) and ``info``. The properties name the parts
    the render reads."""

    sim: SimState
    params: EngineParams
    info: dict

    @property
    def pool(self):
        return self.sim.voxels

    @property
    def meshes(self):
        return self.sim.meshes

    @property
    def body_position(self):
        return self.sim.phys.bodies.position

    @property
    def body_orientation(self):
        return self.sim.phys.bodies.orientation

    @property
    def lights(self):
        return self.params.lights

    @property
    def camera(self):
        return self.params.camera


# OBJ/PLY files referenced by TriangleMeshFile components, keyed by the FNV-1a
# hash of their path (ref: impact_mesh path-hash mesh ids, io/{obj,ply}.rs)
MESH_FILE_PATHS: dict[int, str] = {}



# the reference's name of the compiled scene (same fields, same order)
SceneBuildResult = SceneBuild

def register_mesh_file(path) -> int:
    """Register an OBJ or PLY file for TriangleMeshFile setup; returns the
    FNV-1a hash of its path, the component's ``path_hash``."""
    h = int(hash_str_to_u64(str(path)))
    MESH_FILE_PATHS[h] = str(path)
    return h


# Texture sources referenced by the Textured*/NormalMap/ParallaxMap setup
# components, keyed by the FNV-1a hash of their name (ref: impact_texture
# TextureID = hash of the texture name)
TEXTURE_SOURCES: dict[int, object] = {}


def register_texture(name: str, source) -> int:
    """Register a texture for the textured-material setup components;
    returns its FNV-1a id. ``source``: an image file path (JPEG, or PNG of
    any kind) or its bytes, or a float array [H,W] or [H,W,C] in [0,1]."""
    h = int(hash_str_to_u64(str(name)))
    TEXTURE_SOURCES[h] = source
    return h


def _build_static_geometry(ground_planes, device, user_geometry=None) -> StaticGeometry:
    """The caller's static geometry, then render quads for the y-up planar
    collidables, baked corner-major."""
    parts = [] if user_geometry is None else [user_geometry]
    parts += [ground_plane_geometry(y=y, device=device) for y in ground_planes]
    if not parts:
        return empty_static_geometry(device)
    return bake_static_geometry_corners(concat_static_geometry(parts))


def _stack_meshes(meshes):
    return CompactMesh(*(torch.stack(f) for f in zip(*meshes)))


def _collidable_pools(spheres, planes, capsules, n_bodies: int, dev) -> CollidablePools:
    """Collidable pools trimmed to the scene's counts (at least one slot of
    each family, masked off when unused), as the reference trims them.
    Each family is a list of (body, spec) in slot order."""
    caps = {"sphere": min(64, n_bodies), "plane": 8, "capsule": 16}
    for name, fam in (("sphere", spheres), ("plane", planes), ("capsule", capsules)):
        if len(fam) > caps[name]:
            raise ValueError(f"{name} collidable pool exhausted ({caps[name]} slots)")

    def col(fam, get, width=0, fill=0.0, dtype=torch.float32):
        n = max(1, len(fam))
        row = fill if isinstance(fill, list) else [fill] * width if width else fill
        out = torch.tensor([row] * n, dtype=dtype, device=dev)
        for j, (bi, c) in enumerate(fam):
            v = get(bi, c)
            out[j] = torch.tensor([_f32(e) for e in v] if width else v, dtype=dtype)
        return out

    def body(fam):
        return col(fam, lambda bi, c: bi, dtype=torch.int64)

    def kind(fam, default):
        return col(fam, lambda bi, c: int(c.kind), fill=default, dtype=torch.int32)

    def resp(fam):
        return col(fam, lambda bi, c: c.response, 3)

    def mask(fam):
        return col(fam, lambda bi, c: True, fill=False, dtype=torch.bool)

    return CollidablePools(
        sph_body=body(spheres), sph_center=col(spheres, lambda bi, c: c.center, 3),
        sph_radius=col(spheres, lambda bi, c: _f32(c.radius), fill=1.0),
        sph_kind=kind(spheres, 0), sph_response=resp(spheres), sph_mask=mask(spheres),
        pln_body=body(planes),
        pln_normal=col(planes, lambda bi, c: c.normal, 3, fill=[0.0, 1.0, 0.0]),
        pln_disp=col(planes, lambda bi, c: _f32(c.displacement)),
        pln_kind=kind(planes, 1), pln_response=resp(planes), pln_mask=mask(planes),
        cap_body=body(capsules), cap_start=col(capsules, lambda bi, c: c.segment_start, 3),
        cap_end=col(capsules, lambda bi, c: c.segment_end, 3),
        cap_radius=col(capsules, lambda bi, c: _f32(c.radius), fill=1.0),
        cap_kind=kind(capsules, 0), cap_response=resp(capsules), cap_mask=mask(capsules),
    )


def _resolve_texture(textures: dict, tid, resolution: int, srgb: bool):
    """A texture by id → float [S,S,C]: image files are decoded (sRGB to
    linear when ``srgb``) and Lanczos-resized, arrays resized
    nearest-neighbour, as the reference resolves a registered texture id.
    An id that was never registered raises KeyError."""
    from ..render.textures import _resize_nearest, load_image_layer

    if tid not in textures:
        raise KeyError(f"texture id {tid:#x} not registered (register_texture)")
    src = textures[tid]
    if isinstance(src, (str, bytes)):
        return load_image_layer(src, resolution=resolution, srgb=srgb)
    arr = np.asarray(src, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[:2] != (resolution, resolution):
        arr = _resize_nearest(arr, resolution)
    return arr


def _entity_layer(mat, textures: dict, size: int):
    """Lower a textured material into one texture-array layer (albedo,
    normal, props) with the scale factors baked in; untextured properties
    take their uniform values (ref: runtime/setup.py:912-972)."""
    from ..render.textures import build_entity_material_layer

    def prop(tex, uniform):
        if tex is None:
            return uniform
        name, scale = tex
        return _resolve_texture(textures, name, size, srgb=False)[..., 0] * _f32(scale)

    height = None
    if mat.parallax_map is not None:
        name, disp = mat.parallax_map
        height = _resolve_texture(textures, name, size, srgb=False)[..., 0] * _f32(disp)
    color = (_resolve_texture(textures, mat.color_texture, size, srgb=True)
             if mat.color_texture is not None else np.asarray(mat.color, np.float32))
    normal = (_resolve_texture(textures, mat.normal_map, size, srgb=False)
              if mat.normal_map is not None else None)
    return build_entity_material_layer(
        size, color=color, normal=normal,
        roughness=prop(mat.roughness_texture, _f32(mat.roughness)),
        metalness=prop(mat.metalness_texture, _f32(mat.metalness)),
        specular=prop(mat.specular_texture, _f32(mat.specular)),
        emissive=prop(mat.emissive_texture, _f32(mat.emissive)), height=height)


def _mesh_geometry(spec: MeshSpec):
    """The entity's local mesh (positions scaled and offset), made as the
    reference makes it (``impact_tpu/runtime/setup.py:491-535``)."""
    shape, nc = spec.shape, int(spec.n_circumference_vertices)
    if shape == "box":
        tri = meshlib.box_mesh(tuple(_f32(e) for e in spec.extents))
    elif shape in ("sphere", "hemisphere"):
        n = int(spec.n_rings)
        make = meshlib.sphere_mesh if shape == "sphere" else meshlib.hemisphere_mesh
        tri = make(1.0, n, 2 * n + 2)
    elif shape in ("cylinder", "cone"):
        make = meshlib.cylinder_mesh if shape == "cylinder" else meshlib.cone_mesh
        length = _f32(spec.length)
        tri = make(0.5 * _f32(spec.diameter), length, nc)
        # the reference's convention: the base centred at the origin
        tri = tri._replace(positions=tri.positions
                           + np.array([0.0, 0.5 * length, 0.0], np.float32))
    elif shape == "capsule":
        tri = meshlib.capsule_mesh(0.5 * _f32(spec.diameter), _f32(spec.segment_length),
                                   max(4, nc // 2), nc)
    elif shape == "rectangle":
        tri = meshlib.rectangle_mesh(*(_f32(e) for e in spec.extents))
    elif shape == "file":
        tri = (meshlib.load_ply(spec.path) if spec.path.endswith(".ply")
               else meshlib.load_obj(spec.path))
    else:
        raise ValueError(f"unknown mesh shape {shape!r}")
    pos = tri.positions * np.float32(spec.scale) + np.asarray(spec.offset, np.float32)
    return pos, tri.normals, tri.indices


def _mesh_instances(records, scene_textures: dict, tc, dev):
    """The mesh-instance pool of the scene's count, corners baked, and the
    textured entities' layers. ``records``: (MeshSpec, body or −1,
    position, orientation) in slot order. A material's albedo, f0 and
    emissive follow the reference's metal/dielectric mix."""
    vm_cap, tm_cap = tc.max_mesh_entity_verts, tc.max_mesh_entity_tris
    if len(records) > tc.max_mesh_entities:
        raise ValueError("mesh-entity pool exhausted (tpu.max_mesh_entities)")
    f = empty_mesh_instances(len(records), vm_cap, tm_cap, dev)._asdict()
    layers = []
    for mi, (spec, bi, position, orientation) in enumerate(records):
        pos, nrm, idx = _mesh_geometry(spec)
        nv, nt = pos.shape[0], idx.shape[0]
        if nv > vm_cap or nt > tm_cap:
            raise ValueError(f"mesh entity exceeds caps: {nv} verts/{nt} tris "
                             f"(tpu.max_mesh_entity_verts/_tris)")
        mat = spec.material
        color = np.asarray([_f32(c) for c in mat.color], np.float32)
        metal, spec_r = _f32(mat.metalness), _f32(mat.specular)
        f["vert_pos"][mi, :nv] = torch.from_numpy(pos).to(dev)
        f["vert_normal"][mi, :nv] = torch.from_numpy(nrm).to(dev)
        f["vert_active"][mi, :nv] = True
        f["tri_indices"][mi, :nt] = torch.from_numpy(idx).to(dev).long()
        f["tri_active"][mi, :nt] = True
        f["albedo"][mi] = torch.from_numpy(color * (1.0 - metal))
        f["f0"][mi] = torch.from_numpy(np.full(3, spec_r, np.float32) * (1.0 - metal)
                                       + color * metal)
        f["roughness"][mi] = _f32(mat.roughness)
        f["emissive"][mi] = torch.from_numpy(color * _f32(mat.emissive))
        f["body_index"][mi] = bi
        f["position"][mi] = torch.tensor([_f32(e) for e in position])
        f["orientation"][mi] = torch.tensor([_f32(e) for e in orientation])
        f["alive"][mi] = True
        f["casts_shadows"][mi] = bool(spec.casts_shadows)
        if mat.textured:
            layers.append(_entity_layer(mat, scene_textures, tc.texture_resolution))
            f["material"][mi] = len(layers) - 1
    return bake_mesh_instance_corners(MeshInstancePool(**f)), layers


def _f32(x) -> float:
    return float(np.float32(x))


def _fill_driver(drivers: dict, d, bi: int, slot, vec):
    """Write motion driver ``d`` (a scene.spec *Spec) of body ``bi`` into the
    next slot of its pool (ref: runtime/setup.py:777-827)."""
    if isinstance(d, CircularTrajectorySpec):
        key, vals = "circ", dict(center=vec(d.center), radius=_f32(d.radius),
                                 speed=_f32(d.angular_speed), axis=vec(d.axis),
                                 phase=_f32(d.phase))
    elif isinstance(d, HarmonicOscillationSpec):
        key, vals = "osc", dict(center=vec(d.center), dir=vec(d.direction),
                                amplitude=_f32(d.amplitude), period=_f32(d.period),
                                phase=_f32(d.phase))
    elif isinstance(d, ConstantRotationSpec):
        key, vals = "rot", dict(q0=vec(d.initial_orientation), omega=vec(d.angular_velocity))
    elif isinstance(d, OrbitalTrajectorySpec):
        key, vals = "orb", dict(focus=vec(d.focal_position), a=_f32(d.semi_major_axis),
                                e=_f32(d.eccentricity), period=_f32(d.orbital_period),
                                orient=vec(d.orientation), phase=_f32(d.phase))
    else:
        raise ValueError(f"unknown motion driver {d!r}")
    j = slot(key)
    drivers[f"{key}_body"][j] = bi
    for name, v in vals.items():
        drivers[f"{key}_{name}"][j] = v
    drivers[f"{key}_mask"][j] = True


def _entity_bodies(n_regular: int):
    """(list name, index) → body slot, for joints and distance rules."""
    first = {"rigid_body": 0, "voxel_object": n_regular}

    def body_of(ref):
        kind_, i = ref
        return first[kind_] + i

    return body_of


def _joint_pools(specs, body_of, dev):
    """The spherical joints (ref: runtime/setup.py:864-877), 16 slots."""
    f = {k: v.clone() for k, v in empty_joint_pools(device=dev)._asdict().items()}
    if len(specs) > f["mask"].shape[0]:
        raise ValueError("joint pool exhausted")
    for j, sj in enumerate(specs):
        f["body_a"][j], f["body_b"][j] = body_of(sj.entity_a), body_of(sj.entity_b)
        f["anchor_a"][j] = torch.tensor([_f32(e) for e in sj.anchor_a])
        f["anchor_b"][j] = torch.tensor([_f32(e) for e in sj.anchor_b])
        f["mask"][j] = True
    return JointPools(**f)


def _distance_rule_pools(rules, body_of, dev):
    """The distance-triggered rules (ref: runtime/setup.py:879-898), 16
    slots; a rule on a voxel object also names its object slot."""
    f = {k: v.clone() for k, v in empty_distance_rule_pools(device=dev)._asdict().items()}
    if len(rules) > f["mask"].shape[0]:
        raise ValueError("distance-rule pool exhausted")
    for j, r in enumerate(rules):
        f["body"][j], f["anchor_body"][j] = body_of(r.entity), body_of(r.anchor)
        f["obj_slot"][j] = r.entity[1] if r.entity[0] == "voxel_object" else -1
        f["no_shadow_d2"][j] = _f32(r.no_shadowing_dist_squared)
        f["removal_d2"][j] = _f32(r.removal_dist_squared)
        f["mask"][j] = True
    return DistanceRulePools(**f)


def _object_grids(ob, g: int, i8: bool, dev):
    """SDF grid (i8 codes or f32), voxel types and origin of one object."""
    ve = _f32(ob.voxel_extent)
    graph = ob.graph
    n = ob.noise
    if n is not None:
        graph = sdflib.noise_modifier(graph, int(n.octaves), _f32(n.frequency),
                                      _f32(n.lacunarity), _f32(n.persistence),
                                      _f32(n.amplitude), int(n.seed) & 0xFFFFFFFF)
    grid, org = generate_sdf_grid(graph, g, ve, device=dev)
    if i8:
        grid = encode_sdf_i8(grid, ve)
    gn = ob.voxel_types
    if gn is None:
        vt = torch.full((g, g, g), int(ob.voxel_type), dtype=torch.int32, device=dev)
    else:
        # lattice corners (not voxel centres), as the reference samples them
        r = torch.arange(g, dtype=torch.float32, device=dev)
        coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1) * ve
        noise = sdflib.gradient_noise(coords * _f32(gn.noise_frequency),
                                      seed=int(gn.seed) & 0xFFFFFFFF)
        n_types = int(gn.n_voxel_types)
        sel = torch.clamp(((noise * 0.5 + 0.5) * n_types).to(torch.int32), 0, n_types - 1)
        types = torch.tensor([int(t) for t in gn.voxel_types], dtype=torch.int32, device=dev)
        vt = types[sel.long()]
    return grid, vt, ve, org


def _absorber_pools(bodies, dev):
    """Absorber pools (8 of each kind, as the reference's) in regular-body
    order; ``bodies`` lists the regular bodies."""
    sph = [(bi, rb.absorbing_sphere) for bi, rb in enumerate(bodies)
           if rb.absorbing_sphere is not None]
    cap = [(bi, rb.absorbing_capsule) for bi, rb in enumerate(bodies)
           if rb.absorbing_capsule is not None]
    pools = empty_absorber_pools(max(8, len(sph), len(cap)), device=dev)
    f = {k: v.clone() for k, v in pools._asdict().items()}

    def vec(x):
        return torch.tensor([_f32(e) for e in x], dtype=torch.float32, device=dev)

    for j, (bi, a) in enumerate(sph):
        f["sph_body"][j] = bi
        f["sph_offset"][j] = vec(a.offset)
        f["sph_radius"][j] = _f32(a.radius)
        f["sph_rate"][j] = _f32(a.rate)
        f["sph_mask"][j] = True
    for j, (bi, a) in enumerate(cap):
        f["cap_body"][j] = bi
        f["cap_start"][j] = vec(a.segment_start)
        f["cap_end"][j] = vec(a.segment_end)
        f["cap_radius"][j] = _f32(a.radius)
        f["cap_rate"][j] = _f32(a.rate)
        f["cap_mask"][j] = True
    return type(pools)(**f)


def _chunk_meshes(pool, tc, material_table, dev):
    """The chunk-submesh pool with every surface chunk meshed, in passes of
    64 chunks (the reference's setup loop); raises when the slots run out."""
    o_max, g = pool.n_objects, pool.grid_size
    c = n_chunks_per_object(g)
    n_slots = tc.chunk_submesh_slots or min(o_max * c, 1024)
    meshes = mark_objects_dirty(empty_chunk_mesh_pool(n_slots, tc.chunk_tri_cap, o_max, g, dev),
                                pool.alive)
    budget = 64
    for _ in range(-(-o_max * c // budget)):
        if not bool((meshes.chunk_dirty & pool.alive[:, None]).any()):
            break
        meshes = remesh_chunks(meshes, pool, material_table, budget, tc.chunk_vert_cap,
                               merge_levels=tc.mesh_merge_levels)
    blocked = int(meshes.n_dropped_chunks)
    if blocked > 0:
        raise ValueError(f"chunk-submesh pool exhausted at setup: {blocked} surface chunks "
                         f"blocked (raise tpu.chunk_submesh_slots)")
    return meshes


def compile_scene(world, config: EngineConfig, registry: VoxelTypeRegistry | None = None,
                  sdf_generators: dict | None = None, static_geometry: StaticGeometry | None = None,
                  rng_seed: int = 0, device="cuda") -> SceneBuild:
    """Lower the ECS ``world`` into device state (the setup pipeline),
    stripping the setup components it consumed from the world, as the
    reference does. ``sdf_generators``: generator id → SDF graph (a
    ``voxel/sdf.py`` dict), the graph of each GeneratedVoxelObject by its
    ``generator_id`` (an unknown id raises KeyError). ``static_geometry``:
    render geometry drawn before the ground quads. The fracture generator is
    a ``torch.Generator`` on the device, seeded with ``rng_seed``. An
    orthographic camera sets ``config.tpu.orthographic_camera``."""
    dev = torch.device(device)
    tc = config.tpu
    if tc.chunked_remesh is None:
        tc.chunked_remesh = tc.voxel_grid_size >= 64  # resolved in place, as the reference does
    scene = lower_world(world, TEXTURE_SOURCES, sdf_generators, MESH_FILE_PATHS)
    if scene.camera is not None and scene.camera.orthographic:
        tc.orthographic_camera = True  # in place, as the reference does
    registry = registry_to(registry, dev) if registry is not None else default_registry(dev)
    o_max = tc.max_voxel_objects
    g = tc.voxel_grid_size
    n_regular = tc.max_bodies - o_max
    objects = scene.voxel_objects
    if n_regular <= 0:
        raise ValueError("max_bodies must exceed max_voxel_objects")
    if len(objects) > o_max:
        raise ValueError("voxel object pool exhausted")
    if len(scene.rigid_bodies) > n_regular:
        raise ValueError("regular body pool exhausted")
    i8 = tc.sdf_encoding == "i8"

    phys = init_physics_state(tc.max_bodies, tc.max_contacts, dev)
    b = phys.bodies
    kind, position, orientation = b.kind.clone(), b.position.clone(), b.orientation.clone()
    velocity, angular_velocity = b.velocity.clone(), b.angular_velocity.clone()
    forces = empty_force_pools(tc.max_bodies, cap_accel=max(64, tc.max_bodies), device=dev)
    accel_body, accel, accel_mask = (forces.const_accel_body.clone(), forces.const_accel.clone(),
                                     forces.const_accel_mask.clone())
    alive = torch.zeros(o_max, dtype=torch.bool, device=dev)
    extent = torch.ones(o_max, device=dev)
    origin = torch.zeros((o_max, 3), device=dev)
    if i8:
        sdf = torch.full((o_max, g, g, g), 127, dtype=torch.int8, device=dev)
    else:
        sdf = torch.full((o_max, g, g, g), 1e3, dtype=torch.float32, device=dev)
    vtype = torch.zeros((o_max, g, g, g), dtype=torch.int32, device=dev)
    body_index = torch.arange(o_max, device=dev) + n_regular
    voxel_response = torch.zeros((o_max, 3), device=dev)
    fracturable = torch.zeros(o_max, dtype=torch.bool, device=dev)
    fracture_threshold = torch.full((o_max,), math.inf, device=dev)
    fracture_radius = torch.ones(o_max, device=dev)

    def vec(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    # --- pass 1: voxel objects (identical shapes voxelized once) ----------------
    cache: dict = {}
    uniq: list = []  # (sdf codes, vtype, extent, origin)
    uidx = []
    n_accel = 0
    for oi, ob in enumerate(objects):
        sig = (repr(ob.graph), float(ob.voxel_extent), ob.voxel_type,
               None if ob.noise is None else dataclasses.astuple(ob.noise),
               None if ob.voxel_types is None else dataclasses.astuple(ob.voxel_types))
        if sig not in cache:
            cache[sig] = len(uniq)
            uniq.append(_object_grids(ob, g, i8, dev))
        ui = cache[sig]
        uidx.append(ui)
        grid, vt, ve, org = uniq[ui]
        alive[oi] = True
        extent[oi] = ve
        origin[oi] = org
        sdf[oi] = grid
        vtype[oi] = vt
        bi = n_regular + oi
        kind[bi] = KIND_DYNAMIC if ob.dynamic else KIND_KINEMATIC
        position[bi] = vec(ob.position)
        orientation[bi] = vec(ob.orientation)
        velocity[bi] = vec(ob.linear_velocity)
        angular_velocity[bi] = vec(ob.angular_velocity)
        if ob.response is not None:
            voxel_response[oi] = vec(ob.response)
        if ob.fracture is not None:
            fracturable[oi] = True
            fracture_threshold[oi], fracture_radius[oi] = ob.fracture
        if ob.acceleration is not None:
            accel_body[n_accel] = bi
            accel[n_accel] = vec(ob.acceleration)
            accel_mask[n_accel] = True
            n_accel += 1
    casts = torch.tensor([ob.casts_shadows for ob in objects]
                         + [True] * (o_max - len(objects)), device=dev)
    pool = VoxelObjectPool(alive=alive, body_index=body_index, voxel_extent=extent,
                           origin=origin, sdf=sdf, vtype=vtype, mesh_dirty=alive.clone(),
                           split_pending=torch.zeros_like(alive), casts_shadows=casts)

    # --- pass 2: the regular bodies take bodies 0, 1, ... in entity order ---------
    absorbers = _absorber_pools(scene.rigid_bodies, dev)
    mass, inv_mass = b.mass.clone(), b.inv_mass.clone()
    inertia_body, inv_inertia_body = b.inertia_body.clone(), b.inv_inertia_body.clone()

    def set_mass(bi, m, inertia):
        mass[bi], inv_mass[bi] = m, 1.0 / m
        inertia_body[bi] = inertia
        inv_inertia_body[bi] = torch.linalg.inv(inertia)

    def add_accel(bi, a):
        nonlocal n_accel
        accel_body[n_accel] = bi
        accel[n_accel] = vec(a)
        accel_mask[n_accel] = True
        n_accel += 1

    sph_coll, pln_coll, cap_coll, ground_ys = [], [], [], []
    drivers = {k: v.clone() for k, v in empty_motion_driver_pools(device=dev)._asdict().items()}
    fp = {k: v.clone() for k, v in forces._asdict().items()
          if not k.startswith(("const_accel", "medium"))}
    caps = dict(local=fp["local_force_mask"].shape[0], align=fp["align_mask"].shape[0],
                **{k: drivers[f"{k}_mask"].shape[0] for k in ("circ", "osc", "rot", "orb")})
    counts = dict.fromkeys(caps, 0)
    drag_tables = []

    def slot(pool_name):
        j = counts[pool_name]
        if j >= caps[pool_name]:
            raise ValueError(f"{pool_name} pool exhausted ({caps[pool_name]} slots)")
        counts[pool_name] += 1
        return j

    for bi, rb in enumerate(scene.rigid_bodies):
        kind[bi] = KIND_DYNAMIC if rb.dynamic else KIND_KINEMATIC
        position[bi] = vec([_f32(e) for e in rb.position])
        orientation[bi] = vec([_f32(e) for e in rb.orientation])
        velocity[bi] = vec([_f32(e) for e in rb.linear_velocity])
        angular_velocity[bi] = vec([_f32(e) for e in rb.angular_velocity])
        seg = None
        if rb.capsule is not None:
            seg = float(np.linalg.norm(np.asarray(rb.capsule.segment_end, np.float32)
                                       - np.asarray(rb.capsule.segment_start, np.float32)))
        if rb.inertia is not None:
            set_mass(bi, _f32(rb.inertia.mass),
                     torch.tensor(np.asarray(rb.inertia.inertia_tensor, np.float32)))
        elif rb.mass_density is not None:
            # analytic mass (in double precision, as the reference computes
            # it from component values) and inertia about the centre
            rho = _f32(rb.mass_density)
            if rb.sphere is not None:
                r = _f32(rb.sphere.radius)
                m = sphere_mass(rho, r)
                inertia = sphere_inertia(torch.tensor(m, dtype=torch.float32), torch.tensor(r))
            elif rb.capsule is not None:
                r = _f32(rb.capsule.radius)
                m = capsule_mass(rho, r, seg)
                inertia = capsule_inertia(torch.tensor(m, dtype=torch.float32), torch.tensor(r),
                                          torch.tensor(seg))
            else:
                m, inertia = rho, torch.eye(3) * rho
            set_mass(bi, m, inertia)
        if rb.sphere is not None:
            sph_coll.append((bi, rb.sphere))
        if rb.plane is not None:
            pln_coll.append((bi, rb.plane))
            if tuple(np.round(rb.plane.normal, 3)) == (0.0, 1.0, 0.0):
                ground_ys.append(rb.plane.displacement)
        if rb.capsule is not None:
            cap_coll.append((bi, rb.capsule))
        if rb.acceleration is not None:
            add_accel(bi, rb.acceleration)
        if rb.local_force is not None:
            j = slot("local")
            fp["local_force_body"][j] = bi
            fp["local_force"][j] = vec(rb.local_force[0])
            fp["local_point"][j] = vec(rb.local_force[1])
            fp["local_force_mask"][j] = True
        if rb.dynamic_gravity:
            fp["gravity_participant"][bi] = True
        if rb.drag_coefficient is not None:
            # the analytic area, and a drag-load map of the collidable's mesh
            area, shape = 1.0, None
            if rb.sphere is not None:
                r = _f32(rb.sphere.radius)
                area = float(np.pi * r * r)
                shape = meshlib.sphere_mesh(radius=r, n_rings=12, n_segments=24)
            elif rb.capsule is not None:
                r = _f32(rb.capsule.radius)
                area = float(2 * r * seg + np.pi * r ** 2)
                shape = meshlib.capsule_mesh(radius=r, segment_length=seg, n_rings=8,
                                             n_segments=24)
            fp["drag_coef"][bi] = _f32(rb.drag_coefficient)
            fp["drag_area"][bi] = area
            if shape is not None:
                dm = config.physics.rigid_body_force.drag_load_map_config
                n_theta = max(8, dm.n_theta_coords // 2)
                table = get_or_build_drag_load_map(
                    shape.positions, shape.indices, n_theta=n_theta, n_phi=2 * n_theta,
                    directory=dm.directory, use_saved=dm.use_saved_maps,
                    save_generated=dm.save_generated_maps,
                    overwrite=dm.overwrite_existing_map_files).table
                drag_tables.append(table)
                fp["drag_map_index"][bi] = len(drag_tables) - 1
        if rb.alignment_torque is not None:
            at = rb.alignment_torque
            j = slot("align")
            fp["align_body"][j] = bi
            fp["align_axis"][j] = vec(at.axis)
            fp["align_target"][j] = vec(at.direction)
            fp["align_strength"][j] = _f32(at.strength)
            fp["align_damping"][j] = _f32(at.damping)
            fp["align_mask"][j] = True
        for d in rb.drivers:
            _fill_driver(drivers, d, bi, slot, vec)
    mesh_records = [(me.mesh, -1 if me.body is None else me.body, me.position, me.orientation)
                    for me in scene.mesh_entities]
    if drag_tables:
        fp["drag_map_table"] = torch.from_numpy(np.stack(drag_tables)).to(dev)
    bodies = b._replace(kind=kind, position=position, orientation=orientation,
                        velocity=velocity, angular_velocity=angular_velocity, mass=mass,
                        inv_mass=inv_mass, inertia_body=inertia_body,
                        inv_inertia_body=inv_inertia_body)
    forces = forces._replace(
        **fp, const_accel_body=accel_body, const_accel=accel, const_accel_mask=accel_mask,
        medium_density=torch.tensor(float(config.physics.medium.mass_density), device=dev),
        medium_velocity=vec(config.physics.medium.velocity),
    )
    phys = phys._replace(bodies=apply_forces_and_torques(bodies, forces))
    body_of = _entity_bodies(n_regular)
    joints = _joint_pools(scene.joints, body_of, dev)
    dist_rules = _distance_rule_pools(scene.distance_rules, body_of, dev)
    mesh_instances, entity_layers = _mesh_instances(mesh_records, scene.textures, tc, dev)

    # --- lights + camera ----------------------------------------------------------
    amb = vec(scene.ambient_illuminance)
    n_omni = max(1, len(scene.omni_lights))
    n_uni = max(1, len(scene.uni_lights))

    def pool_of(n, rows, width, default):
        out = torch.tensor([default] * n, dtype=torch.float32, device=dev)
        for j, r in enumerate(rows):
            out[j] = vec(r)
        return out if width else out.reshape(n)

    # plain lights take the leading slots, shadowable ones follow
    om = sorted(scene.omni_lights, key=lambda o: o.shadowable)
    un = sorted(scene.uni_lights, key=lambda u: u.shadowable)
    uni_dirs = []
    for u in un:
        d = torch.tensor(u.direction, dtype=torch.float32)
        uni_dirs.append((d / max(float(torch.linalg.vector_norm(d)), 1e-9)).tolist())
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
    if cs is None:  # the reference's default camera
        cs = CameraSpec(position=(0.0, 5.0, 20.0),
                        orientation=tuple(look_at((0.0, 5.0, 20.0), (0.0, 0.0, 0.0)).tolist()),
                        vertical_fov=math.pi / 3, near=0.05, far=500.0)
    camera = Camera(vec(cs.position), vec(cs.orientation), vec(cs.vertical_fov), vec(cs.near),
                    vec(cs.far))
    material_table = material_corner_table(registry)
    params = EngineParams(
        phys_params=PhysicsParams(
            collidables=_collidable_pools(sph_coll, pln_coll, cap_coll, tc.max_bodies, dev),
            forces=forces, drivers=MotionDriverPools(**drivers), joints=joints),
        lights=lights, absorbers=absorbers, type_density=registry.mass_density, voxel_response=voxel_response,
        fracturable=fracturable, fracture_threshold=fracture_threshold,
        fracture_radius=fracture_radius, camera=camera,
        static_geometry=_build_static_geometry(ground_ys, dev, static_geometry),
        material_table=material_table, mesh_instances=mesh_instances,
        dist_rules=dist_rules, casts_shadows_base=casts.clone(),
    )

    # --- voxel body sync (mass, inertia, body origin at the COM), then momenta
    #     from the initial velocities now that every body has its mass -------------
    phys, pool = _sync_voxel_bodies(phys, pool, registry.mass_density, pool.mesh_dirty)
    bodies = phys.bodies
    phys = phys._replace(bodies=synchronize_momenta(bodies, bodies.velocity,
                                                    bodies.angular_velocity))

    # --- initial meshes: the chunk-submesh pool on chunked grids, else each
    #     distinct shape once, gathered to object slots --------------------------
    vert_cap = tc.mesh_vert_cap or min(4096, (g - 1) ** 3)
    tri_cap = tc.mesh_tri_cap or min(8192, 6 * (g - 1) ** 3)
    if tc.chunked_remesh:
        meshes = _chunk_meshes(pool, tc, material_table, dev)
    else:
        entries = [(grid, vt, ve) for grid, vt, ve, _ in uniq]
        if len(objects) < o_max:  # dead slots share one empty-SDF mesh
            far = torch.full((g, g, g), 127 if i8 else 1e3,
                             dtype=torch.int8 if i8 else torch.float32, device=dev)
            entries.append((far, torch.zeros((g, g, g), dtype=torch.int32, device=dev), 1.0))
            uidx += [len(entries) - 1] * (o_max - len(objects))
        meshes_u = []
        for grid, vt, ve in entries:
            m = compact_mesh(surface_nets(sdf_world(grid, ve), vt, tc.mesh_merge_levels),
                             vert_cap, tri_cap)
            meshes_u.append(bake_mesh_materials(m, material_table))
        meshes = _stack_meshes([meshes_u[i] for i in uidx])
    pool = pool._replace(mesh_dirty=torch.zeros_like(pool.mesh_dirty))

    generator = torch.Generator(device=dev)
    generator.manual_seed(rng_seed)
    bodies = phys.bodies
    sim = SimState(
        phys=phys, voxels=pool, meshes=meshes, probes=extract_probes(pool, voxel_response),
        render=init_render_state(render_config_from_engine_config(config), dev),
        prev_position=bodies.position, prev_orientation=bodies.orientation, rng=generator,
    )
    info = dict(voxel_objects=[dict(entity=ob.entity, slot=i, body=n_regular + i)
                               for i, ob in enumerate(objects)],
                mesh_vert_cap=vert_cap, mesh_tri_cap=tri_cap,
                n_voxel_objects=len(objects), n_unique_shapes=len(uniq),
                n_regular_bodies=len(scene.rigid_bodies),
                entity_texture_layers=entity_layers)
    return SceneBuild(sim=sim, params=params, info=info)


# the reference's raster backends → the port's: its Pallas kernel is K1
RASTER_BACKENDS = {"auto": "kernel", "pallas": "kernel", "xla": "raster"}


def render_config_from_engine_config(config: EngineConfig) -> RenderConfig:
    """The render configuration of an engine config. Tone mapping and the
    sensor sensitivity take the RON forms (a ``ron.Variant``, and RON's
    ``None`` for the None tone mapping, ref: runtime/setup.py:1291-1304) and
    the plain ones (a string; a dict of ``ev_compensation`` or ``iso``)
    alike; the reference's raster backends name the port's."""
    r = config.rendering
    cc = r.capturing_camera
    cam = cc.settings
    sens = cam.sensitivity
    fields = sens if isinstance(sens, dict) else getattr(sens, "fields", None) or {}
    ev = fields.get("ev_compensation", 0.0)
    # Manual { iso } (ref: capturing.rs SensorSensitivity) fixes the exposure
    iso = fields.get("iso") if getattr(sens, "name", "Manual") == "Manual" or "iso" in fields \
        else None
    tone = cc.dynamic_range_compression.tone_mapping_method
    tone = "None" if tone is None else getattr(tone, "name", tone)
    big = config.tpu.render_height >= 720
    return RenderConfig(
        textured=config.tpu.textured_voxels,
        raster_backend=RASTER_BACKENDS.get(config.tpu.raster_backend, config.tpu.raster_backend),
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
        tone_mapping=str(tone),
        shadows_enabled=r.shadow_mapping.enabled,
        csm_cascades=config.tpu.csm_cascades,
        soft_shadows=config.tpu.soft_shadows,
        bf16_shading=config.tpu.bf16_shading,
        max_triangles=config.tpu.max_render_triangles,
        shadow_pcf_downsample=2 if big else 1,
        ao_downsample=2 if big else 1,
        procedural_sky=config.tpu.procedural_sky,
        orthographic=config.tpu.orthographic_camera,
        sky_luminance=tuple(config.tpu.sky_luminance),
    )
