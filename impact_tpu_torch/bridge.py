"""Carry state between the JAX reference and the port as numpy arrays: the
authored ECS world, the render inputs, and the whole engine state
(``SimState``, ``EngineParams``).

The tests feed both packages the same inputs through here. Like the port's
other entry points, the functions put tensors on ``cuda`` unless the caller
passes ``device="cpu"``. Nothing is
imported from JAX or the reference package: reference objects are read by
attribute name and converted with ``np.asarray``, which JAX arrays support.
"""

from __future__ import annotations

import numpy as np
import torch

from .ecs import World, component_registry
from .physics.collision import CollidablePools
from .physics.driven_motion import MotionDriverPools
from .physics.forces import ForcePools
from .physics.solver import JointPools, SolverCache
from .physics.state import BodyState
from .physics.step import PhysicsParams, PhysicsState
from .render.camera import Camera
from .render.lights import LightPools
from .render.pipeline import RenderScene, RenderState
from .runtime.engine import DistanceRulePools, EngineParams, SimState
from .runtime.setup import SceneBuild
from .scene.assembly import MeshInstancePool, StaticGeometry
from .voxel.chunk_mesh import ChunkMeshPool
from .voxel.collision import VoxelProbes
from .voxel.interaction import AbsorberPools
from .voxel.mesh import CompactMesh
from .voxel.object import VoxelObjectPool


def to_torch(x, device="cuda"):
    return torch.from_numpy(np.array(np.asarray(x), copy=True)).to(device)


def to_numpy(t):
    return t.detach().cpu().numpy()


def _tuple(cls, obj, device, fields=None, cast=None):
    cast = cast or {}
    vals = {}
    for f in fields or cls._fields:
        v = to_torch(getattr(obj, f), device)
        if f in cast:
            v = v.to(cast[f])
        vals[f] = v
    return cls(**vals)


def world_from_reference(ref) -> World:
    """A reference ``World`` copied into the port's, entity by entity (each
    in the same slot, so in the same order, with the same id) and
    component by component (each field from the reference's column)."""
    registry = component_registry()
    w = World(capacity=ref.capacity)
    alive = np.nonzero(ref.alive)[0]
    holes = []  # free slots below the last entity stay free
    spare_id = max([int(e) for e in ref.entity_ids] + [ref._next_counter_id]) + 1
    for idx in range(int(alive[-1]) + 1 if alive.size else 0):
        if not ref.alive[idx]:
            holes.append(w.create_entity(entity_id=spare_id + idx))
            continue
        comps = []
        for name, cols in ref._columns.items():
            if cols["__mask__"][idx]:
                cls = registry[name].cls
                comps.append(cls(**{f.name: np.array(cols[f.name][idx])
                                    for f in registry[name].fields}))
        w.create_entity(*comps, entity_id=int(ref.entity_ids[idx]))
    for eid in holes:
        w.remove_entity(eid)
    w._next_counter_id = ref._next_counter_id
    return w


def render_scene_from_reference(rs, device="cuda") -> RenderScene:
    """The reference's RenderScene (NamedTuple of arrays) → the port's."""
    return _tuple(RenderScene, rs, device)


def render_scene_to_numpy(rs: RenderScene) -> dict:
    return {f: to_numpy(getattr(rs, f)) for f in RenderScene._fields}


def camera_from_reference(cam, device="cuda") -> Camera:
    return _tuple(Camera, cam, device)


def lights_from_reference(lp, device="cuda") -> LightPools:
    return _tuple(LightPools, lp, device)


_INDEX_FIELDS = ("body_index", "drag_map_index", "body_a", "body_b", "body", "obj_slot")


def _field(name, x, device):
    """One reference array as a port tensor: u32 keys and i32 body indices
    become int64 (torch indexes, sorts and searches int64)."""
    t = to_torch(x, device)
    if t.dtype == torch.uint32 or (t.dtype == torch.int32 and (
            name.endswith("_body") or name in _INDEX_FIELDS)):
        t = t.to(torch.int64)
    return t


def tuple_from_reference(cls, obj, device="cuda", **override):
    """A reference NamedTuple → the port's ``cls``, field by field by name."""
    return cls(**{f: override[f] if f in override else _field(f, getattr(obj, f), device)
                  for f in cls._fields})


def _generator_from_key(key, device):
    """A generator seeded from the reference's PRNG key. The port draws
    other numbers than threefry from the same key (ROADMAP Queue 3)."""
    k = np.asarray(key).astype(np.uint64).reshape(-1)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(k[0]) << 32 | int(k[-1]))
    return g


def chunk_mesh_pool_from_reference(cp, device="cuda") -> ChunkMeshPool:
    """The reference's ChunkMeshPool → the port's (slot and chunk indices as
    int64; the reference's top-2 type blend is not carried)."""
    return tuple_from_reference(ChunkMeshPool, cp, device, **{
        f: _field(f, getattr(cp, f), device).to(torch.int64)
        for f in ("owner", "chunk", "slot_of", "n_dropped_verts", "n_dropped_tris",
                  "n_dropped_chunks")})


def _meshes_from_reference(meshes, device):
    if hasattr(meshes, "slot_of"):  # the chunked path's submesh pool
        return chunk_mesh_pool_from_reference(meshes, device)
    return _tuple(CompactMesh, meshes, device, cast={"tri_indices": torch.int64})


def sim_state_from_reference(sim, device="cuda") -> SimState:
    """The reference's SimState (dense or chunked path) → the port's."""
    phys = sim.phys
    r = sim.render
    return SimState(
        phys=PhysicsState(bodies=tuple_from_reference(BodyState, phys.bodies, device),
                          solver_cache=tuple_from_reference(SolverCache, phys.solver_cache, device),
                          time=to_torch(phys.time, device)),
        voxels=tuple_from_reference(VoxelObjectPool, sim.voxels, device),
        meshes=_meshes_from_reference(sim.meshes, device),
        probes=tuple_from_reference(VoxelProbes, sim.probes, device),
        render=RenderState(history_luminance=to_torch(r.history_luminance, device),
                           avg_luminance=to_torch(r.avg_luminance, device),
                           frame_index=int(np.asarray(r.frame_index)),
                           n_raster_drops=to_torch(r.n_raster_drops, device).long()),
        prev_position=to_torch(sim.prev_position, device),
        prev_orientation=to_torch(sim.prev_orientation, device),
        rng=_generator_from_key(sim.rng, device),
    )


def mesh_instances_from_reference(mi, device="cuda") -> MeshInstancePool:
    """The reference's MeshInstancePool → the port's (indices as int64, the
    baked corners carried)."""
    over = {f: _field(f, getattr(mi, f), device).to(torch.int64)
            for f in ("tri_indices", "body_index")}
    over.update({f: None for f in ("corner_pos", "corner_normal") if getattr(mi, f) is None})
    return tuple_from_reference(MeshInstancePool, mi, device, **over)


def engine_params_from_reference(params, device="cuda") -> EngineParams:
    """The reference's EngineParams → the port's: collidables, forces (drag
    tables included), motion drivers, joints, distance rules and the rest."""
    pp = params.phys_params
    sg = params.static_geometry
    static = _tuple(StaticGeometry, sg, device, fields=StaticGeometry._fields[:-1],
                    cast={"tri_indices": torch.int64})
    if sg.corners is not None:
        static = static._replace(corners={k: to_torch(a, device) for k, a in sg.corners.items()})
    return EngineParams(
        phys_params=PhysicsParams(
            collidables=tuple_from_reference(CollidablePools, pp.collidables, device),
            forces=tuple_from_reference(ForcePools, pp.forces, device),
            drivers=tuple_from_reference(MotionDriverPools, pp.drivers, device),
            joints=tuple_from_reference(JointPools, pp.joints, device)),
        lights=lights_from_reference(params.lights, device),
        absorbers=tuple_from_reference(AbsorberPools, params.absorbers, device),
        type_density=to_torch(params.type_density, device),
        voxel_response=to_torch(params.voxel_response, device),
        fracturable=to_torch(params.fracturable, device),
        fracture_threshold=to_torch(params.fracture_threshold, device),
        fracture_radius=to_torch(params.fracture_radius, device),
        camera=camera_from_reference(params.camera, device),
        static_geometry=static,
        material_table=to_torch(params.material_table, device),
        mesh_instances=mesh_instances_from_reference(params.mesh_instances, device),
        dist_rules=tuple_from_reference(DistanceRulePools, params.dist_rules, device),
        casts_shadows_base=to_torch(params.casts_shadows_base, device),
    )


def scene_build_from_reference(build, device="cuda") -> SceneBuild:
    """The reference's SceneBuildResult → the port's SceneBuild (state,
    scene constants and info)."""
    return SceneBuild(sim=sim_state_from_reference(build.sim, device),
                      params=engine_params_from_reference(build.params, device),
                      info=dict(build.info))
