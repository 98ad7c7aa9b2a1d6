"""Carry state between the JAX reference and the port as numpy arrays.

The tests feed both packages the same inputs through here. Like the port's
other entry points, the functions put tensors on ``cuda`` unless the caller
passes ``device="cpu"``. Nothing is
imported from JAX or the reference package: reference objects are read by
attribute name and converted with ``np.asarray``, which JAX arrays support.
"""

from __future__ import annotations

import numpy as np
import torch

from .render.camera import Camera
from .render.lights import LightPools
from .render.pipeline import RenderScene, RenderState
from .runtime.setup import SceneBuild
from .scene.assembly import StaticGeometry
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


def render_scene_from_reference(rs, device="cuda") -> RenderScene:
    """The reference's RenderScene (NamedTuple of arrays) → the port's."""
    return _tuple(RenderScene, rs, device)


def render_scene_to_numpy(rs: RenderScene) -> dict:
    return {f: to_numpy(getattr(rs, f)) for f in RenderScene._fields}


def camera_from_reference(cam, device="cuda") -> Camera:
    return _tuple(Camera, cam, device)


def lights_from_reference(lp, device="cuda") -> LightPools:
    return _tuple(LightPools, lp, device)


def scene_build_from_reference(build, device="cuda") -> SceneBuild:
    """The reference's SceneBuildResult → the port's SceneBuild: the voxel
    pool, batched compact meshes, body poses, lights, camera, static geometry
    (with its corner bake), material table and initial render state."""
    sim, params = build.sim, build.params
    v = sim.voxels
    pool = VoxelObjectPool(
        alive=to_torch(v.alive, device), body_index=to_torch(v.body_index, device).long(),
        voxel_extent=to_torch(v.voxel_extent, device), origin=to_torch(v.origin, device),
        sdf=to_torch(v.sdf, device), vtype=to_torch(v.vtype, device),
        casts_shadows=to_torch(v.casts_shadows, device))
    meshes = _tuple(CompactMesh, sim.meshes, device, cast={"tri_indices": torch.int64})
    sg = params.static_geometry
    static = _tuple(StaticGeometry, sg, device, fields=StaticGeometry._fields[:-1],
                    cast={"tri_indices": torch.int64})
    if sg.corners is not None:
        static = static._replace(corners={k: to_torch(a, device) for k, a in sg.corners.items()})
    r = sim.render
    render = RenderState(
        history_luminance=to_torch(r.history_luminance, device),
        avg_luminance=to_torch(r.avg_luminance, device),
        frame_index=int(np.asarray(r.frame_index)),
        n_raster_drops=to_torch(r.n_raster_drops, device).long(),
    )
    bodies = sim.phys.bodies
    return SceneBuild(
        pool=pool, meshes=meshes,
        body_position=to_torch(bodies.position, device),
        body_orientation=to_torch(bodies.orientation, device),
        prev_position=to_torch(sim.prev_position, device),
        prev_orientation=to_torch(sim.prev_orientation, device),
        lights=lights_from_reference(params.lights, device),
        camera=camera_from_reference(params.camera, device),
        static_geometry=static,
        material_table=to_torch(params.material_table, device),
        render=render,
        info=dict(build.info),
    )
