"""Voxel objects: SDF generation, meshing, deformation, collision (port of
``impact_tpu/voxel``; ref: engine/crates/impact_voxel)."""

from . import collision, inertia, interaction, mesh, object, sdf
from .mesh import SurfaceNetsMesh, surface_nets, surface_nets_batched
from .object import VoxelObjectPool, empty_voxel_object_pool, generate_sdf_grid

__all__ = [
    "sdf",
    "object",
    "mesh",
    "inertia",
    "collision",
    "interaction",
    "VoxelObjectPool",
    "empty_voxel_object_pool",
    "generate_sdf_grid",
    "SurfaceNetsMesh",
    "surface_nets",
    "surface_nets_batched",
]
