"""Scene layer: materials, meshes, render-scene assembly, the scene graph
and controllers (ref: impact_scene, impact_material, impact_controller)."""

from . import assembly, controller, graph, materials, mesh, scene_graph
from .assembly import StaticGeometry, build_render_scene, ground_plane_geometry
from .materials import VoxelTypeRegistry, default_registry, make_voxel_type_registry
from .scene_graph import INSTANCE_CASTS_NO_SHADOWS, INSTANCE_IS_HIDDEN, SceneGraph

__all__ = [
    "assembly",
    "materials",
    "mesh",
    "graph",
    "scene_graph",
    "SceneGraph",
    "INSTANCE_IS_HIDDEN",
    "INSTANCE_CASTS_NO_SHADOWS",
    "controller",
    "StaticGeometry",
    "build_render_scene",
    "ground_plane_geometry",
    "VoxelTypeRegistry",
    "default_registry",
    "make_voxel_type_registry",
]
