"""Scene layer: materials, meshes, render-scene assembly, the scene graph
and controllers (ref: impact_scene, impact_material, impact_controller)."""

from .scene_graph import INSTANCE_CASTS_NO_SHADOWS, INSTANCE_IS_HIDDEN, SceneGraph

__all__ = ["INSTANCE_CASTS_NO_SHADOWS", "INSTANCE_IS_HIDDEN", "SceneGraph"]
