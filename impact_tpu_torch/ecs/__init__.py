"""Entity-component system (port of ``impact_tpu/ecs``; ref:
engine/crates/impact_ecs): host-side dense SoA numpy columns and masks,
lowered to device state by ``runtime.setup.compile_scene``."""

from . import components
from .world import ComponentMeta, EntityStager, World, component, component_registry

__all__ = ["World", "EntityStager", "component", "component_registry", "ComponentMeta",
           "components"]
