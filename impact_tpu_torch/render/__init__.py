"""Deferred PBR renderer (port of ``impact_tpu/render``; ref:
engine/crates/impact_rendering, impact_camera, impact_light): rasterization
(the tile kernel K1 on the card), shading, shadows and the postprocess
chain."""

from . import brdf, camera, lights, pipeline, post, raster
from .camera import Camera, look_at
from .lights import LightPools, empty_light_pools
from .pipeline import RenderConfig, RenderScene, RenderState, init_render_state, render_frame

__all__ = [
    "camera",
    "raster",
    "brdf",
    "lights",
    "post",
    "pipeline",
    "Camera",
    "look_at",
    "LightPools",
    "empty_light_pools",
    "RenderConfig",
    "RenderScene",
    "RenderState",
    "init_render_state",
    "render_frame",
]
