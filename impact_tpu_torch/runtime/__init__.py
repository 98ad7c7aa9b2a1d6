"""Engine runtime (port of ``impact_tpu/runtime``; ref: engine/src — Engine,
Runtime, headless run loop)."""

from . import checkpoint, command
from .engine import EngineParams, SimState, make_engine_step
from .headless import HeadlessRuntime
from .setup import (
    SceneBuild,
    compile_scene,
    register_mesh_file,
    register_texture,
    render_config_from_engine_config,
)

__all__ = ["SimState", "EngineParams", "make_engine_step", "HeadlessRuntime", "SceneBuild",
           "compile_scene", "register_mesh_file", "register_texture",
           "render_config_from_engine_config",
           "checkpoint", "command"]
