from .headless import HeadlessRuntime
from .setup import SceneBuild, compile_scene, render_config_from_engine_config

__all__ = ["HeadlessRuntime", "SceneBuild", "compile_scene", "render_config_from_engine_config"]
