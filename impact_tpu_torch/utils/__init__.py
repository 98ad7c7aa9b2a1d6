"""Utilities: config, RON parsing, hashing, timing, images (port of
``impact_tpu/utils``; ref: impact_io, interop/hashing, impact_profiling)."""

from . import config, hashing, ron, timing
from .config import EngineConfig

__all__ = ["config", "ron", "hashing", "timing", "EngineConfig"]
