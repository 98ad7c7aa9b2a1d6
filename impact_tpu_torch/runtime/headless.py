"""Headless runtime: renders frames of a compiled scene without a window.

Port of the render side of ``impact_tpu/runtime/headless.py``
(ref: engine/src/runtime/headless.rs). ``render()`` runs the four stages —
scene assembly + geometry pass, shadow pass, deferred shading, postprocess —
in float32 and records each stage's wall milliseconds in ``stage_ms``,
measured between ``torch.cuda.synchronize()`` calls when the scene lives on
the card. The engine step is not part of this slice: frames render the
compiled scene's initial state.
"""

from __future__ import annotations

import time

import torch

from ..render.pipeline import (
    compact_scene_triangles,
    deferred_shade,
    fp32_render,
    geometry_pass,
    postprocess,
    shadow_pass,
)
from ..scene.assembly import build_render_scene
from ..utils.config import EngineConfig
from .setup import SceneBuild, render_config_from_engine_config


class HeadlessRuntime:
    """Owns the compiled scene and renders frames of it."""

    def __init__(self, build: SceneBuild, config: EngineConfig):
        self.config = config
        self.build = build
        self.render_state = build.render
        self.render_config = render_config_from_engine_config(config)
        self.stage_ms: dict = {}
        self.last_gbuffer = None
        self.last_hdr = None

    def _sync(self):
        if self.build.body_position.is_cuda:
            torch.cuda.synchronize(self.build.body_position.device)

    def scene(self):
        """The compacted corner-major RenderScene of the current state."""
        b = self.build
        scene = build_render_scene(
            b.pool, b.meshes, b.body_position, b.body_orientation,
            b.prev_position, b.prev_orientation, b.static_geometry,
            tris_per_object=self.config.tpu.render_tris_per_object)
        return compact_scene_triangles(scene, self.render_config.max_triangles)

    def render(self):
        """Render the current state → u8 image [H,W,3] (on the scene's device)."""
        b, rc = self.build, self.render_config
        state = self.render_state
        times = {}
        with fp32_render():
            self._sync()
            t0 = time.perf_counter()
            scene = self.scene()
            gb, geo_drops = geometry_pass(scene, b.camera, b.camera, state.frame_index, rc)
            self._sync()
            t1 = time.perf_counter()
            times["geometry"] = (t1 - t0) * 1e3
            omni, uni, shadow_drops = shadow_pass(scene, b.lights, b.camera, rc)
            self._sync()
            t2 = time.perf_counter()
            times["shadows"] = (t2 - t1) * 1e3
            lum = deferred_shade(gb, b.lights, b.camera, omni, uni, rc)
            self._sync()
            t3 = time.perf_counter()
            times["shade"] = (t3 - t2) * 1e3
            state = state._replace(
                n_raster_drops=state.n_raster_drops + geo_drops + shadow_drops)
            img, hdr, state = postprocess(lum, gb.motion, state, rc)
            self._sync()
            times["post"] = (time.perf_counter() - t3) * 1e3
        self.render_state = state
        self.last_gbuffer = gb
        self.last_hdr = hdr
        self.stage_ms = times
        return img

    def dropped_raster_candidates(self) -> int:
        """Cumulative raster candidates lost to window or big-block overflow
        across every rendered view so far (the "no silent caps" counter)."""
        return int(self.render_state.n_raster_drops)
