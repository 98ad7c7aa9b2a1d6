"""Headless runtime: steps and renders a compiled scene without a window.

Port of ``impact_tpu/runtime/headless.py`` (ref: engine/src/runtime/
headless.rs, engine/src/engine/game_loop.rs:17-72). ``step(n)`` advances
the engine step n times, after applying the queued commands, and not at
all while ``paused``; ``render()`` runs the four render stages — scene
assembly + geometry pass, shadow pass, deferred shading (with the scene's
texture set when textured), postprocess — in float32 on the current state;
``step_and_render()`` does one of each, ``run(n_frames, render_every)`` the
game loop. Wall milliseconds are recorded in ``stage_ms`` (render stages),
``step_ms`` (the last ``step`` call), ``timer`` (a TaskTimer by label) and
``metrics`` (smoothed frame durations of ``run``), measured between
``torch.cuda.synchronize()`` calls when the scene lives on the card.

The port makes one engine step per ``step`` call: the reference's
``tpu.steps_per_dispatch`` batching is a JAX dispatch device and the field
is only carried. Commands (``enqueue_command``), checkpoints, ``profile``
(a torch.profiler Chrome trace), a custom voxel-type ``registry`` (dense
and chunked scenes), the gizmos drawn over each frame while
``visible_gizmos`` names any (``render/gizmos.py``) and the feature flags
follow the reference runtime's surface.
"""

from __future__ import annotations

import contextlib
import os
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
from ..scene.materials import (
    VoxelTypeRegistry,
    default_registry,
    material_corner_table,
    registry_to,
)
from ..utils.config import EngineConfig
from ..utils.timing import EngineMetrics, TaskTimer
from ..voxel.chunk_mesh import ChunkMeshPool
from ..voxel.collision import GRID_BROAD_PHASE_MIN_OBJECTS, bounding_radii, broad_phase_pairs
from ..voxel.interaction import _chunk_absorber_hit, deferred_absorption_count
from ..voxel.mesh import bake_mesh_materials
from .engine import make_engine_step
from .setup import SceneBuild, render_config_from_engine_config


class HeadlessRuntime:
    """Owns the simulation state, the engine step and the render."""

    def __init__(self, build: SceneBuild, config: EngineConfig,
                 registry: VoxelTypeRegistry | None = None, enable_fracturing: bool = True,
                 enable_absorption: bool = True, enable_splitting: bool = True,
                 fracture_uniforms=None):
        self.config = config
        self.params = build.params
        self.info = build.info
        self.sim = build.sim
        # the given registry, else the default one (as the reference keeps
        # it): the texture layers of invalidate_render follow its n_types
        self.registry = (registry_to(registry, self.device) if registry is not None
                         else default_registry(self.device))
        if registry is not None:
            # a custom registry: rebake the scene's material table and meshes
            # (compile_scene baked with the registry it was given); a chunk
            # pool, which keeps no vertex census, rebakes from its top-2 blend
            table = material_corner_table(self.registry)
            self.params = self.params._replace(material_table=table)
            self.sim = self.sim._replace(meshes=bake_mesh_materials(self.sim.meshes, table))
        self._initial_sim = self.sim
        self._initial_rng = self.sim.rng.get_state()
        self._features = dict(enable_absorption=enable_absorption,
                              enable_splitting=enable_splitting,
                              enable_fracturing=enable_fracturing)
        self._fracture_uniforms = fracture_uniforms
        self.metrics = EngineMetrics()
        self.timer = TaskTimer()
        self.paused = False
        self.visible_gizmos: tuple = ()  # gizmo kinds drawn over each frame
        self.command_queue = None  # created by the first enqueue_command
        self._step = None
        self._earlier_host_syncs = 0  # host reads of the steps that rebuilds replaced
        self.invalidate_step()
        self.invalidate_render()
        self.stage_ms: dict = {}
        self.step_ms = 0.0
        self.last_gbuffer = None
        self.last_hdr = None
        self.last_drops = (0, 0)  # (geometry, shadow) raster drops of the last render

    @property
    def device(self) -> torch.device:
        return self.sim.phys.bodies.position.device

    def invalidate_step(self):
        """(Re)build the engine step from the config and the feature flags;
        the physics commands call it. ``host_syncs`` keeps counting across a
        rebuild."""
        if self._step is not None:
            self._earlier_host_syncs += self._step.host_syncs
        self._step = make_engine_step(
            self.params, self.config, self.info["mesh_vert_cap"], self.info["mesh_tri_cap"],
            fracture_uniforms=self._fracture_uniforms, **self._features)

    def invalidate_render(self):
        """Derive the render configuration and the texture set from the
        config and the scene: textured mesh entities turn the textured shade
        path on, and their layers follow the voxel-type layers (when
        ``tpu.textured_voxels`` is on) in the scene's texture arrays. The
        voxel-type layers number ``self.registry.n_types``, as in the
        reference, also where the scene was compiled with another registry
        (``ROADMAP.md`` Queue 3)."""
        rc = render_config_from_engine_config(self.config)
        self._voxel_textured = rc.textured
        entity_layers = self.info.get("entity_texture_layers", [])
        mi = self.params.mesh_instances
        if entity_layers:
            rc = rc._replace(textured=True)
            # entity-local layer indices → indices into the scene's arrays
            offset = self.registry.n_types if self._voxel_textured else 0
            mi = mi._replace(material=torch.where(mi.material >= 0, mi.material + offset,
                                                  -1).to(mi.material.dtype))
        self._mesh_instances = mi
        self.render_config = rc
        self.textures = None
        if rc.textured:
            from ..render.textures import build_scene_texture_set

            self.textures = build_scene_texture_set(
                self.registry.n_types, entity_layers,
                self.config.tpu.texture_resolution, include_voxel_layers=self._voxel_textured,
                device=self.sim.phys.bodies.position.device)

    @property
    def host_syncs(self) -> int:
        """Device reads the engine steps have made for their branches so far."""
        return self._earlier_host_syncs + self._step.host_syncs

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, n: int = 1):
        """Apply the queued commands, then advance the simulation ``n``
        steps (no rendering); a no-op while paused."""
        self.apply_commands()
        if self.paused:
            return self.sim
        self._sync()
        t0 = time.perf_counter()
        with self.timer.time("step", block_on=self.device), fp32_render():
            # fp32_render: the jacobi one-hot products in full float32
            for _ in range(n):
                self.sim = self._step(self.sim)
        self.step_ms = (time.perf_counter() - t0) * 1e3
        return self.sim

    def step_and_render(self):
        """One step, then a render of the new state → u8 image [H,W,3]."""
        self.step(1)
        return self.render()

    def run(self, n_frames: int, render_every: int = 0, screenshot_path=None):
        """The game loop: step each frame, render every ``render_every``-th
        frame (from frame 0) and, with ``screenshot_path``, save it there as
        ``frame_NNNNN.png``; returns the rendered frames and records each
        frame's duration in ``metrics`` (ref: game_loop max_iterations)."""
        images = []
        for i in range(n_frames):
            t0 = time.perf_counter()
            self.step()
            if render_every and i % render_every == 0:
                img = self.render()
                images.append(img)
                if screenshot_path:
                    from ..utils.image import save_png

                    save_png(os.path.join(screenshot_path, f"frame_{i:05d}.png"),
                             img.cpu().numpy())
            self.metrics.record_frame(time.perf_counter() - t0)
        self.metrics.last_task_execution_times = self.timer.drain()
        return images

    # --- commands, checkpoints, reset, profile ------------------------------------
    def enqueue_command(self, category: str, action: str, value=None):
        """Queue a command for the next ``step`` (``runtime/command.py``)."""
        from .command import Command, CommandQueue

        if self.command_queue is None:
            self.command_queue = CommandQueue()
        self.command_queue.enqueue(Command(category, action, value))

    def apply_commands(self):
        """Drain the queued commands (runs at each ``step``)."""
        if self.command_queue is not None:
            from .command import execute_commands

            execute_commands(self, self.command_queue)

    def reset_world(self):
        """Restore the initial scene state and the fracture generator
        (ref: SystemAdminCommand::ResetWorld)."""
        self.sim = self._initial_sim
        self.sim.rng.set_state(self._initial_rng)

    def save_checkpoint(self, path, metadata=None):
        from .checkpoint import save_checkpoint

        return save_checkpoint(path, self.sim, metadata)

    def load_checkpoint(self, path):
        """Resume from a checkpoint of this scene (the port's, or one that
        impact_tpu wrote of the same scene); returns its metadata."""
        from .checkpoint import load_checkpoint

        self.sim, meta = load_checkpoint(path, self.sim, device=self.device)
        return meta

    @contextlib.contextmanager
    def profile(self, log_dir):
        """A torch.profiler trace of everything run inside the context, with
        CUDA activity when the scene is on the card, written to
        ``log_dir/trace.json`` (Chrome trace format; open it in
        ui.perfetto.dev). Yields the profiler (``key_averages()``)::

            with rt.profile("traces"):
                rt.step(10); rt.render()
        """
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with torch_profile(activities=activities) as prof:
            yield prof
            self._sync()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    def scene(self):
        """The compacted corner-major RenderScene of the current state."""
        s, p = self.sim, self.params
        b = s.phys.bodies
        scene = build_render_scene(
            s.voxels, s.meshes, b.position, b.orientation, s.prev_position,
            s.prev_orientation, p.static_geometry, self._mesh_instances,
            tris_per_object=self.config.tpu.render_tris_per_object,
            voxel_texture_layers=self._voxel_textured)
        return compact_scene_triangles(scene, self.render_config.max_triangles)

    def render(self):
        """Render the current state → u8 image [H,W,3] (on the scene's device)."""
        p, rc = self.params, self.render_config
        state = self.sim.render
        times = {}
        with self.timer.time("render"), fp32_render():
            self._sync()
            t0 = time.perf_counter()
            scene = self.scene()
            gb, geo_drops = geometry_pass(scene, p.camera, p.camera, state.frame_index, rc)
            self._sync()
            t1 = time.perf_counter()
            times["geometry"] = (t1 - t0) * 1e3
            omni, uni, shadow_drops = shadow_pass(scene, p.lights, p.camera, rc)
            self._sync()
            t2 = time.perf_counter()
            times["shadows"] = (t2 - t1) * 1e3
            lum = deferred_shade(gb, p.lights, p.camera, omni, uni, rc, self.textures)
            self._sync()
            t3 = time.perf_counter()
            times["shade"] = (t3 - t2) * 1e3
            state = state._replace(
                n_raster_drops=state.n_raster_drops + geo_drops + shadow_drops)
            img, hdr, state = postprocess(lum, gb.motion, state, rc)
            self._sync()
            t4 = time.perf_counter()
            times["post"] = (t4 - t3) * 1e3
            if self.visible_gizmos:
                img = self.gizmo_overlay(img, tuple(self.visible_gizmos))
                self._sync()
                times["gizmos"] = (time.perf_counter() - t4) * 1e3
        self.sim = self.sim._replace(render=state)
        self.last_gbuffer = gb
        self.last_hdr = hdr
        self.last_drops = (int(geo_drops), int(shadow_drops))
        self.stage_ms = times
        return img

    def gizmo_lines(self, kinds):
        """(the gizmo lines of ``kinds`` at the current state, the camera's
        unjittered view-projection they are drawn through)."""
        from ..render.camera import projection_matrix, view_matrix
        from ..render.gizmos import build_gizmo_lines

        rc, cam = self.render_config, self.params.camera
        lines = build_gizmo_lines(self.sim, self.params, kinds, aspect=rc.width / rc.height,
                                  n_cascades=self.config.tpu.csm_cascades)
        with fp32_render():
            vp = projection_matrix(cam, rc.width, rc.height, None) @ view_matrix(cam)
        return lines, vp

    def gizmo_overlay(self, img, kinds):
        """The gizmos of ``kinds`` drawn over the u8 frame ``img``."""
        from ..render.gizmos import overlay_lines

        return overlay_lines(img, *self.gizmo_lines(kinds))

    def dropped_raster_candidates(self) -> int:
        """Cumulative raster candidates lost to window or big-block overflow
        across every rendered view so far (the "no silent caps" counter)."""
        return int(self.sim.render.n_raster_drops)

    def dropped_mesh_elements(self):
        """(dropped_verts, dropped_tris) summed over objects: active mesh
        elements that overflowed the compaction caps or the
        render_tris_per_object slice; with a chunk-submesh pool, each chunk
        that found no free slot adds ``chunk_tri_cap`` triangles."""
        m = self.sim.meshes
        dropped_tris = int(m.n_dropped_tris.sum())
        if isinstance(m, ChunkMeshPool):
            dropped_tris += self.config.tpu.chunk_tri_cap * int(m.n_dropped_chunks)
        else:
            k = self.config.tpu.render_tris_per_object
            if k > 0:
                dropped_tris += int(torch.clamp(m.tri_active.sum(dim=-1) - k, min=0).sum())
        return int(m.n_dropped_verts.sum()), dropped_tris

    def deferred_absorptions(self) -> int:
        """Absorber carves the next step defers, estimated at the current
        body poses: in chunked mode the overlapped (object, chunk) windows
        beyond ``absorption_chunk_budget``, else the overlapping objects
        beyond the gate cap."""
        s, tc = self.sim, self.config.tpu
        b = s.phys.bodies
        if not self._features["enable_absorption"]:
            return 0  # a disabled pass defers nothing
        if tc.chunked_remesh:
            hit = _chunk_absorber_hit(s.voxels, self.params.absorbers, b.position, b.orientation)
            return max(int(hit.sum()) - tc.absorption_chunk_budget, 0)
        cap = min(tc.absorption_gate_cap, tc.max_voxel_objects)
        return int(deferred_absorption_count(s.voxels, self.params.absorbers, b.position,
                                             b.orientation, cap))

    def broad_phase_overflow(self) -> int:
        """Shifted-grid broad-phase cell-run overflow at the current state;
        nonzero means candidate pairs may have been missed. Always 0 below
        GRID_BROAD_PHASE_MIN_OBJECTS objects (the dense all-pairs path)."""
        pool = self.sim.voxels
        if pool.n_objects < GRID_BROAD_PHASE_MIN_OBJECTS:
            return 0
        *_, overflow = broad_phase_pairs(
            self.sim.phys.bodies.position[pool.body_index], bounding_radii(pool), pool.alive,
            max_pairs=1, margin=pool.voxel_extent)
        return int(overflow)
