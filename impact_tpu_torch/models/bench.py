"""The reference bench's two configurations.

* ``bench_config``/``bench_scene`` (``bench.py:139-195``): the voxel-box
  tumbler with 62 boxes of 26³ voxels in 64 object slots of 32³ i8 grids,
  80 bodies, 1024 contacts, the jacobi solver at dt 0.005, no fracturing;
  rendered at 1920×1080 with 512² shadow maps, AO, TAA, bloom and ACES,
  4096 render triangles per object and a raster budget covering every slot.
* ``bench_step_scene``: the same 62 boxes for stepping, box i at height
  6 + 11.5·i instead of the bench's 6 + 5·i. The bench kept the tumbler's
  5 m spacing when it grew the boxes from 10 to 26 voxels (6.5 m), so its
  tower starts interpenetrated and the jacobi solve diverges on the first
  step in the reference package as in the port (ROADMAP Queue 3); 11.5 m
  clears a box's bounding-sphere diameter (6.5·√3 ≈ 11.26 m). Widths,
  counts, seeds and the x/z placement are the bench's.
* ``bench_fracture_config``/``bench_fracture_scene`` (``bench.py:447-500``):
  the fracturing scene (a 14-voxel box, a radius-5 sphere at 18 m/s) with
  208 object slots, 224 bodies, 1024 contacts, 32³ i8 grids, jacobi at
  dt 0.005, up to 192 fragments in one event per step, fracture radius 2.5
  and impulse threshold 5.0; rendered at 320×200.
"""

from __future__ import annotations

from ..utils.config import EngineConfig
from .scenes import fracturing, voxel_box_tumbler

N_BOXES, SEED, BOX_EXTENT = 62, 3, 26.0
N_OBJECTS = 64
WIDTH, HEIGHT = 1920, 1080
SHADOW_RES = 512
TRIS_PER_OBJECT = 4096
DT = 0.005
STEP_SPACING = 11.5

FRACTURE_FRAGMENTS = 192
FRACTURE_RADIUS, FRACTURE_THRESHOLD = 2.5, 5.0
FRACTURE_WIDTH, FRACTURE_HEIGHT = 320, 200


def _physics(cfg: EngineConfig) -> EngineConfig:
    cfg.tpu.max_contacts = 1024
    cfg.tpu.voxel_grid_size = 32
    cfg.tpu.solver_mode = "jacobi"
    cfg.tpu.sdf_encoding = "i8"
    cfg.physics.simulator.initial_time_step_duration = DT
    return cfg


def bench_config(width: int = WIDTH, height: int = HEIGHT,
                 backend: str = "kernel") -> EngineConfig:
    cfg = _physics(EngineConfig())
    t = cfg.tpu
    t.max_voxel_objects = N_OBJECTS
    t.max_bodies = N_OBJECTS + 16
    t.render_width, t.render_height = width, height
    t.render_tris_per_object = TRIS_PER_OBJECT
    t.max_render_triangles = N_OBJECTS * TRIS_PER_OBJECT + 64
    t.raster_backend = backend
    cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = SHADOW_RES
    return cfg


def bench_scene():
    return voxel_box_tumbler(N_BOXES, SEED, box_extent=BOX_EXTENT)


def bench_step_scene():
    return voxel_box_tumbler(N_BOXES, SEED, box_extent=BOX_EXTENT, spacing=STEP_SPACING)


def bench_fracture_config(n_fragments: int = FRACTURE_FRAGMENTS) -> EngineConfig:
    cfg = _physics(EngineConfig())
    t = cfg.tpu
    t.max_voxel_objects = n_fragments + 16
    t.max_bodies = n_fragments + 32
    t.render_width, t.render_height = FRACTURE_WIDTH, FRACTURE_HEIGHT
    t.max_fracture_fragments = n_fragments
    t.max_fracture_events = 1
    return cfg


def bench_fracture_scene():
    return fracturing(impulse_threshold=FRACTURE_THRESHOLD, fracture_radius=FRACTURE_RADIUS)
