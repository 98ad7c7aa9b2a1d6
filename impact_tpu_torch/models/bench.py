"""The reference bench's configurations, with its scenes as ECS worlds
edited the way ``bench.py`` edits them (``World.set_field``).

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
* ``bench_chunked_config``/``bench_chunked_scene`` (``bench.py:551-640``):
  the asteroid in 4 object slots of 64³ (2 of 128³) i8 grids, 12 (10)
  bodies, 256 contacts, jacobi at dt 0.005, no fracturing, chunked meshing
  with 512 submesh slots and 16 chunks re-meshed a step; 320×200; an
  absorbing sphere of radius 3 at (4, 4, 0) carving it every step. The
  bench sets the asteroid's radius to (G/2 − 4)·0.3, meaning "G/2 − 4
  voxels of 0.3 m", but the radius is in voxels: its asteroid has a radius
  of 8.4 voxels at 64³ (2,423 active voxels) and 18 at 128³, and the
  absorber barely reaches it.
* ``bench_chunked_fill_scene``: the same with a radius of G/2 − 4 voxels,
  as the bench's comment intends (~92k active voxels at 64³, ~0.9 M at
  128³), where the carve removes voxels (4,167 on step 1 at 64³, splitting
  the asteroid into 3 objects; ROADMAP Queue 3). Everything else is the
  bench's.
"""

from __future__ import annotations

from ..ecs import components as C
from ..utils.config import EngineConfig
from .scenes import asteroid, fracturing, voxel_box_tumbler

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
    """``bench.py:182-191``: the tumbler's boxes grown to 26 voxels a side."""
    world = voxel_box_tumbler(N_BOXES, SEED)
    for eid in world.entities_with(C.VoxelBox):
        for f in ("extent_x", "extent_y", "extent_z"):
            world.set_field(eid, C.VoxelBox, f, BOX_EXTENT)
    return world


def bench_step_scene():
    """The bench scene with box i at height 6 + 11.5·i."""
    world = bench_scene()
    for i, eid in enumerate(world.entities_with(C.VoxelBox)):
        pos = world.get_component(eid, C.ReferenceFrame).position
        pos[1] = 6.0 + STEP_SPACING * i
        world.set_field(eid, C.ReferenceFrame, "position", pos)
    return world


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
    """``bench.py:483-491``: the fracturing scene with the target's fracture
    radius and impulse threshold set."""
    world = fracturing()
    for eid in world.entities_with(C.FracturingProperties):
        world.set_field(eid, C.FracturingProperties, "fracture_radius", FRACTURE_RADIUS)
        world.set_field(eid, C.FracturingProperties, "impulse_threshold", FRACTURE_THRESHOLD)
    return world


CHUNKED_SUBMESH_SLOTS, CHUNKED_REMESH_BUDGET = 512, 16
CHUNKED_WIDTH, CHUNKED_HEIGHT = 320, 200


def bench_chunked_config(grid_size: int) -> EngineConfig:
    cfg = EngineConfig()
    t = cfg.tpu
    n_obj = 4 if grid_size <= 64 else 2
    t.max_voxel_objects = n_obj
    t.max_bodies = n_obj + 8
    t.max_contacts = 256
    t.voxel_grid_size = grid_size
    t.render_width, t.render_height = CHUNKED_WIDTH, CHUNKED_HEIGHT
    t.solver_mode = "jacobi"
    t.sdf_encoding = "i8"
    t.chunked_remesh = True
    t.chunk_submesh_slots = CHUNKED_SUBMESH_SLOTS
    t.chunk_remesh_budget = CHUNKED_REMESH_BUDGET
    cfg.physics.simulator.initial_time_step_duration = DT
    return cfg


def _chunked(radius_voxels: float):
    """``bench.py:592-604``: the asteroid's radius set, and the carving
    absorber."""
    world = asteroid()
    for eid in world.entities_with(C.VoxelSphere):
        world.set_field(eid, C.VoxelSphere, "radius", radius_voxels)
    world.create_entity(
        C.ReferenceFrame(position=(4.0, 4.0, 0.0)),
        C.VoxelAbsorbingSphere(offset=(0.0, 0.0, 0.0), radius=3.0, rate=2.0))
    return world


def bench_chunked_scene(grid_size: int):
    return _chunked((grid_size / 2 - 4) * 0.3)


def bench_chunked_fill_scene(grid_size: int):
    return _chunked(grid_size / 2 - 4)
