"""The bench configuration (``bench.py:139-187`` of the reference): the
voxel-box tumbler with 62 boxes of 26³ voxels in 64 object slots of 32³ i8
grids, rendered at 1920×1080 with 512² shadow maps, AO, TAA, bloom and ACES;
4096 render triangles per object and a raster budget covering every slot."""

from __future__ import annotations

from ..utils.config import EngineConfig
from .scenes import voxel_box_tumbler

N_BOXES, SEED, BOX_EXTENT = 62, 3, 26.0
N_OBJECTS = 64
WIDTH, HEIGHT = 1920, 1080
SHADOW_RES = 512
TRIS_PER_OBJECT = 4096


def bench_config(width: int = WIDTH, height: int = HEIGHT,
                 backend: str = "kernel") -> EngineConfig:
    cfg = EngineConfig()
    t = cfg.tpu
    t.max_voxel_objects = N_OBJECTS
    t.max_bodies = N_OBJECTS + 16
    t.voxel_grid_size = 32
    t.render_width, t.render_height = width, height
    t.sdf_encoding = "i8"
    t.render_tris_per_object = TRIS_PER_OBJECT
    t.max_render_triangles = N_OBJECTS * TRIS_PER_OBJECT + 64
    t.raster_backend = backend
    cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = SHADOW_RES
    return cfg


def bench_scene():
    return voxel_box_tumbler(N_BOXES, SEED, box_extent=BOX_EXTENT)
