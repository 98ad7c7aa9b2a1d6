"""The generation world (``impact_tpu_torch/models/generation.py``: a
sphere union, the voxel generator's example graph and a lowered meta graph
as generated voxel objects, the rectangle, hemisphere, cylinder and cone
meshes, an OBJ and a PLY file) built with each package's ECS and compiled
by each package's ``compile_scene`` on the CPU, at small pools (8 objects of
16³, 32 bodies, 128 contact slots).

The builds are held equal under ``tests/test_torch_world_compile.py``'s
bars (float fields also within 1e-6 of their magnitude: the mass properties
are float32 sums over voxels in another order), and the orthographic
variant sets ``tpu.orthographic_camera`` in both. Each of the world's
components is also stepped in both packages in
``tests/test_torch_world_compile.py``; the world itself steps on the card
(``chip_smoke.py --generation-only``).
"""

import pytest
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_world_compile import (  # noqa: F401  (module fixtures)
    assert_builds_close,
    cache_small_compiles,
    mesh_file_registries,
)

import impact_tpu.runtime.setup as jsetup
from impact_tpu.ecs import World as JWorld
from impact_tpu.ecs import components as JC
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch.models.generation import generation_world
from impact_tpu_torch.runtime import compile_scene
from impact_tpu_torch.utils.config import EngineConfig

G = 16


def small(cfg):
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 8, 32, 128, G
    t.max_fracture_fragments = 4
    t.render_width, t.render_height = 64, 48
    t.steps_per_dispatch = 1
    cfg.physics.rigid_body_force.drag_load_map_config.directory = None
    return cfg


def build_both(tmp_path, orthographic=False):
    jw, jgens = generation_world(tmp_path / "ref", G, orthographic,
                                 ecs=(JWorld, JC, jsetup.register_mesh_file))
    tw, tgens = generation_world(tmp_path / "port", G, orthographic)
    assert jgens == tgens
    jcfg, cfg = small(JConfig()), small(EngineConfig())
    ref = jcompile(jw, jcfg, sdf_generators=jgens)
    got = compile_scene(tw, cfg, sdf_generators=tgens, device="cpu")
    return got, cfg, ref, jcfg


@pytest.mark.parametrize("orthographic", [False, True], ids=["perspective", "orthographic"])
def test_generation_world_compiles_as_the_reference(orthographic, tmp_path):
    got, cfg, ref, jcfg = build_both(tmp_path, orthographic)
    assert_builds_close(got, ref)
    assert got.info["n_voxel_objects"] == 3 and got.info["n_unique_shapes"] == 3
    assert got.params.mesh_instances.alive.tolist() == [True] * 6
    assert cfg.tpu.orthographic_camera == jcfg.tpu.orthographic_camera == orthographic
