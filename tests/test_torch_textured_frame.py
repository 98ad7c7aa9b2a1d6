"""Textured frames of the port against impact_tpu on the CPU.

* TexturedMaterials (the snapshot tester's 20th scene: the RenderingTest
  arrangement with ``tpu.textured_voxels`` and shadow maps): the port's
  runner steps it once and renders it through K1 (its plain version on the
  CPU). The frame is scored against its golden at the harness's 0.93, and
  against the reference's render of the same state at the repo's parity
  bar of 0.95: the port's compacted render scene, lights and camera handed
  to impact_tpu's render stages (XLA raster, its own texture set).
* A textured box entity (tests/test_textured_materials.py's scene, as
  ``chip_smoke.py:textured_box_scene`` holds it: a checkerboard colour, a
  noise normal map and a parallax height map, lit by a directional light)
  compiled and rendered by each package from its
  own scene description, at ≥ 0.95 to each other; the port's texture set
  equals the reference's (within 1e-6, mip means summed in another order).
* A scene compiled with 5 voxel types and run with no registry: the layer
  counts and offsets of both runtimes, and the frame with voxels of types 3
  and 4 in view against the reference's shade of the same scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import pytest
from chip_smoke import textured_box_config, textured_box_scene, textured_box_textures
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_snapshot_scenes import reference_harness

from impact_tpu.ecs import World
from impact_tpu.ecs import components as C
from impact_tpu.render import pipeline as jpipe
from impact_tpu.render import textures as jtex
from impact_tpu.render.camera import Camera as JCamera
from impact_tpu.render.lights import LightPools as JLightPools
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.runtime.setup import register_texture
from impact_tpu.runtime.setup import render_config_from_engine_config as jrender_config
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch.apps import snapshot_tester as st
from impact_tpu_torch.ecs import components as TC
from impact_tpu_torch.runtime import setup as tsetup
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.utils.config import EngineConfig
from impact_tpu_torch.utils.image import rgb_hybrid_compare

PARITY_BAR = 0.95


@pytest.fixture(autouse=True)
def port_textures():
    """The port's texture registry as it was before each test."""
    saved = dict(tsetup.TEXTURE_SOURCES)
    yield
    tsetup.TEXTURE_SOURCES.clear()
    tsetup.TEXTURE_SOURCES.update(saved)


def J(t):
    return jnp.asarray(t.numpy())


def test_textured_materials_frame_matches_golden_and_reference_render():
    img, rt = st.render_scene("TexturedMaterials", "cpu")
    score = st.score("TexturedMaterials", img)
    assert score >= st.MIN_SCORE_TO_PASS, score
    assert rt.last_drops == (0, 0)
    assert rt.textures is not None and rt.textures.props is None
    # the voxel corners carry their types as texture layers
    scene = rt.scene()
    assert bool((scene.tri_material[scene.tri_active] >= 0).any())

    ref_st = reference_harness()
    jcfg = ref_st._snapshot_config()
    ref_st.FEATURE_SCENES["TexturedMaterials"][1](jcfg)
    rc = jrender_config(jcfg)
    assert rc.textured
    jtextures = jtex.build_scene_texture_set(rt.params.material_table.shape[0], [],
                                             jcfg.tpu.texture_resolution)
    for a, b in zip(rt.textures.albedo.mips + rt.textures.normal.mips,
                    jtextures.albedo.mips + jtextures.normal.mips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)

    @jax.jit
    def frame(jscene, lights, cam, textures):
        gb, _ = jpipe.geometry_pass(jscene, cam, cam, 0, rc)
        omni, uni, _ = jpipe.shadow_pass(jscene, lights, cam, rc)
        lum = jpipe.deferred_shade(gb, lights, cam, omni, uni, rc, textures)
        return jpipe.postprocess(lum, gb.motion, jpipe.init_render_state(rc), rc)[0]

    ref = np.asarray(frame(jpipe.RenderScene(*(J(a) for a in scene)),
                           JLightPools(*(J(a) for a in rt.params.lights)),
                           JCamera(*(J(a) for a in rt.params.camera)), jtextures))
    parity = rgb_hybrid_compare(img, ref)
    assert parity >= PARITY_BAR, parity


def reference_box_world():
    """The same box, lit alike, as the reference's entities."""
    tex = textured_box_textures()
    ids = {k: register_texture(f"torch-port-box-{k}", v) for k, v in tex.items()}
    w = World()
    w.create_entity(C.ReferenceFrame(position=(0.0, 0.0, 0.0), orientation=(0.0, 1.0, 0.0, 0.0)),
                    C.PerspectiveCamera(vertical_field_of_view=np.radians(50),
                                        near_distance=0.01, far_distance=100.0))
    w.create_entity(C.AmbientEmission(illuminance=(3e3, 3e3, 3e3)))
    w.create_entity(C.BoxMesh(), C.ModelTransform(scale=1.4),
                    C.ReferenceFrame(position=(0.0, 0.0, 2.6)),
                    C.UniformColor(color=(0.6, 0.6, 0.6)),
                    C.TexturedColor(texture_id=ids["checker"]),
                    C.NormalMap(texture_id=ids["normal"]),
                    C.ParallaxMap(height_map_texture_id=ids["height"], displacement_scale=0.08))
    w.create_entity(C.UnidirectionalEmission(perpendicular_illuminance=(3e3, 3e3, 3e3),
                                             direction=(0.4, -0.4, 0.8),
                                             angular_source_extent=0.0))
    return w


def test_textured_box_entity_matches_reference_render():
    jcfg = textured_box_config(JConfig())
    jrt = JRuntime(jcompile(reference_box_world(), jcfg), jcfg, enable_fracturing=False)
    ref = np.asarray(jrt.render())
    cfg = textured_box_config(EngineConfig())
    rt = HeadlessRuntime(compile_scene(textured_box_scene(), cfg, device="cpu"), cfg,
                         enable_fracturing=False)
    img = rt.render().numpy()
    assert rt.render_config.textured and rt.textures.full_pbr.tolist() == [1.0]
    for a, b in zip(rt.textures.albedo.mips + rt.textures.normal.mips + rt.textures.props.mips,
                    jrt._textures.albedo.mips + jrt._textures.normal.mips
                    + jrt._textures.props.mips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    # the box face fills the middle of the frame, textured
    face = img[28:68, 44:84].astype(np.float32)
    assert face.std(axis=(0, 1)).max() > 8.0
    parity = rgb_hybrid_compare(img, ref)
    assert parity >= PARITY_BAR, parity
    # the parallax map moves the sampled texture
    flat = textured_box_scene()
    flat.remove_component(flat.entities_with(TC.ParallaxMap)[0], TC.ParallaxMap)
    rt2 = HeadlessRuntime(compile_scene(flat, cfg, device="cpu"), cfg, enable_fracturing=False)
    assert np.abs(rt2.render().numpy().astype(int) - img.astype(int)).max() > 8
    assert torch.equal(rt.params.mesh_instances.material, torch.tensor([0], dtype=torch.int32))


FIVE_TYPES = [{"name": f"type{i}", "color": (0.2 * i, 0.5, 0.9 - 0.1 * i)} for i in range(5)]


def test_texture_layers_follow_the_runtime_registry():
    """A scene compiled with a registry of 5 voxel types and run with none:
    both runtimes keep the default registry (3 types), so the voxel-type
    texture layers number 3 and the box entity's layer is offset by 3, to
    layer 3, where voxel type 3 reads too (a reference fault, reproduced).
    Two voxel boxes of types 3 and 4 in view render as the reference's
    shade renders them: its gathers clamp type 4 to the last layer, 3.
    Run with the same registry, the layers number 5 and the offset is 5."""
    import inspect

    from impact_tpu.scene.materials import make_voxel_type_registry as jregistry
    from impact_tpu_torch.scene.materials import make_voxel_type_registry

    jcfg = textured_box_config(JConfig())
    jcfg.tpu.textured_voxels = True
    jrt = JRuntime(jcompile(reference_box_world(), jcfg, registry=jregistry(FIVE_TYPES)), jcfg,
                   enable_fracturing=False)
    ref_params = inspect.getclosurevars(jrt._scene_of.__wrapped__).nonlocals["params"]
    cfg = textured_box_config(EngineConfig())
    cfg.tpu.textured_voxels = True
    cfg.tpu.max_voxel_objects = 2
    world = textured_box_scene()
    for x, voxel_type in ((-1.5, 3), (1.5, 4)):
        world.create_entity(TC.ReferenceFrame(position=(x, 0.0, 2.8)),
                            TC.VoxelBox(voxel_extent=0.3, extent_x=3.0, extent_y=3.0,
                                        extent_z=3.0),
                            TC.SameVoxelType(voxel_type=voxel_type))
    reg = make_voxel_type_registry(FIVE_TYPES, device="cpu")
    build = compile_scene(world, cfg, registry=reg, device="cpu")
    assert build.params.material_table.shape[0] == 5
    rt = HeadlessRuntime(build, cfg, enable_fracturing=False)
    assert rt.registry.n_types == jrt.registry.n_types == 3
    assert rt._mesh_instances.material.tolist() == np.asarray(
        ref_params.mesh_instances.material).tolist() == [3]
    assert rt.textures.albedo.mips[0].shape[0] == jrt._textures.albedo.mips[0].shape[0] == 4
    assert rt.textures.full_pbr.tolist() == [0.0, 0.0, 0.0, 1.0]

    # the frame: the port's against the reference's shade of the same scene
    # with the reference's own texture set
    img = rt.render().numpy()
    scene = rt.scene()
    assert torch.unique(scene.tri_material[scene.tri_active]).tolist() == [3, 4]
    rc = jrender_config(jcfg)

    @jax.jit
    def frame(jscene, lights, cam, textures):
        gb, _ = jpipe.geometry_pass(jscene, cam, cam, 0, rc)
        omni, uni, _ = jpipe.shadow_pass(jscene, lights, cam, rc)
        lum = jpipe.deferred_shade(gb, lights, cam, omni, uni, rc, textures)
        return jpipe.postprocess(lum, gb.motion, jpipe.init_render_state(rc), rc)[0]

    ref = np.asarray(frame(jpipe.RenderScene(*(J(a) for a in scene)),
                           JLightPools(*(J(a) for a in rt.params.lights)),
                           JCamera(*(J(a) for a in rt.params.camera)), jrt._textures))
    parity = rgb_hybrid_compare(img, ref)
    assert parity >= PARITY_BAR, parity

    with_registry = HeadlessRuntime(build, cfg, registry=reg, enable_fracturing=False)
    assert with_registry.registry.n_types == 5
    assert with_registry._mesh_instances.material.tolist() == [5]
    assert with_registry.textures.albedo.mips[0].shape[0] == 6
