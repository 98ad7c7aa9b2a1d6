"""The slice end to end: the port's scene compilation, render-scene assembly
and one full frame (shadows, AO, TAA, bloom on) against impact_tpu on CPU.

The reference renders with its XLA tile raster (``raster_backend="xla"``);
the port renders through K1's wrappers, which run K1's plain version on CPU
tensors. Bars: geometry within float32 round-off (atol 1e-4 on world
positions of magnitude ~30, exact masks and materials), G-buffer coverage
agreement > 0.99, and rgb_hybrid_compare ≥ 0.95 (the repo's parity bar,
apps/parity_snapshots.py)."""

import numpy as np
import pytest
import torch

from impact_tpu.models import voxel_box_tumbler as jtumbler
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu.utils.image import rgb_hybrid_compare as j_compare
from impact_tpu_torch import bridge
from impact_tpu_torch.models import voxel_box_tumbler as ttumbler
from impact_tpu_torch.runtime import HeadlessRuntime as TRuntime
from impact_tpu_torch.runtime import compile_scene as tcompile
from impact_tpu_torch.utils.config import EngineConfig as TConfig
from impact_tpu_torch.utils.image import rgb_hybrid_compare

N_BOXES, SEED, W, H, SHADOW = 3, 3, 128, 96, 128


def _configure(cfg, backend):
    cfg.tpu.max_voxel_objects = 4
    cfg.tpu.max_bodies = 20
    cfg.tpu.voxel_grid_size = 32
    cfg.tpu.render_width = W
    cfg.tpu.render_height = H
    cfg.tpu.sdf_encoding = "i8"
    cfg.tpu.render_tris_per_object = 4096
    cfg.tpu.max_render_triangles = 4 * 4096 + 64
    cfg.tpu.raster_backend = backend
    cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = SHADOW
    return cfg


@pytest.fixture(scope="module")
def reference():
    cfg = _configure(JConfig(), "xla")
    cfg.tpu.max_contacts = 64
    build = jcompile(jtumbler(n_boxes=N_BOXES, seed=SEED), cfg)
    rt = JRuntime(build, cfg, enable_fracturing=False)
    scene = rt._scene_of(rt.sim)
    gb = rt._geometry(scene, rt.sim.render.frame_index)[0]
    img = np.asarray(rt.render())
    return dict(build=build, scene=scene, valid=np.asarray(gb.valid), img=img)


@pytest.fixture(scope="module")
def port():
    cfg = _configure(TConfig(), "kernel")
    build = tcompile(ttumbler(n_boxes=N_BOXES, seed=SEED), cfg, device="cpu")
    return cfg, build


def _compare_scenes(port_scene, ref_scene, pos_atol):
    got = bridge.render_scene_to_numpy(port_scene)
    for f, a in got.items():
        b = np.asarray(getattr(ref_scene, f))
        assert a.shape == b.shape, f
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            atol = pos_atol if f.startswith("tri_pos") else 1e-5
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f)


def test_compile_scene_matches_reference(reference, port):
    cfg, build = port
    ref = reference["build"]
    v = ref.sim.voxels
    np.testing.assert_array_equal(build.pool.alive.numpy(), np.asarray(v.alive))
    np.testing.assert_array_equal(build.pool.sdf.numpy(), np.asarray(v.sdf))
    np.testing.assert_array_equal(build.pool.vtype.numpy(), np.asarray(v.vtype))
    np.testing.assert_allclose(build.pool.origin.numpy(), np.asarray(v.origin), atol=1e-5)
    np.testing.assert_allclose(build.body_position.numpy(),
                               np.asarray(ref.sim.phys.bodies.position), atol=1e-5)
    np.testing.assert_allclose(build.body_orientation.numpy(),
                               np.asarray(ref.sim.phys.bodies.orientation), atol=1e-6)
    for f in build.lights._fields:
        np.testing.assert_allclose(getattr(build.lights, f).numpy(),
                                   np.asarray(getattr(ref.params.lights, f)), atol=1e-6,
                                   err_msg=f)
    for f in build.camera._fields:
        np.testing.assert_allclose(getattr(build.camera, f).numpy(),
                                   np.asarray(getattr(ref.params.camera, f)), atol=1e-6)
    np.testing.assert_array_equal(build.meshes.tri_active.numpy(),
                                  np.asarray(ref.sim.meshes.tri_active))
    np.testing.assert_allclose(build.meshes.tri_albedo.numpy(),
                               np.asarray(ref.sim.meshes.tri_albedo), atol=1e-6)


@pytest.mark.parametrize("source", ["port_build", "bridged_build"])
def test_render_scene_matches_reference(reference, port, source):
    cfg, build = port
    if source == "bridged_build":
        build = bridge.scene_build_from_reference(reference["build"], device="cpu")
    scene = TRuntime(build, cfg).scene()
    _compare_scenes(scene, reference["scene"], pos_atol=1e-4)


@pytest.mark.parametrize("source", ["port_build", "bridged_build"])
def test_frame_matches_reference(reference, port, source):
    cfg, build = port
    if source == "bridged_build":
        build = bridge.scene_build_from_reference(reference["build"], device="cpu")
    rt = TRuntime(build, cfg)
    img = rt.render().numpy()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    assert np.mean(rt.last_gbuffer.valid.numpy() == reference["valid"]) > 0.99
    score = rgb_hybrid_compare(img, reference["img"])
    assert score >= 0.95, score
    assert abs(score - j_compare(img, reference["img"])) < 1e-6
    assert set(rt.stage_ms) == {"geometry", "shadows", "shade", "post"}


@pytest.mark.parametrize("backend", ["raster", "kernel"])
def test_geometry_pass_on_reference_scene(reference, port, backend):
    """The reference's own RenderScene, carried over by the bridge, through
    the port's geometry pass: G-buffer coverage against the reference's XLA
    geometry pass, and the bridge's round trip back to numpy."""
    from impact_tpu_torch.render.pipeline import fp32_render, geometry_pass
    from impact_tpu_torch.runtime import render_config_from_engine_config

    cfg, _ = port
    rc = render_config_from_engine_config(cfg)._replace(raster_backend=backend)
    scene = bridge.render_scene_from_reference(reference["scene"], device="cpu")
    back = bridge.render_scene_to_numpy(scene)
    for f, a in back.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(reference["scene"], f)))
    cam = bridge.camera_from_reference(reference["build"].params.camera, device="cpu")
    with fp32_render():
        gb, n_drop = geometry_pass(scene, cam, cam, 0, rc)
    assert np.mean(gb.valid.numpy() == reference["valid"]) > 0.99
    assert gb.material.dtype == torch.int32 and int(n_drop) >= 0
