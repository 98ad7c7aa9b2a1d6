"""The Voxel Range game (``apps/impact_game.py``) in the port against
impact_tpu on the CPU, with one reference compile of the range world shared
across the module.

* The range world compiles in the port equal to the reference's compile
  (``tests/test_torch_world_compile.py``'s field-by-field bar).
* The carry-over of state from a JAX run into the port: impact_tpu steps
  the range to frame CHECKPOINT_FRAME and writes its checkpoint (in the
  reference's run the targets shatter on landing at frame 57, their
  fragments fill the 24 object slots by frame 66, and from frame 80 the
  pieces rest on the floor with floor contacts every frame); the port loads
  that file into its runtime of the same world and steps 3 more frames,
  which must match the reference's next 3 within the scan tests' rtol 1e-5
  and an atol of 1e-6 of each field's magnitude, the live objects exactly.
  The reference's fracture draws of those frames are handed to the port
  (``fracture_uniforms``), as ``tests/test_torch_engine_step.py`` does.

No test plays the whole game here (400 frames take ~2 minutes on the
CPU); ``chip_smoke.py`` plays it on the card.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_world_compile import assert_builds_equal, cache_small_compiles  # noqa: F401

from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch.apps import impact_game
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

CHECKPOINT_FRAME = 80
RESUMED_FRAMES = 3
RTOL, ATOL_OF_MAGNITUDE = 1e-5, 1e-6
FIELDS = ("position", "orientation", "velocity", "angular_velocity", "momentum",
          "angular_momentum")


def reference_game():
    path = pathlib.Path(__file__).resolve().parents[1] / "apps" / "impact_game.py"
    spec = importlib.util.spec_from_file_location("reference_impact_game", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_config():
    """``apps/impact_game.py:play``'s configuration, one step per dispatch."""
    cfg, port = JConfig(), impact_game.range_config()
    for f in ("max_voxel_objects", "max_bodies", "max_contacts", "voxel_grid_size",
              "render_width", "render_height", "max_fracture_fragments"):
        setattr(cfg.tpu, f, getattr(port.tpu, f))
    cfg.physics.simulator.initial_time_step_duration = 0.01
    cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = 128
    cfg.tpu.steps_per_dispatch = 1
    return cfg


def jax_fracture_uniforms(key):
    """The reference's fracture draws from ``key`` on: each event splits the
    key and draws three uniform vectors from its sub-key's three splits
    (engine.py:540, interaction.py:744-758)."""
    state = [key]

    def draw(generator, n_seeds):
        state[0], sub = jax.random.split(state[0])
        kt, kp, kr = jax.random.split(sub, 3)
        draws = (jax.random.uniform(kt, (n_seeds,), minval=-0.5, maxval=0.5),
                 jax.random.uniform(kp, (n_seeds,), minval=-0.5, maxval=0.5),
                 jax.random.uniform(kr, (n_seeds,)))
        return tuple(torch.from_numpy(np.array(d)) for d in draws)

    return draw


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory, cache_small_compiles):
    """The reference's compile of the range world, its run to the
    checkpoint frame with the checkpoint written, and its next frames."""
    jcfg = reference_config()
    build = jcompile(reference_game().build_range_world(), jcfg)
    rt = JRuntime(build, jcfg)
    rt.step(CHECKPOINT_FRAME)
    path = tmp_path_factory.mktemp("range") / "range.npz"
    rt.save_checkpoint(path, {"frame": CHECKPOINT_FRAME})
    key = rt.sim.rng
    frames = []
    for _ in range(RESUMED_FRAMES):
        rt.step(1)
        b = rt.sim.phys.bodies
        frames.append(dict({f: np.asarray(getattr(b, f)) for f in FIELDS},
                           alive=np.asarray(rt.sim.voxels.alive),
                           active=np.asarray(rt.sim.phys.solver_cache.active)))
    return dict(build=build, path=path, key=key, frames=frames)


def test_range_world_compiles_as_the_reference(reference_run):
    got = compile_scene(impact_game.build_range_world(), impact_game.range_config(),
                        device="cpu")
    assert_builds_equal(got, reference_run["build"])
    assert got.info["n_voxel_objects"] == 6 and got.info["n_regular_bodies"] == 1


def test_reference_checkpoint_resumes_in_the_port(reference_run):
    cfg = impact_game.range_config()
    rt = HeadlessRuntime(compile_scene(impact_game.build_range_world(), cfg, device="cpu"), cfg,
                         fracture_uniforms=jax_fracture_uniforms(reference_run["key"]))
    assert rt.load_checkpoint(reference_run["path"]) == {"frame": CHECKPOINT_FRAME}
    assert rt.sim.render.frame_index == 0 and float(rt.sim.phys.time) > 0.5
    # the meshes' vertex materials load from the reference's file
    with np.load(reference_run["path"]) as data:
        for f in ("vert_type", "vert_type2", "vert_blend"):
            np.testing.assert_array_equal(getattr(rt.sim.meshes, f).numpy(), data[f"meshes/{f}"])
    # at the checkpoint the targets have shattered: fragments fill the pool
    assert int(rt.sim.voxels.alive.sum()) == 24
    for k, want in enumerate(reference_run["frames"]):
        rt.step(1)
        b = rt.sim.phys.bodies
        np.testing.assert_array_equal(rt.sim.voxels.alive.numpy(), want["alive"])
        for f in FIELDS:
            ref = want[f]
            atol = ATOL_OF_MAGNITUDE * max(float(np.abs(ref).max()), 1.0)
            np.testing.assert_allclose(getattr(b, f).numpy(), ref, rtol=RTOL, atol=atol,
                                       err_msg=f"frame {CHECKPOINT_FRAME + k + 1}: {f}")
        assert int(rt.sim.phys.solver_cache.active.sum()) == int(want["active"].sum()) > 0
