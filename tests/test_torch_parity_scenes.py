"""The reference snapshot tester's 13 scenes in the port
(``impact_tpu_torch/models/parity_scenes.py``) and the port's parity harness
(``impact_tpu_torch/apps/parity_snapshots.py``) against impact_tpu on the
CPU: the scene table, the harness's overrides, and each scene's compile.
The frames are in ``tests/test_torch_parity_scenes_frames.py`` (a file of
their own, so that ``--dist loadfile`` spreads them).

* The scene table: the same 13 names and feature switches.
* The overrides: the configuration that the reference harness
  (``apps/parity_snapshots.py:build_runtime``) hands to ``compile_scene`` is
  captured with its config file stood in for by ``EngineConfig()`` and its
  ``compile_scene`` and ``HeadlessRuntime`` stubbed (nothing of the
  reference changes); the port's harness, run on ``EngineConfig()`` with the
  same stubs, must hand over the same value in every field the port
  carries, the same world and the same runtime flags.
* The compiles: the port's world of each scene compiled with the port's
  configuration against the reference's world compiled with the captured
  one, under ``tests/test_torch_world_compile.py``'s bars.
"""

import functools
import importlib.util
import pathlib

import jax
import pytest
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_world_compile import assert_builds_equal

import impact_tpu.runtime as jruntime
import impact_tpu.runtime.setup as jsetup
import impact_tpu.voxel.mesh as jmesh
from impact_tpu.models.parity_scenes import PARITY_SCENES as JPARITY
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch.apps import parity_snapshots as ps
from impact_tpu_torch.models.parity_scenes import PARITY_SCENES
from impact_tpu_torch.runtime import compile_scene
from impact_tpu_torch.runtime.setup import RASTER_BACKENDS
from impact_tpu_torch.utils.config import EngineConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def reference_harness():
    """The reference's apps/parity_snapshots.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location("reference_parity_snapshots",
                                                  ROOT / "apps" / "parity_snapshots.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_handoff(name, mp):
    """What the reference harness's build_runtime(name) hands on, with its
    config file replaced by EngineConfig() → dict(world, cfg, flags);
    ``mp`` is a pytest MonkeyPatch."""
    seen = {}
    mp.setattr(JConfig, "from_ron_file", staticmethod(lambda path: JConfig()))
    mp.setattr(jruntime, "compile_scene",
               lambda world, cfg: seen.update(world=world, cfg=cfg) or "build")
    mp.setattr(jruntime, "HeadlessRuntime",
               lambda build, cfg, **flags: seen.update(flags=flags))
    reference_harness().build_runtime(name)
    return seen


@functools.lru_cache(maxsize=None)
def _jitted_surface_nets(merge_levels):
    return jax.jit(jmesh.make_surface_nets_batched(merge_levels))


def jcompile(world, cfg):
    """The reference's ``compile_scene`` with its setup's Surface Nets and
    compaction jitted (eager, they cost seconds of op-by-op dispatch per
    world here)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsetup, "make_surface_nets_batched", _jitted_surface_nets)
        mp.setattr(jsetup, "compact_mesh_batched",
                   jax.jit(jmesh.compact_mesh_batched, static_argnums=(1, 2)))
        return jruntime.compile_scene(world, cfg)


def reference_config(name):
    """The reference harness's configuration of scene ``name`` on
    EngineConfig()."""
    with pytest.MonkeyPatch.context() as mp:
        return reference_handoff(name, mp)["cfg"]


def port_handoff(name, mp):
    seen = {}
    mp.setattr("impact_tpu_torch.runtime.compile_scene",
               lambda world, cfg, device: seen.update(world=world, cfg=cfg, device=device)
               or "build")
    mp.setattr("impact_tpu_torch.runtime.HeadlessRuntime",
               lambda build, cfg, **flags: seen.update(flags=flags))
    ps.build_runtime(name, cfg=EngineConfig(), device="cpu")
    return seen


def assert_config_fields_equal(got, ref, what="cfg"):
    """Every field of the port's config dataclass tree equal to the
    reference's field of the same path."""
    import dataclasses

    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_config_fields_equal(getattr(got, f.name), getattr(ref, f.name),
                                       f"{what}.{f.name}")
    else:
        if what == "cfg.tpu.raster_backend":  # the reference's backend names name the port's
            ref = RASTER_BACKENDS.get(ref, ref)
        assert got == ref or (isinstance(got, tuple) and tuple(got) == tuple(ref)), (what, got,
                                                                                       ref)


@pytest.fixture(scope="module", autouse=True)
def cache_small_compiles():
    """The reference's compile of a world runs hundreds of small XLA
    compiles under the suite's 2 s floor for the persistent compilation
    cache: cache them too while this module runs."""
    floor = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", floor)


def test_scene_table_matches_reference():
    assert list(PARITY_SCENES) == list(JPARITY)
    for name, (_, feats) in PARITY_SCENES.items():
        assert feats == JPARITY[name][1], name


@pytest.mark.parametrize("name", list(JPARITY))
def test_overrides_match_reference(name, monkeypatch):
    ref = reference_handoff(name, monkeypatch)
    got = port_handoff(name, monkeypatch)
    assert got["device"] == "cpu"
    assert got["flags"] == ref["flags"] == dict(enable_fracturing=False, enable_absorption=False,
                                                enable_splitting=False)
    assert_config_fields_equal(got["cfg"], ref["cfg"])
    t = got["cfg"].tpu
    assert (t.render_width, t.render_height, t.max_voxel_objects, t.voxel_grid_size) == (
        768, 512, 1, 16)
    assert tuple(t.sky_luminance) == (0.0, 0.0, 0.0)
    # the scene's world (its compile is held below)
    assert got["world"].n_alive == ref["world"].n_alive


def test_base_config_and_goldens(tmp_path, monkeypatch):
    """The reference harness's own paths are read from its source; a given
    config and golden directory win; without the reference checkout the
    harness starts from EngineConfig() and scores against the repo's JAX
    renders, and its labels say so."""
    paths = ps.reference_paths()
    assert paths["REF_CONFIG"] == pathlib.Path(reference_harness().REF_CONFIG)
    assert paths["REF_DIR"] == reference_harness().REF_DIR
    ron = tmp_path / "engine_config.ron"
    ron.write_text("(tpu: (bf16_shading: true))")
    cfg, label = ps.load_base_config(ron)
    assert cfg.tpu.bf16_shading and label == str(ron)
    assert ps.golden_dir(tmp_path) == (tmp_path, f"{tmp_path} (given)")
    monkeypatch.setattr(ps, "reference_paths", lambda: {})
    cfg, label = ps.load_base_config(None)
    assert cfg == EngineConfig() and label.startswith("EngineConfig()")
    goldens, label = ps.golden_dir(None)
    assert goldens == ps.JAX_RENDERS and "JAX renders" in label


@pytest.mark.parametrize("name", list(JPARITY))
def test_compile_matches_reference(name):
    ref = jcompile(JPARITY[name][0](), reference_config(name))
    cfg = ps.parity_config(name, EngineConfig())
    got = compile_scene(PARITY_SCENES[name][0](), cfg, device="cpu")
    assert_builds_equal(got, ref)
