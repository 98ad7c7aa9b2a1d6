"""The voxel, physics, runtime and config names of the reference's surface
against impact_tpu on the CPU, on the same numpy inputs.

* ``split_off_disconnected_region``: every pool leaf and both flags equal
  to the reference's (f32 and i8 pools) for one connected grid, two
  components of unequal and of equal size, ``free_slot = -1`` and an alive
  free slot. It labels through ``connected_component_labels``, the labels
  kernel on the card (``chip_smoke.py``'s surface phase).
* ``connected_component_labels(occ, max_iters)`` equal to the reference's
  at 1, 2 and 5 sweeps and at the fixpoint; ``connected_component_labels_pallas``
  and ``ccl_propagate_sweeps`` equal to the reference's XLA labels and
  sweeps (its Pallas kernel's diagonal leak is a recorded difference).
* ``sample_sdf_trilinear`` and ``sample_sdf_gradient`` within 1e-6;
  ``empty_voxel_object_pool`` and ``empty_collidable_pools`` equal;
  ``make_surface_nets_batched`` and ``compact_mesh_batched`` equal to the
  port's own batched meshing (held to the reference by
  ``tests/test_torch_voxel_mesh.py``).
* The inertia functions within 1e-6 of magnitude (``mesh_inertial_properties``
  sums in float64 numpy, as the reference does; 1e-5 for ``rotated_inertia``,
  whose einsum sums in another order); ``sample_drag_load`` within 1e-5 of
  magnitude; ``native.available``; ``SceneBuildResult``.
* ``EngineConfig``: ``dataclasses.asdict`` equal to the reference's for the
  same RON text (the RON config of ``tests/test_torch_ron_config.py`` and
  one that sets every section), ``tpu.raster_backend`` read through the
  port's names for the reference's backends.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ron_config import CONFIG_RON

import impact_tpu.native as jnative
from impact_tpu.physics import collision as jcoll
from impact_tpu.physics import drag_map as jdrag
from impact_tpu.physics import inertia as jinertia
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu.voxel import collision as jvcoll
from impact_tpu.voxel import interaction as jinter
from impact_tpu.voxel import object as jobject
from impact_tpu_torch import native as tnative
from impact_tpu_torch.ops import ccl_pallas as tccl
from impact_tpu_torch.physics import collision as tcoll
from impact_tpu_torch.physics import drag_map as tdrag
from impact_tpu_torch.physics import inertia as tinertia
from impact_tpu_torch.runtime import setup as tsetup
from impact_tpu_torch.runtime.setup import RASTER_BACKENDS
from impact_tpu_torch.utils.config import EngineConfig
from impact_tpu_torch.voxel import collision as tvcoll
from impact_tpu_torch.voxel import interaction as tinter
from impact_tpu_torch.voxel import mesh as tmesh
from impact_tpu_torch.voxel import object as tobject

G = 12


def to_torch(pool):
    """A reference pool as the port's (body slots as i64)."""
    leaves = {k: torch.from_numpy(np.array(v)) for k, v in pool._asdict().items()}
    leaves["body_index"] = leaves["body_index"].long()
    return tobject.VoxelObjectPool(**leaves)


def assert_pool_equal(got, ref):
    for name in ref._fields:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.shape == r.shape and np.array_equal(g, r.astype(g.dtype)), name


def two_blobs(sizes):
    """bool [G,G,G]: boxes of the given edge lengths, apart (None: one
    connected L-shape)."""
    occ = np.zeros((G, G, G), bool)
    if sizes is None:
        occ[1:6, 1:3, 1:3] = True
        occ[1:3, 1:8, 1:3] = True
        return occ
    a, b = sizes
    occ[1:1 + a, 1:1 + a, 1:1 + a] = True
    occ[-1 - b:-1, -1 - b:-1, -1 - b:-1] = True
    return occ


def pool_with(occ, sdf_dtype, alive_slots=(0,)):
    pool = jobject.empty_voxel_object_pool(4, G, sdf_dtype)
    sdf = np.asarray(pool.sdf).copy()
    rng = np.random.default_rng(int(occ.sum()))
    if sdf_dtype == jnp.int8:
        sdf[0] = np.where(occ, -rng.integers(1, 100, occ.shape), 60)
    else:
        sdf[0] = np.where(occ, -rng.uniform(0.1, 1.0, occ.shape), 0.7)
    alive = np.zeros(4, bool)
    alive[list(alive_slots)] = True
    vtype = rng.integers(0, 3, (4, G, G, G)).astype(np.int32)
    return pool._replace(sdf=jnp.asarray(sdf), alive=jnp.asarray(alive), vtype=jnp.asarray(vtype),
                         voxel_extent=jnp.asarray([0.25, 1.0, 1.0, 1.0], jnp.float32),
                         origin=jnp.asarray(rng.normal(size=(4, 3)), jnp.float32),
                         body_index=jnp.asarray([3, 0, 0, 0], jnp.int32))


SPLITS = {
    "connected": (None, 2),
    "unequal": ((3, 2), 2),
    "equal": ((3, 3), 2),
    "no free slot": ((3, 2), -1),
    "free slot alive": ((3, 2), 1),
}


@pytest.mark.parametrize("case", list(SPLITS))
@pytest.mark.parametrize("sdf_dtype", [jnp.float32, jnp.int8], ids=["f32", "i8"])
def test_split_off_disconnected_region_equals_the_reference(case, sdf_dtype):
    sizes, free_slot = SPLITS[case]
    jpool = pool_with(two_blobs(sizes), sdf_dtype, alive_slots=(0, 1))
    ref, ref_can, ref_disc = jinter.split_off_disconnected_region(jpool, 0, free_slot)
    got, can, disc = tinter.split_off_disconnected_region(to_torch(jpool), 0, free_slot)
    assert_pool_equal(got, ref)
    assert bool(can) == bool(ref_can) and bool(disc) == bool(ref_disc)
    assert can.dtype == disc.dtype == torch.bool
    expect = {"connected": (False, False), "no free slot": (False, True),
              "free slot alive": (False, True)}.get(case, (True, True))
    assert (bool(can), bool(disc)) == expect


def test_labels_at_a_sweep_bound_and_the_kernels_reference_names():
    rng = np.random.default_rng(4)
    occ = rng.uniform(size=(G, G, G)) < 0.45
    t_occ = torch.from_numpy(occ)
    for bound in (1, 2, 5, None):
        ref = np.asarray(jinter.connected_component_labels(jnp.asarray(occ), bound))
        got = tinter.connected_component_labels(t_occ, bound)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref), bound
    full = np.asarray(jinter.connected_component_labels(jnp.asarray(occ)))
    assert np.array_equal(tccl.connected_component_labels_pallas(t_occ).numpy(), full)
    two = np.asarray(jinter.connected_component_labels(jnp.asarray(occ), 6))
    assert np.array_equal(tccl.connected_component_labels_pallas(t_occ, 3, 2).numpy(), two)
    swept = tccl.ccl_propagate_sweeps(t_occ, tccl.initial_labels(t_occ), 2)
    assert np.array_equal(torch.where(t_occ, swept, -1).numpy(),
                          np.asarray(jinter.connected_component_labels(jnp.asarray(occ), 2)))


def test_samplers_pools_and_meshing_names():
    rng = np.random.default_rng(5)
    sdf = rng.normal(size=(G, G, G)).astype(np.float32)
    pts = rng.uniform(-1.0, G + 1.0, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tvcoll.sample_sdf_trilinear(torch.from_numpy(sdf), torch.from_numpy(pts)).numpy(),
        np.asarray(jvcoll.sample_sdf_trilinear(jnp.asarray(sdf), jnp.asarray(pts))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tvcoll.sample_sdf_gradient(torch.from_numpy(sdf), torch.from_numpy(pts)).numpy(),
        np.asarray(jvcoll.sample_sdf_gradient(jnp.asarray(sdf), jnp.asarray(pts))),
        atol=1e-6, rtol=1e-6)
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.int8, torch.int8)):
        assert_pool_equal(tobject.empty_voxel_object_pool(3, 8, tdt, device="cpu"),
                          jobject.empty_voxel_object_pool(3, 8, dt))
    ref = jcoll.empty_collidable_pools(5, 3, 2)
    got = tcoll.empty_collidable_pools(5, 3, 2, device="cpu")
    for name in ref._fields:
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name))), name
    occ = two_blobs((3, 2))[:8, :8, :8]
    grids = torch.from_numpy(np.stack([np.where(occ, -0.5, 0.5), np.where(occ.T, -0.5, 0.5)])
                             .astype(np.float32))
    vt = torch.ones(grids.shape, dtype=torch.int32)
    for merge in (0, 1):
        a = tmesh.make_surface_nets_batched(merge)(grids, vt)
        b = tmesh.surface_nets(grids, vt, merge)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(tmesh.surface_nets_batched(grids, vt),
                                                  tmesh.surface_nets(grids, vt)))
    mesh = tmesh.surface_nets(grids, vt, 1)
    assert all(torch.equal(x, y) for x, y in zip(tmesh.compact_mesh_batched(mesh, 64, 128),
                                                  tmesh.compact_mesh(mesh, 64, 128)))


def _close(got, ref, tol=1e-6):
    r = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), r, rtol=0,
                               atol=tol * max(1.0, float(np.abs(r).max())))


def test_inertia_drag_native_and_scene_build_names():
    rng = np.random.default_rng(6)
    mass = rng.uniform(0.5, 3.0, 4).astype(np.float32)
    for axis in (0, 1, 2):
        _close(tinertia.cylinder_inertia(torch.from_numpy(mass), 0.4, 1.3, axis),
               jinertia.cylinder_inertia(jnp.asarray(mass), 0.4, 1.3, axis))
    inertia = np.array(jinertia.box_inertia(jnp.asarray(mass), jnp.ones((4, 3)) * 1.5))
    offset = rng.normal(size=(4, 3)).astype(np.float32)
    _close(tinertia.translated_inertia(torch.from_numpy(inertia), torch.from_numpy(mass),
                                       torch.from_numpy(offset)),
           jinertia.translated_inertia(jnp.asarray(inertia), jnp.asarray(mass), jnp.asarray(offset)))
    q, _ = np.linalg.qr(rng.normal(size=(4, 3, 3)))
    rot = q.astype(np.float32)
    _close(tinertia.rotated_inertia(torch.from_numpy(inertia), torch.from_numpy(rot)),
           jinertia.rotated_inertia(jnp.asarray(inertia), jnp.asarray(rot)), 1e-5)
    # a closed box mesh off the origin
    v = np.array([[x, y, z] for x in (0, 2) for y in (0, 1) for z in (0, 3)], np.float64) + 0.7
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    for g, r in zip(tinertia.mesh_inertial_properties(v, faces, 2.5, device="cpu"),
                    jinertia.mesh_inertial_properties(v, faces, 2.5)):
        assert g.dtype == torch.float32
        _close(g, r)
    table = rng.normal(size=(8, 16, 6)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for g, r in zip(tdrag.sample_drag_load(torch.from_numpy(table), torch.from_numpy(dirs)),
                    jdrag.sample_drag_load(jnp.asarray(table), jnp.asarray(dirs))):
        _close(g, r, 1e-5)
    assert tnative.available() is True and jnative.available() is True
    build = tsetup.SceneBuildResult("sim", "params", {"k": 1})
    assert (build.sim, build.params, build.info) == ("sim", "params", {"k": 1})


EVERY_SECTION_RON = """
(
    resources: (resource_file_path: Some("r.ron"), lookup_table_dir: Some("lut")),
    rendering: (basic: (enabled: false, timings_enabled: true),
                capturing_camera: (bloom: (blur_filter_radius: 0.01),
                                   average_luminance_computation: (fetch_histogram: true))),
    physics: (simulator: (match_frame_duration: true, max_auto_time_step_duration: Some(0.02),
                          simulation_speed_multiplier_increment_factor: 1.2),
              rigid_body_force: (drag_load_map_config: (n_direction_samples: 100,
                                                        smoothness: 3.0))),
    voxel: (types: (texture_resolution: 64, voxel_types_path: Some("types.ron")),
            interaction: (fracturing: (min_relative_fragment_mass: 0.01,
                                       impact: (radial_grid_size: 32, seed: 7)))),
    controller: (motion: SemiDirectional((movement_speed: 8.0, vertical_control: true)),
                 orientation: RollFreeCamera(())),
    game_loop: (max_fps: Some(60.0), max_iterations: Some(100)),
    input: (mouse_sensitivity: 0.5),
    screen_capture: (output_dir: Some("shots"), tagging: Counter),
    user_interface: (initially_interactive: false),
    gizmo: (unknown_key: 1),
    tpu: (max_entities: 64, max_lights: 4, raster_backend: "xla", steps_per_dispatch: 1),
)
"""


@pytest.mark.parametrize("text", [CONFIG_RON, EVERY_SECTION_RON, "(tpu: (max_bodies: 16))"],
                         ids=["ron-config", "every-section", "one-key"])
def test_config_dicts_equal_the_reference(text):
    got = dataclasses.asdict(EngineConfig.from_ron_str(text))
    ref = dataclasses.asdict(JConfig.from_ron_str(text))
    ref["tpu"]["raster_backend"] = RASTER_BACKENDS.get(ref["tpu"]["raster_backend"],
                                                       ref["tpu"]["raster_backend"])
    got["tpu"]["raster_backend"] = RASTER_BACKENDS.get(got["tpu"]["raster_backend"],
                                                       got["tpu"]["raster_backend"])
    assert got == ref
