"""The port's meta SDF graphs (``voxel/meta_sdf.py``) against impact_tpu's
on the CPU.

Every meta graph that ``tests/test_voxel.py`` builds in ``TestMetaSdf`` and
``TestMetaSdfReferenceNodes`` is built with each package's constructors
(equal meta dicts) and lowered by both at two seeds: the lowered atomic
graphs are equal dicts, float for float (the same numpy sampling, seeding
and host evaluation). The circular parameter dependency raises in both.
The lowered graphs are voxelized by each package's ``generate_sdf_grid``
(the port's in torch, the reference's in JAX) on a 32³ grid: the f32 grids
agree within 1e-5 absolute, and the i8 codes are equal except where a
float32 ulp of the evaluation flips a code, at most 1e-4 of the voxels,
each by ±1 (the bar of ``tests/test_torch_sdf_noise.py``).
"""

import numpy as np
import pytest
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

from impact_tpu.voxel import meta_sdf as jmeta
from impact_tpu.voxel import sdf as jsdf
from impact_tpu.voxel.encoding import encode_sdf_i8 as jencode
from impact_tpu.voxel.object import generate_sdf_grid as jgrid
from impact_tpu_torch.voxel import meta_sdf as tmeta
from impact_tpu_torch.voxel import sdf as tsdf
from impact_tpu_torch.voxel.encoding import encode_sdf_i8 as tencode
from impact_tpu_torch.voxel.object import generate_sdf_grid as tgrid

G = 32
SEEDS = (1, 8)
GRID_ATOL = 1e-5
FLIP_SHARE = 1e-4


def meta_graphs(meta, sdf):
    """name → (meta graph, voxel extent of its grid), as tests/test_voxel.py
    builds them with module ``meta`` and the atomic module ``sdf``."""
    surface = meta.sdf_instantiation(meta.meta_spheres(radius=4.0))
    inner = meta.stratified_grid_transforms(meta.meta_spheres(radius=0.6), shape=(3, 3, 3),
                                            cell_size=2.0, jitter=0.0)
    rocks = meta.ray_translation_to_surface(
        surface,
        meta.sphere_surface_transforms(
            meta.meta_capsules(radius=0.3,
                               segment_length=meta.from_param("radius", scale=3.0)),
            count=6, sphere_radius=8.0, rotation="radial_inwards"),
        anchor="shape_boundary")
    base = meta.sdf_instantiation(meta.meta_spheres(radius=6.0))
    return {
        "stratified_grid": (meta.stratified_grid_transforms(
            meta.meta_spheres(radius=meta.uniform(0.5, 1.0)), shape=(2, 2, 2), cell_size=3.0,
            jitter=0.3), 0.5),
        "sphere_surface_boxes": (meta.sphere_surface_transforms(
            meta.meta_boxes(extent=meta.uniform(0.4, 1.2)), count=12, sphere_radius=5.0,
            jitter=0.2), 0.5),
        "full_grid": (inner, 0.5),
        "stochastic_selection": (meta.stochastic_selection(inner, keep_probability=0.4), 0.5),
        "group_union": (meta.group_union(
            [sdf.sphere(4.0), meta.sphere_surface_transforms(meta.meta_spheres(radius=1.0),
                                                             count=6, sphere_radius=4.0)],
            smoothness=1.0), 0.5),
        "per_instance_radii": (meta.stratified_grid_transforms(
            meta.meta_spheres(radius=meta.uniform(0.5, 1.0)), shape=(2, 2, 2), cell_size=3.0,
            jitter=0.0), 0.5),
        "closest_translation": (meta.sdf_instantiation(meta.closest_translation_to_surface(
            surface, meta.sphere_surface_transforms(meta.meta_boxes(extent=0.5), count=8,
                                                    sphere_radius=7.0, jitter=0.0))), 0.5),
        "ray_translation_rotation_to_gradient": (meta.group_union(
            [surface, meta.sdf_instantiation(meta.rotation_to_gradient(surface, rocks))],
            smoothness=0.2), 0.4),
        "meta_noise": (meta.noise_modifier(base, octaves=3, frequency=0.6, amplitude=1.2), 0.5),
        "noisy_boxes": (meta.noise_modifier(
            meta.sdf_instantiation(meta.meta_boxes(extent=1.5, count=3)), octaves=3,
            frequency=0.7, amplitude=0.4), 0.5),
    }


NAMES = list(meta_graphs(tmeta, tsdf))


@pytest.fixture(scope="module")
def lowered():
    """name → seed → (port's lowered graph, reference's, voxel extent)."""
    port, ref = meta_graphs(tmeta, tsdf), meta_graphs(jmeta, jsdf)
    out = {}
    for name in NAMES:
        assert port[name] == ref[name], name
        node_t, ve = port[name]
        node_j, _ = ref[name]
        out[name] = {s: (tmeta.lower(node_t, seed=s), jmeta.lower(node_j, seed=s), ve)
                     for s in SEEDS}
    return out


@pytest.mark.parametrize("name", NAMES)
def test_lowered_graphs_equal_the_reference(name, lowered):
    for seed in SEEDS:
        got, ref, _ = lowered[name][seed]
        assert got == ref, (name, seed)
        tsdf.validate(got)
    if name == "sphere_surface_boxes":  # the seed matters
        assert lowered[name][SEEDS[0]][0] != lowered[name][SEEDS[1]][0]


@pytest.mark.parametrize("name", NAMES)
def test_lowered_grids_match_the_reference(name, lowered):
    got, ref, ve = lowered[name][SEEDS[0]]
    g_t, o_t = tgrid(got, G, ve, device="cpu")
    g_j, o_j = jgrid(ref, G, ve)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=GRID_ATOL, rtol=0)
    diff = tencode(g_t, ve).numpy().astype(np.int32) - np.asarray(jencode(g_j, ve)).astype(
        np.int32)
    n_flips = int((diff != 0).sum())
    assert n_flips <= FLIP_SHARE * diff.size and np.abs(diff).max(initial=0) <= 1, n_flips
    assert int((g_t < 0).sum()) > 0, name


def test_parameter_samples_equal_the_reference():
    specs = {m: {"r": m.uniform(1.0, 2.0), "len": m.from_param("r", scale=3.0, offset=0.5),
                 "ang": m.uniform_cos_angle(10.0, 80.0), "p": m.power_law(1.0, 10.0, -2.0),
                 "n": m.discrete_uniform(2, 5), "z": m.normal(0.0, 2.0)}
             for m in (tmeta, jmeta)}
    assert specs[tmeta] == specs[jmeta]
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        assert tmeta.sample_params(specs[tmeta], rt) == jmeta.sample_params(specs[jmeta], rj)


@pytest.mark.parametrize("meta", [tmeta, jmeta], ids=["port", "reference"])
def test_parameter_cycle_detected(meta):
    with pytest.raises(ValueError, match="circular"):
        meta.sample_params({"a": meta.from_param("b"), "b": meta.from_param("a")},
                           np.random.default_rng(0))
    with pytest.raises(ValueError, match="circular"):
        meta.lower(meta.meta_spheres(radius=meta.from_param("radius")), seed=0)


def test_lowered_graph_evaluates_on_torch_like_numpy(lowered):
    got, _, _ = lowered["noisy_boxes"][SEEDS[0]]
    p = np.random.default_rng(0).uniform(-3, 3, (256, 3)).astype(np.float32)
    d_np = tsdf.evaluate_np(got, p)
    d_t = tsdf.evaluate(got, torch.from_numpy(p)).numpy()
    assert np.abs(d_np - d_t).max() < 1e-4
