"""The port's halo exchange and sharded min filter (``impact_tpu_torch/
parallel/halo.py``) on a 4×2 mesh of 8 CPU ranks over gloo, held against
numpy's padded 3-point min and the reference's ``make_sharded_min_filter_x``
on the 8 virtual CPU devices (``tests/test_parallel.py:107-132``)."""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from impact_tpu.parallel import make_device_mesh as jmake_mesh
from impact_tpu.parallel.halo import make_sharded_min_filter_x as jmin_filter
from impact_tpu_torch.parallel import jobs
from impact_tpu_torch.parallel.halo import sharded_grid_spec
from impact_tpu_torch.parallel.mesh import OBJECTS_SPACE
from impact_tpu_torch.parallel.world import World


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(8, device="cpu", store_dir=tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _numpy_min_filter(g):
    pad = np.pad(g, ((0, 0), (1, 1), (0, 0), (0, 0)), constant_values=np.inf)
    return np.minimum(np.minimum(pad[:, :-2], pad[:, 1:-1]), pad[:, 2:])


def _reference(g):
    mesh = jmake_mesh(n_objects_axis=4, n_space_axis=2, devices=jax.devices("cpu")[:8])
    gs = jax.device_put(g, NamedSharding(mesh, P("objects", "space")))
    return np.asarray(jax.jit(jmin_filter(mesh))(gs))


def test_min_filter_matches_numpy_and_reference(world):
    g = np.random.default_rng(0).uniform(size=(8, 16, 4, 4)).astype(np.float32)
    res = world.run(jobs.halo_job, g, 4, 2)
    out = res[0]["out"]
    np.testing.assert_array_equal(out, _numpy_min_filter(g))
    np.testing.assert_array_equal(out, _reference(g))
    # one plane from the one neighbour along space, none across the edge
    for r in res:
        assert len(r["halos"]) == 1 and r["halos"][0]["shape"] == (2, 1, 4, 4), r
    assert sharded_grid_spec(None) == OBJECTS_SPACE


def test_halo_boundary_closed(world):
    """Edge shards see +inf (empty space), not the far edge's plane."""
    g = np.zeros((8, 16, 4, 4), np.float32)
    g[:, 0], g[:, -1] = -5.0, -7.0
    out = world.run(jobs.halo_job, g, 4, 2)[0]["out"]
    assert out[0, 0, 0, 0] == -5.0
    assert out[0, -1, 0, 0] == -7.0
    np.testing.assert_array_equal(out, _reference(g))
