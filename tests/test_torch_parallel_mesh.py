"""The port's device meshes and state placements (``impact_tpu_torch/
parallel/mesh.py``) on 8 CPU ranks over gloo, held against the reference's
``impact_tpu/parallel/mesh.py`` on the 8 virtual CPU devices; the transport
rule; and the dry run (``parallel/dryrun.py``).

The ranks are spawned once for the module (``World``), rendezvous through a
file under the test's temporary directory, and run one thread each."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from impact_tpu.ecs import components as JC
from impact_tpu.models import voxel_box_tumbler as jtumbler
from impact_tpu.parallel import make_device_mesh as jmake_mesh
from impact_tpu.parallel.mesh import sim_state_shardings as jshardings
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch import bridge
from impact_tpu_torch.parallel import jobs
from impact_tpu_torch.parallel.comm import resolve_backend
from impact_tpu_torch.parallel.mesh import (
    OBJECTS,
    OBJECTS_SPACE,
    REPLICATED,
    leaves_with_path,
    sim_state_shardings,
)
from impact_tpu_torch.parallel.world import World

N_RANKS = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N_RANKS, device="cpu", store_dir=tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def test_mesh_shape_and_names(world):
    grid = np.arange(8 * 16 * 4 * 4, dtype=np.float32).reshape(8, 16, 4, 4)
    res = world.run(jobs.mesh_job, grid, 4, 2)
    assert {r["axis_names"] for r in res} == {("objects", "space")}
    assert {r["dim_names"] for r in res} == {("objects", "space")}
    assert {r["shape"] for r in res} == {(4, 2)}
    assert sorted(r["coordinate"] for r in res) == [(i, j) for i in range(4) for j in range(2)]
    assert {r["local_shape"] for r in res} == {(2, 8, 4, 4)}


def test_sharded_grid_round_trip(world):
    """tests/test_parallel.py:27-38: a grid sharded over objects × space,
    each block doubled plus one, gathered whole."""
    grid = np.arange(8 * 16 * 4 * 4, dtype=np.float32).reshape(8, 16, 4, 4)
    out = world.run(jobs.mesh_job, grid, 4, 2)[0]["out"]
    np.testing.assert_array_equal(out, grid * 2 + 1)


def _spec_placements(spec):
    return {P("objects", "space"): OBJECTS_SPACE, P("objects"): OBJECTS, P(): REPLICATED}[spec]


def test_placements_match_reference_shardings():
    """Every leaf's placements equal the reference's PartitionSpec of the
    same path on a bridged tumbler state (the generator replicated as the
    reference's PRNG key)."""
    jworld = jtumbler(n_boxes=2)
    for eid in jworld.entities_with(JC.VoxelBox):
        for f in ("extent_x", "extent_y", "extent_z"):
            jworld.set_field(eid, JC.VoxelBox, f, 6.0)
    cfg = JConfig()
    cfg.tpu.max_voxel_objects = 8
    cfg.tpu.max_bodies = 16
    cfg.tpu.max_contacts = 128
    cfg.tpu.voxel_grid_size = 16
    jsim = jcompile(jworld, cfg).sim
    jmesh = jmake_mesh(n_objects_axis=4, n_space_axis=2, devices=jax.devices("cpu")[:8])
    ref = {"/".join(getattr(k, "name", str(getattr(k, "idx", k))) for k in path): s.spec
           for path, s in jax.tree_util.tree_flatten_with_path(jshardings(jmesh, jsim))[0]}
    sim = bridge.sim_state_from_reference(jsim, device="cpu")
    got = dict(leaves_with_path(sim_state_shardings(None, sim)))
    leaves = dict(leaves_with_path(sim))
    checked = 0
    for path, placements in got.items():
        if isinstance(leaves[path], torch.Tensor):
            assert path in ref, path
            assert placements == _spec_placements(ref[path]), (path, ref[path])
            checked += 1
    assert got["rng"] == REPLICATED and ref["rng"] == P()
    assert got["voxels/sdf"] == OBJECTS_SPACE and got["meshes/tri_pos"] == OBJECTS
    assert checked >= 50


def test_indivisible_pool_and_unported_axes_raise(world):
    """A pool of 6 slots on 4 ranks raises ValueError (sharding it, and the
    sharded step), as do slabs that break the slab constraints on a 1×4
    mesh (G = 18, a slab of 6 planes, merge levels 3 at slabs of 4) and
    chunked mode."""
    errors = world.run(jobs.guards_job)[0]
    assert set(errors) == {"shard", "step", "slab_divide", "slab_probe", "slab_merge",
                           "chunked"}, errors
    assert "does not divide" in errors["shard"]
    assert all("slab constraint" in errors[k] for k in ("slab_divide", "slab_probe",
                                                         "slab_merge"))
    assert "ROADMAP.md" in errors["chunked"]


def test_transport_rule():
    """cuda tensors ride nccl with a card per rank; ranks outnumbering the
    cards need backend='gloo'; cpu tensors ride gloo and nothing else."""
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="backend='gloo'"):
        resolve_backend("cuda", None, n_cards + 1)
    assert resolve_backend("cuda", "gloo", n_cards + 4) == "gloo"
    assert resolve_backend("cpu", None, 8) == "gloo"
    with pytest.raises(ValueError):
        resolve_backend("cpu", "nccl", 1)
    with pytest.raises(ValueError):
        World(n_cards + 1, device="cuda")


def test_dryrun_multichip_on_cpu_ranks(tmp_path, capsys):
    from impact_tpu_torch.parallel import dryrun_multichip

    report = dryrun_multichip(8, device="cpu", store_dir=tmp_path)
    assert report["finite"] and report["halo_equal"]
    assert report["mesh"] == (4, 2) and report["halo_mesh"] == (4, 2)
    assert "dryrun_multichip OK: 8 ranks" in capsys.readouterr().out
