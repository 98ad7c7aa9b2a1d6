"""A chunked state under sharding is refused by both packages, with a
ValueError.

A chunked state's ``meshes`` is a ``ChunkMeshPool`` whose three overflow
counters are 0-d (``impact_tpu/voxel/chunk_mesh.py:61-63``). The
reference's ``sim_state_shardings`` places every ``meshes/`` leaf on
``P("objects")`` whatever its rank (``impact_tpu/parallel/mesh.py:52``),
so its ``shard_sim_state`` refuses the state in ``device_put``. The port
keeps the rule and refuses the same state in ``shard_sim_state``, naming
the 0-d leaf, and refuses chunked mode in ``make_sharded_engine_step``.

The states are each package's dense build of the dry run's scene with its
meshes replaced by an empty chunk pool; the reference's on 4 of the 8
virtual CPU devices, the port's on 4 gloo ranks, both on a 2×2 mesh."""

import jax
import pytest

from impact_tpu.models import voxel_box_tumbler as jtumbler
from impact_tpu.parallel import make_device_mesh as jmake_mesh
from impact_tpu.parallel import shard_sim_state as jshard
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu.voxel.chunk_mesh import empty_chunk_mesh_pool as jempty_pool
from impact_tpu_torch.parallel import jobs
from impact_tpu_torch.parallel.world import World


def _reference_chunked_state():
    """``jobs.scene("dryrun", 2)`` in the reference, its meshes an empty
    chunk pool."""
    cfg = JConfig()
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 4, 12, 128, 16
    t.render_width, t.render_height, t.solver_mode = 128, 96, "jacobi"
    cfg.physics.simulator.initial_time_step_duration = 0.01
    build = jcompile(jtumbler(n_boxes=2), cfg)
    return build.sim._replace(meshes=jempty_pool(16, 64, 4, 16))


def test_both_packages_refuse_a_chunked_state(tmp_path):
    with World(4, device="cpu", store_dir=tmp_path) as world:
        world.submit(jobs.chunked_refusal_job)
        sim = _reference_chunked_state()
        assert sim.meshes.n_dropped_verts.ndim == 0
        mesh = jmake_mesh(2, 2, devices=jax.devices("cpu")[:4])
        with pytest.raises(ValueError, match="rank at least 1"):
            jshard(mesh, sim)
        errors = world.collect()[0]
    assert "meshes/n_dropped_verts" in errors["shard"] and "rank 0" in errors["shard"]
    assert "chunked" in errors["step"] and "ROADMAP.md" in errors["step"]
