"""Multi-device scale-out on ``torch.distributed`` (port of
``impact_tpu/parallel``): device meshes, state shardings, the halo exchange
and the engine step sharded over the voxel-object pool and the grids' x
axis. Every collective goes through ``comm.Comm``; ``world.World`` spawns
ranks for the dry run and the checks."""

from .dryrun import dryrun_multichip
from .halo import exchange_halo_x, make_sharded_min_filter_x, sharded_grid_spec
from .mesh import (
    gather_sim_state,
    make_device_mesh,
    replicate,
    shard_sim_state,
    sim_state_shardings,
)
from .step import make_sharded_engine_step

__all__ = [
    "make_device_mesh",
    "shard_sim_state",
    "replicate",
    "exchange_halo_x",
    "sharded_grid_spec",
    "make_sharded_min_filter_x",
    "sim_state_shardings",
    "gather_sim_state",
    "make_sharded_engine_step",
    "dryrun_multichip",
]
