"""Multi-device scale-out on ``torch.distributed`` (port of
``impact_tpu/parallel``): device meshes, state shardings, the halo exchange,
the engine step sharded over the voxel-object pool and the grids' x axis,
and the contact solve with the bodies split over the ``objects`` axis.
Every collective goes through ``comm.Comm``; ``world.World`` spawns ranks
for the dry run and the checks."""

from .dryrun import dryrun_multichip
from .halo import exchange_halo_x, make_sharded_min_filter_x, sharded_grid_spec
from .mesh import (
    body_shardings,
    gather_bodies,
    gather_sim_state,
    make_device_mesh,
    replicate,
    shard_bodies,
    shard_sim_state,
    sim_state_shardings,
)
from .solver import sharded_solve_contacts
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
    "body_shardings",
    "shard_bodies",
    "gather_bodies",
    "sharded_solve_contacts",
    "dryrun_multichip",
]
