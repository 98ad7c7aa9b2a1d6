"""The physics step (port of ``impact_tpu/physics/step.py``; ref:
impact_physics/src/lib.rs:31-109 ``perform_physics_step``), in the
reference's stage order:
  1. synchronize collidables with rigid bodies
  2. prepare constraints (narrow phase on pre-force velocities, warm start)
  3. advance dynamic momenta from the accumulated forces/torques
  4. solve + apply constrained velocities and corrected configurations
  5. advance dynamic configurations
  6. advance kinematic configurations
  7. apply motion drivers
  8. apply forces/torques (fills the accumulators for the next substep)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import state as body_state
from .collision import CollidablePools, narrow_phase, synchronize_collidables
from .driven_motion import MotionDriverPools, apply_motion_drivers
from .forces import ForcePools, apply_forces_and_torques
from .solver import (
    JointPools,
    SolverCache,
    empty_solver_cache,
    prepare_contacts,
    solve_contacts,
    solve_joints,
)
from .state import BodyState


class PhysicsState(NamedTuple):
    bodies: BodyState
    solver_cache: SolverCache
    time: torch.Tensor  # f32[] simulation time


class PhysicsParams(NamedTuple):
    collidables: CollidablePools
    forces: ForcePools
    drivers: MotionDriverPools
    joints: JointPools


def physics_substep(phys: PhysicsState, params: PhysicsParams, dt: float, solver_config,
                    max_contacts: int, solver_mode: str = "scan",
                    extra_contacts_fn=None) -> PhysicsState:
    """One substep. ``extra_contacts_fn(bodies, contacts) -> ContactBuffer``
    merges the voxel subsystem's probe contacts in before solving."""
    bodies = phys.bodies
    world = synchronize_collidables(params.collidables, bodies.position, bodies.orientation)
    contacts = narrow_phase(params.collidables, world, max_contacts)
    if extra_contacts_fn is not None:
        contacts = extra_contacts_fn(bodies, contacts)
    prepared = prepare_contacts(bodies, contacts, phys.solver_cache, solver_config)

    bodies = body_state.advance_momenta(bodies, dt)
    if solver_config.enabled:
        bodies, cache = solve_contacts(bodies, prepared, solver_config, mode=solver_mode)
        bodies = solve_joints(bodies, params.joints, solver_config)
    else:
        cache = phys.solver_cache

    bodies = body_state.advance_configurations(bodies, dt, (body_state.KIND_DYNAMIC,))
    bodies = body_state.advance_configurations(bodies, dt, (body_state.KIND_KINEMATIC,))
    new_time = phys.time + dt
    bodies = apply_motion_drivers(bodies, params.drivers, new_time)
    bodies = apply_forces_and_torques(bodies, params.forces)
    return PhysicsState(bodies=bodies, solver_cache=cache, time=new_time)


def physics_step(phys: PhysicsState, params: PhysicsParams, dt: float, n_substeps: int,
                 solver_config, max_contacts: int, solver_mode: str = "scan",
                 extra_contacts_fn=None) -> PhysicsState:
    """One step = ``n_substeps`` substeps of dt / n_substeps."""
    for _ in range(n_substeps):
        phys = physics_substep(phys, params, dt / n_substeps, solver_config, max_contacts,
                               solver_mode, extra_contacts_fn)
    return phys


def init_physics_state(n_bodies: int, max_contacts: int, device="cuda") -> PhysicsState:
    return PhysicsState(bodies=body_state.empty_body_state(n_bodies, device),
                        solver_cache=empty_solver_cache(max_contacts, device),
                        time=torch.tensor(0.0, device=device))
