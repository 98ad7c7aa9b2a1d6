"""Rigid-body physics (port of ``impact_tpu/physics``; ref:
engine/crates/impact_physics): pools of bodies, collidables, forces and
drivers as masked tensors, and the substep in the reference's stage order."""

from . import collision, driven_motion, forces, inertia, solver, state, step
from .state import KIND_DYNAMIC, KIND_KINEMATIC, KIND_NONE, BodyState, empty_body_state
from .step import PhysicsParams, PhysicsState, init_physics_state, physics_step

__all__ = [
    "state",
    "inertia",
    "forces",
    "driven_motion",
    "collision",
    "solver",
    "step",
    "BodyState",
    "PhysicsState",
    "PhysicsParams",
    "physics_step",
    "init_physics_state",
    "empty_body_state",
    "KIND_NONE",
    "KIND_DYNAMIC",
    "KIND_KINEMATIC",
]
