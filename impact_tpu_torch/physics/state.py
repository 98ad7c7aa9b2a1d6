"""Rigid-body state as one pool of dense SoA tensors (port of
``impact_tpu/physics/state.py``; ref: impact_physics/src/rigid_body.rs).

Every body lives in one fixed-capacity pool with a per-slot ``kind`` code;
masks select behaviour. Kinematic bodies store velocity directly and have
inv_mass = 0, so impulses never move them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import quaternion as quat

KIND_NONE = 0
KIND_DYNAMIC = 1
KIND_KINEMATIC = 2


class BodyState(NamedTuple):
    """[N]-pooled rigid bodies."""

    kind: torch.Tensor  # i32[N]: 0 none, 1 dynamic, 2 kinematic
    mass: torch.Tensor  # f32[N]
    inv_mass: torch.Tensor  # f32[N] (0 for kinematic/none)
    inertia_body: torch.Tensor  # f32[N,3,3] body-frame inertia about COM
    inv_inertia_body: torch.Tensor  # f32[N,3,3]
    position: torch.Tensor  # f32[N,3] centre of mass, world
    orientation: torch.Tensor  # f32[N,4] quaternion (x,y,z,w)
    momentum: torch.Tensor  # f32[N,3]
    angular_momentum: torch.Tensor  # f32[N,3] world frame
    velocity: torch.Tensor  # f32[N,3] kinematic primary; derived for dynamic
    angular_velocity: torch.Tensor  # f32[N,3]
    total_force: torch.Tensor  # f32[N,3] accumulator
    total_torque: torch.Tensor  # f32[N,3] accumulator

    @property
    def n(self) -> int:
        return self.kind.shape[0]

    @property
    def is_dynamic(self):
        return self.kind == KIND_DYNAMIC

    @property
    def is_kinematic(self):
        return self.kind == KIND_KINEMATIC

    @property
    def alive(self):
        return self.kind != KIND_NONE


def empty_body_state(n: int, device="cuda") -> BodyState:
    z3 = torch.zeros((n, 3), device=device)
    return BodyState(
        kind=torch.zeros(n, dtype=torch.int32, device=device),
        mass=torch.ones(n, device=device),
        inv_mass=torch.zeros(n, device=device),
        inertia_body=torch.eye(3, device=device).expand(n, 3, 3).clone(),
        inv_inertia_body=torch.zeros((n, 3, 3), device=device),
        position=z3,
        orientation=quat.identity((n,), device=device),
        momentum=z3.clone(),
        angular_momentum=z3.clone(),
        velocity=z3.clone(),
        angular_velocity=z3.clone(),
        total_force=z3.clone(),
        total_torque=z3.clone(),
    )


def world_inv_inertia(bodies: BodyState):
    """World-frame inverse inertia tensors R · I⁻¹_body · Rᵀ [N,3,3]."""
    r = quat.to_rotation_matrix(bodies.orientation)
    return torch.einsum("nij,njk,nlk->nil", r, bodies.inv_inertia_body, r)


def compute_velocities(bodies: BodyState):
    """(velocity, angular_velocity) [N,3]: p/m and I⁻¹_world·L for dynamic
    bodies, the stored values for the others."""
    dyn = bodies.is_dynamic[:, None]
    v_dyn = bodies.momentum * bodies.inv_mass[:, None]
    w_dyn = torch.einsum("nij,nj->ni", world_inv_inertia(bodies), bodies.angular_momentum)
    return (torch.where(dyn, v_dyn, bodies.velocity),
            torch.where(dyn, w_dyn, bodies.angular_velocity))


def synchronize_momenta(bodies: BodyState, velocity, angular_velocity) -> BodyState:
    """Dynamic momenta from the given velocities; the velocities are stored
    for every body."""
    r = quat.to_rotation_matrix(bodies.orientation)
    inertia_world = torch.einsum("nij,njk,nlk->nil", r, bodies.inertia_body, r)
    dyn = bodies.is_dynamic[:, None]
    return bodies._replace(
        momentum=torch.where(dyn, bodies.mass[:, None] * velocity, bodies.momentum),
        angular_momentum=torch.where(
            dyn, torch.einsum("nij,nj->ni", inertia_world, angular_velocity),
            bodies.angular_momentum),
        velocity=velocity,
        angular_velocity=angular_velocity,
    )


def advance_momenta(bodies: BodyState, dt) -> BodyState:
    """Semi-implicit Euler force step (ref: rigid_body.rs:708-718)."""
    dyn = bodies.is_dynamic[:, None]
    return bodies._replace(
        momentum=torch.where(dyn, bodies.momentum + bodies.total_force * dt, bodies.momentum),
        angular_momentum=torch.where(
            dyn, bodies.angular_momentum + bodies.total_torque * dt, bodies.angular_momentum),
    )


def advance_configurations(bodies: BodyState, dt, kinds) -> BodyState:
    """Advance position/orientation of bodies whose kind is in ``kinds``
    (ref: rigid_body.rs:722-744)."""
    v, w = compute_velocities(bodies)
    sel = torch.zeros_like(bodies.kind, dtype=torch.bool)
    for k in kinds:
        sel = sel | (bodies.kind == k)
    sel = sel[:, None]
    return bodies._replace(
        position=torch.where(sel, bodies.position + v * dt, bodies.position),
        orientation=torch.where(
            sel, quat.integrate_angular_velocity(bodies.orientation, w, dt), bodies.orientation),
        velocity=torch.where(sel, v, bodies.velocity),
        angular_velocity=torch.where(sel, w, bodies.angular_velocity),
    )


def reset_forces_and_torques(bodies: BodyState) -> BodyState:
    return bodies._replace(total_force=torch.zeros_like(bodies.total_force),
                           total_torque=torch.zeros_like(bodies.total_torque))
