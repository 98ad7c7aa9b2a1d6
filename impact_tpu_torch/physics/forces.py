"""Force and torque generators (port of ``impact_tpu/physics/forces.py``;
ref: impact_physics/src/force.rs).

Each generator kind is a fixed-capacity SoA pool; one vectorized pass
scatter-adds every generator into the bodies' accumulators. Both scenes of
this slice use only the constant-acceleration pool (gravity); the others are
ported whole and run masked.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..math import quaternion as quat
from ..math.quaternion import cross
from .drag_map import bilinear_lookup
from .state import BodyState, compute_velocities, reset_forces_and_torques


class ForcePools(NamedTuple):
    const_accel_body: torch.Tensor  # i64[Ca]
    const_accel: torch.Tensor  # f32[Ca,3]
    const_accel_mask: torch.Tensor  # bool[Ca]
    local_force_body: torch.Tensor  # i64[Cl]
    local_force: torch.Tensor  # f32[Cl,3] world-space force
    local_point: torch.Tensor  # f32[Cl,3] body-frame application point
    local_force_mask: torch.Tensor  # bool[Cl]
    spring_body_a: torch.Tensor  # i64[Cs]
    spring_body_b: torch.Tensor  # i64[Cs]
    spring_attach_a: torch.Tensor  # f32[Cs,3]
    spring_attach_b: torch.Tensor  # f32[Cs,3]
    spring_stiffness: torch.Tensor  # f32[Cs]
    spring_damping: torch.Tensor  # f32[Cs]
    spring_rest_length: torch.Tensor  # f32[Cs]
    spring_mask: torch.Tensor  # bool[Cs]
    gravity_participant: torch.Tensor  # bool[N]
    gravitational_constant: torch.Tensor  # f32[]
    align_body: torch.Tensor  # i64[Ct]
    align_axis: torch.Tensor  # f32[Ct,3]
    align_target: torch.Tensor  # f32[Ct,3]
    align_strength: torch.Tensor  # f32[Ct]
    align_damping: torch.Tensor  # f32[Ct]
    align_mask: torch.Tensor  # bool[Ct]
    drag_coef: torch.Tensor  # f32[N]
    drag_area: torch.Tensor  # f32[N]
    medium_density: torch.Tensor  # f32[]
    medium_velocity: torch.Tensor  # f32[3]
    drag_map_table: torch.Tensor  # f32[M,T,P,6]
    drag_map_index: torch.Tensor  # i64[N], −1 = analytic drag


def empty_force_pools(n_bodies: int, cap_accel: int = 64, cap_local: int = 16,
                      cap_springs: int = 64, cap_align: int = 16, device="cuda") -> ForcePools:
    def z3(c):
        return torch.zeros((c, 3), device=device)

    def zi(c):
        return torch.zeros(c, dtype=torch.int64, device=device)

    def zb(c):
        return torch.zeros(c, dtype=torch.bool, device=device)

    def zf(c):
        return torch.zeros(c, device=device)

    up = torch.tensor([[0.0, 1.0, 0.0]], device=device)
    return ForcePools(
        const_accel_body=zi(cap_accel), const_accel=z3(cap_accel), const_accel_mask=zb(cap_accel),
        local_force_body=zi(cap_local), local_force=z3(cap_local), local_point=z3(cap_local),
        local_force_mask=zb(cap_local),
        spring_body_a=zi(cap_springs), spring_body_b=zi(cap_springs),
        spring_attach_a=z3(cap_springs), spring_attach_b=z3(cap_springs),
        spring_stiffness=zf(cap_springs), spring_damping=zf(cap_springs),
        spring_rest_length=zf(cap_springs), spring_mask=zb(cap_springs),
        gravity_participant=zb(n_bodies),
        gravitational_constant=torch.tensor(6.674e-11, device=device),
        align_body=zi(cap_align), align_axis=up.repeat(cap_align, 1),
        align_target=up.repeat(cap_align, 1), align_strength=zf(cap_align),
        align_damping=zf(cap_align), align_mask=zb(cap_align),
        drag_coef=zf(n_bodies), drag_area=torch.ones(n_bodies, device=device),
        medium_density=torch.tensor(0.0, device=device),
        medium_velocity=torch.zeros(3, device=device),
        drag_map_table=torch.zeros((1, 2, 2, 6), device=device),
        drag_map_index=torch.full((n_bodies,), -1, dtype=torch.int64, device=device),
    )


def sample_drag_load(tables, direction_body):
    """Bilinear equirectangular lookup per body (ref: DragLoadMap). ``tables``
    f32[N,T,P,6], ``direction_body`` [N,3] unit incoming-flow direction.
    Returns (force_coef [N,3], torque_coef [N,3])."""
    b = torch.arange(tables.shape[0], device=tables.device)
    return bilinear_lookup(lambda t, p: tables[b, t, p], tables.shape[1], tables.shape[2],
                           direction_body)


def apply_forces_and_torques(bodies: BodyState, pools: ForcePools) -> BodyState:
    """Reset and refill the force/torque accumulators (ref: lib.rs:102-108)."""
    bodies = reset_forces_and_torques(bodies)
    n = bodies.n
    dev = bodies.position.device
    force = torch.zeros((n, 3), device=dev)
    torque = torch.zeros((n, 3), device=dev)
    vel, ang_vel = compute_velocities(bodies)
    dyn = bodies.is_dynamic

    # constant acceleration: F = m a
    cb = pools.const_accel_body
    force = force.index_add(
        0, cb, bodies.mass[cb][:, None] * pools.const_accel * pools.const_accel_mask[:, None])

    # local forces: world force at a body point → force + torque
    lb = pools.local_force_body
    lp_world = quat.rotate(bodies.orientation[lb], pools.local_point)
    lf = pools.local_force * pools.local_force_mask[:, None]
    force = force.index_add(0, lb, lf)
    torque = torque.index_add(0, lb, cross(lp_world, lf))

    # springs between attachment points
    ia, ib = pools.spring_body_a, pools.spring_body_b
    ra = quat.rotate(bodies.orientation[ia], pools.spring_attach_a)
    rb = quat.rotate(bodies.orientation[ib], pools.spring_attach_b)
    dvec = (bodies.position[ib] + rb) - (bodies.position[ia] + ra)
    dist = torch.linalg.vector_norm(dvec, dim=-1)
    direction = dvec / torch.clamp(dist, min=1e-12)[:, None]
    va = vel[ia] + cross(ang_vel[ia], ra)
    vb = vel[ib] + cross(ang_vel[ib], rb)
    rel_speed = ((vb - va) * direction).sum(dim=-1)
    f_mag = (pools.spring_stiffness * (dist - pools.spring_rest_length)
             + pools.spring_damping * rel_speed) * pools.spring_mask
    f_on_a = f_mag[:, None] * direction
    force = force.index_add(0, ia, f_on_a)
    force = force.index_add(0, ib, -f_on_a)
    torque = torque.index_add(0, ia, cross(ra, f_on_a))
    torque = torque.index_add(0, ib, cross(rb, -f_on_a))

    # alignment torque τ = k·(R·axis × target) − c·ω (ref: alignment_torque.rs)
    ab = pools.align_body
    axis_w = quat.rotate(bodies.orientation[ab], pools.align_axis)
    tgt = pools.align_target / torch.clamp(
        torch.linalg.vector_norm(pools.align_target, dim=-1, keepdim=True), min=1e-9)
    t_align = (pools.align_strength[:, None] * cross(axis_w, tgt)
               - pools.align_damping[:, None] * ang_vel[ab]) * pools.align_mask[:, None]
    torque = torque.index_add(0, ab, t_align)

    # dynamic N-body gravity, pairwise masked O(N²) (ref: dynamic_gravity.rs)
    gp = pools.gravity_participant & bodies.alive
    diff = bodies.position[None, :, :] - bodies.position[:, None, :]
    r2 = (diff * diff).sum(dim=-1)
    pair_mask = gp[:, None] & gp[None, :] & ~torch.eye(n, dtype=torch.bool, device=dev)
    inv_r3 = torch.where(pair_mask, 1.0 / torch.clamp(r2, min=1e-12) ** 1.5, 0.0)
    mm = bodies.mass[:, None] * bodies.mass[None, :]
    g_force = pools.gravitational_constant * ((mm * inv_r3)[..., None] * diff).sum(dim=1)
    force = force + torch.where(gp[:, None], g_force, 0.0)

    # drag: a body with a precomputed load map samples it by body-frame flow
    # direction, the others use the analytic quadratic model
    v_rel = vel - pools.medium_velocity
    speed = torch.linalg.vector_norm(v_rel, dim=-1, keepdim=True)
    drag_on = (pools.drag_coef > 0) & (pools.medium_density > 0)
    k = -0.5 * pools.medium_density * pools.drag_coef[:, None] * pools.drag_area[:, None]
    f_drag = k * speed * v_rel
    t_drag = k * torch.linalg.vector_norm(ang_vel, dim=-1, keepdim=True) * ang_vel
    has_map = drag_on & (pools.drag_map_index >= 0)
    if pools.drag_map_table.shape[0] > 0:
        flow_body = quat.inverse_rotate(bodies.orientation, -v_rel)
        d_body = flow_body / torch.clamp(speed, min=1e-9)
        q_dyn = 0.5 * pools.medium_density * speed[:, 0] ** 2
        tables = pools.drag_map_table[torch.clamp(pools.drag_map_index, min=0)]
        fc, tc = sample_drag_load(tables, d_body)
        f_drag = torch.where(has_map[:, None],
                             quat.rotate(bodies.orientation, fc) * q_dyn[:, None], f_drag)
        t_drag = torch.where(has_map[:, None],
                             quat.rotate(bodies.orientation, tc) * q_dyn[:, None], t_drag)
    force = force + torch.where(drag_on[:, None], f_drag, 0.0)
    torque = torque + torch.where(drag_on[:, None], t_drag, 0.0)

    return bodies._replace(total_force=torch.where(dyn[:, None], force, 0.0),
                           total_torque=torch.where(dyn[:, None], torque, 0.0))
