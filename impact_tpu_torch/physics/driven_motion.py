"""Driven motion: analytic drivers that overwrite kinematic body state each
step (port of ``impact_tpu/physics/driven_motion.py``; ref:
impact_physics/src/driven_motion.rs and its five driver modules).

One fixed-capacity pool per driver kind; each apply is a masked scatter into
the body pool. Masked-off entries scatter nowhere.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..math import quaternion as quat
from ..math.quaternion import cross
from .state import BodyState


def _orthonormal_basis(axis):
    """Two unit vectors spanning the plane ⟂ axis [...,3]."""
    ex = torch.tensor([1.0, 0.0, 0.0], device=axis.device).expand_as(axis)
    ey = torch.tensor([0.0, 1.0, 0.0], device=axis.device).expand_as(axis)
    h = torch.where(axis[..., 0:1].abs() < 0.9, ex, ey)
    e1 = cross(axis, h)
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=1e-12)
    return e1, cross(axis, e1)


class MotionDriverPools(NamedTuple):
    circ_body: torch.Tensor  # i64[Cc]
    circ_center: torch.Tensor  # f32[Cc,3]
    circ_radius: torch.Tensor  # f32[Cc]
    circ_speed: torch.Tensor  # f32[Cc] rad/s
    circ_axis: torch.Tensor  # f32[Cc,3]
    circ_phase: torch.Tensor  # f32[Cc]
    circ_mask: torch.Tensor  # bool[Cc]
    lin_body: torch.Tensor
    lin_p0: torch.Tensor
    lin_v0: torch.Tensor
    lin_accel: torch.Tensor
    lin_mask: torch.Tensor
    rot_body: torch.Tensor
    rot_q0: torch.Tensor  # f32[Cr,4]
    rot_omega: torch.Tensor  # f32[Cr,3]
    rot_mask: torch.Tensor
    osc_body: torch.Tensor
    osc_center: torch.Tensor
    osc_dir: torch.Tensor
    osc_amplitude: torch.Tensor
    osc_period: torch.Tensor
    osc_phase: torch.Tensor
    osc_mask: torch.Tensor
    orb_body: torch.Tensor
    orb_focus: torch.Tensor  # f32[Co,3]
    orb_a: torch.Tensor  # semi-major axis
    orb_e: torch.Tensor  # eccentricity
    orb_period: torch.Tensor
    orb_orient: torch.Tensor  # f32[Co,4] orbit-plane orientation
    orb_phase: torch.Tensor  # initial mean anomaly
    orb_mask: torch.Tensor


def empty_motion_driver_pools(cap: int = 16, device="cuda") -> MotionDriverPools:
    def z(*s):
        return torch.zeros(s, device=device)

    def zi():
        return torch.zeros(cap, dtype=torch.int64, device=device)

    def zb():
        return torch.zeros(cap, dtype=torch.bool, device=device)

    def one():
        return torch.ones(cap, device=device)

    return MotionDriverPools(
        circ_body=zi(), circ_center=z(cap, 3), circ_radius=z(cap), circ_speed=z(cap),
        circ_axis=z(cap, 3), circ_phase=z(cap), circ_mask=zb(),
        lin_body=zi(), lin_p0=z(cap, 3), lin_v0=z(cap, 3), lin_accel=z(cap, 3), lin_mask=zb(),
        rot_body=zi(), rot_q0=quat.identity((cap,), device=device), rot_omega=z(cap, 3),
        rot_mask=zb(),
        osc_body=zi(), osc_center=z(cap, 3), osc_dir=z(cap, 3), osc_amplitude=z(cap),
        osc_period=one(), osc_phase=z(cap), osc_mask=zb(),
        orb_body=zi(), orb_focus=z(cap, 3), orb_a=one(), orb_e=z(cap), orb_period=one(),
        orb_orient=quat.identity((cap,), device=device), orb_phase=z(cap), orb_mask=zb(),
    )


def solve_kepler(mean_anomaly, eccentricity, n_newton: int = 8):
    """Eccentric anomaly E from M = E − e·sin E (fixed Newton iterations)."""
    e = eccentricity
    big_e = mean_anomaly + e * torch.sin(mean_anomaly)
    for _ in range(n_newton):
        f = big_e - e * torch.sin(big_e) - mean_anomaly
        fp = 1.0 - e * torch.cos(big_e)
        big_e = big_e - f / torch.clamp(fp, min=1e-9)
    return big_e


def _scatter(target, body, mask, value):
    """target[body] = value where ``mask``: masked-off entries write a spare
    row past the pool that is then dropped (no host sync for the mask)."""
    n = target.shape[0]
    out = torch.cat([target, target[:1]])
    out.index_copy_(0, torch.where(mask, body, n), value)
    return out[:n]


def apply_motion_drivers(bodies: BodyState, pools: MotionDriverPools, t) -> BodyState:
    """Overwrite driven kinematic bodies' state at simulation time ``t``."""
    pos, vel = bodies.position, bodies.velocity
    ori, ang = bodies.orientation, bodies.angular_velocity

    # circular
    th = pools.circ_speed * t + pools.circ_phase
    e1, e2 = _orthonormal_basis(pools.circ_axis)
    p_c = pools.circ_center + pools.circ_radius[:, None] * (
        torch.cos(th)[:, None] * e1 + torch.sin(th)[:, None] * e2)
    v_c = pools.circ_radius[:, None] * pools.circ_speed[:, None] * (
        -torch.sin(th)[:, None] * e1 + torch.cos(th)[:, None] * e2)
    pos = _scatter(pos, pools.circ_body, pools.circ_mask, p_c)
    vel = _scatter(vel, pools.circ_body, pools.circ_mask, v_c)

    # constant-acceleration trajectory
    p_l = pools.lin_p0 + pools.lin_v0 * t + 0.5 * pools.lin_accel * t * t
    v_l = pools.lin_v0 + pools.lin_accel * t
    pos = _scatter(pos, pools.lin_body, pools.lin_mask, p_l)
    vel = _scatter(vel, pools.lin_body, pools.lin_mask, v_l)

    # constant rotation q(t) = exp(½ω t)·q0
    w_norm = torch.linalg.vector_norm(pools.rot_omega, dim=-1)
    axis = pools.rot_omega / torch.clamp(w_norm, min=1e-12)[:, None]
    q_rot = quat.mul(quat.from_axis_angle(axis, w_norm * t), pools.rot_q0)
    ori = _scatter(ori, pools.rot_body, pools.rot_mask, q_rot)
    ang = _scatter(ang, pools.rot_body, pools.rot_mask, pools.rot_omega)

    # harmonic oscillation
    ph = 2.0 * math.pi * t / pools.osc_period + pools.osc_phase
    p_o = pools.osc_center + pools.osc_dir * (pools.osc_amplitude * torch.sin(ph))[:, None]
    v_o = pools.osc_dir * (
        pools.osc_amplitude * (2.0 * math.pi / pools.osc_period) * torch.cos(ph))[:, None]
    pos = _scatter(pos, pools.osc_body, pools.osc_mask, p_o)
    vel = _scatter(vel, pools.osc_body, pools.osc_mask, v_o)

    # Keplerian orbit: x toward periapsis, z the orbit normal, rotated by orb_orient
    n_mean = 2.0 * math.pi / pools.orb_period
    big_e = solve_kepler(n_mean * t + pools.orb_phase, pools.orb_e)
    a, e = pools.orb_a, pools.orb_e
    b = a * torch.sqrt(torch.clamp(1.0 - e * e, min=0.0))
    de_dt = n_mean / torch.clamp(1.0 - e * torch.cos(big_e), min=1e-9)
    zeros = torch.zeros_like(a)
    p_loc = torch.stack([a * (torch.cos(big_e) - e), b * torch.sin(big_e), zeros], dim=-1)
    v_loc = torch.stack([-a * torch.sin(big_e) * de_dt, b * torch.cos(big_e) * de_dt, zeros],
                        dim=-1)
    pos = _scatter(pos, pools.orb_body, pools.orb_mask,
                   pools.orb_focus + quat.rotate(pools.orb_orient, p_loc))
    vel = _scatter(vel, pools.orb_body, pools.orb_mask, quat.rotate(pools.orb_orient, v_loc))

    return bodies._replace(position=pos, velocity=vel, orientation=ori, angular_velocity=ang)
