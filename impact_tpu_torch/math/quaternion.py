"""Unit quaternions and rotations, batched over leading axes.

Port of ``impact_tpu/math/quaternion.py``: quaternions are ``[..., 4]``
tensors in (x, y, z, w) order; every function is shape polymorphic over
leading batch axes.
"""

from __future__ import annotations

import torch

IDENTITY = torch.tensor([0.0, 0.0, 0.0, 1.0])  # (x, y, z, w), on the CPU


def identity(batch_shape=(), dtype=torch.float32, device="cuda"):
    q = torch.zeros((*batch_shape, 4), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def normalize(q, eps=1e-12):
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def mul(q1, q2):
    """Hamilton product q1 * q2 (apply q2's rotation, then q1's)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def conjugate(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


inverse = conjugate  # unit quaternions only


def cross(a, b):
    """Cross product over the last axis, broadcasting the leading axes."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q, v):
    """Rotate vectors ``v`` [..., 3] by unit quaternions ``q`` [..., 4]
    (v' = v + w·t + u×t with t = 2·u×v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def inverse_rotate(q, v):
    return rotate(conjugate(q), v)


def from_axis_angle(axis, angle):
    """Unit quaternion rotating by ``angle`` (radians) about unit ``axis``."""
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)



def to_axis_angle(q, eps=1e-12):
    """Inverse of :func:`from_axis_angle`: (axis [...,3], angle [...]);
    the x axis where the rotation is the identity."""
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=q.dtype, device=q.device).expand(q[..., :3].shape)
    axis = torch.where(s[..., None] > eps, q[..., :3] / torch.clamp(s[..., None], min=eps), x_axis)
    return axis, angle


def integrate_angular_velocity(q, omega, dt):
    """q ← normalize(q + dt·½ ω ⊗ q) (ref: rigid_body.rs:734-744)."""
    omega_q = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    return normalize(q + dt * (0.5 * mul(omega_q, q)))


def to_rotation_matrix(q):
    """Unit quaternion(s) → rotation matrices ``[..., 3, 3]``."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def from_rotation_matrix(m):
    """Rotation matrix ``[..., 3, 3]`` → unit quaternion (Shepperd's method,
    branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s0 = s_of(tr + 1.0)
    c0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = s_of(1.0 + m00 - m11 - m22)
    c1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = s_of(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = s_of(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, c0, torch.where(use1, c1, torch.where(use2, c2, c3)))
    return normalize(q)


def slerp(q0, q1, t):
    """Spherical linear interpolation (shortest arc)."""
    d = (q0 * q1).sum(dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = d.abs()
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    inv = 1.0 / torch.clamp(sin_theta, min=1e-12)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) * inv)
    w1 = torch.where(small, t, torch.sin(t * theta) * inv)
    return normalize(w0 * q0 + w1 * q1)
