"""Analytic inertial properties of primitive shapes (port of
``impact_tpu/physics/inertia.py:14-80``; ref: impact_physics/src/inertia.rs).

Tensors are about the centre of mass in the body frame, batched over
leading axes. Masses take plain floats or tensors: with floats they are
computed in Python's double precision, as the reference's are when scene
setup calls them with component values."""

from __future__ import annotations

import math

import torch


def _diag(d):
    return torch.diag_embed(d)


def sphere_inertia(mass, radius):
    """Solid sphere: I = (2/5) m r² · 𝟙."""
    i = torch.as_tensor(0.4 * mass * radius ** 2)
    return i[..., None, None] * torch.eye(3, dtype=i.dtype, device=i.device)


def box_inertia(mass, extents):
    """Solid box with full side lengths ``extents`` [...,3]."""
    ex2 = extents ** 2
    diag = torch.stack([ex2[..., 1] + ex2[..., 2], ex2[..., 0] + ex2[..., 2],
                        ex2[..., 0] + ex2[..., 1]], dim=-1)
    return _diag(diag * torch.as_tensor(mass / 12.0)[..., None])


def capsule_inertia(mass, radius, segment_length, axis=1):
    """Solid capsule along local ``axis``: a cylinder of length L and two
    hemispherical caps, the mass split by volume."""
    r, length = radius, segment_length
    v_cyl = math.pi * r ** 2 * length
    v_caps = (4.0 / 3.0) * math.pi * r ** 3
    f_cyl = v_cyl / (v_cyl + v_caps)
    m_cyl = mass * f_cyl
    m_caps = mass * (1.0 - f_cyl)
    i_axis = 0.5 * m_cyl * r ** 2 + 0.4 * m_caps * r ** 2
    i_perp = (m_cyl * (3.0 * r ** 2 + length ** 2) / 12.0
              + m_caps * (0.4 * r ** 2 + 0.5 * length * r * 0.75 + 0.25 * length ** 2))
    d = [torch.as_tensor(i_perp)] * 3
    d[axis] = torch.as_tensor(i_axis)
    return _diag(torch.stack(torch.broadcast_tensors(*d), dim=-1))


def sphere_mass(density, radius):
    return density * (4.0 / 3.0) * math.pi * radius ** 3


def box_mass(density, extents):
    return density * torch.prod(extents, dim=-1)


def capsule_mass(density, radius, segment_length):
    return density * (math.pi * radius ** 2 * segment_length
                      + (4.0 / 3.0) * math.pi * radius ** 3)
