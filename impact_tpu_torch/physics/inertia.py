"""Analytic inertial properties of primitive shapes (port of
``impact_tpu/physics/inertia.py``; ref: impact_physics/src/inertia.rs).

Tensors are about the centre of mass in the body frame, batched over
leading axes. Masses take plain floats or tensors: with floats they are
computed in Python's double precision, as the reference's are when scene
setup calls them with component values."""

from __future__ import annotations

import math

import numpy as np
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


def cylinder_inertia(mass, radius, length, axis=1):
    """Solid cylinder along local ``axis``."""
    i_axis = 0.5 * mass * radius ** 2
    i_perp = mass * (3.0 * radius ** 2 + length ** 2) / 12.0
    d = [torch.as_tensor(i_perp)] * 3
    d[axis] = torch.as_tensor(i_axis)
    return _diag(torch.stack(torch.broadcast_tensors(*d), dim=-1))


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


def translated_inertia(inertia, mass, offset):
    """Parallel-axis theorem: the inertia about a point displaced by
    ``offset`` [...,3] from the centre of mass."""
    mass = torch.as_tensor(mass, dtype=inertia.dtype, device=inertia.device)
    d2 = (offset * offset).sum(dim=-1)[..., None, None]
    outer = offset[..., :, None] * offset[..., None, :]
    eye = torch.eye(3, dtype=inertia.dtype, device=inertia.device)
    return inertia + mass[..., None, None] * (d2 * eye - outer)


def rotated_inertia(inertia, rotation_matrix):
    """The inertia tensor in a rotated frame: R·I·Rᵀ."""
    return torch.einsum("...ij,...jk,...lk->...il", rotation_matrix, inertia, rotation_matrix)


def mesh_inertial_properties(vertices, triangles, mass_density=1.0, device="cuda"):
    """(mass, centre of mass [3], inertia [3,3] about it) of a closed,
    consistently wound triangle mesh of uniform density (ref: inertia.rs:69
    of_uniform_triangle_mesh): signed tetrahedra about the origin, summed in
    float64 numpy on the host, as the reference sums them; float32 tensors
    out."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    vol6 = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 × signed volume
    volume = vol6.sum() / 6.0
    com = ((a + b + c) / 4.0 * vol6[:, None]).sum(axis=0) / (6.0 * volume)

    def moment(i, j):
        return (vol6 / 120.0 * (
            2.0 * (a[:, i] * a[:, j] + b[:, i] * b[:, j] + c[:, i] * c[:, j])
            + a[:, i] * b[:, j] + b[:, i] * a[:, j] + a[:, i] * c[:, j] + c[:, i] * a[:, j]
            + b[:, i] * c[:, j] + c[:, i] * b[:, j])).sum()

    xx, yy, zz = moment(0, 0), moment(1, 1), moment(2, 2)
    xy, xz, yz = moment(0, 1), moment(0, 2), moment(1, 2)
    inertia_origin = np.array([[yy + zz, -xy, -xz], [-xy, xx + zz, -yz], [-xz, -yz, xx + yy]])
    mass = mass_density * volume
    shift = (com @ com) * np.eye(3) - np.outer(com, com)
    inertia_com = mass_density * inertia_origin - mass * shift

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return f32(mass), f32(com), f32(inertia_com)
