"""Rigid and similarity transforms, batched.

Port of ``impact_tpu/math/transform.py``: an isometry is
``(translation [...,3], rotation quat [...,4])``; a similarity adds a uniform
``scaling [...]``. ``apply(compose(a, b), p) == apply(a, apply(b, p))``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import quaternion as quat


class Isometry(NamedTuple):
    translation: torch.Tensor  # [..., 3]
    rotation: torch.Tensor  # [..., 4]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cuda"):
        return Isometry(torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
                        quat.identity(batch_shape, dtype, device))


class Similarity(NamedTuple):
    translation: torch.Tensor  # [..., 3]
    rotation: torch.Tensor  # [..., 4]
    scaling: torch.Tensor  # [...]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cuda"):
        return Similarity(torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
                          quat.identity(batch_shape, dtype, device),
                          torch.ones(batch_shape, dtype=dtype, device=device))


def iso_apply(iso: Isometry, p):
    return quat.rotate(iso.rotation, p) + iso.translation



def iso_apply_vector(iso: Isometry, v):
    return quat.rotate(iso.rotation, v)


def iso_inverse(iso: Isometry) -> Isometry:
    rinv = quat.conjugate(iso.rotation)
    return Isometry(-quat.rotate(rinv, iso.translation), rinv)


def iso_compose(a: Isometry, b: Isometry) -> Isometry:
    """a ∘ b: apply b first, then a."""
    return Isometry(
        quat.rotate(a.rotation, b.translation) + a.translation,
        quat.normalize(quat.mul(a.rotation, b.rotation)),
    )


def sim_apply(sim: Similarity, p):
    return quat.rotate(sim.rotation, p * sim.scaling[..., None]) + sim.translation



def sim_apply_vector(sim: Similarity, v):
    return quat.rotate(sim.rotation, v * sim.scaling[..., None])


def sim_inverse(sim: Similarity) -> Similarity:
    rinv = quat.conjugate(sim.rotation)
    sinv = 1.0 / sim.scaling
    return Similarity(-quat.rotate(rinv, sim.translation) * sinv[..., None], rinv, sinv)


def sim_compose(a: Similarity, b: Similarity) -> Similarity:
    return Similarity(
        quat.rotate(a.rotation, b.translation * a.scaling[..., None]) + a.translation,
        quat.normalize(quat.mul(a.rotation, b.rotation)),
        a.scaling * b.scaling,
    )


def sim_to_matrix(sim: Similarity):
    """Similarity → homogeneous 4x4 matrix [..., 4, 4] (column-vector maths)."""
    r = quat.to_rotation_matrix(sim.rotation) * sim.scaling[..., None, None]
    batch = sim.translation.shape[:-1]
    m = torch.zeros((*batch, 4, 4), dtype=sim.translation.dtype,
                    device=sim.translation.device)
    m[..., :3, :3] = r
    m[..., :3, 3] = sim.translation
    m[..., 3, 3] = 1.0
    return m


def iso_to_matrix(iso: Isometry):
    ones = torch.ones(iso.translation.shape[:-1], dtype=iso.translation.dtype,
                      device=iso.translation.device)
    return sim_to_matrix(Similarity(iso.translation, iso.rotation, ones))


def sim_from_iso(iso: Isometry) -> Similarity:
    return Similarity(iso.translation, iso.rotation,
                      torch.ones(iso.translation.shape[:-1], dtype=iso.translation.dtype,
                                 device=iso.translation.device))
