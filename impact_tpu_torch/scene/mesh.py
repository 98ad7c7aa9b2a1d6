"""Procedural triangle meshes (port of the box, sphere and capsule of
``impact_tpu/scene/mesh.py`` that scenes and drag maps use; ref: impact_mesh
generation.rs). Meshes are host-side numpy, made at scene setup; they reach
the device as mesh-instance pools (``scene/assembly.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TriangleMesh(NamedTuple):
    positions: np.ndarray  # f32[V,3]
    normals: np.ndarray  # f32[V,3]
    indices: np.ndarray  # i32[T,3]


def _mesh(positions, normals, indices) -> TriangleMesh:
    return TriangleMesh(np.asarray(positions, np.float32), np.asarray(normals, np.float32),
                        np.asarray(indices, np.int32))


def compute_vertex_normals(positions, indices):
    """Area-weighted vertex normals."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    n = np.zeros_like(positions)
    a, b, c = (positions[indices[:, i]] for i in range(3))
    fn = np.cross(b - a, c - a)
    for i in range(3):
        np.add.at(n, indices[:, i], fn)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def box_mesh(extents=(1.0, 1.0, 1.0)) -> TriangleMesh:
    """Axis-aligned box centred at the origin, 24 vertices (normals per face)."""
    ex, ey, ez = (e * 0.5 for e in extents)
    faces = [
        ((1, 0, 0), [(ex, -ey, -ez), (ex, ey, -ez), (ex, ey, ez), (ex, -ey, ez)]),
        ((-1, 0, 0), [(-ex, -ey, ez), (-ex, ey, ez), (-ex, ey, -ez), (-ex, -ey, -ez)]),
        ((0, 1, 0), [(-ex, ey, -ez), (-ex, ey, ez), (ex, ey, ez), (ex, ey, -ez)]),
        ((0, -1, 0), [(-ex, -ey, ez), (-ex, -ey, -ez), (ex, -ey, -ez), (ex, -ey, ez)]),
        ((0, 0, 1), [(-ex, -ey, ez), (ex, -ey, ez), (ex, ey, ez), (-ex, ey, ez)]),
        ((0, 0, -1), [(ex, -ey, -ez), (-ex, -ey, -ez), (-ex, ey, -ez), (ex, ey, -ez)]),
    ]
    pos, nrm, idx = [], [], []
    for normal, corners in faces:
        base = len(pos)
        pos.extend(corners)
        nrm.extend([normal] * 4)
        idx.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
    return _mesh(pos, nrm, idx)


def sphere_mesh(radius=1.0, n_rings=16, n_segments=32) -> TriangleMesh:
    """UV sphere: (n_rings + 1) × (n_segments + 1) vertices."""
    pos, nrm, idx = [], [], []
    for r in range(n_rings + 1):
        theta = np.pi * r / n_rings
        for s in range(n_segments + 1):
            phi = 2 * np.pi * s / n_segments
            n = (np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi))
            pos.append(tuple(radius * c for c in n))
            nrm.append(n)
    stride = n_segments + 1
    for r in range(n_rings):
        for s in range(n_segments):
            a = r * stride + s
            b = a + stride
            idx.extend([(a, a + 1, b), (a + 1, b + 1, b)])
    return _mesh(pos, nrm, idx)


def capsule_mesh(radius=0.5, segment_length=1.0, n_rings=8, n_segments=32) -> TriangleMesh:
    """y-axis capsule: a UV sphere of 2·n_rings rings split at the equator,
    its halves moved by ±segment_length/2."""
    sp = sphere_mesh(radius, n_rings * 2, n_segments)
    pos = sp.positions.copy()
    pos[:, 1] += np.where(pos[:, 1] >= 0, segment_length * 0.5, -segment_length * 0.5)
    return _mesh(pos, sp.normals, sp.indices)
