"""Drag-load maps: force and torque tables over incoming-flow directions
(port of ``impact_tpu/physics/drag_map.py``; ref: impact_physics
force/detailed_drag, DragLoadMapConfig).

A map is a dense ``[n_theta, n_phi, 6]`` table of force and torque
coefficients in the body frame per unit dynamic pressure q = ½ρ|v|², built
once on the host in float64 numpy from the shape's surface mesh with a
Newtonian flat-plate model (the same code as the reference's, so the tables
are equal bit for bit) and cached on disk under a sha1 of the mesh and the
resolution. ``sample_drag_load`` samples one table, as the reference's
does; the engine samples the tables per body in ``forces.sample_drag_load``;
both read through ``bilinear_lookup``.
"""

from __future__ import annotations

import hashlib
import math
import pathlib
from typing import NamedTuple

import numpy as np
import torch


class DragLoadMap(NamedTuple):
    """``table[t, p, 0:3]`` force and ``[..., 3:6]`` torque coefficient for
    incoming flow direction (θ_t, φ_p), numpy float32."""

    table: np.ndarray  # f32[T, P, 6]


def _direction_grid(n_theta: int, n_phi: int):
    theta = (np.arange(n_theta) + 0.5) / n_theta * np.pi
    phi = np.arange(n_phi) / n_phi * 2.0 * np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    cp, sp = np.cos(phi)[None, :], np.sin(phi)[None, :]
    return np.stack([st * cp, np.broadcast_to(ct, (n_theta, n_phi)), st * sp],
                    axis=-1)  # [T,P,3] unit incoming-flow directions (y = polar axis)


def build_drag_load_map(vertices, triangles, center_of_mass=(0.0, 0.0, 0.0), n_theta: int = 32,
                        n_phi: int = 64, friction_coefficient: float = 0.05) -> DragLoadMap:
    """The table of a closed surface mesh in the body frame: windward faces
    (n·d < 0) feel pressure Cp = 2·(n·d)² along −n plus a small friction
    along d; force and torque about the COM integrate over the faces."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    com = np.asarray(center_of_mass, np.float64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    ok = area > 1e-12
    normal = np.where(ok[:, None], cross / np.maximum(2.0 * area, 1e-12)[:, None], 0.0)
    centroid = (a + b + c) / 3.0 - com

    dirs = _direction_grid(n_theta, n_phi)
    s = np.einsum("fk,tpk->tpf", normal, dirs)  # n_f · d_tp
    wind = np.maximum(0.0, -s)
    cp = 2.0 * wind**2
    f_press = -np.einsum("tpf,fk->tpfk", cp * area[None, None, :], normal)
    f_fric = friction_coefficient * np.einsum("tpf,tpk->tpfk", wind * area[None, None, :], dirs)
    df = f_press + f_fric  # [T,P,F,3]
    force = df.sum(axis=2)
    torque = np.cross(np.broadcast_to(centroid[None, None, :, :], df.shape), df).sum(axis=2)
    return DragLoadMap(table=np.concatenate([force, torque], axis=-1).astype(np.float32))


def _cache_key(vertices, triangles, n_theta: int, n_phi: int) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(vertices, np.float32).tobytes())
    h.update(np.ascontiguousarray(triangles, np.int32).tobytes())
    h.update(f"{n_theta}x{n_phi}".encode())
    return h.hexdigest()[:16]


def get_or_build_drag_load_map(vertices, triangles, center_of_mass=(0.0, 0.0, 0.0),
                               n_theta: int = 32, n_phi: int = 64, directory=None,
                               use_saved: bool = True, save_generated: bool = True,
                               overwrite: bool = False) -> DragLoadMap:
    """The map, read from ``directory`` when a saved one matches (the
    reference's file names and format, ``drag_load_<key>.npz``), else built
    and saved there; ``directory`` None builds without the cache."""
    path = None
    if directory is not None:
        key = _cache_key(vertices, triangles, n_theta, n_phi)
        path = pathlib.Path(directory) / f"drag_load_{key}.npz"
        if use_saved and path.exists() and not overwrite:
            with np.load(path) as data:
                return DragLoadMap(table=np.asarray(data["table"], np.float32))
    m = build_drag_load_map(vertices, triangles, center_of_mass, n_theta, n_phi)
    if path is not None and save_generated:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, table=m.table)
    return m


def bilinear_lookup(entry, n_theta: int, n_phi: int, direction_body):
    """The bilinear equirectangular lookup of a [T,P,6] map at unit
    incoming-flow directions [...,3] in the body frame, the map read through
    ``entry(theta_index, phi_index)``. Returns (force_coef [...,3],
    torque_coef [...,3])."""
    d = direction_body
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.remainder(torch.atan2(d[..., 2], d[..., 0]), 2.0 * math.pi)
    ft = theta / math.pi * n_theta - 0.5
    fp = phi / (2.0 * math.pi) * n_phi
    t0 = torch.clamp(torch.floor(ft).long(), 0, n_theta - 1)
    t1 = torch.clamp(t0 + 1, 0, n_theta - 1)
    wt = torch.clamp(ft - t0, 0.0, 1.0)[..., None]
    p0 = torch.remainder(torch.floor(fp).long(), n_phi)
    p1 = torch.remainder(p0 + 1, n_phi)
    wp = (fp - torch.floor(fp))[..., None]
    out = (entry(t0, p0) * (1 - wt) * (1 - wp) + entry(t0, p1) * (1 - wt) * wp
           + entry(t1, p0) * wt * (1 - wp) + entry(t1, p1) * wt * wp)
    return out[..., 0:3], out[..., 3:6]


def sample_drag_load(map_table, direction_body):
    """Bilinear equirectangular lookup in one map ``map_table`` f32[T,P,6]
    at unit incoming-flow directions [...,3] in the body frame. Returns
    (force_coef [...,3], torque_coef [...,3]); ``physics/forces.py`` has
    the per-body form the engine step uses."""
    return bilinear_lookup(lambda t, p: map_table[t, p], map_table.shape[0], map_table.shape[1],
                           direction_body)
