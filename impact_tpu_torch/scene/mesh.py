"""Triangle meshes: procedural primitives and OBJ/PLY import (port of
``impact_tpu/scene/mesh.py``; ref: impact_mesh generation.rs and
io/{obj,ply}.rs).

The primitives are the box, rectangle, UV sphere, hemisphere, cylinder,
cone, capsule, circular frustum and screen quad. Meshes are host-side
numpy, made at scene setup; they reach the device as mesh-instance pools
or static geometry (``scene/assembly.py``)."""

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


def rectangle_mesh(width=1.0, depth=1.0) -> TriangleMesh:
    """A y-up rectangle in the xz-plane."""
    hw, hd = width * 0.5, depth * 0.5
    pos = [(-hw, 0, -hd), (hw, 0, -hd), (hw, 0, hd), (-hw, 0, hd)]
    return _mesh(pos, [(0, 1, 0)] * 4, [(0, 2, 1), (0, 3, 2)])


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


def hemisphere_mesh(radius=1.0, n_rings=8, n_segments=32) -> TriangleMesh:
    """Upper hemisphere: the vertices of a 2·n_rings-ring UV sphere at
    y ≥ 0 and the triangles among them."""
    full = sphere_mesh(radius, n_rings * 2, n_segments)
    keep = full.positions[:, 1] >= -1e-6
    remap = -np.ones(len(full.positions), np.int32)
    remap[keep] = np.arange(keep.sum())
    tri_keep = keep[full.indices].all(axis=1)
    return _mesh(full.positions[keep], full.normals[keep], remap[full.indices[tri_keep]])


def _cap(pos, nrm, idx, y, sign, radius, n_segments, flip):
    """A disc at height ``y`` facing ``sign``·y: a centre and a ring."""
    center = len(pos)
    pos.append((0, y, 0))
    nrm.append((0, sign, 0))
    ring = len(pos)
    for s in range(n_segments + 1):
        phi = 2 * np.pi * s / n_segments
        pos.append((radius * np.cos(phi), y, radius * np.sin(phi)))
        nrm.append((0, sign, 0))
    for s in range(n_segments):
        tri = (center, ring + s, ring + s + 1)
        idx.append((tri[0], tri[2], tri[1]) if flip else tri)


def cylinder_mesh(radius=0.5, length=1.0, n_segments=32) -> TriangleMesh:
    """Closed y-axis cylinder centred at the origin."""
    h = length * 0.5
    pos, nrm, idx = [], [], []
    for s in range(n_segments + 1):
        phi = 2 * np.pi * s / n_segments
        c, sn = np.cos(phi), np.sin(phi)
        pos.extend([(radius * c, -h, radius * sn), (radius * c, h, radius * sn)])
        nrm.extend([(c, 0, sn)] * 2)
    for s in range(n_segments):
        a = 2 * s
        idx.extend([(a, a + 1, a + 2), (a + 1, a + 3, a + 2)])
    _cap(pos, nrm, idx, h, 1.0, radius, n_segments, flip=True)
    _cap(pos, nrm, idx, -h, -1.0, radius, n_segments, flip=False)
    return _mesh(pos, nrm, idx)


def _slanted_side(pos, nrm, bottom_radius, top_radius, length, n_segments):
    """The side of a y-axis cone or frustum: one bottom and one top vertex
    per segment edge, with the slanted normal."""
    h = length * 0.5
    slope = (bottom_radius - top_radius) / length
    for s in range(n_segments + 1):
        phi = 2 * np.pi * s / n_segments
        c, sn = np.cos(phi), np.sin(phi)
        n = np.array([c, slope, sn])
        n /= np.linalg.norm(n)
        pos.extend([(bottom_radius * c, -h, bottom_radius * sn),
                    (top_radius * c, h, top_radius * sn)])
        nrm.extend([tuple(n)] * 2)


def cone_mesh(radius=0.5, length=1.0, n_segments=32) -> TriangleMesh:
    """y-axis cone centred at the origin, apex up, with its base cap."""
    pos, nrm, idx = [], [], []
    _slanted_side(pos, nrm, radius, 0.0, length, n_segments)
    for s in range(n_segments):
        a = 2 * s
        idx.append((a, a + 1, a + 2))
    _cap(pos, nrm, idx, -length * 0.5, -1.0, radius, n_segments, flip=False)
    return _mesh(pos, nrm, idx)


def screen_quad_mesh() -> TriangleMesh:
    """Fullscreen quad in NDC."""
    pos = [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)]
    return _mesh(pos, [(0, 0, 1)] * 4, [(0, 1, 2), (0, 2, 3)])


def circular_frustum_mesh(bottom_radius=0.5, top_radius=0.25, length=1.0,
                          n_segments=32) -> TriangleMesh:
    """Open conical frustum along y, centred at the origin."""
    pos, nrm, idx = [], [], []
    _slanted_side(pos, nrm, bottom_radius, top_radius, length, n_segments)
    for s in range(n_segments):
        a = 2 * s
        idx.extend([(a, a + 1, a + 2), (a + 1, a + 3, a + 2)])
    return _mesh(pos, nrm, idx)


# --- import (ref: impact_mesh/src/io/{obj,ply}.rs) ---------------------------------


def load_obj(path) -> TriangleMesh:
    """Minimal OBJ reader: v/vn/f records, polygons triangulated as fans.
    The normals are the file's when it gives one per vertex, else
    area-weighted vertex normals."""
    verts, norms, faces = [], [], []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "vn":
                norms.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "f":
                refs = []
                for p in parts[1:]:
                    vi = int(p.split("/")[0])
                    refs.append(vi - 1 if vi > 0 else len(verts) + vi)
                for i in range(1, len(refs) - 1):
                    faces.append((refs[0], refs[i], refs[i + 1]))
    positions = np.asarray(verts, np.float32)
    indices = np.asarray(faces, np.int32)
    normals = (np.asarray(norms, np.float32) if len(norms) == len(verts)
               else compute_vertex_normals(positions, indices))
    return TriangleMesh(positions, normals, indices)


def load_ply(path) -> TriangleMesh:
    """Minimal ASCII-PLY reader: vertex x/y/z (and nx/ny/nz), face lists
    triangulated as fans."""
    with open(path, "rb") as f:
        lines = f.read().decode("utf-8", errors="replace").splitlines()
    if lines[0].strip() != "ply":
        raise ValueError(f"{path}: not a PLY file")
    n_verts = n_faces = 0
    props = []
    fmt, current, i = "ascii", None, 1
    while i < len(lines):
        parts = lines[i].split()
        if parts[:1] == ["format"]:
            fmt = parts[1]
        elif parts[:1] == ["element"]:
            current = parts[1]
            if current == "vertex":
                n_verts = int(parts[2])
            elif current == "face":
                n_faces = int(parts[2])
        elif parts[:1] == ["property"] and current == "vertex":
            props.append(parts[-1])
        elif parts[:1] == ["end_header"]:
            i += 1
            break
        i += 1
    if fmt != "ascii":
        raise ValueError(f"{path}: only ASCII PLY is supported, not {fmt}")
    rows = [lines[i + k].split() for k in range(n_verts)]
    cols = {p: j for j, p in enumerate(props)}

    def columns(names):
        return np.asarray([[float(r[cols[c]]) for c in names] for r in rows], np.float32)

    positions = columns("xyz")
    faces = []
    for k in range(n_faces):
        parts = lines[i + n_verts + k].split()
        cnt = int(parts[0])
        refs = [int(x) for x in parts[1:1 + cnt]]
        for j in range(1, cnt - 1):
            faces.append((refs[0], refs[j], refs[j + 1]))
    indices = np.asarray(faces, np.int32)
    normals = (columns(("nx", "ny", "nz")) if {"nx", "ny", "nz"} <= set(cols)
               else compute_vertex_normals(positions, indices))
    return TriangleMesh(positions, normals, indices)


def mesh_to_static_geometry(mesh: TriangleMesh, albedo=(0.6, 0.6, 0.6), f0=0.04,
                            roughness=0.7, emissive=(0.0, 0.0, 0.0), transform=None,
                            device="cuda"):
    """TriangleMesh → ``scene.assembly.StaticGeometry`` on ``device``, with
    one uniform material; ``transform`` = (translation [3], rotation
    [3,3], scale) applied to the positions (and the rotation to the
    normals)."""
    import torch

    from .assembly import StaticGeometry

    pos, nrm = mesh.positions, mesh.normals
    if transform is not None:
        t, r_mat, s = transform
        pos = (pos * s) @ np.asarray(r_mat).T + np.asarray(t)
        nrm = nrm @ np.asarray(r_mat).T
    v = len(pos)

    def rows(x):
        return torch.tensor([x], dtype=torch.float32, device=device).repeat(v, 1)

    return StaticGeometry(
        vert_pos=torch.as_tensor(np.asarray(pos, np.float32), device=device),
        vert_normal=torch.as_tensor(np.asarray(nrm, np.float32), device=device),
        vert_albedo=rows(albedo),
        vert_f0=torch.full((v, 3), float(f0), device=device),
        vert_roughness=torch.full((v,), float(roughness), device=device),
        vert_emissive=rows(emissive),
        vert_material=torch.full((v,), -1, dtype=torch.int32, device=device),
        tri_indices=torch.as_tensor(mesh.indices, device=device).long(),
        tri_active=torch.ones(len(mesh.indices), dtype=torch.bool, device=device),
    )
