"""SDF generation graphs: the atomic nodes, their evaluation on the device
and their host-side twins (port of ``impact_tpu/voxel/sdf.py``; ref:
impact_voxel generation/sdf.rs and generation/sdf/atomic.rs).

A graph is a tree of plain dicts with the reference's keys: the sphere,
box and capsule primitives; the translation, rotation and scaling
transforms; the sharp or smooth union, subtraction and intersection; and
the multifractal noise modifier. A graph built or saved by either package
evaluates and loads in both. :func:`evaluate` runs a graph over a tensor
of points on its device; :func:`evaluate_np` is the numpy twin the meta
graphs (``voxel/meta_sdf.py``) sample on the host; :func:`estimate_bounds`
gives a graph's conservative box; :func:`validate`, :func:`save_graph` and
:func:`load_graph` check and (de)serialise graphs as JSON.

The noise's lattice hash is u32 arithmetic with wraparound multiplies and
logical right shifts. On the device it runs in int64 holding values in
[0, 2³²): each product is split into 16-bit halves so that no int64
product overflows, and every sum is masked back to 32 bits."""

from __future__ import annotations

import json

import numpy as np
import torch

from ..math import quaternion as quat

_MASK = 0xFFFFFFFF


# --- smooth boolean ops (ref: generation/sdf.rs:46-102) -------------------------


def sdf_union(d1, d2, smoothness=0.0):
    if smoothness == 0.0:
        return torch.minimum(d1, d2)
    h = torch.clamp(smoothness - (d1 - d2).abs(), min=0.0)
    return torch.minimum(d1, d2) - (h * h) * (0.25 / smoothness)


def sdf_subtraction(d1, d2, smoothness=0.0):
    return -sdf_union(-d1, d2, smoothness)


def sdf_intersection(d1, d2, smoothness=0.0):
    return -sdf_union(-d1, -d2, smoothness)


# --- node constructors (kinds of atomic.rs:63-171) -------------------------------


def sphere(radius):
    return {"kind": "sphere", "radius": float(radius)}


def box(extents):
    return {"kind": "box", "extents": tuple(float(e) for e in extents)}


def capsule(radius, segment_length):
    """A capsule along y: a segment of ``segment_length`` swept by ``radius``."""
    return {"kind": "capsule", "radius": float(radius), "segment_length": float(segment_length)}


def translation(child, offset):
    return {"kind": "translation", "offset": tuple(map(float, offset)), "child": child}


def rotation(child, quaternion_xyzw):
    return {"kind": "rotation", "quaternion": tuple(map(float, quaternion_xyzw)), "child": child}


def scaling(child, scale):
    return {"kind": "scaling", "scale": float(scale), "child": child}


def union(a, b, smoothness=0.0):
    return {"kind": "union", "smoothness": float(smoothness), "children": [a, b]}


def subtraction(a, b, smoothness=0.0):
    return {"kind": "subtraction", "smoothness": float(smoothness), "children": [a, b]}


def intersection(a, b, smoothness=0.0):
    return {"kind": "intersection", "smoothness": float(smoothness), "children": [a, b]}


def noise_modifier(child, octaves=4, frequency=1.0, lacunarity=2.0, persistence=0.5,
                   amplitude=1.0, seed=0):
    return {
        "kind": "multifractal_noise",
        "octaves": int(octaves),
        "frequency": float(frequency),
        "lacunarity": float(lacunarity),
        "persistence": float(persistence),
        "amplitude": float(amplitude),
        "seed": int(seed),
        "child": child,
    }


def _mul32(a, c: int):
    """(a · c) mod 2³² for int64 ``a`` in [0, 2³²) and a constant ``c``."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash3(ix, iy, iz, seed: int):
    """The reference's u32 lattice hash of int32 coordinates (as int64)."""
    h = (_mul32(ix & _MASK, 0x8DA6B343) + _mul32(iy & _MASK, 0xD8163841)
         + _mul32(iz & _MASK, 0xCB1AB31F) + ((seed * 0x9E3779B9) & _MASK)) & _MASK
    h = h ^ (h >> 13)
    h = _mul32(h, 0x85EBCA6B)
    return h ^ (h >> 16)


def _grad_dot(ix, iy, iz, fx, fy, fz, seed: int):
    """Dot of the lattice point's pseudo-random gradient with the offset."""
    h = _hash3(ix, iy, iz, seed)
    gx = (h & 0xFF).to(torch.float32) / 127.5 - 1.0
    gy = ((h >> 8) & 0xFF).to(torch.float32) / 127.5 - 1.0
    gz = ((h >> 16) & 0xFF).to(torch.float32) / 127.5 - 1.0
    return gx * fx + gy * fy + gz * fz


def gradient_noise(p, seed: int = 0):
    """3D Perlin-style gradient noise over points [...,3], range ≈ [-1, 1]."""
    pi = torch.floor(p)
    pf = p - pi
    ii = pi.to(torch.int32).to(torch.int64)
    ix, iy, iz = ii[..., 0], ii[..., 1], ii[..., 2]
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
    u = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    v = fy * fy * fy * (fy * (fy * 6.0 - 15.0) + 10.0)
    w = fz * fz * fz * (fz * (fz * 6.0 - 15.0) + 10.0)

    def g(dx, dy, dz):
        return _grad_dot(ix + dx, iy + dy, iz + dz, fx - dx, fy - dy, fz - dz, seed)

    n000, n100 = g(0, 0, 0), g(1, 0, 0)
    n010, n110 = g(0, 1, 0), g(1, 1, 0)
    n001, n101 = g(0, 0, 1), g(1, 0, 1)
    n011, n111 = g(0, 1, 1), g(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def multifractal_noise(p, octaves=4, frequency=1.0, lacunarity=2.0, persistence=0.5, seed=0):
    """Octave sum of gradient noise (ref: atomic.rs MultifractalNoiseSDFModifier)."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    amp, freq = 1.0, frequency
    norm = 0.0
    for o in range(octaves):
        total = total + amp * gradient_noise(p * freq, seed=seed + o)
        norm += amp
        amp *= persistence
        freq *= lacunarity
    return total / max(norm, 1e-12)


def evaluate(node, p):
    """Evaluate an SDF graph at points ``p`` [...,3] → distances [...]."""
    kind = node["kind"]
    if kind == "sphere":
        return torch.linalg.vector_norm(p, dim=-1) - node["radius"]
    if kind == "box":
        he = torch.tensor(node["extents"], dtype=torch.float32, device=p.device) * 0.5
        q = p.abs() - he
        return torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
            q.amax(dim=-1), max=0.0
        )
    if kind == "capsule":
        half = node["segment_length"] * 0.5
        py = torch.clamp(p[..., 1], -half, half)
        q = p - torch.stack([torch.zeros_like(py), py, torch.zeros_like(py)], dim=-1)
        return torch.linalg.vector_norm(q, dim=-1) - node["radius"]
    if kind == "translation":
        off = torch.tensor(node["offset"], dtype=torch.float32, device=p.device)
        return evaluate(node["child"], p - off)
    if kind == "rotation":
        q = torch.tensor(node["quaternion"], dtype=torch.float32, device=p.device)
        return evaluate(node["child"], quat.inverse_rotate(q, p))
    if kind == "scaling":
        s = node["scale"]
        return evaluate(node["child"], p / s) * s
    if kind in _BOOLEAN_OPS:
        a, b = node["children"]
        return _BOOLEAN_OPS[kind](evaluate(a, p), evaluate(b, p), node["smoothness"])
    if kind == "multifractal_noise":
        d = evaluate(node["child"], p)
        n = multifractal_noise(p, octaves=node["octaves"], frequency=node["frequency"],
                               lacunarity=node["lacunarity"], persistence=node["persistence"],
                               seed=node["seed"])
        return d + n * node["amplitude"]
    raise ValueError(f"unknown SDF node kind {kind!r}")


_BOOLEAN_OPS = {"union": sdf_union, "subtraction": sdf_subtraction,
                "intersection": sdf_intersection}


# --- host-side evaluation and bounds (build-time helpers) --------------------------
#
# Meta-SDF lowering places instances on the surface of graphs it has already
# lowered (ref: meta.rs MetaClosestTranslationToSurface et al.), on the host
# at scene build. A numpy evaluator serves those tiny point batches without
# a device round trip for each Newton or spherecast iteration. Its float32
# operations are the reference's own, in the same order, so both packages
# place instances at the same points.


def _np_hash3(ix, iy, iz, seed):
    with np.errstate(over="ignore"):  # wrapping u32 hash, overflow intended
        h = (
            ix.astype(np.uint32) * np.uint32(0x8DA6B343)
            + iy.astype(np.uint32) * np.uint32(0xD8163841)
            + iz.astype(np.uint32) * np.uint32(0xCB1AB31F)
            + np.uint32((seed * 0x9E3779B9) & _MASK)
        )
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(16))
    return h


def _np_gradient_noise(p, seed=0):
    """Numpy twin of :func:`gradient_noise` (the same lattice hash)."""
    pi = np.floor(p)
    pf = p - pi
    ix, iy, iz = (pi[..., a].astype(np.int32) for a in range(3))
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
    u = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    v = fy * fy * fy * (fy * (fy * 6.0 - 15.0) + 10.0)
    w = fz * fz * fz * (fz * (fz * 6.0 - 15.0) + 10.0)

    def g(dx, dy, dz):
        h = _np_hash3(ix + dx, iy + dy, iz + dz, seed)
        gx = (h & np.uint32(0xFF)).astype(np.float32) / 127.5 - 1.0
        gy = ((h >> np.uint32(8)) & np.uint32(0xFF)).astype(np.float32) / 127.5 - 1.0
        gz = ((h >> np.uint32(16)) & np.uint32(0xFF)).astype(np.float32) / 127.5 - 1.0
        return gx * (fx - dx) + gy * (fy - dy) + gz * (fz - dz)

    n000, n100 = g(0, 0, 0), g(1, 0, 0)
    n010, n110 = g(0, 1, 0), g(1, 1, 0)
    n001, n101 = g(0, 0, 1), g(1, 0, 1)
    n011, n111 = g(0, 1, 1), g(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def _np_quat_rotate(q, v):
    u, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _np_quat_conj(q):
    return q * np.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def _np_union(d1, d2, sm):
    if sm == 0.0:
        return np.minimum(d1, d2)
    h = np.maximum(sm - np.abs(d1 - d2), 0.0)
    return np.minimum(d1, d2) - (h * h) * (0.25 / sm)


def evaluate_np(node, p):
    """Numpy twin of :func:`evaluate` over points ``p`` [...,3] → [...]."""
    p = np.asarray(p, np.float32)
    kind = node["kind"]
    if kind == "sphere":
        return np.linalg.norm(p, axis=-1) - node["radius"]
    if kind == "box":
        he = np.asarray(node["extents"], np.float32) * 0.5
        q = np.abs(p) - he
        return np.linalg.norm(np.maximum(q, 0.0), axis=-1) + np.minimum(q.max(axis=-1), 0.0)
    if kind == "capsule":
        half = node["segment_length"] * 0.5
        py = np.clip(p[..., 1], -half, half)
        q = p - np.stack([np.zeros_like(py), py, np.zeros_like(py)], axis=-1)
        return np.linalg.norm(q, axis=-1) - node["radius"]
    if kind == "translation":
        return evaluate_np(node["child"], p - np.asarray(node["offset"], np.float32))
    if kind == "rotation":
        q = np.asarray(node["quaternion"], np.float32)
        return evaluate_np(node["child"], _np_quat_rotate(_np_quat_conj(q), p))
    if kind == "scaling":
        s = node["scale"]
        return evaluate_np(node["child"], p / s) * s
    if kind in _BOOLEAN_OPS:
        a, b = node["children"]
        da, db = evaluate_np(a, p), evaluate_np(b, p)
        sm = node["smoothness"]
        if kind == "union":
            return _np_union(da, db, sm)
        if kind == "subtraction":
            return -_np_union(-da, db, sm)
        return -_np_union(-da, -db, sm)
    if kind == "multifractal_noise":
        d = evaluate_np(node["child"], p)
        total = np.zeros(p.shape[:-1], np.float32)
        amp, freq, norm = 1.0, node["frequency"], 0.0
        for o in range(node["octaves"]):
            total = total + amp * _np_gradient_noise(p * freq, seed=node["seed"] + o)
            norm += amp
            amp *= node["persistence"]
            freq *= node["lacunarity"]
        return d + (total / max(norm, 1e-12)) * node["amplitude"]
    raise ValueError(f"unknown SDF node kind {kind!r}")


def estimate_bounds(node):
    """Conservative AABB (lo, hi) of a graph's negative region, f32 [3]
    each: the ray-march domain of surface-relative meta placement (ref:
    meta.rs:2620-2628 domain.find_ray_intersection)."""
    kind = node["kind"]
    if kind == "sphere":
        r = node["radius"]
        return np.full(3, -r, np.float32), np.full(3, r, np.float32)
    if kind == "box":
        he = np.asarray(node["extents"], np.float32) * 0.5
        return -he, he
    if kind == "capsule":
        r, h = node["radius"], node["segment_length"] * 0.5
        he = np.array([r, r + h, r], np.float32)
        return -he, he
    if kind == "translation":
        lo, hi = estimate_bounds(node["child"])
        off = np.asarray(node["offset"], np.float32)
        return lo + off, hi + off
    if kind == "rotation":
        lo, hi = estimate_bounds(node["child"])
        q = np.asarray(node["quaternion"], np.float32)
        corners = np.stack([np.where([(i >> a) & 1 for a in range(3)], hi, lo)
                            for i in range(8)])
        rc = _np_quat_rotate(q, corners)
        return rc.min(axis=0), rc.max(axis=0)
    if kind == "scaling":
        lo, hi = estimate_bounds(node["child"])
        s = node["scale"]
        return lo * s, hi * s
    if kind == "union":
        a, b = node["children"]
        lo1, hi1 = estimate_bounds(a)
        lo2, hi2 = estimate_bounds(b)
        sm = node["smoothness"]
        return np.minimum(lo1, lo2) - sm, np.maximum(hi1, hi2) + sm
    if kind == "subtraction":
        return estimate_bounds(node["children"][0])
    if kind == "intersection":
        a, b = node["children"]
        lo1, hi1 = estimate_bounds(a)
        lo2, hi2 = estimate_bounds(b)
        return np.maximum(lo1, lo2), np.minimum(hi1, hi2)
    if kind == "multifractal_noise":
        lo, hi = estimate_bounds(node["child"])
        a = abs(node["amplitude"])
        return lo - a, hi + a
    raise ValueError(f"unknown SDF node kind {kind!r}")


# --- graph (de)serialisation (ref: apps/voxel_generator's graph files,
#     editor/meta/io.rs) --------------------------------------------------------------

_KNOWN_KINDS = {
    "sphere", "box", "capsule", "translation", "rotation", "scaling",
    "union", "subtraction", "intersection", "multifractal_noise",
}


def validate(node):
    """Check a graph dict; raises ValueError on an unknown kind or a value
    that is not a node."""
    if not isinstance(node, dict) or "kind" not in node:
        raise ValueError(f"not an SDF node: {node!r}")
    kind = node["kind"]
    if kind not in _KNOWN_KINDS:
        raise ValueError(f"unknown SDF node kind {kind!r}")
    for child in node.get("children", []):
        validate(child)
    if "child" in node:
        validate(node["child"])
    return node


def save_graph(path, node):
    """Write a graph as JSON (the voxel generator's file format)."""
    validate(node)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(node, f, indent=2)


def load_graph(path):
    with open(path, "r", encoding="utf-8") as f:
        return validate(json.load(f))
