"""SDF graph nodes and their evaluation (port of the part of
``impact_tpu/voxel/sdf.py`` the built-in scenes need: the box, sphere and
capsule primitives and the multifractal noise modifier of the asteroid).

Graph nodes are plain dicts with the same keys as the reference's, so a
graph built by either package evaluates in both.

The noise's lattice hash is u32 arithmetic with wraparound multiplies and
logical right shifts. It runs here in int64 holding values in [0, 2³²):
each product is split into 16-bit halves so that no int64 product
overflows, and every sum is masked back to 32 bits."""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def sphere(radius):
    return {"kind": "sphere", "radius": float(radius)}


def box(extents):
    return {"kind": "box", "extents": tuple(float(e) for e in extents)}


def capsule(radius, segment_length):
    """A capsule along y: a segment of ``segment_length`` swept by ``radius``."""
    return {"kind": "capsule", "radius": float(radius), "segment_length": float(segment_length)}


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
    if kind == "multifractal_noise":
        d = evaluate(node["child"], p)
        n = multifractal_noise(p, octaves=node["octaves"], frequency=node["frequency"],
                               lacunarity=node["lacunarity"], persistence=node["persistence"],
                               seed=node["seed"])
        return d + n * node["amplitude"]
    raise ValueError(f"SDF node kind {kind!r} is not ported")
