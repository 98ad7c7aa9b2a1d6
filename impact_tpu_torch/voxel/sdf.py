"""SDF graph nodes and their evaluation (port of the part of
``impact_tpu/voxel/sdf.py`` the bench scenes need: the box and sphere
primitives).

Graph nodes are plain dicts with the same keys as the reference's, so a
graph built by either package evaluates in both."""

from __future__ import annotations

import torch


def sphere(radius):
    return {"kind": "sphere", "radius": float(radius)}


def box(extents):
    return {"kind": "box", "extents": tuple(float(e) for e in extents)}


def evaluate(node, p):
    """Evaluate an SDF graph at points ``p`` [...,3] → distances [...]."""
    kind = node["kind"]
    if kind == "sphere":
        return torch.sqrt((p * p).sum(dim=-1)) - node["radius"]
    if kind == "box":
        he = torch.tensor(node["extents"], dtype=torch.float32, device=p.device) * 0.5
        q = p.abs() - he
        return torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
            q.amax(dim=-1), max=0.0
        )
    raise ValueError(f"SDF node kind {kind!r} is not ported")
