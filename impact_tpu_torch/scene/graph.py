"""Scene graph over the ECS: parent-child transform propagation (port of
``impact_tpu/scene/graph.py``; ref: impact_scene/src/graph.rs:32-38,
``update_all_group_to_root_transforms``).

The graph is derived from the ``Parent`` component: an entity's world
transform composes its ``ReferenceFrame`` with its parent's world
transform, recursively. Host-side authoring work on the port's
``ecs.World`` (the quaternion arithmetic in float32 on the CPU); the
per-frame path reads body poses directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ecs import World
from ..ecs import components as C
from ..math import quaternion as quat


def _rotate(q, v):
    return quat.rotate(torch.from_numpy(q), torch.from_numpy(v)).numpy()


def _compose_rotation(pq, q):
    return quat.normalize(quat.mul(torch.from_numpy(pq), torch.from_numpy(q))).numpy()


def world_transforms(world: World):
    """World-space (position f32[3], orientation f32[4]) of every alive
    entity, composing ReferenceFrame along Parent chains → dict entity id →
    (position, orientation). A chain deeper than 64 raises ValueError."""
    ids = [int(e) for e in world.entity_ids[world.alive]]
    local = {}
    parents = {}
    for eid in ids:
        if world.has_component(eid, C.ReferenceFrame):
            rf = world.get_component(eid, C.ReferenceFrame)
            local[eid] = (np.asarray(rf.position, np.float32),
                          np.asarray(rf.orientation, np.float32))
        else:
            local[eid] = (np.zeros(3, np.float32), np.array([0, 0, 0, 1], np.float32))
        if world.has_component(eid, C.Parent):
            parents[eid] = int(world.get_component(eid, C.Parent).entity_id)

    out = {}

    def resolve(eid, depth=0):
        if eid in out:
            return out[eid]
        if depth > 64:
            raise ValueError("scene graph cycle or excessive depth")
        p, q = local[eid]
        parent = parents.get(eid)
        if parent is not None and parent in local:
            pp, pq = resolve(parent, depth + 1)
            p = _rotate(pq, p) + pp
            q = _compose_rotation(pq, q)
        out[eid] = (p, q)
        return out[eid]

    for eid in ids:
        resolve(eid)
    return out


def flatten_to_world_frames(world: World):
    """Write the composed world transforms back into each entity's
    ReferenceFrame (the setup reads world-space frames; ref: graph.rs
    update_all_group_to_root_transforms and the sync systems)."""
    for eid, (p, q) in world_transforms(world).items():
        if world.has_component(eid, C.ReferenceFrame):
            world.set_field(eid, C.ReferenceFrame, "position", p)
            world.set_field(eid, C.ReferenceFrame, "orientation", q)
    return world
