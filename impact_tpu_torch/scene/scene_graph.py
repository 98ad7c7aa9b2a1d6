"""Typed scene-graph node storage with root-transform propagation (port of
``impact_tpu/scene/scene_graph.py``; ref: impact_scene/src/graph.rs:33-110).

``SceneGraph`` holds three node pools: group nodes (group-to-parent
isometries and child lists), model-instance nodes (model-to-parent
similarities, per-instance flags and a bounding sphere) and camera nodes
(camera-to-parent isometries). ``update_all_group_to_root_transforms``
(graph.rs:454) propagates transforms root-down; the flattened instance
model-to-root transforms and world bounding spheres feed culling
(lib.rs:160).

Host-side authoring state in numpy, as ``ecs.World`` is: the per-frame
path reads the flattened outputs (``instance_transforms_to_root``), so
node bookkeeping launches nothing on the card. Slot pools with ids that
are never reused within one session stand for NodeStorage's generational
arenas.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# ModelInstanceFlags (ref: graph.rs:110 bitflags)
INSTANCE_IS_HIDDEN = 1 << 0
INSTANCE_CASTS_NO_SHADOWS = 1 << 1


def _np_quat_mul(a, b):
    """Hamilton product, xyzw layout (numpy: host-side graph work
    launches nothing on the device)."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        np.float32,
    )


def _np_quat_rotate(q, v):
    """Rotate vector v by unit quaternion q (xyzw), numpy."""
    u = np.asarray(q[:3], np.float32)
    w = np.float32(q[3])
    v = np.asarray(v, np.float32)
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _compose(pp, pq, ps, p, q, s):
    """Compose parent (pos, quat, scale) with child local (pos, quat, scale):
    similarity transforms T_parent ∘ T_child (ref: Similarity3 composition)."""
    pos = np.asarray(pp, np.float32) + ps * _np_quat_rotate(pq, p)
    rot = _np_quat_mul(pq, q)
    rot = rot / max(float(np.linalg.norm(rot)), 1e-12)
    return pos, rot.astype(np.float32), ps * s


@dataclass
class _GroupNode:
    parent: int | None  # parent group id (None = root)
    position: np.ndarray  # group-to-parent isometry
    orientation: np.ndarray
    children_groups: list = field(default_factory=list)
    children_instances: list = field(default_factory=list)
    children_cameras: list = field(default_factory=list)
    # derived by update_all_group_to_root_transforms
    root_position: np.ndarray | None = None
    root_orientation: np.ndarray | None = None


@dataclass
class _ModelInstanceNode:
    parent: int
    model_id: int  # caller-defined model handle (mesh pool slot, etc.)
    position: np.ndarray  # model-to-parent similarity
    orientation: np.ndarray
    scale: float
    flags: int
    bounding_radius: float  # model-space bounding sphere (center = origin)


@dataclass
class _CameraNode:
    parent: int
    position: np.ndarray  # camera-to-parent isometry
    orientation: np.ndarray


class SceneGraph:
    """Ref: graph.rs:126 SceneGraph::new — starts with one root group."""

    def __init__(self):
        self._groups: dict[int, _GroupNode] = {}
        self._instances: dict[int, _ModelInstanceNode] = {}
        self._cameras: dict[int, _CameraNode] = {}
        self._next_id = 1
        self._root = self._alloc()
        self._groups[self._root] = _GroupNode(
            parent=None,
            position=np.zeros(3, np.float32),
            orientation=np.array([0, 0, 0, 1], np.float32),
        )

    # -- storage ------------------------------------------------------------

    def _alloc(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    @property
    def root_node_id(self) -> int:
        return self._root

    def n_nodes(self) -> int:
        return len(self._groups) + len(self._instances) + len(self._cameras)

    def has_group(self, gid: int) -> bool:
        return gid in self._groups

    def has_instance(self, iid: int) -> bool:
        return iid in self._instances

    # -- creation (ref: graph.rs:169/208/274) -------------------------------

    def create_group_node(
        self, parent: int, position=(0, 0, 0), orientation=(0, 0, 0, 1)
    ) -> int:
        if parent not in self._groups:
            raise KeyError(f"no group node {parent}")
        gid = self._alloc()
        self._groups[gid] = _GroupNode(
            parent=parent,
            position=np.asarray(position, np.float32),
            orientation=np.asarray(orientation, np.float32),
        )
        self._groups[parent].children_groups.append(gid)
        return gid

    def create_model_instance_node(
        self,
        parent: int,
        model_id: int,
        position=(0, 0, 0),
        orientation=(0, 0, 0, 1),
        scale: float = 1.0,
        flags: int = 0,
        bounding_radius: float = 1.0,
    ) -> int:
        if parent not in self._groups:
            raise KeyError(f"no group node {parent}")
        iid = self._alloc()
        self._instances[iid] = _ModelInstanceNode(
            parent=parent,
            model_id=model_id,
            position=np.asarray(position, np.float32),
            orientation=np.asarray(orientation, np.float32),
            scale=float(scale),
            flags=int(flags),
            bounding_radius=float(bounding_radius),
        )
        self._groups[parent].children_instances.append(iid)
        return iid

    def create_camera_node(
        self, parent: int, position=(0, 0, 0), orientation=(0, 0, 0, 1)
    ) -> int:
        if parent not in self._groups:
            raise KeyError(f"no group node {parent}")
        cid = self._alloc()
        self._cameras[cid] = _CameraNode(
            parent=parent,
            position=np.asarray(position, np.float32),
            orientation=np.asarray(orientation, np.float32),
        )
        self._groups[parent].children_cameras.append(cid)
        return cid

    # -- removal (ref: graph.rs:307/345/364 — remove_group_node recursively
    # removes the group and all descendant groups/instances/cameras) --------

    def remove_group_node(self, gid: int):
        if gid == self._root:
            raise ValueError("cannot remove the root group")
        node = self._groups[gid]
        for iid in list(node.children_instances):
            self.remove_model_instance_node(iid)
        for cid in list(node.children_cameras):
            self.remove_camera_node(cid)
        for child_gid in list(node.children_groups):
            self.remove_group_node(child_gid)
        self._groups[node.parent].children_groups.remove(gid)
        del self._groups[gid]

    def remove_model_instance_node(self, iid: int):
        node = self._instances.pop(iid)
        self._groups[node.parent].children_instances.remove(iid)

    def remove_camera_node(self, cid: int):
        node = self._cameras.pop(cid)
        self._groups[node.parent].children_cameras.remove(cid)

    # -- transform setters (ref: graph.rs:391-446) --------------------------

    def set_group_to_parent_transform(self, gid, position, orientation):
        n = self._groups[gid]
        n.position = np.asarray(position, np.float32)
        n.orientation = np.asarray(orientation, np.float32)

    def set_model_to_parent_transform(
        self, iid, position, orientation, scale: float = 1.0
    ):
        n = self._instances[iid]
        n.position = np.asarray(position, np.float32)
        n.orientation = np.asarray(orientation, np.float32)
        n.scale = float(scale)

    def set_camera_to_parent_transform(self, cid, position, orientation):
        n = self._cameras[cid]
        n.position = np.asarray(position, np.float32)
        n.orientation = np.asarray(orientation, np.float32)

    def set_instance_flags(self, iid, flags: int):
        self._instances[iid].flags = int(flags)

    def instance_flags(self, iid) -> int:
        return self._instances[iid].flags

    # -- propagation (ref: graph.rs:454) ------------------------------------

    def update_all_group_to_root_transforms(self):
        """Root-down BFS: each group's group-to-root isometry from its
        parent's (already final) root transform."""
        order = [self._root]
        root = self._groups[self._root]
        root.root_position = root.position
        root.root_orientation = root.orientation
        i = 0
        while i < len(order):
            gid = order[i]
            i += 1
            g = self._groups[gid]
            for cid in g.children_groups:
                c = self._groups[cid]
                c.root_position, c.root_orientation, _ = _compose(
                    g.root_position, g.root_orientation, 1.0,
                    c.position, c.orientation, 1.0,
                )
                order.append(cid)

    def group_to_root_transform(self, gid):
        g = self._groups[gid]
        if g.root_position is None:
            raise ValueError("call update_all_group_to_root_transforms first")
        return g.root_position, g.root_orientation

    # -- flattened per-frame outputs ----------------------------------------

    def instance_transforms_to_root(self, include_hidden: bool = False):
        """Flatten model instances to arrays for the render path:
        (model_ids i32[K], positions f32[K,3], orientations f32[K,4],
        scales f32[K], flags i32[K], bounding spheres (centers f32[K,3],
        radii f32[K])) — the buffered-instance analog of
        lib.rs:160 buffer_model_instances_and_bound_lights."""
        ids, pos, ori, scl, flg, rad = [], [], [], [], [], []
        for iid, n in self._instances.items():
            if not include_hidden and (n.flags & INSTANCE_IS_HIDDEN):
                continue
            gp, gq = self.group_to_root_transform(n.parent)
            p, q, s = _compose(gp, gq, 1.0, n.position, n.orientation, n.scale)
            ids.append(n.model_id)
            pos.append(p)
            ori.append(q)
            scl.append(s)
            flg.append(n.flags)
            rad.append(n.bounding_radius * s)
        k = len(ids)
        return (
            np.asarray(ids, np.int32).reshape(k),
            np.asarray(pos, np.float32).reshape(k, 3),
            np.asarray(ori, np.float32).reshape(k, 4),
            np.asarray(scl, np.float32).reshape(k),
            np.asarray(flg, np.int32).reshape(k),
            (np.asarray(pos, np.float32).reshape(k, 3),
             np.asarray(rad, np.float32).reshape(k)),
        )

    def sync_camera_view_transform(self, cid):
        """World pose of a camera node (ref: graph.rs:482) — feed into
        render.camera.Camera(position, orientation, ...)."""
        n = self._cameras[cid]
        gp, gq = self.group_to_root_transform(n.parent)
        p, q, _ = _compose(gp, gq, 1.0, n.position, n.orientation, 1.0)
        return p, q
