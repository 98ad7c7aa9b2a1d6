"""Built-in scenes as plain data (port of the tumbler part of
``impact_tpu/models/scenes.py``).

The reference builds an ECS world; the port has no ECS, so a scene is a
:class:`Scene` record holding exactly what ``runtime.setup.compile_scene``
reads. ``voxel_box_tumbler`` makes the same ``np.random.default_rng(seed)``
draws in the same order as the reference, so both packages place the same
boxes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..render.camera import look_at


@dataclass
class CameraSpec:
    position: tuple
    orientation: tuple  # (x, y, z, w) camera-to-world
    vertical_fov: float
    near: float
    far: float


@dataclass
class OmniLight:
    position: tuple
    luminous_intensity: tuple
    source_extent: float
    shadowable: bool


@dataclass
class UniLight:
    direction: tuple
    perpendicular_illuminance: tuple
    angular_source_extent: float
    shadowable: bool


@dataclass
class VoxelBoxSpec:
    position: tuple
    orientation: tuple
    angular_velocity: tuple
    voxel_extent: float
    extent_x: float
    extent_y: float
    extent_z: float
    voxel_type: int = 0
    casts_shadows: bool = True


@dataclass
class Scene:
    camera: CameraSpec | None = None
    ambient_illuminance: tuple = (0.0, 0.0, 0.0)
    omni_lights: list = field(default_factory=list)
    uni_lights: list = field(default_factory=list)
    ground_planes: list = field(default_factory=list)  # y displacement per y-up plane
    boxes: list = field(default_factory=list)


def _camera(scene: Scene, eye, target, fov=np.pi / 3):
    q = look_at(eye, target).numpy()
    scene.camera = CameraSpec(
        position=tuple(float(e) for e in eye), orientation=tuple(float(x) for x in q),
        vertical_fov=float(fov), near=0.05, far=500.0,
    )


def _standard_lights(scene: Scene):
    scene.ambient_illuminance = (900.0, 950.0, 1100.0)
    scene.omni_lights.append(OmniLight(
        position=(25.0, 30.0, 25.0), luminous_intensity=(3e5, 2.8e5, 2.4e5),
        source_extent=0.5, shadowable=True,
    ))
    scene.uni_lights.append(UniLight(
        direction=(-0.35, -0.8, -0.48),
        perpendicular_illuminance=(30000.0, 28000.0, 24000.0),
        angular_source_extent=2.0, shadowable=True,
    ))


def _ground(scene: Scene, y=0.0):
    scene.ground_planes.append(float(y))


def voxel_box_tumbler(n_boxes: int = 4, seed: int = 0, box_extent: float = 10.0) -> Scene:
    """Ref scene VoxelBoxTumbler: dynamic voxel boxes over a floor.
    ``box_extent`` (voxels per side) is what the bench sets to 26."""
    rng = np.random.default_rng(seed)
    s = Scene()
    _camera(s, (0.0, 14.0, 34.0), (0.0, 2.0, 0.0))
    _standard_lights(s)
    _ground(s, y=0.0)
    for i in range(n_boxes):
        pos = (float(rng.uniform(-6, 6)), float(6.0 + 5.0 * i), float(rng.uniform(-6, 6)))
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(0, np.pi)
        q = np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])
        ang = rng.uniform(-2, 2, 3).astype(np.float32)
        s.boxes.append(VoxelBoxSpec(
            position=pos,
            orientation=tuple(float(x) for x in q.astype(np.float32)),
            angular_velocity=tuple(float(x) for x in ang),
            voxel_extent=0.25, extent_x=box_extent, extent_y=box_extent,
            extent_z=box_extent, voxel_type=0,
        ))
    return s
