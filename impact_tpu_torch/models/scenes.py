"""Built-in scenes as plain data (port of the nine scenes of
``impact_tpu/models/scenes.py``: Blank, VoxelBoxTumbler, Fracturing,
BallPit, Asteroid, HarmonicOscillation, FreeRotation, DragDrop and
RenderingTest).

Each builder returns a :class:`~impact_tpu_torch.scene.spec.Scene` (see
there for the slot order the records keep). ``voxel_box_tumbler`` and
``ball_pit`` make the same ``np.random.default_rng(seed)`` draws in the same
order as the reference, so both packages place the same bodies.
"""

from __future__ import annotations

import numpy as np

from ..render.camera import look_at
from ..scene.spec import (
    CameraSpec,
    GradientNoiseTypesSpec,
    GroundPlane,
    HarmonicOscillationSpec,
    Inertia,
    Material,
    MeshSpec,
    NoiseSpec,
    OmniLight,
    RigidBody,
    Scene,
    SphereCollidableSpec,
    UniLight,
    VoxelObjectSpec,
)


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


def _ground(scene: Scene, y=0.0, restitution=0.3):
    scene.ground_planes.append(GroundPlane(y=float(y), restitution=restitution))


def blank() -> Scene:
    """Ref scene Blank: camera and lights only."""
    s = Scene()
    _camera(s, (0.0, 5.0, 20.0), (0.0, 0.0, 0.0))
    _standard_lights(s)
    return s


def voxel_box_tumbler(n_boxes: int = 4, seed: int = 0, box_extent: float = 10.0,
                      spacing: float = 5.0) -> Scene:
    """Ref scene VoxelBoxTumbler: dynamic voxel boxes over a floor, box i at
    height 6 + spacing·i. ``box_extent`` (voxels per side) is what the bench
    sets to 26; ``spacing`` is the reference's 5 m unless a caller clears
    larger boxes (see ``models/bench.py``)."""
    rng = np.random.default_rng(seed)
    s = Scene()
    _camera(s, (0.0, 14.0, 34.0), (0.0, 2.0, 0.0))
    _standard_lights(s)
    _ground(s, y=0.0)
    for i in range(n_boxes):
        pos = (float(rng.uniform(-6, 6)), float(6.0 + spacing * i), float(rng.uniform(-6, 6)))
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(0, np.pi)
        q = np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])
        ang = rng.uniform(-2, 2, 3).astype(np.float32)
        s.voxel_objects.append(VoxelObjectSpec(
            position=pos,
            orientation=tuple(float(x) for x in q.astype(np.float32)),
            angular_velocity=tuple(float(x) for x in ang),
            voxel_extent=0.25, shape="box", size=(box_extent,) * 3, voxel_type=0,
            response=(0.3, 0.7, 0.5),
        ))
    return s


def fracturing(impulse_threshold: float = 30.0, fracture_radius: float = 2.5) -> Scene:
    """Ref experiment Fracturing: a voxel ball fired at a fracturable voxel
    box over a floor. ``bench.py:bench_fracture`` sets the box's impulse
    threshold to 5.0 (see ``models/bench.py``)."""
    s = Scene()
    _camera(s, (0.0, 10.0, 30.0), (0.0, 2.0, 0.0))
    _standard_lights(s)
    _ground(s, y=0.0)
    s.voxel_objects.append(VoxelObjectSpec(
        position=(0.0, 3.2, 0.0), voxel_extent=0.25, shape="box", size=(14.0, 14.0, 14.0),
        voxel_type=0, response=(0.1, 0.8, 0.6),
        fracture=(float(impulse_threshold), float(fracture_radius)),
    ))
    s.voxel_objects.append(VoxelObjectSpec(
        position=(-12.0, 4.0, 0.0), voxel_extent=0.25, shape="sphere", size=(5.0,),
        voxel_type=1, linear_velocity=(18.0, 1.0, 0.0), response=(0.1, 0.6, 0.4),
    ))
    return s


def ball_pit(n_balls: int = 12, seed: int = 0) -> Scene:
    """Ref scene BallPit: analytic spheres raining into a pit."""
    rng = np.random.default_rng(seed)
    s = Scene()
    _camera(s, (0.0, 10.0, 24.0), (0.0, 1.0, 0.0))
    _standard_lights(s)
    _ground(s, y=0.0, restitution=0.5)
    palette = [(0.8, 0.25, 0.2), (0.2, 0.55, 0.8), (0.85, 0.7, 0.2),
               (0.3, 0.7, 0.35), (0.7, 0.35, 0.75), (0.9, 0.5, 0.3)]
    for i in range(n_balls):
        x = float(rng.uniform(-4, 4))
        z = float(rng.uniform(-4, 4))
        # a dynamic sphere under gravity, drawn as a UV sphere of radius 1
        s.rigid_bodies.append(RigidBody(
            position=(x, float(3.0 + 1.5 * i), z), mass_density=1200.0,
            sphere=SphereCollidableSpec(radius=0.5, response=(0.6, 0.5, 0.3)),
            acceleration=(0.0, -9.81, 0.0),
            mesh=MeshSpec(shape="sphere", n_rings=12, material=Material(
                color=palette[i % len(palette)], roughness=0.4)),
        ))
    return s


def asteroid(seed: int = 7) -> Scene:
    """Ref scene Asteroid: a noise-modified voxel sphere (radius 10 voxels of
    0.3 m) with noise-mixed voxel types, tumbling with no gravity and no
    floor."""
    s = Scene()
    _camera(s, (0.0, 6.0, 26.0), (0.0, 0.0, 0.0))
    _standard_lights(s)
    s.voxel_objects.append(VoxelObjectSpec(
        position=(0.0, 0.0, 0.0), voxel_extent=0.3, shape="sphere", size=(10.0,),
        angular_velocity=(0.05, 0.25, 0.1), response=(0.0, 0.5, 0.3), acceleration=None,
        noise=NoiseSpec(octaves=4, frequency=0.22, lacunarity=2.0, persistence=0.55,
                        amplitude=1.6, seed=seed),
        voxel_types=GradientNoiseTypesSpec(n_voxel_types=3, voxel_types=(0, 1, 2, 0),
                                           noise_frequency=0.35, voxel_type_frequency=1.0,
                                           seed=seed),
    ))
    return s


def harmonic_oscillation() -> Scene:
    """Ref experiment HarmonicOscillation: a phantom sphere on a kinematic
    body driven up and down."""
    s = Scene()
    _camera(s, (0.0, 2.0, 14.0), (0.0, 2.0, 0.0))
    _standard_lights(s)
    s.rigid_bodies.append(RigidBody(
        position=(0.0, 2.0, 0.0), sphere=SphereCollidableSpec(radius=0.5, kind=2),
        driver=HarmonicOscillationSpec(center=(0.0, 2.0, 0.0), direction=(0.0, 1.0, 0.0),
                                       amplitude=2.0, period=2.0)))
    return s


def free_rotation() -> Scene:
    """Ref experiment FreeRotation: torque-free tumbling of an asymmetric
    body spun near its intermediate axis."""
    s = Scene()
    _camera(s, (0.0, 0.0, 10.0), (0.0, 0.0, 0.0))
    _standard_lights(s)
    s.rigid_bodies.append(RigidBody(
        angular_velocity=(0.01, 5.0, 0.01),
        inertia=Inertia(mass=1.0, inertia_tensor=((0.2, 0.0, 0.0), (0.0, 1.0, 0.0),
                                                  (0.0, 0.0, 2.0)))))
    return s


def drag_drop() -> Scene:
    """Ref experiment DragDrop: two spheres dropped over a floor, one with
    detailed drag (coefficient 4) and one without. The drag acts only where
    ``physics.medium.mass_density`` > 0, which defaults to 0: as written
    both fall alike (ROADMAP Queue 3)."""
    s = Scene()
    _camera(s, (0.0, 5.0, 16.0), (0.0, 4.0, 0.0))
    _standard_lights(s)
    _ground(s, y=0.0)
    for x, drag in ((-2.0, 0.0), (2.0, 4.0)):
        s.rigid_bodies.append(RigidBody(
            position=(x, 8.0, 0.0), sphere=SphereCollidableSpec(radius=0.5),
            mass_density=500.0, drag_coefficient=drag, acceleration=(0.0, -9.81, 0.0)))
    return s


def rendering_test(ambient=(900.0, 950.0, 1100.0), omni: str | None = "shadowable",
                   uni: str | None = "shadowable", omni_extent: float = 0.5,
                   uni_extent: float = 2.0, emissive_sphere: bool = False) -> Scene:
    """Ref scene RenderingTest: a fixed arrangement of a box, a sphere and a
    capsule of voxel types 0, 1 and 2 (static, no collidable) on a floor,
    lit by its own lights; ``omni`` and ``uni`` are None, "plain" or
    "shadowable". The snapshot tester renders it with one feature on per
    scene."""
    s = Scene()
    _camera(s, (0.0, 4.5, 11.0), (0.0, 1.5, 0.0))
    if any(c > 0 for c in ambient):
        s.ambient_illuminance = tuple(float(c) for c in ambient)
    if omni is not None:
        s.omni_lights.append(OmniLight(
            position=(6.0, 10.0, 7.0), luminous_intensity=(8e5, 7.6e5, 6.4e5),
            source_extent=omni_extent, shadowable=omni == "shadowable"))
    if uni is not None:
        s.uni_lights.append(UniLight(
            direction=(-0.4, -0.75, -0.5), perpendicular_illuminance=(25000.0, 24000.0, 20000.0),
            angular_source_extent=uni_extent, shadowable=uni == "shadowable"))
    _ground(s, y=0.0)
    shapes = [((-3.2, 2.0, 0.0), 0, "box", (14.0, 14.0, 14.0)),
              ((0.6, 1.9, 1.5), 1, "sphere", (9.0,)),
              ((3.8, 1.4, -0.8), 2, "capsule", (5.0, 10.0))]
    if emissive_sphere:
        # strongly emissive marker for the bloom scene
        shapes.append(((0.0, 5.0, 2.5), 2, "sphere", (6.0,)))
    for pos, vtype, shape, size in shapes:
        s.voxel_objects.append(VoxelObjectSpec(
            position=pos, voxel_extent=0.3, shape=shape, size=size, voxel_type=vtype,
            response=None, acceleration=None, dynamic=False))
    return s


SCENES = {
    "Blank": blank,
    "VoxelBoxTumbler": voxel_box_tumbler,
    "Fracturing": fracturing,
    "BallPit": ball_pit,
    "Asteroid": asteroid,
    "HarmonicOscillation": harmonic_oscillation,
    "FreeRotation": free_rotation,
    "DragDrop": drag_drop,
    "RenderingTest": rendering_test,
}
