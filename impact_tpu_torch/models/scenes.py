"""Built-in scenes as ECS worlds: the port of ``impact_tpu/models/scenes.py``
(Blank, VoxelBoxTumbler, Fracturing, BallPit, Asteroid, HarmonicOscillation,
FreeRotation, DragDrop and RenderingTest; ref: apps/basic_app/scripts/, the
Roc-authored scenes).

Each builder creates the same entities with the same components, in the same
order, as the reference's, and ``voxel_box_tumbler`` and ``ball_pit`` make
the same ``np.random.default_rng(seed)`` draws, so the two packages build
equal worlds (``tests/test_torch_ecs.py``). ``compile_scene`` takes them as
they are.
"""

from __future__ import annotations

import numpy as np

from ..ecs import World
from ..ecs import components as C
from ..render.camera import look_at


def _camera(world: World, eye, target, fov=np.pi / 3):
    q = look_at(eye, target).numpy()
    world.create_entity(
        C.ReferenceFrame(position=tuple(eye), orientation=tuple(q)),
        C.PerspectiveCamera(vertical_field_of_view=float(fov), near_distance=0.05,
                            far_distance=500.0),
    )


def _standard_lights(world: World):
    world.create_entity(C.AmbientEmission(illuminance=(900.0, 950.0, 1100.0)))
    world.create_entity(
        C.ReferenceFrame(position=(25.0, 30.0, 25.0)),
        C.ShadowableOmnidirectionalEmission(
            luminous_intensity=(3e5, 2.8e5, 2.4e5), source_extent=0.5
        ),
    )
    world.create_entity(
        C.ShadowableUnidirectionalEmission(
            perpendicular_illuminance=(30000.0, 28000.0, 24000.0),
            direction=(-0.35, -0.8, -0.48),
            angular_source_extent=2.0,
        ),
    )


def _ground(world: World, y=0.0, restitution=0.3):
    world.create_entity(
        C.ReferenceFrame(),
        C.PlanarCollidable(
            kind=1, normal=(0.0, 1.0, 0.0), displacement=y,
            restitution=restitution, static_friction=0.7, dynamic_friction=0.5,
        ),
    )


def blank() -> World:
    """Ref scene: Blank — camera + lights only."""
    w = World()
    _camera(w, (0.0, 5.0, 20.0), (0.0, 0.0, 0.0))
    _standard_lights(w)
    return w


def voxel_box_tumbler(n_boxes: int = 4, seed: int = 0) -> World:
    """Ref scene: VoxelBoxTumbler — dynamic voxel boxes tumbling onto a floor."""
    rng = np.random.default_rng(seed)
    w = World()
    _camera(w, (0.0, 14.0, 34.0), (0.0, 2.0, 0.0))
    _standard_lights(w)
    _ground(w, y=0.0)
    for i in range(n_boxes):
        pos = (
            float(rng.uniform(-6, 6)),
            float(6.0 + 5.0 * i),
            float(rng.uniform(-6, 6)),
        )
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(0, np.pi)
        q = np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])
        w.create_entity(
            C.ReferenceFrame(position=pos, orientation=tuple(q.astype(np.float32))),
            C.Motion(angular_velocity=tuple(rng.uniform(-2, 2, 3).astype(np.float32))),
            C.VoxelBox(voxel_extent=0.25, extent_x=10.0, extent_y=10.0, extent_z=10.0),
            C.SameVoxelType(voxel_type=0),
            C.DynamicVoxels(),
            C.VoxelCollidable(kind=0, restitution=0.3, static_friction=0.7,
                              dynamic_friction=0.5),
            C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)),
        )
    return w


def fracturing(seed: int = 0) -> World:
    """Ref experiment: Fracturing — a voxel ball fired at a fracturable voxel
    box over a floor."""
    w = World()
    _camera(w, (0.0, 10.0, 30.0), (0.0, 2.0, 0.0))
    _standard_lights(w)
    _ground(w, y=0.0)
    # fracturable target box
    w.create_entity(
        C.ReferenceFrame(position=(0.0, 3.2, 0.0)),
        C.VoxelBox(voxel_extent=0.25, extent_x=14.0, extent_y=14.0, extent_z=14.0),
        C.SameVoxelType(voxel_type=0),
        C.DynamicVoxels(),
        C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.8,
                          dynamic_friction=0.6),
        C.FracturingProperties(impulse_threshold=30.0, fracture_radius=2.5),
        C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)),
    )
    # projectile voxel sphere
    w.create_entity(
        C.ReferenceFrame(position=(-12.0, 4.0, 0.0)),
        C.Motion(linear_velocity=(18.0, 1.0, 0.0)),
        C.VoxelSphere(voxel_extent=0.25, radius=5.0),
        C.SameVoxelType(voxel_type=1),
        C.DynamicVoxels(),
        C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.6,
                          dynamic_friction=0.4),
        C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)),
    )
    return w


def ball_pit(n_balls: int = 12, seed: int = 0) -> World:
    """Ref scene: BallPit — analytic spheres raining into a pit."""
    rng = np.random.default_rng(seed)
    w = World()
    _camera(w, (0.0, 10.0, 24.0), (0.0, 1.0, 0.0))
    _standard_lights(w)
    _ground(w, y=0.0, restitution=0.5)
    palette = [
        (0.8, 0.25, 0.2), (0.2, 0.55, 0.8), (0.85, 0.7, 0.2),
        (0.3, 0.7, 0.35), (0.7, 0.35, 0.75), (0.9, 0.5, 0.3),
    ]
    for i in range(n_balls):
        col = palette[i % len(palette)]
        w.create_entity(
            C.ReferenceFrame(
                position=(
                    float(rng.uniform(-4, 4)),
                    float(3.0 + 1.5 * i),
                    float(rng.uniform(-4, 4)),
                )
            ),
            # renderable sphere (unit diameter = collidable radius 0.5; the
            # reference's BallPit bodies carry mesh + material setup
            # components too, Scenes/BallPit.roc create_capsules!)
            C.SphereMesh(n_rings=12),
            C.UniformColor(color=col),
            C.UniformRoughness(roughness=0.4),
            C.SphericalCollidable(kind=0, radius=0.5, restitution=0.6,
                                  static_friction=0.5, dynamic_friction=0.3),
            C.DynamicRigidBodySubstance(mass_density=1200.0),
            C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)),
        )
    return w


def asteroid(seed: int = 7) -> World:
    """Ref scene: Asteroid — a noise-modified generated voxel asteroid
    (the voxel_generator flagship shape) with drag-free tumbling."""
    w = World()
    _camera(w, (0.0, 6.0, 26.0), (0.0, 0.0, 0.0))
    _standard_lights(w)
    w.create_entity(
        C.ReferenceFrame(position=(0.0, 0.0, 0.0)),
        C.Motion(angular_velocity=(0.05, 0.25, 0.1)),
        C.VoxelSphere(voxel_extent=0.3, radius=10.0),
        C.MultifractalNoiseSDFModification(
            octaves=4, frequency=0.22, lacunarity=2.0, persistence=0.55,
            amplitude=1.6, seed=seed,
        ),
        C.GradientNoiseVoxelTypes(
            n_voxel_types=3, voxel_types=(0, 1, 2, 0), noise_frequency=0.35,
            voxel_type_frequency=1.0, seed=seed,
        ),
        C.DynamicVoxels(),
        C.VoxelCollidable(kind=0),
    )
    return w


def harmonic_oscillation() -> World:
    """Ref experiment: HarmonicOscillation — kinematic driver demo."""
    w = World()
    _camera(w, (0.0, 2.0, 14.0), (0.0, 2.0, 0.0))
    _standard_lights(w)
    w.create_entity(
        C.ReferenceFrame(position=(0.0, 2.0, 0.0)),
        C.SphericalCollidable(kind=2, radius=0.5),  # phantom: no contacts
        C.HarmonicOscillation(center=(0.0, 2.0, 0.0), direction=(0.0, 1.0, 0.0),
                              amplitude=2.0, period=2.0),
    )
    return w


def free_rotation() -> World:
    """Ref experiment: FreeRotation — torque-free tumbling of an asymmetric
    body (Dzhanibekov-style intermediate-axis dynamics)."""
    w = World()
    _camera(w, (0.0, 0.0, 10.0), (0.0, 0.0, 0.0))
    _standard_lights(w)
    w.create_entity(
        C.ReferenceFrame(),
        C.Motion(angular_velocity=(0.01, 5.0, 0.01)),
        C.DynamicRigidBodyInertialProperties(
            mass=1.0,
            inertia_tensor=((0.2, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 2.0)),
        ),
    )
    return w


def drag_drop() -> World:
    """Ref experiment: DragDrop — spheres falling through a dense medium."""
    w = World()
    _camera(w, (0.0, 5.0, 16.0), (0.0, 4.0, 0.0))
    _standard_lights(w)
    _ground(w, y=0.0)
    for x, drag in ((-2.0, 0.0), (2.0, 4.0)):
        w.create_entity(
            C.ReferenceFrame(position=(x, 8.0, 0.0)),
            C.SphericalCollidable(kind=0, radius=0.5),
            C.DynamicRigidBodySubstance(mass_density=500.0),
            C.DetailedDrag(drag_coefficient=drag),
            C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)),
        )
    return w


def rendering_test(
    ambient=(900.0, 950.0, 1100.0),
    omni: str | None = "shadowable",  # None | "plain" | "shadowable"
    uni: str | None = "shadowable",
    omni_extent: float = 0.5,
    uni_extent: float = 2.0,
    emissive_sphere: bool = False,
) -> World:
    """Standard rendering-feature scene (ref: basic_app RenderingTest scene —
    a fixed arrangement of shaded objects the snapshot_tester renders with one
    feature enabled per scene, testing.rs:20-60)."""
    w = World()
    _camera(w, (0.0, 4.5, 11.0), (0.0, 1.5, 0.0))
    if any(c > 0 for c in ambient):
        w.create_entity(C.AmbientEmission(illuminance=ambient))
    if omni == "plain":
        w.create_entity(
            C.ReferenceFrame(position=(6.0, 10.0, 7.0)),
            C.OmnidirectionalEmission(
                luminous_intensity=(8e5, 7.6e5, 6.4e5), source_extent=omni_extent
            ),
        )
    elif omni == "shadowable":
        w.create_entity(
            C.ReferenceFrame(position=(6.0, 10.0, 7.0)),
            C.ShadowableOmnidirectionalEmission(
                luminous_intensity=(8e5, 7.6e5, 6.4e5), source_extent=omni_extent
            ),
        )
    if uni == "plain":
        w.create_entity(
            C.UnidirectionalEmission(
                perpendicular_illuminance=(25000.0, 24000.0, 20000.0),
                direction=(-0.4, -0.75, -0.5),
                angular_source_extent=uni_extent,
            )
        )
    elif uni == "shadowable":
        w.create_entity(
            C.ShadowableUnidirectionalEmission(
                perpendicular_illuminance=(25000.0, 24000.0, 20000.0),
                direction=(-0.4, -0.75, -0.5),
                angular_source_extent=uni_extent,
            )
        )
    _ground(w, y=0.0)
    # fixed arrangement: box, sphere, capsule of distinct voxel types
    for pos, vtype, builder in (
        ((-3.2, 2.0, 0.0), 0, lambda: C.VoxelBox(voxel_extent=0.3, extent_x=14, extent_y=14, extent_z=14)),
        ((0.6, 1.9, 1.5), 1, lambda: C.VoxelSphere(voxel_extent=0.3, radius=9.0)),
        ((3.8, 1.4, -0.8), 2, lambda: C.VoxelCapsule(voxel_extent=0.3, segment_length=10.0, radius=5.0)),
    ):
        w.create_entity(
            builder(),
            C.ReferenceFrame(position=pos),
            C.SameVoxelType(voxel_type=vtype),
        )
    if emissive_sphere:
        # strongly emissive marker for the bloom scene
        w.create_entity(
            C.VoxelSphere(voxel_extent=0.3, radius=6.0),
            C.ReferenceFrame(position=(0.0, 5.0, 2.5)),
            C.SameVoxelType(voxel_type=2),
        )
    return w


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
