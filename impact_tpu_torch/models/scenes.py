"""Built-in scenes as plain data (port of the blank, tumbler, fracturing,
ball pit, asteroid and rendering-test scenes of
``impact_tpu/models/scenes.py``).

The reference builds an ECS world; the port has no ECS, so a scene is a
:class:`Scene` record holding exactly what ``runtime.setup.compile_scene``
reads, with voxel objects in the reference's entity order (which fixes
their object and body slots). Regular bodies go to ground planes, then
absorbing spheres, then absorbing capsules, then dynamic sphere bodies, the
entity order of the reference's scenes. ``voxel_box_tumbler`` and
``ball_pit`` make the same ``np.random.default_rng(seed)`` draws in the
same order as the reference, so both packages place the same bodies.
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
class GroundPlane:
    """A static y-up planar collidable (ref scene helper ``_ground``)."""

    y: float = 0.0
    restitution: float = 0.3
    static_friction: float = 0.7
    dynamic_friction: float = 0.5


@dataclass
class NoiseSpec:
    """The multifractal noise added to a voxel object's SDF (ref component
    MultifractalNoiseSDFModification)."""

    octaves: int = 4
    frequency: float = 0.15
    lacunarity: float = 2.0
    persistence: float = 0.5
    amplitude: float = 2.0
    seed: int = 0


@dataclass
class GradientNoiseTypesSpec:
    """Voxel types mixed by gradient noise, up to 4 (ref component
    GradientNoiseVoxelTypes)."""

    n_voxel_types: int = 1
    voxel_types: tuple = (0, 0, 0, 0)
    noise_frequency: float = 0.15
    voxel_type_frequency: float = 1.0
    seed: int = 0


@dataclass
class AbsorbingSphere:
    """A voxel-absorbing sphere on a kinematic body of its own at
    ``position`` (ref component VoxelAbsorbingSphere; offset in the body's
    frame)."""

    position: tuple
    offset: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0
    rate: float = 1.0


@dataclass
class AbsorbingCapsule:
    """A voxel-absorbing capsule on a kinematic body of its own at
    ``position`` (ref component VoxelAbsorbingCapsule; segment in the
    body's frame)."""

    position: tuple
    segment_start: tuple = (0.0, -0.5, 0.0)
    segment_end: tuple = (0.0, 0.5, 0.0)
    radius: float = 1.0
    rate: float = 1.0


@dataclass
class VoxelObjectSpec:
    """A voxel object: a box (``size`` = extents in voxels), a sphere
    (``size`` = (radius,) in voxels) or a capsule along y (``size`` =
    (radius, segment_length) in voxels), with its motion, contact response
    (None: no voxel collidable, a zero response), gravity and fracture
    properties, an optional noise modifier of its SDF and optional
    noise-mixed voxel types (else ``voxel_type``). ``dynamic=False`` is the
    reference's voxel object without DynamicVoxels: its body starts
    kinematic."""

    position: tuple
    voxel_extent: float
    shape: str = "box"  # "box" | "sphere" | "capsule"
    size: tuple = (10.0, 10.0, 10.0)
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    voxel_type: int = 0
    linear_velocity: tuple = (0.0, 0.0, 0.0)
    angular_velocity: tuple = (0.0, 0.0, 0.0)
    response: tuple | None = (0.3, 0.7, 0.5)  # restitution, static and dynamic friction
    dynamic: bool = True
    acceleration: tuple | None = (0.0, -9.81, 0.0)  # constant acceleration (gravity)
    fracture: tuple | None = None  # (impulse_threshold, fracture_radius)
    casts_shadows: bool = True
    noise: NoiseSpec | None = None
    voxel_types: GradientNoiseTypesSpec | None = None


@dataclass
class SphereBody:
    """A dynamic rigid sphere (ref components SphericalCollidable,
    DynamicRigidBodySubstance, ConstantAcceleration) drawn as a UV sphere
    mesh of ``n_rings`` rings and radius 1 (ref SphereMesh) with a uniform
    colour and roughness."""

    position: tuple
    radius: float = 0.5
    mass_density: float = 1.0
    response: tuple = (0.0, 0.5, 0.3)  # restitution, static and dynamic friction
    acceleration: tuple | None = (0.0, -9.81, 0.0)
    n_rings: int = 15
    color: tuple = (1.0, 1.0, 1.0)
    roughness: float = 1.0


@dataclass
class Scene:
    camera: CameraSpec | None = None
    ambient_illuminance: tuple = (0.0, 0.0, 0.0)
    omni_lights: list = field(default_factory=list)
    uni_lights: list = field(default_factory=list)
    ground_planes: list = field(default_factory=list)  # GroundPlane
    voxel_objects: list = field(default_factory=list)  # VoxelObjectSpec
    absorbing_spheres: list = field(default_factory=list)  # AbsorbingSphere
    absorbing_capsules: list = field(default_factory=list)  # AbsorbingCapsule
    sphere_bodies: list = field(default_factory=list)  # SphereBody


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
        s.sphere_bodies.append(SphereBody(
            position=(x, float(3.0 + 1.5 * i), z), radius=0.5, mass_density=1200.0,
            response=(0.6, 0.5, 0.3), n_rings=12, color=palette[i % len(palette)],
            roughness=0.4,
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
    "RenderingTest": rendering_test,
}
