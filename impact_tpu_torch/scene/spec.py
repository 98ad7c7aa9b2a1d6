"""A scene as plain data: the records that ``runtime.setup.compile_scene``
lowers into device state.

The reference builds an ECS world; the port has no ECS, so a scene is a
:class:`Scene` record holding exactly what the compile reads, with voxel
objects in the reference's entity order (which fixes their object and body
slots). Regular bodies go to ground planes, then absorbing spheres, then
absorbing capsules, then the rigid bodies in list order: a scene lists its
entities in that order to get the reference's body slots. Mesh entities
take mesh-instance slots in the same order (rigid bodies with a mesh, then
the static mesh entities). Joints and distance rules name their entities
by (list, index), e.g. ``("rigid_body", 0)``. Textures live in the scene
(``Scene.textures``, by name): a material that names one the scene lacks
raises ``KeyError`` at compile, as an unregistered texture id does in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
class Material:
    """A mesh entity's material (ref: impact_material setup/physical.rs:
    Uniform*/Textured*/NormalMap/ParallaxMap): each property uniform, or
    textured by the name of a scene texture; the textured scalar
    properties take (name, scale factor), the parallax map (name,
    displacement scale in world units)."""

    color: tuple = (1.0, 1.0, 1.0)
    specular: float = 0.0
    roughness: float = 1.0
    metalness: float = 0.0
    emissive: float = 0.0
    color_texture: str | None = None
    specular_texture: tuple | None = None
    roughness_texture: tuple | None = None
    metalness_texture: tuple | None = None
    emissive_texture: tuple | None = None
    normal_map: str | None = None
    parallax_map: tuple | None = None

    @property
    def textured(self) -> bool:
        return any(v is not None for v in (
            self.color_texture, self.specular_texture, self.roughness_texture,
            self.metalness_texture, self.emissive_texture, self.normal_map, self.parallax_map))


@dataclass
class MeshSpec:
    """A mesh model (ref components BoxMesh, SphereMesh, CapsuleMesh and
    ModelTransform): ``shape`` "box" (``extents``), "sphere" (the
    reference's UV sphere of radius 1 and ``n_rings`` rings) or "capsule"
    (``segment_length``, ``diameter``, ``n_circumference_vertices``),
    scaled by ``scale`` and moved by ``offset`` in the entity's frame."""

    shape: str = "box"
    extents: tuple = (1.0, 1.0, 1.0)
    n_rings: int = 15
    segment_length: float = 1.0
    diameter: float = 1.0
    n_circumference_vertices: int = 15
    scale: float = 1.0
    offset: tuple = (0.0, 0.0, 0.0)
    material: Material = field(default_factory=Material)
    casts_shadows: bool = True


@dataclass
class MeshEntity:
    """A mesh model at a static pose (no rigid body)."""

    mesh: MeshSpec
    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)


@dataclass
class SphereCollidableSpec:
    """ref component SphericalCollidable; kind 0 dynamic, 1 static, 2
    phantom (no contacts)."""

    radius: float = 1.0
    kind: int = 0
    center: tuple = (0.0, 0.0, 0.0)
    response: tuple = (0.0, 0.5, 0.3)  # restitution, static and dynamic friction


@dataclass
class CapsuleCollidableSpec:
    """ref component CapsularCollidable."""

    segment_start: tuple = (0.0, -0.5, 0.0)
    segment_end: tuple = (0.0, 0.5, 0.0)
    radius: float = 0.5
    kind: int = 0
    response: tuple = (0.0, 0.5, 0.3)


@dataclass
class PlaneCollidableSpec:
    """ref component PlanarCollidable (a half-space; static by default)."""

    normal: tuple = (0.0, 1.0, 0.0)
    displacement: float = 0.0
    kind: int = 1
    response: tuple = (0.0, 0.5, 0.3)


@dataclass
class Inertia:
    """ref component DynamicRigidBodyInertialProperties (the centre of mass
    is not read, as in the reference)."""

    mass: float = 1.0
    center_of_mass: tuple = (0.0, 0.0, 0.0)
    inertia_tensor: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


@dataclass
class HarmonicOscillationSpec:
    center: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 1.0, 0.0)
    amplitude: float = 1.0
    period: float = 1.0
    phase: float = 0.0


@dataclass
class CircularTrajectorySpec:
    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0
    angular_speed: float = 1.0
    axis: tuple = (0.0, 1.0, 0.0)
    phase: float = 0.0


@dataclass
class ConstantRotationSpec:
    initial_orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    angular_velocity: tuple = (0.0, 0.0, 0.0)


@dataclass
class OrbitalTrajectorySpec:
    focal_position: tuple = (0.0, 0.0, 0.0)
    semi_major_axis: float = 1.0
    eccentricity: float = 0.0
    orbital_period: float = 1.0
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    phase: float = 0.0


@dataclass
class AlignmentTorqueSpec:
    """ref component FixedDirectionAlignmentTorque."""

    axis: tuple = (0.0, 1.0, 0.0)
    direction: tuple = (0.0, 1.0, 0.0)
    strength: float = 1.0
    damping: float = 0.1


@dataclass
class RigidBody:
    """A rigid-body entity on a regular body slot. It is dynamic
    when it has ``mass_density`` (ref DynamicRigidBodySubstance: mass and
    inertia from its sphere or capsule collidable, else mass = density and
    inertia = density·I) or ``inertia``, else kinematic (ref
    KinematicRigidBodyMarker and the trajectory components). It may carry
    collidables, forces (constant acceleration, a local force at a body
    point, dynamic gravity, detailed drag, an alignment torque), one motion
    driver and a mesh."""

    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    linear_velocity: tuple = (0.0, 0.0, 0.0)
    angular_velocity: tuple = (0.0, 0.0, 0.0)
    mass_density: float | None = None
    inertia: Inertia | None = None
    sphere: SphereCollidableSpec | None = None
    capsule: CapsuleCollidableSpec | None = None
    plane: PlaneCollidableSpec | None = None
    acceleration: tuple | None = None
    local_force: tuple | None = None  # (force, body-frame point)
    dynamic_gravity: bool = False
    drag_coefficient: float | None = None
    alignment_torque: AlignmentTorqueSpec | None = None
    driver: object | None = None  # one of the *Spec drivers above
    mesh: MeshSpec | None = None

    @property
    def dynamic(self) -> bool:
        return self.mass_density is not None or self.inertia is not None


@dataclass
class SphericalJointSpec:
    """ref component SphericalJoint: the body-frame anchors of two
    entities (each an (list, index) reference) held together."""

    entity_a: tuple
    entity_b: tuple
    anchor_a: tuple = (0.0, 0.0, 0.0)
    anchor_b: tuple = (0.0, 0.0, 0.0)


@dataclass
class DistanceRule:
    """ref component DistanceTriggeredRules on ``entity``: beyond
    √no_shadowing_dist_squared from ``anchor`` it casts no shadow, beyond
    √removal_dist_squared it is removed."""

    entity: tuple
    anchor: tuple
    no_shadowing_dist_squared: float = 1e30
    removal_dist_squared: float = 1e30


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
    rigid_bodies: list = field(default_factory=list)  # RigidBody
    mesh_entities: list = field(default_factory=list)  # MeshEntity
    joints: list = field(default_factory=list)  # SphericalJointSpec
    distance_rules: list = field(default_factory=list)  # DistanceRule
    # name → float array [H,W] or [H,W,C] in [0,1], or a PNG path
    textures: dict = field(default_factory=dict)
