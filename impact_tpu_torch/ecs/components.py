"""The component schema: the port's copy of ``impact_tpu/ecs/components.py``,
with the same 66 components, names, fields, dtypes, shapes, defaults and
setup/standard categories, so a world means the same thing in both
packages (ref: README.md:131-150; scenes are authored by attaching
components). Storage is the dense SoA arrays of ``ecs/world.py``.

Sources for each group:
- spatial:   impact_geometry/src/{reference_frame,model_transform}.rs
- motion:    impact_physics/src/quantities.rs:78 (Motion)
- rigid body setup: impact_physics/src/rigid_body/setup.rs:23-43,
             rigid_body.rs:41-53 marker components
- collision setup:  impact_physics/src/collision/setup.rs:26-64
- forces:    impact_physics/src/force/*.rs setup components
- driven motion: impact_physics/src/driven_motion/*.rs
- scene:     impact_scene/src/{lib,graph}.rs (SceneEntityFlags, Parent)

Angular velocity note: the reference stores axis+speed (quantities.rs:93); we
store the equivalent ω = axis·speed 3-vector, which is the form every kernel
consumes.
"""

from __future__ import annotations

from .world import component

# --- spatial ------------------------------------------------------------------


@component
class ReferenceFrame:
    """Origin position + orientation in parent space (ref: reference_frame.rs:12)."""

    position: ("f32", 3) = (0.0, 0.0, 0.0)
    orientation: ("f32", 4) = (0.0, 0.0, 0.0, 1.0)  # quaternion (x, y, z, w)


@component
class ModelTransform:
    """Model-to-entity similarity transform (ref: model_transform.rs:18)."""

    offset: ("f32", 3) = (0.0, 0.0, 0.0)
    scale: float = 1.0


@component
class Motion:
    """Linear + angular velocity (ref: quantities.rs:78)."""

    linear_velocity: ("f32", 3) = (0.0, 0.0, 0.0)
    angular_velocity: ("f32", 3) = (0.0, 0.0, 0.0)  # ω vector (axis·speed)


# --- scene ---------------------------------------------------------------------


@component
class SceneEntityFlags:
    """Bit flags: 1=IS_DISABLED, 2=CASTS_NO_SHADOWS (ref: impact_scene/src/lib.rs)."""

    flags: int = 0


@component
class DistanceTriggeredRules:
    """Disable shadowing / remove the entity beyond distances from an anchor
    entity (ref: impact_scene/src/lib.rs:74-91 DistanceTriggeredRules)."""

    anchor_id: ("u64", ()) = 0
    no_shadowing_dist_squared: float = 1e30
    removal_dist_squared: float = 1e30


@component
class Parent:
    """Parent entity reference (ref: impact_scene ParentEntity)."""

    entity_id: ("u64", ()) = 0


# --- rigid bodies ---------------------------------------------------------------


@component
class HasDynamicRigidBody:
    """Marker linking an entity to a dynamic rigid body slot
    (ref: rigid_body.rs:41). body_index is assigned by setup."""

    body_index: int = -1


@component
class HasKinematicRigidBody:
    """Marker linking an entity to a kinematic rigid body slot
    (ref: rigid_body.rs:53)."""

    body_index: int = -1


@component(setup=True)
class DynamicRigidBodySubstance:
    """Mass density of the body's substance; inertia computed from shape
    (ref: rigid_body/setup.rs:23)."""

    mass_density: float = 1.0


@component(setup=True)
class DynamicRigidBodyInertialProperties:
    """Explicit mass / center of mass / inertia tensor (ref: rigid_body/setup.rs:34)."""

    mass: float = 1.0
    center_of_mass: ("f32", 3) = (0.0, 0.0, 0.0)
    inertia_tensor: ("f32", (3, 3)) = (
        (1.0, 0.0, 0.0),
        (0.0, 1.0, 0.0),
        (0.0, 0.0, 1.0),
    )


@component(setup=True)
class KinematicRigidBodyMarker:
    """Requests a kinematic (velocity-driven) rigid body."""

    pass


# --- collidables -----------------------------------------------------------------


@component(setup=True)
class SphericalCollidable:
    """Sphere collidable (ref: collision/setup.rs:26). kind: 0=Dynamic 1=Static 2=Phantom."""

    kind: int = 0
    center: ("f32", 3) = (0.0, 0.0, 0.0)
    radius: float = 1.0
    restitution: float = 0.0
    static_friction: float = 0.5
    dynamic_friction: float = 0.3


@component(setup=True)
class PlanarCollidable:
    """Half-space collidable (ref: collision/setup.rs:39)."""

    kind: int = 1
    normal: ("f32", 3) = (0.0, 1.0, 0.0)
    displacement: float = 0.0
    restitution: float = 0.0
    static_friction: float = 0.5
    dynamic_friction: float = 0.3


@component(setup=True)
class CapsularCollidable:
    """Capsule collidable (ref: collision/setup.rs:52)."""

    kind: int = 0
    segment_start: ("f32", 3) = (0.0, -0.5, 0.0)
    segment_end: ("f32", 3) = (0.0, 0.5, 0.0)
    radius: float = 0.5
    restitution: float = 0.0
    static_friction: float = 0.5
    dynamic_friction: float = 0.3


# --- forces ------------------------------------------------------------------------


@component(setup=True)
class ConstantAcceleration:
    """Uniform acceleration (gravity) (ref: force/constant_acceleration.rs:51)."""

    acceleration: ("f32", 3) = (0.0, -9.81, 0.0)


@component(setup=True)
class LocalForce:
    """Constant force applied at a body-fixed point (ref: force/local_force.rs:29)."""

    force: ("f32", 3) = (0.0, 0.0, 0.0)
    point: ("f32", 3) = (0.0, 0.0, 0.0)


@component(setup=True)
class DynamicDynamicSpringForceGenerator:
    """Spring between two dynamic bodies (ref: force/spring_force.rs:46).
    Attachment points are in each entity's body frame."""

    entity_a: ("u64", ()) = 0
    entity_b: ("u64", ()) = 0
    attachment_a: ("f32", 3) = (0.0, 0.0, 0.0)
    attachment_b: ("f32", 3) = (0.0, 0.0, 0.0)
    stiffness: float = 1.0
    damping: float = 0.0
    rest_length: float = 0.0


@component(setup=True)
class DynamicGravity:
    """Participates in N-body pairwise gravity (ref: force/dynamic_gravity.rs:18)."""

    pass


@component(setup=True)
class DetailedDrag:
    """Drag force/torque against the uniform medium
    (ref: force/detailed_drag.rs:46). TPU build uses an analytic quadratic
    drag model over the body's bounding sphere area by default."""

    drag_coefficient: float = 1.0


# --- driven motion ------------------------------------------------------------------


@component(setup=True)
class CircularTrajectory:
    """Kinematic circular trajectory driver (ref: driven_motion/circular.rs)."""

    center: ("f32", 3) = (0.0, 0.0, 0.0)
    radius: float = 1.0
    angular_speed: float = 1.0
    axis: ("f32", 3) = (0.0, 1.0, 0.0)
    phase: float = 0.0


@component(setup=True)
class ConstantAccelerationTrajectory:
    """Kinematic trajectory with constant acceleration (ref: driven_motion/
    constant_acceleration.rs)."""

    initial_position: ("f32", 3) = (0.0, 0.0, 0.0)
    initial_velocity: ("f32", 3) = (0.0, 0.0, 0.0)
    acceleration: ("f32", 3) = (0.0, 0.0, 0.0)


@component(setup=True)
class ConstantRotation:
    """Kinematic constant-rate rotation (ref: driven_motion/constant_rotation.rs)."""

    initial_orientation: ("f32", 4) = (0.0, 0.0, 0.0, 1.0)
    angular_velocity: ("f32", 3) = (0.0, 0.0, 0.0)


@component(setup=True)
class HarmonicOscillation:
    """Kinematic harmonic oscillation along an axis (ref: driven_motion/
    harmonic_oscillation.rs)."""

    center: ("f32", 3) = (0.0, 0.0, 0.0)
    direction: ("f32", 3) = (0.0, 1.0, 0.0)
    amplitude: float = 1.0
    period: float = 1.0
    phase: float = 0.0


@component(setup=True)
class OrbitalTrajectory:
    """Kinematic Keplerian orbit (ref: driven_motion/orbit.rs)."""

    focal_position: ("f32", 3) = (0.0, 0.0, 0.0)
    semi_major_axis: float = 1.0
    eccentricity: float = 0.0
    orbital_period: float = 1.0
    # Orientation of the orbital plane (quaternion rotating the reference
    # orbit plane, x toward periapsis, z = orbit normal).
    orientation: ("f32", 4) = (0.0, 0.0, 0.0, 1.0)
    phase: float = 0.0


# --- camera (ref: impact_camera/src/setup.rs:13-26) ---------------------------


@component(setup=True)
class PerspectiveCamera:
    """Perspective camera projection (ref: camera setup.rs:13)."""

    vertical_field_of_view: float = 1.0471976  # 60°, radians
    near_distance: float = 0.01
    far_distance: float = 1000.0


# --- lights (ref: impact_light/src/lib.rs:80-175) -----------------------------


@component
class AmbientEmission:
    """Uniform ambient illuminance, lux (ref: lib.rs:80)."""

    illuminance: ("f32", 3) = (0.0, 0.0, 0.0)


@component
class OmnidirectionalEmission:
    """Point light, candela (ref: lib.rs:97)."""

    luminous_intensity: ("f32", 3) = (0.0, 0.0, 0.0)
    source_extent: float = 0.0


@component
class ShadowableOmnidirectionalEmission:
    """Shadow-casting point light (ref: lib.rs:118)."""

    luminous_intensity: ("f32", 3) = (0.0, 0.0, 0.0)
    source_extent: float = 0.0


@component
class UnidirectionalEmission:
    """Directional light, lux (ref: lib.rs:139)."""

    perpendicular_illuminance: ("f32", 3) = (0.0, 0.0, 0.0)
    direction: ("f32", 3) = (0.0, -1.0, 0.0)
    angular_source_extent: float = 0.0


@component
class ShadowableUnidirectionalEmission:
    """Shadow-casting directional light (ref: lib.rs:160)."""

    perpendicular_illuminance: ("f32", 3) = (0.0, 0.0, 0.0)
    direction: ("f32", 3) = (0.0, -1.0, 0.0)
    angular_source_extent: float = 0.0


# --- voxel objects (ref: impact_voxel/src/setup.rs:44-165) ---------------------


@component(setup=True)
class VoxelSphere:
    """Spherical voxel object; radius in voxels (ref: setup.rs:114)."""

    voxel_extent: float = 0.25
    radius: float = 8.0


@component(setup=True)
class VoxelBox:
    """Box voxel object; extents in voxels (ref: setup.rs:97)."""

    voxel_extent: float = 0.25
    extent_x: float = 8.0
    extent_y: float = 8.0
    extent_z: float = 8.0


@component(setup=True)
class VoxelCapsule:
    """Capsular voxel object (ref: setup.rs:127)."""

    voxel_extent: float = 0.25
    segment_length: float = 8.0
    radius: float = 4.0


@component(setup=True)
class VoxelSphereUnion:
    """Smooth union of two spheres (ref: setup.rs:144)."""

    voxel_extent: float = 0.25
    radius_1: float = 6.0
    radius_2: float = 6.0
    center_offsets: ("f32", 3) = (6.0, 0.0, 0.0)
    smoothness: float = 2.0


@component(setup=True)
class GeneratedVoxelObject:
    """SDF-generator-built voxel object (ref: setup.rs:44). generator_id is
    the FNV-32 hash of the registered generator name."""

    generator_id: ("u32", ()) = 0
    voxel_extent: float = 0.25
    scale_factor: float = 1.0
    seed: ("u64", ()) = 0


@component(setup=True)
class SameVoxelType:
    """Single voxel type by registry index (the reference stores the FNV-32
    name hash; we resolve names at setup time) (ref: setup.rs:57)."""

    voxel_type: int = 0


@component(setup=True)
class GradientNoiseVoxelTypes:
    """Noise-mixed voxel types (ref: setup.rs:67). Up to 4 types here."""

    n_voxel_types: int = 1
    voxel_types: ("i32", 4) = (0, 0, 0, 0)
    noise_frequency: float = 0.15
    voxel_type_frequency: float = 1.0
    seed: ("u32", ()) = 0


@component(setup=True)
class MultifractalNoiseSDFModification:
    """Noise modification of the generated SDF (ref: setup.rs:82)."""

    octaves: int = 4
    frequency: float = 0.15
    lacunarity: float = 2.0
    persistence: float = 0.5
    amplitude: float = 2.0
    seed: ("u32", ()) = 0


@component(setup=True)
class DynamicVoxels:
    """Voxel object behaves as a dynamic rigid body (ref: setup.rs:165)."""

    pass


@component(setup=True)
class VoxelCollidable:
    """Voxel object participates in collision (ref: impact_voxel/src/setup.rs
    VoxelCollidable setup component). kind: 0=Dynamic 1=Static."""

    kind: int = 0
    restitution: float = 0.0
    static_friction: float = 0.5
    dynamic_friction: float = 0.3


@component
class VoxelAbsorbingSphere:
    """Sphere that absorbs voxels from dynamic voxel objects, in the entity's
    frame (ref: interaction/absorption.rs VoxelAbsorbingSphere)."""

    offset: ("f32", 3) = (0.0, 0.0, 0.0)
    radius: float = 1.0
    rate: float = 1.0


@component
class FracturingProperties:
    """Enables impact fracturing for a voxel object
    (ref: interaction/fracturing.rs:61-70 force threshold etc.)."""

    impulse_threshold: float = 100.0
    fracture_radius: float = 4.0


@component(setup=True)
class FixedDirectionAlignmentTorque:
    """Torque aligning a body-fixed axis with a fixed world direction
    (ref: force/alignment_torque.rs:70 FixedDirectionAlignmentTorque)."""

    axis: ("f32", 3) = (0.0, 1.0, 0.0)
    direction: ("f32", 3) = (0.0, 1.0, 0.0)
    strength: float = 1.0
    damping: float = 0.1


@component
class VoxelAbsorbingCapsule:
    """Capsule that absorbs voxels, in the entity's frame
    (ref: interaction/absorption.rs VoxelAbsorbingCapsule)."""

    segment_start: ("f32", 3) = (0.0, -0.5, 0.0)
    segment_end: ("f32", 3) = (0.0, 0.5, 0.0)
    radius: float = 1.0
    rate: float = 1.0


@component(setup=True)
class SphericalJoint:
    """Ball joint constraining two body-frame anchor points to coincide
    (ref: impact_physics/src/constraint/spherical_joint.rs + anchor.rs)."""

    entity_a: ("u64", ()) = 0
    entity_b: ("u64", ()) = 0
    anchor_a: ("f32", 3) = (0.0, 0.0, 0.0)
    anchor_b: ("f32", 3) = (0.0, 0.0, 0.0)


@component(setup=True)
class OrthographicCamera:
    """Orthographic camera projection (ref: impact_camera setup.rs:26).
    The view volume's half-height is far·tan(fov/2), matching
    OrthographicTransform::with_field_of_view (projection.rs:216-236)."""

    vertical_field_of_view: float = 0.02  # radians
    near_distance: float = 0.01
    far_distance: float = 1000.0


# --- mesh models (ref: impact_mesh/src/setup.rs mesh setup components) ---------


@component(setup=True)
class BoxMesh:
    """Axis-aligned box mesh (ref: impact_mesh setup.rs BoxMesh; unit cube =
    extents 1)."""

    extent_x: float = 1.0
    extent_y: float = 1.0
    extent_z: float = 1.0


@component(setup=True)
class SphereMesh:
    """Lat/long unit-diameter sphere mesh (ref: setup.rs SphereMesh)."""

    n_rings: int = 15


@component(setup=True)
class HemisphereMesh:
    """Upper-half unit-diameter sphere (ref: setup.rs HemisphereMesh)."""

    n_rings: int = 8


@component(setup=True)
class CylinderMesh:
    """Y-axis cylinder, base at the origin (ref: setup.rs CylinderMesh)."""

    length: float = 1.0
    diameter: float = 1.0
    n_circumference_vertices: int = 15


@component(setup=True)
class ConeMesh:
    """Y-axis cone, base at the origin (ref: setup.rs ConeMesh)."""

    length: float = 1.0
    max_diameter: float = 1.0
    n_circumference_vertices: int = 15


@component(setup=True)
class CapsuleMesh:
    """Y-axis capsule centered on the origin (ref: setup.rs CapsuleMesh)."""

    segment_length: float = 1.0
    diameter: float = 1.0
    n_circumference_vertices: int = 15


@component(setup=True)
class RectangleMesh:
    """Unit square in the xz-plane, +y normal (ref: setup.rs RectangleMesh)."""

    extent_x: float = 1.0
    extent_z: float = 1.0


@component(setup=True)
class TriangleMeshFile:
    """OBJ/PLY mesh import by path hash — the path is looked up host-side at
    setup (ref: impact_mesh/src/io/{obj,ply}.rs import components)."""

    path_hash: ("u64", ()) = 0


# --- per-entity material setup (ref: impact_material/src/setup/physical.rs) ----


@component(setup=True)
class UniformColor:
    """Uniform base color: albedo for dielectrics, F0 tint for metals
    (ref: setup/physical.rs:36 UniformColor)."""

    color: ("f32", 3) = (1.0, 1.0, 1.0)


@component(setup=True)
class UniformSpecularReflectance:
    """Scalar specular reflectance at normal incidence (ref:
    setup/physical.rs:62; METAL_MAX = 1.0, WATER = 0.02, etc.)."""

    reflectance: float = 0.0


@component(setup=True)
class UniformRoughness:
    """GGX roughness in [0,1] (ref: setup/physical.rs:108)."""

    roughness: float = 1.0


@component(setup=True)
class UniformMetalness:
    """Metalness in [0,1]: blends albedo into F0 (ref: setup/physical.rs:136;
    add_metal = 1.0)."""

    metalness: float = 0.0


@component(setup=True)
class UniformEmissiveLuminance:
    """Emitted luminance (cd/m²), tinted by the entity color (ref:
    setup/physical.rs:178 UniformEmissiveLuminance)."""

    luminance: float = 0.0


@component(setup=True)
class TexturedColor:
    """Textured base color: albedo for dielectrics, F0 tint for metals
    (ref: setup/physical.rs:55 TexturedColor(TextureID)). ``texture_id`` is
    the FNV-1a hash of a registered texture (runtime.setup.register_texture)."""

    texture_id: ("u64", ()) = 0


@component(setup=True)
class TexturedSpecularReflectance:
    """Textured scalar specular reflectance at normal incidence, scaled by
    ``scale_factor`` (ref: setup/physical.rs:79)."""

    texture_id: ("u64", ()) = 0
    scale_factor: float = 1.0


@component(setup=True)
class TexturedRoughness:
    """Textured GGX roughness, scaled by ``scale_factor``
    (ref: setup/physical.rs:105)."""

    texture_id: ("u64", ()) = 0
    scale_factor: float = 1.0


@component(setup=True)
class TexturedMetalness:
    """Textured metalness, scaled by ``scale_factor``
    (ref: setup/physical.rs:152)."""

    texture_id: ("u64", ()) = 0
    scale_factor: float = 1.0


@component(setup=True)
class TexturedEmissiveLuminance:
    """Textured monochromatic emissive luminance (cd/m²), scaled by
    ``scale_factor`` and tinted by the base color
    (ref: setup/physical.rs:183)."""

    texture_id: ("u64", ()) = 0
    scale_factor: float = 1.0


@component(setup=True)
class NormalMap:
    """Tangent-space normal map describing surface details
    (ref: setup/physical.rs:196 NormalMap(TextureID))."""

    texture_id: ("u64", ()) = 0


@component(setup=True)
class ParallaxMap:
    """Height map for parallax mapping (ref: setup/physical.rs:205
    ParallaxMap). ``displacement_scale`` is in world units here (the
    deferred triplanar path offsets world-space sample positions;
    uv_per_distance is kept for schema parity and folded into the offset)."""

    height_map_texture_id: ("u64", ()) = 0
    displacement_scale: float = 0.02
    uv_per_distance: ("f32", 2) = (1.0, 1.0)
