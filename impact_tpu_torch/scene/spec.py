"""The lowered form of an ECS world: the records that
``runtime.setup.compile_scene`` turns into device state, and
:func:`lower_world`, which reads a :class:`~impact_tpu_torch.ecs.World`
into them.

``lower_world`` walks the world in the reference compile's passes and
order (``impact_tpu/runtime/setup.py:310-1055``): voxel objects in entity
order (which fixes their object and body slots), then the mesh-model
entities, then every entity that needs a regular body, in entity order
(which fixes the regular body slots, and the collidable, force, driver and
absorber slots within each family), then joints, distance rules, lights and
the camera. As in the reference, it strips each lowered entity's setup
components from the world, so a world is compiled once. Joints and distance
rules name their entities as (list, index), ``("rigid_body", j)`` or
``("voxel_object", i)``; a mesh entity names its rigid body by index.
Textures are referenced by their FNV-1a ids, and ``Scene.textures`` holds
the registered source of each id the materials use: an id that was never
registered is missing there, and the compile raises ``KeyError`` for it, as
the reference does.

Every setup component of the reference lowers: voxel spheres, boxes,
capsules, sphere unions and generated objects (each as its SDF graph of
``voxel/sdf.py``; a generated object's graph is ``sdf_generators[
generator_id]``, and an unknown id raises ``KeyError``, as in the
reference), the box, sphere, hemisphere, cylinder, cone, capsule and
rectangle meshes and OBJ/PLY mesh files (an unregistered path lowers to no
mesh, as in the reference), and the perspective and orthographic cameras.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ecs import components as C
from ..voxel import sdf as sdflib


@dataclass
class CameraSpec:
    position: tuple
    orientation: tuple  # (x, y, z, w) camera-to-world
    vertical_fov: float
    near: float
    far: float
    orthographic: bool = False  # half-height far·tan(fov/2), ref projection.rs:216-236


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
    """ref component VoxelAbsorbingSphere (offset in the body's frame)."""

    offset: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0
    rate: float = 1.0


@dataclass
class AbsorbingCapsule:
    """ref component VoxelAbsorbingCapsule (segment in the body's frame)."""

    segment_start: tuple = (0.0, -0.5, 0.0)
    segment_end: tuple = (0.0, 0.5, 0.0)
    radius: float = 1.0
    rate: float = 1.0


@dataclass
class VoxelObjectSpec:
    """A voxel object: its SDF graph (``voxel/sdf.py`` dicts, in world
    units, before the noise modifier) voxelized at ``voxel_extent``, with
    its motion, contact response (None: no voxel collidable, a zero
    response), gravity and fracture properties, an optional noise modifier
    of its SDF and optional noise-mixed voxel types (else ``voxel_type``).
    ``dynamic=False`` is the reference's voxel object without DynamicVoxels:
    its body starts kinematic."""

    position: tuple
    voxel_extent: float
    graph: dict
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
    entity: int | None = None  # the world's entity id


@dataclass
class Material:
    """A mesh entity's material (ref: impact_material setup/physical.rs:
    Uniform*/Textured*/NormalMap/ParallaxMap): each property uniform, or
    textured by a texture id; the textured scalar properties take (id,
    scale factor), the parallax map (id, displacement scale in world
    units)."""

    color: tuple = (1.0, 1.0, 1.0)
    specular: float = 0.0
    roughness: float = 1.0
    metalness: float = 0.0
    emissive: float = 0.0
    color_texture: int | None = None
    specular_texture: tuple | None = None
    roughness_texture: tuple | None = None
    metalness_texture: tuple | None = None
    emissive_texture: tuple | None = None
    normal_map: int | None = None
    parallax_map: tuple | None = None

    @property
    def textured(self) -> bool:
        return any(v is not None for v in (
            self.color_texture, self.specular_texture, self.roughness_texture,
            self.metalness_texture, self.emissive_texture, self.normal_map, self.parallax_map))

    def texture_ids(self):
        for v in (self.color_texture, self.normal_map):
            if v is not None:
                yield v
        for v in (self.specular_texture, self.roughness_texture, self.metalness_texture,
                  self.emissive_texture, self.parallax_map):
            if v is not None:
                yield v[0]


@dataclass
class MeshSpec:
    """A mesh model (ref components BoxMesh, SphereMesh, HemisphereMesh,
    CylinderMesh, ConeMesh, CapsuleMesh, RectangleMesh, TriangleMeshFile
    and ModelTransform), by ``shape``:

    * "box": ``extents``;
    * "sphere" and "hemisphere": the reference's UV sphere (or its upper
      half) of radius 1 and ``n_rings`` rings;
    * "cylinder" and "cone": ``length``, ``diameter`` (the cone's base) and
      ``n_circumference_vertices``, the base at the origin;
    * "capsule": ``segment_length``, ``diameter`` and
      ``n_circumference_vertices``;
    * "rectangle": ``extents`` = (extent_x, extent_z) in the xz-plane;
    * "file": the OBJ or PLY mesh at ``path`` (PLY by its suffix);

    scaled by ``scale`` and moved by ``offset`` in the entity's frame."""

    shape: str = "box"
    extents: tuple = (1.0, 1.0, 1.0)
    n_rings: int = 15
    segment_length: float = 1.0
    length: float = 1.0
    diameter: float = 1.0
    n_circumference_vertices: int = 15
    path: str | None = None
    scale: float = 1.0
    offset: tuple = (0.0, 0.0, 0.0)
    material: Material = field(default_factory=Material)
    casts_shadows: bool = True


@dataclass
class MeshEntity:
    """A mesh model, posed by rigid body ``body`` (an index into
    ``Scene.rigid_bodies``) or, without one, at its static frame."""

    mesh: MeshSpec
    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    body: int | None = None


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
    """An entity on a regular body slot. It is dynamic when it has
    ``mass_density`` (ref DynamicRigidBodySubstance: mass and inertia from
    its sphere or capsule collidable, else mass = density and inertia =
    density·I) or ``inertia``, else kinematic (ref KinematicRigidBodyMarker,
    the trajectory components, or an entity that only carries collidables,
    absorbers or an alignment torque). It may carry collidables, forces
    (constant acceleration, a local force at a body point, dynamic gravity,
    detailed drag, an alignment torque), motion drivers (in the reference's
    circular, harmonic, rotation, orbital order) and voxel absorbers."""

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
    drivers: list = field(default_factory=list)  # *Spec drivers above
    absorbing_sphere: AbsorbingSphere | None = None
    absorbing_capsule: AbsorbingCapsule | None = None

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
    omni_lights: list = field(default_factory=list)  # plain ones first
    uni_lights: list = field(default_factory=list)
    voxel_objects: list = field(default_factory=list)  # VoxelObjectSpec, entity order
    rigid_bodies: list = field(default_factory=list)  # RigidBody, entity order
    mesh_entities: list = field(default_factory=list)  # MeshEntity, entity order
    joints: list = field(default_factory=list)  # SphericalJointSpec
    distance_rules: list = field(default_factory=list)  # DistanceRule
    # texture id → float array [H,W] or [H,W,C] in [0,1], or an image path
    textures: dict = field(default_factory=dict)


# --- lowering ---------------------------------------------------------------------


def _t(x) -> tuple:
    return tuple(np.asarray(x).tolist())


def _response(c) -> tuple:
    return (c.restitution, c.static_friction, c.dynamic_friction)


_VOXEL_SHAPES = (C.VoxelSphere, C.VoxelBox, C.VoxelCapsule, C.VoxelSphereUnion,
                 C.GeneratedVoxelObject)
_MESHES = (C.BoxMesh, C.SphereMesh, C.HemisphereMesh, C.CylinderMesh, C.ConeMesh,
           C.CapsuleMesh, C.RectangleMesh, C.TriangleMeshFile)
_KINEMATIC = (C.KinematicRigidBodyMarker, C.CircularTrajectory,
              C.ConstantAccelerationTrajectory, C.ConstantRotation, C.HarmonicOscillation,
              C.OrbitalTrajectory)
_BODY_PARTS = (C.SphericalCollidable, C.PlanarCollidable, C.CapsularCollidable,
               C.VoxelAbsorbingSphere, C.VoxelAbsorbingCapsule,
               C.FixedDirectionAlignmentTorque)
_DRIVERS = ((C.CircularTrajectory, CircularTrajectorySpec, dict(
    center="center", radius="radius", angular_speed="angular_speed", axis="axis",
    phase="phase")),
            (C.HarmonicOscillation, HarmonicOscillationSpec, dict(
                center="center", direction="direction", amplitude="amplitude",
                period="period", phase="phase")),
            (C.ConstantRotation, ConstantRotationSpec, dict(
                initial_orientation="initial_orientation",
                angular_velocity="angular_velocity")),
            (C.OrbitalTrajectory, OrbitalTrajectorySpec, dict(
                focal_position="focal_position", semi_major_axis="semi_major_axis",
                eccentricity="eccentricity", orbital_period="orbital_period",
                orientation="orientation", phase="phase")))


def _spec_value(v):
    return _t(v) if isinstance(v, np.ndarray) else v


def _voxel_graph(shape, sdf_generators: dict) -> dict:
    """A voxel shape component's SDF graph in world units, in the
    reference's float arithmetic (``impact_tpu/runtime/setup.py:351-367``)."""
    extent = float(shape.voxel_extent)
    if isinstance(shape, C.VoxelSphere):
        return sdflib.sphere(shape.radius * extent)
    if isinstance(shape, C.VoxelBox):
        return sdflib.box((shape.extent_x * extent, shape.extent_y * extent,
                           shape.extent_z * extent))
    if isinstance(shape, C.VoxelCapsule):
        return sdflib.capsule(shape.radius * extent, shape.segment_length * extent)
    if isinstance(shape, C.VoxelSphereUnion):
        off = np.asarray(shape.center_offsets) * extent  # float32, as the reference's
        return sdflib.union(sdflib.translation(sdflib.sphere(shape.radius_1 * extent), -off / 2),
                            sdflib.translation(sdflib.sphere(shape.radius_2 * extent), off / 2),
                            smoothness=shape.smoothness * extent)
    # GeneratedVoxelObject: the reference reads only generator_id
    return sdf_generators[int(shape.generator_id)]


def _mesh_spec(mc, mesh_files: dict) -> MeshSpec | None:
    """The MeshSpec of a mesh component; None for a mesh file whose path
    was never registered (the reference lowers no mesh for it)."""
    if isinstance(mc, C.BoxMesh):
        return MeshSpec(shape="box", extents=(mc.extent_x, mc.extent_y, mc.extent_z))
    if isinstance(mc, (C.SphereMesh, C.HemisphereMesh)):
        return MeshSpec(shape="sphere" if isinstance(mc, C.SphereMesh) else "hemisphere",
                        n_rings=mc.n_rings)
    if isinstance(mc, (C.CylinderMesh, C.ConeMesh)):
        cyl = isinstance(mc, C.CylinderMesh)
        return MeshSpec(shape="cylinder" if cyl else "cone", length=mc.length,
                        diameter=mc.diameter if cyl else mc.max_diameter,
                        n_circumference_vertices=mc.n_circumference_vertices)
    if isinstance(mc, C.CapsuleMesh):
        return MeshSpec(shape="capsule", segment_length=mc.segment_length, diameter=mc.diameter,
                        n_circumference_vertices=mc.n_circumference_vertices)
    if isinstance(mc, C.RectangleMesh):
        return MeshSpec(shape="rectangle", extents=(mc.extent_x, mc.extent_z))
    path = mesh_files.get(int(mc.path_hash))  # TriangleMeshFile
    return None if path is None else MeshSpec(shape="file", path=str(path))


def lower_world(world, texture_sources: dict, sdf_generators: dict | None = None,
                mesh_files: dict | None = None) -> Scene:
    """Read ``world`` into a :class:`Scene` in the reference compile's order,
    stripping each lowered entity's setup components. ``texture_sources``:
    texture id → source (``runtime.setup.TEXTURE_SOURCES``);
    ``sdf_generators``: generator id → SDF graph, for GeneratedVoxelObject;
    ``mesh_files``: path hash → OBJ/PLY path
    (``runtime.setup.MESH_FILE_PATHS``), for TriangleMeshFile."""
    sdf_generators = sdf_generators or {}
    mesh_files = mesh_files or {}
    s = Scene()

    def get(eid, comp):
        return world.get_component(eid, comp) if world.has_component(eid, comp) else None

    def frame_of(eid):
        rf = get(eid, C.ReferenceFrame)
        if rf is None:
            return (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)
        return _t(rf.position), _t(rf.orientation)

    def motion_of(eid):
        mo = get(eid, C.Motion)
        if mo is None:
            return (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
        return _t(mo.linear_velocity), _t(mo.angular_velocity)

    entity_ref: dict[int, tuple] = {}  # entity id → ("voxel_object" | "rigid_body", index)

    # pass 1: voxel objects
    for eid in world.entities_with():
        shape = next((get(eid, ck) for ck in _VOXEL_SHAPES if world.has_component(eid, ck)),
                     None)
        if shape is None:
            continue
        graph = _voxel_graph(shape, sdf_generators)
        pos, ori = frame_of(eid)
        vel, ang = motion_of(eid)
        vt, gn = get(eid, C.SameVoxelType), get(eid, C.GradientNoiseVoxelTypes)
        nm, vc = get(eid, C.MultifractalNoiseSDFModification), get(eid, C.VoxelCollidable)
        fp, ca = get(eid, C.FracturingProperties), get(eid, C.ConstantAcceleration)
        flags = get(eid, C.SceneEntityFlags)
        s.voxel_objects.append(VoxelObjectSpec(
            position=pos, orientation=ori, voxel_extent=shape.voxel_extent, graph=graph,
            linear_velocity=vel, angular_velocity=ang,
            voxel_type=int(vt.voxel_type) if vt is not None else 0,
            voxel_types=None if vt is not None or gn is None else GradientNoiseTypesSpec(
                n_voxel_types=gn.n_voxel_types, voxel_types=_t(gn.voxel_types),
                noise_frequency=gn.noise_frequency,
                voxel_type_frequency=gn.voxel_type_frequency, seed=gn.seed),
            noise=None if nm is None else NoiseSpec(
                octaves=nm.octaves, frequency=nm.frequency, lacunarity=nm.lacunarity,
                persistence=nm.persistence, amplitude=nm.amplitude, seed=nm.seed),
            response=None if vc is None else _response(vc),
            dynamic=world.has_component(eid, C.DynamicVoxels),
            acceleration=None if ca is None else _t(ca.acceleration),
            fracture=None if fp is None else (fp.impulse_threshold, fp.fracture_radius),
            casts_shadows=flags is None or not (int(flags.flags) & 2), entity=eid))
        entity_ref[eid] = ("voxel_object", len(s.voxel_objects) - 1)
        world.strip_setup_components(eid)

    # pass 1.9: mesh-model entities, read before pass 2 strips them
    meshes = []
    for eid in world.entities_with():
        mc = next((get(eid, c) for c in _MESHES if world.has_component(eid, c)), None)
        if mc is None:
            continue
        spec = _mesh_spec(mc, mesh_files)
        if spec is None:
            continue
        mt = get(eid, C.ModelTransform)
        if mt is not None:
            spec.scale, spec.offset = mt.scale, _t(mt.offset)
        m = spec.material
        for comp, attr, fld in ((C.UniformColor, "color", "color"),
                                (C.UniformSpecularReflectance, "specular", "reflectance"),
                                (C.UniformRoughness, "roughness", "roughness"),
                                (C.UniformMetalness, "metalness", "metalness"),
                                (C.UniformEmissiveLuminance, "emissive", "luminance")):
            c = get(eid, comp)
            if c is not None:
                setattr(m, attr, _spec_value(getattr(c, fld)))
        c = get(eid, C.TexturedColor)
        if c is not None:
            m.color_texture = int(c.texture_id)
        for comp, attr in ((C.TexturedSpecularReflectance, "specular_texture"),
                           (C.TexturedRoughness, "roughness_texture"),
                           (C.TexturedMetalness, "metalness_texture"),
                           (C.TexturedEmissiveLuminance, "emissive_texture")):
            c = get(eid, comp)
            if c is not None:
                setattr(m, attr, (int(c.texture_id), c.scale_factor))
        c = get(eid, C.NormalMap)
        if c is not None:
            m.normal_map = int(c.texture_id)
        c = get(eid, C.ParallaxMap)
        if c is not None:
            m.parallax_map = (int(c.height_map_texture_id), c.displacement_scale)
        flags = get(eid, C.SceneEntityFlags)
        spec.casts_shadows = flags is None or not (int(flags.flags) & 2)
        pos, ori = frame_of(eid)
        meshes.append((eid, MeshEntity(spec, position=pos, orientation=ori)))

    # pass 2: regular bodies with their collidables, forces, drivers, absorbers
    for eid in world.entities_with():
        if eid in entity_ref:
            continue
        is_dynamic = (world.has_component(eid, C.DynamicRigidBodySubstance)
                      or world.has_component(eid, C.DynamicRigidBodyInertialProperties))
        if not (is_dynamic or any(world.has_component(eid, c) for c in _KINEMATIC + _BODY_PARTS)):
            continue
        pos, ori = frame_of(eid)
        vel, ang = motion_of(eid)
        rb = RigidBody(position=pos, orientation=ori, linear_velocity=vel, angular_velocity=ang)
        ip = get(eid, C.DynamicRigidBodyInertialProperties)
        sub = get(eid, C.DynamicRigidBodySubstance)
        if ip is not None:
            rb.inertia = Inertia(mass=ip.mass, center_of_mass=_t(ip.center_of_mass),
                                 inertia_tensor=_t(ip.inertia_tensor))
        elif sub is not None:
            rb.mass_density = sub.mass_density
        c = get(eid, C.SphericalCollidable)
        if c is not None:
            rb.sphere = SphereCollidableSpec(radius=c.radius, kind=c.kind, center=_t(c.center),
                                             response=_response(c))
        c = get(eid, C.PlanarCollidable)
        if c is not None:
            rb.plane = PlaneCollidableSpec(normal=_t(c.normal), displacement=c.displacement,
                                           kind=c.kind, response=_response(c))
        c = get(eid, C.CapsularCollidable)
        if c is not None:
            rb.capsule = CapsuleCollidableSpec(segment_start=_t(c.segment_start),
                                               segment_end=_t(c.segment_end), radius=c.radius,
                                               kind=c.kind, response=_response(c))
        c = get(eid, C.ConstantAcceleration)
        if c is not None:
            rb.acceleration = _t(c.acceleration)
        c = get(eid, C.LocalForce)
        if c is not None:
            rb.local_force = (_t(c.force), _t(c.point))
        rb.dynamic_gravity = world.has_component(eid, C.DynamicGravity)
        c = get(eid, C.DetailedDrag)
        if c is not None:
            rb.drag_coefficient = c.drag_coefficient
        for comp, spec_cls, fields in _DRIVERS:
            c = get(eid, comp)
            if c is not None:
                rb.drivers.append(spec_cls(**{k: _spec_value(getattr(c, v))
                                              for k, v in fields.items()}))
        c = get(eid, C.FixedDirectionAlignmentTorque)
        if c is not None:
            rb.alignment_torque = AlignmentTorqueSpec(axis=_t(c.axis), direction=_t(c.direction),
                                                      strength=c.strength, damping=c.damping)
        c = get(eid, C.VoxelAbsorbingSphere)
        if c is not None:
            rb.absorbing_sphere = AbsorbingSphere(offset=_t(c.offset), radius=c.radius,
                                                  rate=c.rate)
        c = get(eid, C.VoxelAbsorbingCapsule)
        if c is not None:
            rb.absorbing_capsule = AbsorbingCapsule(segment_start=_t(c.segment_start),
                                                    segment_end=_t(c.segment_end),
                                                    radius=c.radius, rate=c.rate)
        s.rigid_bodies.append(rb)
        entity_ref[eid] = ("rigid_body", len(s.rigid_bodies) - 1)
        world.strip_setup_components(eid)

    # pass 2.5: joints; 2.6: distance rules (both need the bodies resolved)
    for eid in world.entities_with(C.SphericalJoint):
        sj = world.get_component(eid, C.SphericalJoint)
        ea, eb = int(sj.entity_a), int(sj.entity_b)
        if ea in entity_ref and eb in entity_ref:
            s.joints.append(SphericalJointSpec(entity_ref[ea], entity_ref[eb],
                                               anchor_a=_t(sj.anchor_a), anchor_b=_t(sj.anchor_b)))
        world.strip_setup_components(eid)
    for eid in world.entities_with(C.DistanceTriggeredRules):
        dr = world.get_component(eid, C.DistanceTriggeredRules)
        anchor = int(dr.anchor_id)
        if eid in entity_ref and anchor in entity_ref:
            s.distance_rules.append(DistanceRule(
                entity_ref[eid], entity_ref[anchor],
                no_shadowing_dist_squared=dr.no_shadowing_dist_squared,
                removal_dist_squared=dr.removal_dist_squared))

    # pass 2.7: mesh entities take their bodies
    for eid, me in meshes:
        ref = entity_ref.get(eid)
        me.body = ref[1] if ref is not None and ref[0] == "rigid_body" else None
        s.mesh_entities.append(me)
        for tid in me.mesh.material.texture_ids():
            if tid in texture_sources:
                s.textures[tid] = texture_sources[tid]

    # pass 3: lights and the camera
    ambient = np.zeros(3, np.float32)
    for eid in world.entities_with(C.AmbientEmission):
        ambient += np.asarray(world.get_component(eid, C.AmbientEmission).illuminance)
    s.ambient_illuminance = _t(ambient)
    for comp, shadowable in ((C.OmnidirectionalEmission, False),
                             (C.ShadowableOmnidirectionalEmission, True)):
        for eid in world.entities_with(comp):
            e = world.get_component(eid, comp)
            s.omni_lights.append(OmniLight(position=frame_of(eid)[0],
                                           luminous_intensity=_t(e.luminous_intensity),
                                           source_extent=e.source_extent, shadowable=shadowable))
    for comp, shadowable in ((C.UnidirectionalEmission, False),
                             (C.ShadowableUnidirectionalEmission, True)):
        for eid in world.entities_with(comp):
            e = world.get_component(eid, comp)
            s.uni_lights.append(UniLight(direction=_t(e.direction),
                                         perpendicular_illuminance=_t(e.perpendicular_illuminance),
                                         angular_source_extent=e.angular_source_extent,
                                         shadowable=shadowable))
    # the perspective cameras, then the orthographic ones: the last one read
    # is the scene's, as in the reference
    for comp in (C.PerspectiveCamera, C.OrthographicCamera):
        for eid in world.entities_with(comp):
            c = world.get_component(eid, comp)
            pos, ori = frame_of(eid)
            s.camera = CameraSpec(position=pos, orientation=ori,
                                  vertical_fov=c.vertical_field_of_view, near=c.near_distance,
                                  far=c.far_distance,
                                  orthographic=comp is C.OrthographicCamera)
            world.strip_setup_components(eid)
    return s
