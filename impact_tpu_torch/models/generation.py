"""The generation world: procedural SDF objects beside every mesh primitive
kind, built as an ECS world through the reference's public API.

* a ground: a RectangleMesh with a PlanarCollidable;
* a VoxelSphereUnion at its defaults, dropped onto the ground;
* a GeneratedVoxelObject from the voxel generator's example graph
  (``apps/voxel_generator.py:example_graph``), a kinematic boulder, its
  voxel extent chosen so that its ``estimate_bounds`` fits inside the grid;
* a GeneratedVoxelObject from a meta graph lowered at seed 7
  (``sphere_surface_transforms(meta_boxes(extent=uniform(0.4, 1.2)),
  count=12, sphere_radius=5.0, jitter=0.2)``, as ``tests/test_voxel.py``
  builds it) with FracturingProperties, thrown down so that it fractures
  on landing, as the Voxel Range targets do;
* a HemisphereMesh, a CylinderMesh and a ConeMesh;
* an OBJ box of quads and a PLY pyramid that :func:`write_mesh_files`
  writes and ``register_mesh_file`` registers;
* a perspective camera (or, with ``orthographic``, an OrthographicCamera
  framing the same view), one shadowable omni light and one
  unidirectional light.

:func:`generation_world` returns the world and the ``sdf_generators`` to
compile it with. It takes the ECS classes and the mesh-file registry as
arguments, so that the reference package's API builds the same world.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

ROCK = "generation/rock"
CLUSTER = "generation/cluster"
CLUSTER_SEED = 7
EYE, TARGET = (2.0, 9.0, 27.0), (0.0, 2.5, 0.0)


def example_graph():
    """The voxel generator's example graph."""
    from ..apps.voxel_generator import example_graph as graph

    return graph()


def cluster_meta_graph():
    from ..voxel import meta_sdf

    return meta_sdf.sphere_surface_transforms(
        meta_sdf.meta_boxes(extent=meta_sdf.uniform(0.4, 1.2)), count=12, sphere_radius=5.0,
        jitter=0.2)


def fitting_extent(graph, grid_size: int) -> float:
    """The smallest voxel extent at which the graph's ``estimate_bounds``
    lies inside the centred grid with two voxels to spare (the SDF's
    clamp band)."""
    from ..voxel.sdf import estimate_bounds

    lo, hi = estimate_bounds(graph)
    reach = float(max(np.abs(lo).max(), np.abs(hi).max()))
    return float(np.float32(reach / (grid_size / 2 - 2)))


def write_mesh_files(directory):
    """An OBJ unit box of quads (normals computed on load) and an ASCII
    PLY square pyramid with a quad base → (obj path, ply path)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    obj, ply = d / "box.obj", d / "pyramid.ply"
    obj.write_text(
        "# a unit box of quads\n"
        "v -0.5 -0.5 -0.5\nv 0.5 -0.5 -0.5\nv 0.5 0.5 -0.5\nv -0.5 0.5 -0.5\n"
        "v -0.5 -0.5 0.5\nv 0.5 -0.5 0.5\nv 0.5 0.5 0.5\nv -0.5 0.5 0.5\n"
        "f 1 4 3 2\nf 5 6 7 8\nf 1 2 6 5\nf 2 3 7 6\nf 3 4 8 7\nf 4 1 5 8\n")
    ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 5\nproperty float x\nproperty float y\n"
        "property float z\nelement face 5\nproperty list uchar int vertex_indices\n"
        "end_header\n-1 0 -1\n1 0 -1\n1 0 1\n-1 0 1\n0 1.5 0\n"
        "4 0 1 2 3\n3 0 4 1\n3 1 4 2\n3 2 4 3\n3 3 4 0\n")
    return str(obj), str(ply)


def _port_ecs():
    from ..ecs import World
    from ..ecs import components as C
    from ..runtime.setup import register_mesh_file

    return World, C, register_mesh_file


def generation_world(mesh_dir, grid_size: int = 32, orthographic: bool = False, ecs=None):
    """(world, sdf_generators) of the generation world on grids of
    ``grid_size``³. ``ecs``: (World class, components module,
    register_mesh_file), the port's by default."""
    from ..render.camera import look_at
    from ..utils.hashing import hash_str_to_u32
    from ..voxel import meta_sdf

    World, C, register_mesh_file = ecs or _port_ecs()
    rock, cluster = example_graph(), meta_sdf.lower(cluster_meta_graph(), seed=CLUSTER_SEED)
    rock_id, cluster_id = hash_str_to_u32(ROCK), hash_str_to_u32(CLUSTER)
    gens = {rock_id: rock, cluster_id: cluster}
    obj, ply = write_mesh_files(mesh_dir)
    w = World()
    w.create_entity(C.AmbientEmission(illuminance=(1500.0, 1550.0, 1700.0)))
    w.create_entity(C.ReferenceFrame(position=(14.0, 30.0, 24.0)),
                    C.ShadowableOmnidirectionalEmission(luminous_intensity=(9e5, 8.6e5, 7.6e5),
                                                        source_extent=0.5))
    w.create_entity(C.UnidirectionalEmission(perpendicular_illuminance=(20000.0, 19000.0, 17000.0),
                                             direction=(-0.35, -0.8, -0.48),
                                             angular_source_extent=2.0))
    # the ground: a rectangle 2 cm above the planar collidable's render quad
    w.create_entity(C.ReferenceFrame(), C.RectangleMesh(extent_x=60.0, extent_z=60.0),
                    C.ModelTransform(offset=(0.0, 0.02, 0.0)),
                    C.UniformColor(color=(0.42, 0.45, 0.38)), C.UniformRoughness(roughness=0.9),
                    C.PlanarCollidable(kind=1, normal=(0.0, 1.0, 0.0), displacement=0.0,
                                       restitution=0.2, static_friction=0.8,
                                       dynamic_friction=0.6))
    w.create_entity(C.ReferenceFrame(position=(-7.0, 3.5, 2.0)), C.VoxelSphereUnion(),
                    C.SameVoxelType(voxel_type=1), C.DynamicVoxels(),
                    C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.7,
                                      dynamic_friction=0.5),
                    C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)))
    rock_extent = fitting_extent(rock, grid_size)
    w.create_entity(C.ReferenceFrame(position=(20.0, 8.8, -28.0)),
                    C.GeneratedVoxelObject(generator_id=rock_id, voxel_extent=rock_extent),
                    C.SameVoxelType(voxel_type=2),
                    C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.8,
                                      dynamic_friction=0.6))
    w.create_entity(C.ReferenceFrame(position=(2.0, 9.0, -1.0)),
                    C.Motion(linear_velocity=(0.0, -10.0, 0.0), angular_velocity=(0.4, 0.0, 0.3)),
                    C.GeneratedVoxelObject(generator_id=cluster_id,
                                           voxel_extent=fitting_extent(cluster, grid_size)),
                    C.SameVoxelType(voxel_type=0), C.DynamicVoxels(),
                    C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.8,
                                      dynamic_friction=0.6),
                    C.FracturingProperties(impulse_threshold=25.0, fracture_radius=2.2),
                    C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)))
    for pos, mesh, color, scale in (
            ((-12.0, 0.0, 8.0), C.HemisphereMesh(n_rings=8), (0.8, 0.3, 0.25), 2.0),
            ((-7.0, 0.0, 10.0), C.CylinderMesh(length=3.0, diameter=1.6,
                                               n_circumference_vertices=20), (0.3, 0.5, 0.8), 1.0),
            ((-2.0, 0.0, 11.0), C.ConeMesh(length=2.6, max_diameter=2.0,
                                           n_circumference_vertices=20), (0.9, 0.75, 0.2), 1.0),
            ((4.0, 1.0, 10.0), C.TriangleMeshFile(path_hash=register_mesh_file(obj)),
             (0.55, 0.55, 0.6), 2.0),
            ((9.0, 0.0, 9.0), C.TriangleMeshFile(path_hash=register_mesh_file(ply)),
             (0.35, 0.7, 0.4), 1.5)):
        w.create_entity(C.ReferenceFrame(position=pos), mesh, C.ModelTransform(scale=scale),
                        C.UniformColor(color=color), C.UniformRoughness(roughness=0.6))
    orientation = tuple(float(x) for x in look_at(EYE, TARGET).cpu().numpy())
    if orthographic:
        # the half-height far·tan(fov/2) covers the perspective view's at the target
        far = 120.0
        half = 0.5 * math.dist(EYE, TARGET) * math.tan(math.pi / 6) * 2.0
        cam = C.OrthographicCamera(vertical_field_of_view=2.0 * math.atan(half / far),
                                   near_distance=0.1, far_distance=far)
    else:
        cam = C.PerspectiveCamera(vertical_field_of_view=math.pi / 3, near_distance=0.1,
                                  far_distance=500.0)
    w.create_entity(C.ReferenceFrame(position=EYE, orientation=orientation), cam)
    return w, gens
