"""The reference snapshot tester's 13 test scenes as ECS worlds (port of
``impact_tpu/models/parity_scenes.py``; ref: apps/snapshot_tester/scripts/
Entities.roc and Scenes.roc for the arrangements and their constants,
src/testing.rs:20-108 for each scene's feature switches).

``PARITY_SCENES`` maps a name to (world builder, feature switches); the
harness ``apps/parity_snapshots.py`` renders them at 768x512.
"""

from __future__ import annotations

import math

import numpy as np

from ..ecs import World, components as C

GOLD = (1.000, 0.782, 0.344)  # ref: setup/physical.rs:350 UniformColor::GOLD


def _qmul(a, b):
    """Hamilton product a*b (apply b, then a) — glam convention (x,y,z,w)."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    )


def _axis_angle(axis, angle):
    s = math.sin(angle / 2)
    return (axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle / 2))


_Q_CAM = _axis_angle((0, 1, 0), math.pi)  # camera faces +z (Entities.roc)
_Q_TILTED = _qmul(_axis_angle((1, 0, 0), 0.5), _axis_angle((0, 1, 0), math.pi))


def _camera(w: World, tilted=False):
    w.create_entity(
        C.ReferenceFrame(position=(0.0, 0.0, 0.0),
                         orientation=_Q_TILTED if tilted else _Q_CAM),
        C.PerspectiveCamera(
            vertical_field_of_view=math.radians(50),
            near_distance=0.01, far_distance=1000.0,
        ),
    )


def _ambient_light(w):
    w.create_entity(C.AmbientEmission(illuminance=(3e3, 3e3, 3e3)))


def _omni_light(w, shadowable=False, extent=0.4, pos=(0.0, 0.0, 0.0),
                intensity=1e4):
    comp = (C.ShadowableOmnidirectionalEmission if shadowable
            else C.OmnidirectionalEmission)
    w.create_entity(
        C.ReferenceFrame(position=pos),
        comp(luminous_intensity=(intensity,) * 3, source_extent=extent),
    )


def _uni_light(w, shadowable=False, extent=10.0, direction=(0.0, 0.0, 1.0)):
    comp = (C.ShadowableUnidirectionalEmission if shadowable
            else C.UnidirectionalEmission)
    w.create_entity(
        comp(perpendicular_illuminance=(3e3, 3e3, 3e3),
             direction=direction, angular_source_extent=extent)
    )


def _diffuse(w, *comps):
    w.create_entity(*comps, C.UniformColor(color=(0.4, 0.8, 0.3)),
                    C.UniformRoughness(roughness=0.7))


def _plastic(w, *comps):
    w.create_entity(*comps, C.UniformColor(color=(0.3, 0.4, 0.8)),
                    C.UniformSpecularReflectance(reflectance=0.05),
                    C.UniformRoughness(roughness=0.3))


def _metallic(w, *comps):
    w.create_entity(*comps, C.UniformColor(color=GOLD),
                    C.UniformSpecularReflectance(reflectance=1.0),
                    C.UniformMetalness(metalness=1.0),
                    C.UniformRoughness(roughness=0.5))


def _model_grid(w: World):
    """The 2x3 material grid (Entities.roc "Mesh material grid")."""
    dist = 2.8
    voffset, hspacing, vspacing = 0.1, 0.05, 0.05
    box_scale, box_height = 0.75, -0.5
    sphere_rings, sphere_scale, sphere_height = 15, 0.5, 0.5
    by = box_height - vspacing + voffset
    sy = sphere_height + vspacing + voffset
    for x, mat in ((1 + hspacing, _diffuse), (0.0, _plastic),
                   (-1 - hspacing, _metallic)):
        mat(w, C.BoxMesh(), C.ModelTransform(scale=box_scale),
            C.ReferenceFrame(position=(x, by, dist)))
        mat(w, C.SphereMesh(n_rings=sphere_rings),
            C.ModelTransform(scale=sphere_scale),
            C.ReferenceFrame(position=(x, sy, dist)))


def _grid_scene(ambient=False, omni=None, uni=None):
    w = World()
    _camera(w)
    _model_grid(w)
    if ambient:
        _ambient_light(w)
    if omni is not None:
        _omni_light(w, shadowable=omni == "shadowable")
    if uni is not None:
        _uni_light(w, shadowable=uni == "shadowable")
    return w


def ambient_light():
    return _grid_scene(ambient=True)


def omnidirectional_light():
    return _grid_scene(omni="plain")


def unidirectional_light():
    return _grid_scene(uni="plain")


def shadowable_omnidirectional_light():
    return _grid_scene(omni="shadowable")


def shadowable_unidirectional_light():
    return _grid_scene(uni="shadowable")


def ambient_occlusion():
    w = World()
    _camera(w, tilted=True)
    gh, box_scale, hshift, sph_scale = -2.0, 1.0, 0.6, 0.6
    _metallic(w, C.RectangleMesh(), C.ModelTransform(scale=10.0),
              C.ReferenceFrame(position=(0.0, gh, 5.0)))
    _diffuse(w, C.BoxMesh(), C.ModelTransform(scale=box_scale),
             C.ReferenceFrame(position=(hshift, gh + box_scale / 2, 3.0),
                              orientation=_axis_angle((0, 1, 0), -0.1)))
    _plastic(w, C.SphereMesh(n_rings=15), C.ModelTransform(scale=sph_scale),
             C.ReferenceFrame(position=(
                 hshift - box_scale / 2 - sph_scale, gh + sph_scale, 2.8)))
    _ambient_light(w)
    return w


def bloom():
    w = World()
    _camera(w)
    qx = _axis_angle((1, 0, 0), -math.pi / 2)
    w.create_entity(
        C.RectangleMesh(),
        C.ReferenceFrame(position=(0.0, 0.0, 1.5), orientation=qx),
        C.UniformColor(color=(1.0, 1.0, 1.0)),
        C.UniformEmissiveLuminance(luminance=1e6),
    )
    w.create_entity(
        C.RectangleMesh(),
        C.ModelTransform(scale=0.5),
        C.ReferenceFrame(position=(0.0, 0.0, 1.4), orientation=qx),
        C.UniformColor(color=(0.0, 0.0, 0.0)),
    )
    return w


def _shadow_cube_mapping_models(w):
    scm_dist, gh = 4.5, -2.0
    sph, box = 0.4, 0.6
    _diffuse(w, C.RectangleMesh(), C.ModelTransform(scale=2 * scm_dist),
             C.ReferenceFrame(position=(0.0, gh, scm_dist)))
    _plastic(w, C.SphereMesh(n_rings=15), C.ModelTransform(scale=sph),
             C.ReferenceFrame(position=(-0.8, gh + sph, scm_dist - 1.5)))
    _plastic(w, C.CylinderMesh(length=1.5, diameter=0.2,
                               n_circumference_vertices=15),
             C.ReferenceFrame(position=(-0.4, gh, scm_dist + 0.6)))
    # Entities.roc:296 scales the box by *csm*_box_scale (0.8) while the
    # height offset uses scm_box_scale/2 (0.3) — the box sinks 0.1 into the
    # ground in the reference render; reproduce the quirk verbatim
    _plastic(w, C.BoxMesh(), C.ModelTransform(scale=0.8),
             C.ReferenceFrame(position=(0.8, gh + box / 2, scm_dist - 0.6)))


def shadow_cube_mapping(soft=False):
    w = World()
    _camera(w, tilted=True)
    _shadow_cube_mapping_models(w)
    _omni_light(w, shadowable=True, extent=0.2 if soft else 0.0,
                pos=(0.0, -2.0 + 1.8, 4.5))
    return w


def _cascaded_shadow_mapping_models(w):
    gh, sph, box = -2.0, 0.5, 0.8
    _diffuse(w, C.RectangleMesh(), C.ModelTransform(scale=20.0),
             C.ReferenceFrame(position=(0.0, gh, 10.0)))
    _plastic(w, C.SphereMesh(n_rings=15), C.ModelTransform(scale=sph),
             C.ReferenceFrame(position=(0.8, gh + sph, 4.0)))
    _plastic(w, C.CylinderMesh(length=1.5, diameter=0.2,
                               n_circumference_vertices=15),
             C.ReferenceFrame(position=(-1.0, gh, 2.0)))
    _plastic(w, C.BoxMesh(), C.ModelTransform(scale=box),
             C.ReferenceFrame(position=(0.0, gh + box / 2, 10.0)))


def cascaded_shadow_mapping(soft=False):
    w = World()
    _camera(w, tilted=True)  # Scenes.roc:103 uses tilted_camera
    _cascaded_shadow_mapping_models(w)
    d = np.asarray([0.0, -0.08, 1.0])
    d = tuple(d / np.linalg.norm(d))
    w.create_entity(
        C.ShadowableUnidirectionalEmission(
            perpendicular_illuminance=(3e3, 3e3, 3e3), direction=d,
            angular_source_extent=1.5 if soft else 0.0,
        )
    )
    return w


# name -> (world builder, feature config mutations)
PARITY_SCENES = {
    "AmbientLight": (ambient_light, {}),
    "OmnidirectionalLight": (omnidirectional_light, {}),
    "UnidirectionalLight": (unidirectional_light, {}),
    "ShadowableOmnidirectionalLight": (shadowable_omnidirectional_light, {}),
    "ShadowableUnidirectionalLight": (shadowable_unidirectional_light, {}),
    "ShadowCubeMapping": (
        lambda: shadow_cube_mapping(False), {"shadows": True}),
    "SoftShadowCubeMapping": (
        lambda: shadow_cube_mapping(True), {"shadows": True, "soft": True}),
    "CascadedShadowMapping": (
        lambda: cascaded_shadow_mapping(False), {"shadows": True, "csm": 4}),
    "SoftCascadedShadowMapping": (
        lambda: cascaded_shadow_mapping(True),
        {"shadows": True, "csm": 4, "soft": True}),
    "AmbientOcclusion": (ambient_occlusion, {"ao": True}),
    "Bloom": (bloom, {"bloom": True}),
    "ACESToneMapping": (omnidirectional_light, {"tone": "ACES"}),
    "KhronosPBRNeutralToneMapping": (
        omnidirectional_light, {"tone": "KhronosPBRNeutral"}),
}
