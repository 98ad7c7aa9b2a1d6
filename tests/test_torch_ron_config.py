"""The port's RON parser, engine config loader and voxel-type registry
loader against impact_tpu's on the CPU.

* The RON texts of ``tests/test_utils.py:12-43`` (and a few more) parse to
  equal values in both packages (variants compared by name, positional and
  named payload).
* One RON config text with every section the port reads, plus sections and
  keys it does not know, loads to equal values on every field both
  ``EngineConfig``s have; missing keys keep their defaults.
* The tone mapping and the sensor sensitivity in their RON forms (a
  ``Variant``; RON's ``None``) and in their plain forms (a string; a dict)
  give the same ``RenderConfig``, which equals the reference's on every
  field both have (the raster backend is named the port's way).
* ``registry_from_ron_file`` gives registries equal to the reference's.

Equal is exact: the values are parsed, not computed.
"""

import dataclasses

import numpy as np
import pytest

from impact_tpu.runtime.setup import render_config_from_engine_config as jrender_config
from impact_tpu.scene import materials as jmaterials
from impact_tpu.utils import ron as jron
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch.runtime.setup import RASTER_BACKENDS, render_config_from_engine_config
from impact_tpu_torch.scene import materials as tmaterials
from impact_tpu_torch.utils import ron
from impact_tpu_torch.utils.config import EngineConfig


def plain(v):
    """A parsed RON value with the variants of either package as tuples."""
    if isinstance(v, (ron.Variant, jron.Variant)):
        return ("Variant", v.name, plain(v.args), plain(v.fields))
    if isinstance(v, dict):
        return {plain(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(plain(x) for x in v)
    return v


RON_TEXTS = [
    "42", "-1.5e3", "true", '"hi\\n"', "None", "Some(3)", "0x1F", "1_000",
    "(a: 1, b: (2.0, 3.0), c: [1, 2],)",
    "SemiDirectional((movement_speed: 8.0))", "ACES",
    "( a: 1, // comment\n b: 2, /* block /* nested */ */ )",
    "(sensitivity: Auto(ev_compensation: 0.0))",
    "{\"k\": [Some(1.5), None], 'x': Manual(iso: 100)}",
    "Named(x: 1, y: Unit, z: ())",
]


@pytest.mark.parametrize("text", RON_TEXTS)
def test_ron_values_equal_the_reference(text):
    assert plain(ron.loads(text)) == plain(jron.loads(text))


@pytest.mark.parametrize("text", ["(a: 1", "(a: 1) x", "[1, 2", "(a 1)"])
def test_malformed_ron_raises_with_an_offset(text):
    with pytest.raises(jron.RonError):
        jron.loads(text)
    with pytest.raises(ron.RonError, match="offset|unterminated"):
        ron.loads(text)


CONFIG_RON = """
// every section the port reads, and some it does not
(
    resources: (resource_file_path: Some("assets/resources.ron")),
    rendering: (
        basic: (wireframe_mode_on: false),
        shadow_mapping: (
            enabled: true,
            omnidirectional_light_shadow_map_resolution: 256,
            unidirectional_light_shadow_map_resolution: 512,
        ),
        ambient_occlusion: (enabled: false, sample_count: 8, sample_radius: 0.5,
                            intensity: 3.0, contrast: 0.5),
        temporal_anti_aliasing: (enabled: true, current_frame_weight: 0.2,
                                 variance_clipping_threshold: 1.5),
        capturing_camera: (
            settings: (relative_aperture: 2.8, shutter_duration: 0.01,
                       sensitivity: Auto(ev_compensation: -1.0),
                       exposure_bounds: (lower: 1e-5, upper: 1e-1)),
            average_luminance_computation: (
                luminance_bounds: (lower: 10.0, upper: 1e6),
                current_frame_weight: 0.05, fetch_histogram: true),
            bloom: (enabled: false, n_downsamplings: 3, blur_filter_radius: 0.01,
                    blurred_luminance_weight: 0.06),
            dynamic_range_compression: (tone_mapping_method: KhronosPBRNeutral),
        ),
    ),
    physics: (
        simulator: (enabled: true, n_substeps: 2, initial_time_step_duration: 0.005,
                    match_frame_duration: false),
        rigid_body_force: (drag_load_map_config: (n_direction_samples: 100,
                           n_theta_coords: 32, save_generated_maps: false,
                           use_saved_maps: false, directory: "maps")),
        constraint_solver: (enabled: true, n_iterations: 6, old_impulse_weight: 0.3,
                            n_positional_correction_iterations: 2,
                            positional_correction_factor: 0.25),
        medium: (mass_density: 1.2, velocity: (1.0, 0.0, -2.0)),
    ),
    voxel: (
        types: (texture_resolution: 128),
        interaction: (fracturing: (impact: (boundary_polar_grid_size: 4,
            boundary_azimuthal_grid_size: 5, boundary_angular_jitter: 0.7,
            boundary_radial_jitter: 0.3, max_fragment_count: 64,
            radial_falloff_power: 1.5, angular_falloff_power: 0.25, seed: 3),
            min_relative_fragment_mass: 1e-2)),
    ),
    controller: (motion: SemiDirectional((movement_speed: 8.0)),
                 orientation: RollFreeCamera(())),
    input: (mouse_sensitivity: 2.0),
    user_interface: (initially_interactive: false),
    screen_capture: (output_dir: None),
    not_a_section: (x: 1),
    tpu: (max_voxel_objects: 8, max_bodies: 24, max_contacts: 256, voxel_grid_size: 16,
          render_width: 64, render_height: 48, solver_mode: "jacobi", csm_cascades: 2,
          sdf_encoding: "i8", textured_voxels: true, soft_shadows: true,
          max_fracture_fragments: 16, raster_backend: "xla", steps_per_dispatch: 1,
          unknown_tpu_key: 5),
)
"""


def shared_fields(got, ref, path=""):
    """(path, port value, reference value) of every leaf field both
    dataclass trees have."""
    for f in dataclasses.fields(ref):
        if not hasattr(got, f.name):
            continue
        g, r = getattr(got, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(r):
            yield from shared_fields(g, r, f"{path}{f.name}.")
        else:
            yield f"{path}{f.name}", g, r


def test_config_from_ron_equals_the_reference():
    got, ref = EngineConfig.from_ron_str(CONFIG_RON), JConfig.from_ron_str(CONFIG_RON)
    fields = list(shared_fields(got, ref))
    assert len(fields) >= 80
    for path, g, r in fields:
        assert plain(g) == plain(r), path
    assert got.tpu.max_voxel_objects == 8 and got.physics.medium.velocity == (1.0, 0.0, -2.0)
    # a key the text leaves out keeps its default
    assert got.tpu.mesh_merge_levels == EngineConfig().tpu.mesh_merge_levels == 2


def test_config_from_ron_file_and_defaults(tmp_path):
    path = tmp_path / "engine_config.ron"
    path.write_text("(tpu: (max_voxel_objects: 8, max_bodies: 24))")
    got = EngineConfig.from_ron_file(path)
    want = EngineConfig()
    want.tpu.max_voxel_objects, want.tpu.max_bodies = 8, 24
    assert got == want
    assert EngineConfig.from_ron_str("(not_a_section: (x: 1))") == EngineConfig()
    for path_, g, r in shared_fields(EngineConfig(), JConfig()):
        if path_ == "tpu.raster_backend":  # "kernel" is what the reference's "auto" names
            assert RASTER_BACKENDS.get(r) == g == "kernel"
        else:
            assert plain(g) == plain(r), path_


def render_fields(got, ref):
    return {f: (getattr(got, f), getattr(ref, f)) for f in got._fields if f in ref._fields}


@pytest.mark.parametrize("tone, plain_tone", [("ACES", "ACES"), ("None", "None"),
                                              ("KhronosPBRNeutral", "KhronosPBRNeutral")])
@pytest.mark.parametrize("sens, plain_sens", [
    ("None", None), ("Auto(ev_compensation: 1.5)", {"ev_compensation": 1.5}),
    ("Manual(iso: 400.0)", {"iso": 400.0})])
def test_variant_and_plain_forms_give_the_same_render_config(tone, plain_tone, sens,
                                                             plain_sens):
    text = (f"(rendering: (capturing_camera: (settings: (sensitivity: {sens}), "
            f"dynamic_range_compression: (tone_mapping_method: {tone}))))")
    from_ron = EngineConfig.from_ron_str(text)
    by_hand = EngineConfig()
    by_hand.rendering.capturing_camera.settings.sensitivity = plain_sens
    by_hand.rendering.capturing_camera.dynamic_range_compression.tone_mapping_method = plain_tone
    rc = render_config_from_engine_config(from_ron)
    assert rc == render_config_from_engine_config(by_hand)
    assert rc.tone_mapping == plain_tone
    assert rc.exposure_iso == (400.0 if "iso" in sens else None)
    assert rc.exposure_ev_compensation == (1.5 if "ev_" in sens else 0.0)
    for f, (g, r) in render_fields(rc, jrender_config(JConfig.from_ron_str(text))).items():
        if f != "raster_backend":
            assert g == r, f


def test_reference_raster_backends_name_the_ports():
    for ref_name, port_name in (("auto", "kernel"), ("pallas", "kernel"), ("xla", "raster"),
                                ("kernel", "kernel"), ("raster", "raster")):
        cfg = EngineConfig.from_ron_str(f'(tpu: (raster_backend: "{ref_name}"))')
        assert render_config_from_engine_config(cfg).raster_backend == port_name


VOXEL_TYPES_RON = """
(voxel_types: [
    VoxelTypeSpecification(name: "Granite", mass_density: 2700.0, color: (0.5, 0.45, 0.4),
                           roughness: 0.9),
    (name: "Gold", mass_density: 19300.0, color: (1.0, 0.78, 0.34), metalness: 1.0,
     roughness: 0.3, specular_reflectance: 0.9),
    (name: "Lava", emissive_luminance: 5000.0, color: (1.0, 0.3, 0.05)),
])
"""


@pytest.mark.parametrize("wrapped", [True, False], ids=["struct", "list"])
def test_registry_from_ron_file_equals_the_reference(tmp_path, wrapped):
    text = VOXEL_TYPES_RON if wrapped else VOXEL_TYPES_RON.strip()[len("(voxel_types:"):-1]
    path = tmp_path / "voxel_types.ron"
    path.write_text(text)
    got = tmaterials.registry_from_ron_file(path, device="cpu")
    ref = jmaterials.registry_from_ron_file(path)
    assert got.n_types == ref.n_types == 3 and got.names == ref.names
    for f in ("mass_density", "color", "specular_reflectance", "roughness", "metalness",
              "emissive_luminance"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(tmaterials.material_corner_table(got).numpy(),
                                  np.asarray(jmaterials.material_corner_table(ref)))
