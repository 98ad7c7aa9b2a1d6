"""Engine configuration: the port's copy of the ``impact_tpu/utils/config.py``
fields the render, the engine step and the runtime read, with the same
names and defaults (ref: engine.rs:86-99 sub-configs: resources, rendering, physics,
voxel, controller, game loop, input, screen capture, user interface; ``tpu``
holds the static capacities). ``EngineConfig.from_ron_file`` and
``from_ron_str`` read the reference's RON config files with serde-default
semantics, as the reference package does (ref: engine/src/engine.rs:573-592):
missing keys take their defaults and unknown keys are ignored, so that
``dataclasses.asdict`` of a config equals the reference's for the same text.
Sections the port does not act on (controller, game loop, input, resources,
screen capture, user interface) are read and carried.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

from . import ron


@dataclass
class BasicRenderingConfig:
    enabled: bool = True
    wireframe_mode_on: bool = False
    timings_enabled: bool = False


@dataclass
class ShadowMappingConfig:
    enabled: bool = True
    omnidirectional_light_shadow_map_resolution: int = 1024
    unidirectional_light_shadow_map_resolution: int = 1024


@dataclass
class AmbientOcclusionConfig:
    enabled: bool = True
    sample_count: int = 4
    sample_radius: float = 1.0
    intensity: float = 2.0
    contrast: float = 0.75


@dataclass
class TemporalAntiAliasingConfig:
    enabled: bool = True
    current_frame_weight: float = 0.1
    variance_clipping_threshold: float = 1.0


@dataclass
class ExposureBounds:
    lower: float = 1e-6
    upper: float = 1e-2


@dataclass
class CameraSettings:
    relative_aperture: float = 4.0
    shutter_duration: float = 0.005
    # None = auto at 0 EV; RON gives ``Auto(ev_compensation: x)`` or
    # ``Manual(iso: x)`` as a ron.Variant, and {"ev_compensation": x} or
    # {"iso": x} are the same settings as plain dicts
    sensitivity: Any = None
    exposure_bounds: ExposureBounds = field(default_factory=ExposureBounds)


@dataclass
class LuminanceBounds:
    lower: float = 100.0
    upper: float = 1e7


@dataclass
class AverageLuminanceConfig:
    luminance_bounds: LuminanceBounds = field(default_factory=LuminanceBounds)
    current_frame_weight: float = 0.02
    fetch_histogram: bool = False


@dataclass
class BloomConfig:
    enabled: bool = True
    n_downsamplings: int = 4
    blur_filter_radius: float = 0.005
    blurred_luminance_weight: float = 0.04


@dataclass
class DynamicRangeCompressionConfig:
    # "None" | "ACES" | "KhronosPBRNeutral"; RON gives a ron.Variant, and its
    # ``None`` (Python None) is the None method
    tone_mapping_method: Any = "ACES"


@dataclass
class CapturingCameraConfig:
    settings: CameraSettings = field(default_factory=CameraSettings)
    average_luminance_computation: AverageLuminanceConfig = field(
        default_factory=AverageLuminanceConfig)
    bloom: BloomConfig = field(default_factory=BloomConfig)
    dynamic_range_compression: DynamicRangeCompressionConfig = field(
        default_factory=DynamicRangeCompressionConfig)


@dataclass
class RenderingConfig:
    basic: BasicRenderingConfig = field(default_factory=BasicRenderingConfig)
    shadow_mapping: ShadowMappingConfig = field(default_factory=ShadowMappingConfig)
    ambient_occlusion: AmbientOcclusionConfig = field(default_factory=AmbientOcclusionConfig)
    temporal_anti_aliasing: TemporalAntiAliasingConfig = field(
        default_factory=TemporalAntiAliasingConfig)
    capturing_camera: CapturingCameraConfig = field(default_factory=CapturingCameraConfig)


@dataclass
class SimulatorConfig:
    enabled: bool = True
    n_substeps: int = 1
    initial_time_step_duration: float = 0.01667
    match_frame_duration: bool = False
    max_auto_time_step_duration: Optional[float] = None
    simulation_speed_multiplier_increment_factor: float = 1.1


@dataclass
class ConstraintSolverConfig:
    enabled: bool = True
    n_iterations: int = 8
    old_impulse_weight: float = 0.4
    n_positional_correction_iterations: int = 3
    positional_correction_factor: float = 0.2


@dataclass
class MediumConfig:
    mass_density: float = 0.0
    velocity: tuple = (0.0, 0.0, 0.0)


@dataclass
class DragLoadMapConfig:
    """Drag-load map tables and their disk cache (``physics/drag_map.py``);
    ``directory`` None builds the tables without the cache."""

    n_direction_samples: int = 5000
    n_theta_coords: int = 64
    smoothness: float = 2.0
    save_generated_maps: bool = True
    overwrite_existing_map_files: bool = False
    use_saved_maps: bool = True
    directory: str | None = "resources/drag_load_maps"


@dataclass
class RigidBodyForceConfig:
    drag_load_map_config: DragLoadMapConfig = field(default_factory=DragLoadMapConfig)


@dataclass
class PhysicsConfig:
    simulator: SimulatorConfig = field(default_factory=SimulatorConfig)
    rigid_body_force: RigidBodyForceConfig = field(default_factory=RigidBodyForceConfig)
    constraint_solver: ConstraintSolverConfig = field(default_factory=ConstraintSolverConfig)
    medium: MediumConfig = field(default_factory=MediumConfig)


@dataclass
class FracturingImpactConfig:
    boundary_polar_grid_size: int = 3
    boundary_azimuthal_grid_size: int = 6
    boundary_angular_jitter: float = 0.8
    boundary_radial_jitter: float = 0.2
    max_fragment_count: int = 512
    radial_falloff_power: float = 2.0
    angular_falloff_power: float = 0.5
    radial_grid_size: int = 128
    angular_grid_size: int = 128
    max_position_rejections_per_sample: int = 128
    seed: int = 0


@dataclass
class FracturingConfig:
    impact: FracturingImpactConfig = field(default_factory=FracturingImpactConfig)
    min_relative_fragment_mass: float = 1e-3


@dataclass
class VoxelInteractionConfig:
    fracturing: FracturingConfig = field(default_factory=FracturingConfig)


@dataclass
class VoxelTypesConfig:
    texture_resolution: int = 256
    voxel_types_path: Optional[str] = None


@dataclass
class VoxelConfig:
    types: VoxelTypesConfig = field(default_factory=VoxelTypesConfig)
    interaction: VoxelInteractionConfig = field(default_factory=VoxelInteractionConfig)


@dataclass
class GameLoopConfig:
    max_fps: Optional[float] = None
    max_iterations: Optional[int] = None


@dataclass
class InputConfig:
    mouse_sensitivity: float = 1.0


@dataclass
class ResourcesConfig:
    resource_file_path: Optional[str] = None
    lookup_table_dir: Optional[str] = None


@dataclass
class ControllerConfig:
    motion: Any = None  # a ron.Variant, SemiDirectional((movement_speed, vertical_control))
    orientation: Any = None  # a ron.Variant, RollFreeCamera(())


@dataclass
class ScreenCaptureConfig:
    output_dir: Optional[str] = None
    tagging: Any = "Timestamp"


@dataclass
class UserInterfaceConfig:
    initially_interactive: bool = True


@dataclass
class TpuConfig:
    """Static capacities and render switches (names kept from the reference)."""

    max_entities: int = 1024
    max_bodies: int = 1024
    max_contacts: int = 4096
    max_voxel_objects: int = 64
    voxel_grid_size: int = 32
    max_lights: int = 8
    render_width: int = 256
    render_height: int = 192
    solver_mode: str = "scan"  # "scan" (Gauss-Seidel parity) | "jacobi" (scale)
    csm_cascades: int = 1
    max_render_triangles: int = 65536
    mesh_vert_cap: int = 0  # 0 = auto: min(4096, (G-1)³)
    mesh_tri_cap: int = 0  # 0 = auto: min(8192, 6·(G-1)³)
    mesh_merge_levels: int = 2
    render_tris_per_object: int = 0
    textured_voxels: bool = False  # triplanar voxel-type texture arrays
    texture_resolution: int = 64  # procedural texture-array base size
    # absorption runs dense only on the ≤cap objects whose bounding spheres
    # overlap an absorber; in chunked mode the carve visits only the ≤budget
    # (object, chunk) 16³ windows that overlap one (the rest defer a step)
    absorption_gate_cap: int = 8
    absorption_chunk_budget: int = 32
    max_fracture_fragments: int = 128
    max_fracture_events: int = 2
    # chunk-gated meshing: surface meshes live in a shared pool of chunk
    # submesh slots, up to chunk_remesh_budget dirty chunks re-meshed a step
    chunked_remesh: bool | None = None  # None = on for G ≥ 64 (resolved by compile_scene)
    chunk_submesh_slots: int = 0  # 0 = auto (min(O·C, 1024))
    chunk_tri_cap: int = 1024  # triangle slots per chunk submesh
    chunk_vert_cap: int = 1024  # vertex budget per chunk compaction
    chunk_remesh_budget: int = 16  # dirty chunks re-meshed per step
    max_split_objects: int = 4
    max_split_regions: int = 3
    soft_shadows: bool = False  # PCSS-style soft shadows from light extents
    procedural_sky: bool = False
    sdf_encoding: str = "f32"  # "f32" | "i8"
    orthographic_camera: bool = False
    bf16_shading: bool = False  # BRDF math in bfloat16
    sky_luminance: tuple = (3000.0, 4500.0, 9000.0)
    # the reference's lax.scan step batching; the port steps once per call
    # and only carries the field
    steps_per_dispatch: int = 8
    # "kernel" (K1) | "raster" (the plain tile raster); the reference's names
    # read as the port's: "auto" and "pallas" are K1, "xla" the plain raster
    raster_backend: str = "kernel"
    view_culling: bool = True
    # renderable mesh-model entities (sphere meshes of BallPit's balls)
    max_mesh_entities: int = 16
    max_mesh_entity_verts: int = 1024  # vertex capacity per mesh entity
    max_mesh_entity_tris: int = 2048


@dataclass
class EngineConfig:
    resources: ResourcesConfig = field(default_factory=ResourcesConfig)
    rendering: RenderingConfig = field(default_factory=RenderingConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    voxel: VoxelConfig = field(default_factory=VoxelConfig)
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    game_loop: GameLoopConfig = field(default_factory=GameLoopConfig)
    input: InputConfig = field(default_factory=InputConfig)
    screen_capture: ScreenCaptureConfig = field(default_factory=ScreenCaptureConfig)
    user_interface: UserInterfaceConfig = field(default_factory=UserInterfaceConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    @staticmethod
    def from_ron_file(path) -> "EngineConfig":
        return EngineConfig.from_obj(ron.load(path))

    @staticmethod
    def from_ron_str(text: str) -> "EngineConfig":
        return EngineConfig.from_obj(ron.loads(text))

    @staticmethod
    def from_obj(obj: Any) -> "EngineConfig":
        return _build(EngineConfig, obj)


def _build(cls, obj):
    """Construct dataclass ``cls`` from parsed RON, serde-default style:
    missing keys take defaults, unknown keys are ignored, a struct variant
    builds from its fields and any other variant is kept as it is."""
    if obj is None:
        return cls()
    if isinstance(obj, ron.Variant):
        if obj.fields is None:
            return obj
        obj = obj.fields
    if not isinstance(obj, dict):
        return obj
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in obj:
            continue
        v = obj[f.name]
        ftype = globals().get(f.type) if isinstance(f.type, str) else f.type
        if dataclasses.is_dataclass(ftype) and isinstance(v, (dict, ron.Variant)):
            kwargs[f.name] = _build(ftype, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
