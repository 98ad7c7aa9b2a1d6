"""Voxel-type registry and the packed material table (port of
``impact_tpu/scene/materials.py``; ref: impact_voxel voxel_types.rs:32-51 and
impact_material's metalness workflow)."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..utils import ron


class VoxelTypeRegistry(NamedTuple):
    n_types: int
    mass_density: torch.Tensor  # f32[T]
    color: torch.Tensor  # f32[T,3] linear RGB
    specular_reflectance: torch.Tensor  # f32[T]
    roughness: torch.Tensor  # f32[T]
    metalness: torch.Tensor  # f32[T]
    emissive_luminance: torch.Tensor  # f32[T]
    names: tuple


def make_voxel_type_registry(specs: Sequence[dict], device="cuda") -> VoxelTypeRegistry:
    def col(key, default):
        return torch.tensor([s.get(key, default) for s in specs],
                            dtype=torch.float32, device=device)

    colors = torch.tensor([tuple(s.get("color", (0.5, 0.5, 0.5))) for s in specs],
                          dtype=torch.float32, device=device)
    return VoxelTypeRegistry(
        n_types=len(specs),
        mass_density=col("mass_density", 1000.0),
        color=colors,
        specular_reflectance=col("specular_reflectance", 0.04),
        roughness=col("roughness", 0.8),
        metalness=col("metalness", 0.0),
        emissive_luminance=col("emissive_luminance", 0.0),
        names=tuple(s.get("name", f"type{i}") for i, s in enumerate(specs)),
    )


def registry_from_ron_file(path, device="cuda") -> VoxelTypeRegistry:
    """Load the reference's voxel-types RON format (ref: voxel_types.rs
    VoxelTypeSpecification list): a list of specs, or a struct holding one
    under ``voxel_types``."""
    data = ron.load(path)
    if isinstance(data, dict) and "voxel_types" in data:
        data = data["voxel_types"]
    specs = []
    for entry in data:
        if isinstance(entry, ron.Variant):
            entry = entry.fields or {}
        specs.append(dict(entry))
    return make_voxel_type_registry(specs, device=device)


def registry_to(registry: VoxelTypeRegistry, device) -> VoxelTypeRegistry:
    """The registry with its tensors on ``device``."""
    return registry._replace(**{k: v.to(device) for k, v in registry._asdict().items()
                                if isinstance(v, torch.Tensor)})


def default_registry(device="cuda") -> VoxelTypeRegistry:
    return make_voxel_type_registry(
        [
            {"name": "Rock", "mass_density": 2500.0, "color": (0.45, 0.38, 0.32),
             "roughness": 0.85},
            {"name": "Metal", "mass_density": 7800.0, "color": (0.7, 0.7, 0.72),
             "metalness": 1.0, "roughness": 0.4},
            {"name": "Ice", "mass_density": 900.0, "color": (0.7, 0.85, 0.95),
             "roughness": 0.2, "specular_reflectance": 0.08},
        ],
        device=device,
    )


def material_corner_table(registry: VoxelTypeRegistry) -> torch.Tensor:
    """Per-type rows f32[T,10] = (albedo 3, f0 3, roughness 1, emissive 3)."""
    metal = registry.metalness[:, None]
    spec = registry.specular_reflectance[:, None]
    albedo = registry.color * (1.0 - metal)
    f0 = spec * (1.0 - metal) + registry.color * metal
    emissive = registry.color * registry.emissive_luminance[:, None]
    return torch.cat([albedo, f0, registry.roughness[:, None], emissive], dim=-1)


def material_params_for_types(registry: VoxelTypeRegistry, vtypes):
    """Voxel types [...] → (albedo [...,3], f0 [...,3], roughness [...],
    emissive [...,3]) in the metalness workflow of the reference's shading
    templates; types clamp to the registry."""
    t = torch.clamp(vtypes, 0, registry.n_types - 1).long()
    color = registry.color[t]
    metal = registry.metalness[t][..., None]
    spec = registry.specular_reflectance[t][..., None]
    albedo = color * (1.0 - metal)
    f0 = spec * (1.0 - metal) + color * metal
    emissive = color * registry.emissive_luminance[t][..., None]
    return albedo, f0, registry.roughness[t], emissive
