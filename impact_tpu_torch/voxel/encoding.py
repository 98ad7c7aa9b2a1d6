"""Compact i8 signed-distance encoding (port of ``impact_tpu/voxel/encoding.py``;
ref: impact_voxel lib.rs:60-73,140-170 ``VoxelSignedDistance`` — step 0.02
voxel extents per code)."""

from __future__ import annotations

import torch

QUANTIZATION_STEP_SIZE = 0.02
MAX_CODE = 127
VOID_LIMIT = 100  # codes ≥ this are void (2.0 / 0.02)
MIN_CODE = -128


def sdf_scale(voxel_extent):
    return voxel_extent * QUANTIZATION_STEP_SIZE


def encode_sdf_i8(sdf_world, voxel_extent):
    """f32 world-unit SDF → i8 codes (round half to even, saturate)."""
    scale = torch.as_tensor(sdf_scale(voxel_extent), dtype=torch.float32,
                            device=sdf_world.device)
    q = torch.round(sdf_world / scale)
    return torch.clamp(q, MIN_CODE, MAX_CODE).to(torch.int8)


def decode_sdf_i8(codes, voxel_extent):
    scale = torch.as_tensor(sdf_scale(voxel_extent), dtype=torch.float32,
                            device=codes.device)
    return codes.to(torch.float32) * scale


def sdf_world(pool_sdf, voxel_extent):
    """Pool SDF (f32 world units or i8 codes) → f32 world units;
    ``voxel_extent`` broadcasts per object ([O] against [O,G,G,G])."""
    if not is_encoded(pool_sdf):
        return pool_sdf
    scale = sdf_scale(torch.as_tensor(voxel_extent, dtype=torch.float32,
                                      device=pool_sdf.device))
    if scale.ndim == 1 and pool_sdf.ndim == 4:
        scale = scale[:, None, None, None]
    return pool_sdf.to(torch.float32) * scale


def is_encoded(sdf) -> bool:
    return sdf.dtype == torch.int8


def far_value(pool_sdf_dtype, voxel_extent):
    """The 'definitely empty' SDF value in the pool's storage units."""
    if pool_sdf_dtype == torch.int8:
        return MAX_CODE
    return 2.0 * voxel_extent
