"""Camera: view transforms, projection, TAA jitter.

Port of ``impact_tpu/render/camera.py`` (ref: impact_camera
gpu_resource.rs:24-76 — perspective projection with a 32-entry Halton jitter
sequence for temporal anti-aliasing).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.projection import (
    orthographic_projection_matrix,
    perspective_projection_matrix,
)
from ..math import quaternion as quat
from ..math.random import taa_jitter_offsets


class Camera(NamedTuple):
    position: torch.Tensor  # f32[3]
    orientation: torch.Tensor  # f32[4] camera-to-world rotation
    vertical_fov: torch.Tensor  # f32 radians
    near: torch.Tensor
    far: torch.Tensor


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Camera at ``eye`` looking at ``target`` (camera looks down −z)."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=eye.device)
    up = torch.as_tensor(up, dtype=torch.float32, device=eye.device)
    fwd = target - eye
    fwd = fwd / torch.clamp(torch.linalg.vector_norm(fwd), min=1e-9)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.clamp(torch.linalg.vector_norm(right), min=1e-9)
    true_up = torch.linalg.cross(right, fwd)
    m = torch.stack([right, true_up, -fwd], dim=-1)
    return quat.from_rotation_matrix(m)


def view_matrix(cam: Camera):
    """World → view 4x4 (inverse of the camera's rigid transform)."""
    r = quat.to_rotation_matrix(quat.conjugate(cam.orientation))
    t = -r @ cam.position
    m = torch.zeros((4, 4), dtype=torch.float32, device=r.device)
    m[:3, :3] = r
    m[:3, 3] = t
    m[3, 3] = 1.0
    return m


def projection_matrix(cam: Camera, width: int, height: int, jitter_index=None,
                      orthographic: bool = False):
    """Projection for the camera; ``jitter_index`` (an int) offsets it by the
    Halton TAA jitter, one pixel = 2/size in NDC."""
    dev = cam.position.device
    if orthographic:
        half_h = cam.far * torch.tan(0.5 * cam.vertical_fov)
        half_w = half_h * (width / height)
        proj = orthographic_projection_matrix(
            -half_w, half_w, -half_h, half_h, cam.near, cam.far, device=dev
        )
        col = 3
    else:
        proj = perspective_projection_matrix(
            width / height, cam.vertical_fov, cam.near, cam.far, device=dev
        )
        col = 2
    if jitter_index is not None:
        j = taa_jitter_offsets[int(jitter_index) % taa_jitter_offsets.shape[0]]
        proj[0, col] = proj[0, col] + float(-j[0] * 2.0 / width)
        proj[1, col] = proj[1, col] + float(-j[1] * 2.0 / height)
    return proj


def view_proj(cam: Camera, width: int, height: int, jitter_index=None,
              orthographic: bool = False):
    return projection_matrix(cam, width, height, jitter_index, orthographic) @ view_matrix(cam)
