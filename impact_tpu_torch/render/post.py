"""Postprocessing chain: AO, TAA, bloom, auto-exposure, tone mapping, sRGB.

Port of ``impact_tpu/render/post.py`` (ref: impact_rendering
postprocessing.rs — Alchemy AO + blur, variance-clipped TAA, the 13-tap
bloom downsample / tent-upsample chain, average-luminance exposure,
ACES/Khronos tone mapping). Convolutions run through ``torch.nn.functional``
in float32; callers keep TF32 off (``pipeline.fp32_render``)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _halton(base, n):
    out = np.zeros(n)
    for i in range(n):
        f, r, idx = 1.0, 0.0, i + 1
        while idx > 0:
            f /= base
            r += f * (idx % base)
            idx //= base
        out[i] = r
    return out


def ambient_occlusion(view_pos, view_normal, valid, vertical_fov, sample_count: int = 4,
                      sample_radius: float = 1.0, intensity: float = 2.0,
                      contrast: float = 0.75, frame_counter: int = 0):
    """Alchemy screen-space ambient obscurance → occlusion factor [H,W]
    (1 = unoccluded), followed by a zero-padded 3×3 box blur."""
    h, w = valid.shape
    dev = view_pos.device
    rad = sample_radius * np.sqrt(_halton(2, sample_count))
    ang = 2.0 * np.pi * _halton(3, sample_count)
    offs = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1).astype(np.float32)

    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5 + float(frame_counter % 8)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    noise = torch.remainder(52.9829189 * torch.remainder(0.06711056 * xs + 0.00583715 * ys, 1.0),
                            1.0)
    theta = 2.0 * math.pi * noise
    c, sn = torch.cos(theta), torch.sin(theta)

    vfov = torch.as_tensor(vertical_fov, dtype=torch.float32, device=dev)
    fpx = (0.5 * h) / torch.tan(0.5 * vfov)
    z = view_pos[..., 2]
    inv_neg_z = 1.0 / torch.clamp(-z, min=1e-6)
    far = torch.tensor([0.0, 0.0, -1e8], dtype=torch.float32, device=dev)
    occluder_flat = torch.where(valid[..., None], view_pos, far).reshape(h * w, 3)
    bias = 1e-4 * z
    total = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for si in range(sample_count):
        o0, o1 = float(offs[si, 0]), float(offs[si, 1])
        ox = o0 * c - o1 * sn
        oy = o0 * sn + o1 * c
        sx = view_pos[..., 0] + ox
        sy = view_pos[..., 1] + oy
        u = 0.5 * w + sx * fpx * inv_neg_z
        v = 0.5 * h - sy * fpx * inv_neg_z
        ui = torch.clamp(u.to(torch.int32), 0, w - 1).long()
        vi = torch.clamp(v.to(torch.int32), 0, h - 1).long()
        occluder = occluder_flat[(vi * w + ui).reshape(-1)].reshape(h, w, 3)
        d = occluder - view_pos
        d_n = (d * view_normal).sum(dim=-1)
        d2 = (d * d).sum(dim=-1)
        total = total + torch.clamp(d_n + bias, min=0.0) / (d2 + 1e-4)
    norm = 2.0 * intensity / (np.pi * sample_count)
    ao = torch.clamp(1.0 - norm * total, min=0.0) ** contrast
    ao = torch.where(valid, ao, torch.ones_like(ao))
    k = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=torch.float32, device=dev)
    return F.conv2d(ao[None, None], k, padding=1)[0, 0]


def temporal_anti_aliasing(current, history, motion, current_frame_weight: float = 0.1,
                           variance_clipping_threshold: float = 1.0):
    """Variance-clipped history blend (nearest reprojection by motion)."""
    h, w, _ = current.shape
    dev = current.device
    u = torch.arange(w, device=dev)[None, :] + motion[..., 0] * w
    v = torch.arange(h, device=dev)[:, None] + motion[..., 1] * h
    ui = torch.clamp(torch.round(u).long(), 0, w - 1)
    vi = torch.clamp(torch.round(v).long(), 0, h - 1)
    hist = history.reshape(h * w, 3)[(vi * w + ui).reshape(-1)].reshape(h, w, 3)

    def _sum3(img):
        p = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)
        rows = p[:-2] + p[1:-1] + p[2:]
        return rows[:, :-2] + rows[:, 1:-1] + rows[:, 2:]

    sx = _sum3(current) * (1.0 / 9.0)
    sxx = _sum3(current * current) * (1.0 / 9.0)
    sigma = torch.sqrt(torch.clamp(sxx - sx * sx, min=0.0))
    lo = sx - variance_clipping_threshold * sigma
    hi = sx + variance_clipping_threshold * sigma
    hist_clipped = torch.minimum(torch.maximum(hist, lo), hi)
    return current_frame_weight * current + (1.0 - current_frame_weight) * hist_clipped


_DOWN13_KERNEL = np.array(
    [[1, 1, 2, 2, 1, 1],
     [1, 5, 6, 6, 5, 1],
     [2, 6, 8, 8, 6, 2],
     [2, 6, 8, 8, 6, 2],
     [1, 5, 6, 6, 5, 1],
     [1, 1, 2, 2, 1, 1]], np.float32) / 128.0


def _edge_pad(x, left, right, top, bottom):
    return F.pad(x, (left, right, top, bottom), mode="replicate")


def _down13_nchw(x):
    """The reference's 13-tap bloom downsample as a 6×6 stride-2 conv on [B,1,H,W]."""
    _, _, h, w = x.shape
    if h % 2 or w % 2:
        x = _edge_pad(x, 0, w % 2, 0, h % 2)
    p = _edge_pad(x, 2, 2, 2, 2)
    k = torch.as_tensor(_DOWN13_KERNEL, device=x.device)[None, None]
    return F.conv2d(p, k, stride=2)


def _dilate(x, axis):
    """Insert one zero between neighbours along ``axis`` (lhs dilation 2)."""
    shape = list(x.shape)
    n = shape[axis]
    shape[axis] = 2 * n - 1
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(0, 2 * n - 1, 2)
    out[tuple(idx)] = x
    return out


def _up2_nchw(x):
    """2× bilinear upsample (wgpu half-pixel alignment) as a separable
    lhs-dilated conv."""
    p = _edge_pad(x, 1, 1, 1, 1)
    k = torch.tensor([0.25, 0.75, 0.75, 0.25], dtype=torch.float32, device=x.device)
    y = F.conv2d(_dilate(p, 2), k[None, None, :, None])
    return F.conv2d(_dilate(y, 3), k[None, None, None, :])


def _tent_kernel(r: float) -> np.ndarray:
    reach = int(math.ceil(abs(r))) + 1
    w = np.zeros(2 * reach + 1, np.float32)
    w[reach] += 0.5
    for d in (r, -r):
        lo = int(math.floor(d))
        f = d - lo
        w[reach + lo] += 0.25 * (1.0 - f)
        w[reach + lo + 1] += 0.25 * f
    return w


def _tent_nchw(x, r: float):
    k = _tent_kernel(float(r))
    reach = (len(k) - 1) // 2
    p = _edge_pad(x, reach, reach, reach, reach)
    kt = torch.as_tensor(k, device=x.device)
    y = F.conv2d(p, kt[None, None, :, None])
    return F.conv2d(y, kt[None, None, None, :])


def bloom(luminance, n_downsamplings: int = 4, blur_filter_radius: float = 0.005,
          blurred_luminance_weight: float = 0.04):
    """13-tap progressive downsample to mip N, tent-blurred bilinear upsamples
    added into each mip back up to mip 1, blended at full resolution."""
    h, w0, _ = luminance.shape
    x = luminance.permute(2, 0, 1)[:, None]  # [3,1,H,W]
    levels = [x]
    for _ in range(n_downsamplings):
        x = _down13_nchw(x)
        levels.append(x)
    acc = levels[n_downsamplings]
    for i in range(n_downsamplings - 1, 0, -1):
        th, tw = levels[i].shape[2], levels[i].shape[3]
        r_px = blur_filter_radius * acc.shape[3]
        acc = _up2_nchw(_tent_nchw(acc, r_px))[:, :, :th, :tw] + levels[i]
    blurred = _up2_nchw(acc)[:, :, :h, :w0] / n_downsamplings
    wgt = blurred_luminance_weight
    return (1.0 - wgt) * luminance + wgt * blurred[:, 0].permute(1, 2, 0)


def compute_luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def average_luminance(luminance_rgb, lower=100.0, upper=1e7):
    """Geometric-mean luminance of the pixels within bounds."""
    lum = compute_luminance(luminance_rgb)
    in_range = (lum >= lower) & (lum <= upper)
    log_lum = torch.where(in_range, torch.log(torch.clamp(lum, min=1e-12)),
                          torch.zeros_like(lum))
    count = torch.clamp(in_range.sum(), min=1)
    return torch.exp(log_lum.sum() / count)


def exposure_from_average_luminance(avg_lum, ev_compensation=0.0, lower=1e-6, upper=1e-2):
    """Saturation-based-sensitivity auto exposure (K = 12.5, q = 0.65)."""
    max_lum = ((78.0 / 65.0) * (100.0 / 12.5) * torch.clamp(avg_lum, min=1e-9)
               * (2.0 ** (-ev_compensation)))
    return torch.clamp(1.0 / max_lum, lower, upper)


def manual_exposure(relative_aperture=4.0, shutter_duration=0.005, iso=100.0,
                    lower=1e-6, upper=1e-2):
    e = shutter_duration * iso / (120.0 * relative_aperture ** 2)
    return float(np.clip(e, lower, upper))


def tonemap_aces(x):
    """ACES filmic fit (Narkowicz) with the reference's 0.6 pre-exposure."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = x * 0.6
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap_khronos_pbr_neutral(color):
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = color.amin(dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, torch.full_like(x, 0.04), x - 6.25 * x * x)
    color = color - offset
    peak = color.amax(dim=-1, keepdim=True)
    new_peak = 1.0 - (1.0 - start_compression) ** 2 / torch.clamp(
        peak + 1.0 - 2.0 * start_compression, min=1e-6)
    scaled = color * (new_peak / torch.clamp(peak, min=1e-6))
    g = 1.0 / (desaturation * (peak - new_peak) + 1.0)
    compressed = torch.where(peak < start_compression, color, g * scaled + (1.0 - g) * new_peak)
    return torch.clamp(compressed, 0.0, 1.0)


def tonemap(color, method: str = "ACES"):
    if method in ("None", None, "none"):
        return torch.clamp(color, 0.0, 1.0)
    if method == "ACES":
        return tonemap_aces(color)
    if method == "KhronosPBRNeutral":
        return tonemap_khronos_pbr_neutral(color)
    raise ValueError(f"unknown tone mapping method {method!r}")


def to_srgb(linear):
    return torch.where(linear <= 0.0031308, 12.92 * linear,
                       1.055 * torch.clamp(linear, min=1e-12) ** (1.0 / 2.4) - 0.055)


def to_u8(ldr):
    return torch.clamp(torch.round(ldr * 255.0), 0, 255).to(torch.uint8)
