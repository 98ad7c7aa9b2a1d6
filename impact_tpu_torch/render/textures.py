"""Texture arrays, samplers, mipmaps and lookup tables (port of
``impact_tpu/render/textures.py``; ref: impact_texture lib.rs, import.rs,
processing.rs, lookup_table.rs, and the 2×2 box mipmap pass of
impact_gpu mipmap.wgsl).

A texture array is a dense ``[N, H, W, C]`` float32 tensor of same-size
layers plus its mip levels, each a tensor of its own. Sampling is gathers
over pixel batches; wrap and filter modes are static sampler settings. The
procedural generators are numpy, copied from the reference so that both
packages make the same layers bit for bit. Image files are read with the
port's own PNG reader (``utils/image.py``) and resized with a Lanczos
filter written in numpy after PIL's (the card's machine has no PIL); only
PNGs are read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# wrap modes (ref: impact_texture sampler configs / wgpu AddressMode)
WRAP_REPEAT = "repeat"
WRAP_CLAMP = "clamp"
WRAP_MIRROR = "mirror"


class SamplerConfig(NamedTuple):
    """Static sampling configuration (ref: SamplerRegistry entries)."""

    wrap: str = WRAP_REPEAT
    filter_linear: bool = True
    mip_linear: bool = True


class TextureArray(NamedTuple):
    """N same-size layers with a full mip chain: ``mips[0]`` is the base
    level ``[N, H, W, C]``, each next level halves H and W down to 1×1."""

    mips: tuple  # tuple of f32[N, H>>l, W>>l, C]

    @property
    def n_layers(self) -> int:
        return self.mips[0].shape[0]

    @property
    def base_shape(self):
        return tuple(self.mips[0].shape[1:3])

    @property
    def n_levels(self) -> int:
        return len(self.mips)


def build_texture_array(layers, generate_mipmaps: bool = True, device="cuda") -> TextureArray:
    """Stack ``layers`` ([N,H,W,C], H and W powers of two) into a texture
    array with a box-filtered mip chain (ref: mipmap.wgsl 2×2 box)."""
    base = torch.as_tensor(np.asarray(layers, np.float32), device=device)
    if base.ndim != 4:
        raise ValueError(f"expect [N,H,W,C] layers, got {tuple(base.shape)}")
    mips = [base]
    if generate_mipmaps:
        cur = base
        while cur.shape[1] > 1 or cur.shape[2] > 1:
            n, h, w, c = cur.shape
            nh, nw = max(h // 2, 1), max(w // 2, 1)
            cur = cur[:, :nh * 2, :nw * 2, :].reshape(n, nh, min(h, 2), nw, min(w, 2), c)
            cur = cur.mean(dim=(2, 4))
            mips.append(cur)
    return TextureArray(mips=tuple(mips))


def _wrap_coords(x, size: int, mode: str):
    """Integer texel coordinates wrapped into [0, size); the modulo is a
    floor modulo, as ``jnp.mod`` is."""
    if mode == WRAP_REPEAT:
        return torch.remainder(x, size)
    if mode == WRAP_MIRROR:
        period = 2 * size
        m = torch.remainder(x, period)
        return torch.where(m < size, m, period - 1 - m)
    return torch.clamp(x, 0, size - 1)  # clamp


def sample_level(level, layer, uv, sampler: SamplerConfig = SamplerConfig()):
    """Sample one mip level ``[N,H,W,C]`` at ``uv`` [...,2] for layers
    ``layer`` (integer [...]). Returns [...,C]."""
    _, h, w, _ = level.shape
    layer = layer.long()
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    if not sampler.filter_linear:
        iu = _wrap_coords(torch.round(u).long(), w, sampler.wrap)
        iv = _wrap_coords(torch.round(v).long(), h, sampler.wrap)
        return level[layer, iv, iu]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0 = u0.long()
    v0 = v0.long()

    def texel(du, dv):
        return level[layer, _wrap_coords(v0 + dv, h, sampler.wrap),
                     _wrap_coords(u0 + du, w, sampler.wrap)]

    top = texel(0, 0) * (1 - fu) + texel(1, 0) * fu
    bot = texel(0, 1) * (1 - fu) + texel(1, 1) * fu
    return top * (1 - fv) + bot * fv


def sample_texture_array(tex: TextureArray, layer, uv, lod=None,
                         sampler: SamplerConfig = SamplerConfig()):
    """Trilinear (mip-interpolated) sample. ``lod`` is the mip level as a
    float tensor [...]; None = base level. Returns [...,C].

    Every level is sampled once and each pixel picks its two by index: the
    reference's unrolled select over the levels takes the same values."""
    if lod is None or tex.n_levels == 1:
        return sample_level(tex.mips[0], layer, uv, sampler)
    n = tex.n_levels
    lod = torch.clamp(lod, 0.0, float(n - 1))
    l0f = torch.floor(lod)
    f = (lod - l0f)[..., None]
    l0 = torch.clamp(l0f.long(), 0, n - 1)
    per_level = torch.stack([sample_level(m, layer, uv, sampler) for m in tex.mips])

    def pick(idx):
        return torch.gather(per_level, 0, idx[None, ..., None].expand(
            1, *per_level.shape[1:]))[0]

    acc0 = pick(l0)
    if not sampler.mip_linear:
        return acc0
    acc1 = pick(torch.clamp(l0 + 1, max=n - 1))
    return acc0 * (1 - f) + acc1 * f


def lod_from_scale(texels_per_pixel):
    """Mip level from the texel footprint of one screen pixel (the analog of
    hardware derivative-based LOD selection)."""
    return torch.log2(torch.clamp(texels_per_pixel, min=1e-6))


# --- triplanar projection ------------------------------------------------------
# Voxel surfaces have no UV atlas: the reference's voxel geometry shader
# projects its per-type texture arrays along the axes and blends by the normal.


def triplanar_weights(normal, sharpness: float = 4.0):
    """[...,3] blend weights for the x/y/z projections."""
    w = torch.abs(normal) ** sharpness
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)


def sample_triplanar(tex: TextureArray, layer, world_pos, normal, scale: float = 1.0, lod=None,
                     sampler: SamplerConfig = SamplerConfig()):
    """Triplanar-blended texture sample at world positions [...,3]."""
    wts = triplanar_weights(normal)
    sx = sample_texture_array(tex, layer, world_pos[..., [1, 2]] * scale, lod, sampler)
    sy = sample_texture_array(tex, layer, world_pos[..., [0, 2]] * scale, lod, sampler)
    sz = sample_texture_array(tex, layer, world_pos[..., [0, 1]] * scale, lod, sampler)
    return sx * wts[..., 0:1] + sy * wts[..., 1:2] + sz * wts[..., 2:3]


def triplanar_normal(tex: TextureArray, layer, world_pos, normal, strength: float = 1.0,
                     scale: float = 1.0, lod=None, sampler: SamplerConfig = SamplerConfig()):
    """Normal-mapped surface normal by a triplanar tangent-space perturbation
    (whiteout blend). ``tex`` holds tangent-space normal maps in [0,1]."""
    tn = sample_triplanar(tex, layer, world_pos, normal, scale, lod, sampler)
    tn = tn * 2.0 - 1.0  # [-1,1] tangent-space normal
    wts = triplanar_weights(normal)
    tx, ty = tn[..., 0] * strength, tn[..., 1] * strength
    n_x = torch.stack([normal[..., 0], tx, ty], -1)
    n_y = torch.stack([tx, normal[..., 1], ty], -1)
    n_z = torch.stack([tx, ty, normal[..., 2]], -1)
    out = n_x * wts[..., 0:1] + n_y * wts[..., 1:2] + n_z * wts[..., 2:3]
    return out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-9)


def parallax_offset_uv(height_tex: TextureArray, layer, uv, view_dir_tangent,
                       height_scale: float = 0.05, sampler: SamplerConfig = SamplerConfig()):
    """One-step parallax mapping UV offset (ref: ParallaxMap,
    setup/physical.rs:168-214; the reference steps in the shader)."""
    h = sample_level(height_tex.mips[0], layer, uv, sampler)[..., 0]
    offs = (view_dir_tangent[..., :2]
            / torch.clamp(view_dir_tangent[..., 2], min=0.2)[..., None]
            * (h * height_scale)[..., None])
    return uv - offs


class LookupTable(NamedTuple):
    """A table sampled with multilinear interpolation (ref:
    impact_texture/src/lookup_table.rs)."""

    values: torch.Tensor  # f32[..., C]

    def sample(self, coords):
        """coords [...,D] in [0,1]^D → [...,C]."""
        dims = self.values.shape[:-1]
        d = len(dims)
        x = [coords[..., i] * (dims[i] - 1) for i in range(d)]
        i0 = [torch.clamp(torch.floor(xi).long(), 0, dims[i] - 1) for i, xi in enumerate(x)]
        i1 = [torch.clamp(i + 1, 0, dims[k] - 1) for k, i in enumerate(i0)]
        f = [torch.clamp(xi - ii, 0.0, 1.0)[..., None] for xi, ii in zip(x, i0)]
        out = 0.0
        for corner in range(1 << d):
            idx = tuple(i1[k] if corner >> k & 1 else i0[k] for k in range(d))
            w = 1.0
            for k in range(d):
                w = w * (f[k] if corner >> k & 1 else 1.0 - f[k])
            out = out + self.values[idx] * w
        return out


# --- procedural sources (numpy, as the reference's) -----------------------------


def checkerboard(size: int = 256, tiles: int = 8, color_a=(0.9, 0.9, 0.9),
                 color_b=(0.2, 0.2, 0.2)):
    ij = np.indices((size, size)) * tiles // size
    sel = (ij[0] + ij[1]) % 2
    a = np.asarray(color_a, np.float32)
    b = np.asarray(color_b, np.float32)
    return np.where(sel[..., None] == 0, a, b).astype(np.float32)


def value_noise(size: int = 256, cells: int = 16, seed: int = 0, channels: int = 1):
    """Bilinear-interpolated value noise, tileable."""
    rng = np.random.default_rng(seed)
    lattice = rng.uniform(0.0, 1.0, (cells, cells, channels)).astype(np.float32)
    ys = np.linspace(0, cells, size, endpoint=False)
    xs = np.linspace(0, cells, size, endpoint=False)
    y0 = np.floor(ys).astype(int) % cells
    x0 = np.floor(xs).astype(int) % cells
    fy = (ys - np.floor(ys))[:, None, None]
    fx = (xs - np.floor(xs))[None, :, None]
    y1 = (y0 + 1) % cells
    x1 = (x0 + 1) % cells
    c00 = lattice[y0][:, x0]
    c01 = lattice[y0][:, x1]
    c10 = lattice[y1][:, x0]
    c11 = lattice[y1][:, x1]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def noise_normal_map(size: int = 256, cells: int = 16, seed: int = 0, strength: float = 2.0):
    """Tangent-space normal map derived from a value-noise height field."""
    h = value_noise(size, cells, seed)[..., 0]
    dx = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) * 0.5 * size / cells
    dy = (np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)) * 0.5 * size / cells
    n = np.stack([-dx * strength, -dy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((n + 1.0) * 0.5).astype(np.float32)


class VoxelTextureSet(NamedTuple):
    """The texture arrays the shade pass reads: one layer per voxel type,
    then one per textured mesh entity. ``props`` holds the entities'
    property channels [roughness, metalness, specular, emissive, height,
    0, 0, 0] with their scale factors baked in; ``full_pbr`` (f32[L]) flags
    the layers whose props replace the G-buffer's material (textured
    entities), while voxel-type layers change albedo and normal only."""

    albedo: TextureArray
    normal: TextureArray
    props: TextureArray | None = None
    full_pbr: torch.Tensor | None = None  # f32[L]


def _resize_nearest(arr, size: int):
    """Nearest-neighbour resize [H,W,C] → [size,size,C]."""
    h, w = arr.shape[:2]
    yi = (np.arange(size) * h // size).astype(np.int64)
    xi = (np.arange(size) * w // size).astype(np.int64)
    return arr[yi][:, xi]


def build_entity_material_layer(size: int, color=None, normal=None, roughness=1.0,
                                metalness=0.0, specular=0.0, emissive=0.0, height=None):
    """One textured-entity layer (albedo, normal, props[8]) from a mix of
    textures and uniform values (ref: setup/physical.rs, each property
    independently uniform or textured)."""

    def chan(v):
        if v is None:
            return np.zeros((size, size), np.float32)
        v = np.asarray(v, np.float32)
        if v.ndim == 0:
            return np.full((size, size), float(v), np.float32)
        if v.ndim == 3:
            v = v[..., 0]
        if v.shape != (size, size):
            v = _resize_nearest(v[..., None], size)[..., 0]
        return v.astype(np.float32)

    if color is None:
        color = np.ones(3, np.float32)
    color = np.asarray(color, np.float32)
    if color.ndim == 1:
        albedo = np.broadcast_to(color, (size, size, 3)).astype(np.float32)
    else:
        albedo = _resize_nearest(color, size) if color.shape[:2] != (size, size) else color
    if normal is None:
        nrm = np.broadcast_to(np.asarray([0.5, 0.5, 1.0], np.float32),
                              (size, size, 3)).astype(np.float32)
    else:
        normal = np.asarray(normal, np.float32)
        nrm = _resize_nearest(normal, size) if normal.shape[:2] != (size, size) else normal
    zero = np.zeros((size, size), np.float32)
    props = np.stack([chan(roughness), chan(metalness), chan(specular), chan(emissive),
                      chan(height), zero, zero, zero], axis=-1)
    return albedo, nrm, props


def _default_voxel_layers(n_types: int, size: int):
    """Per-voxel-type albedo and normal-map layers, numpy [T,S,S,3] each."""
    palettes = [
        ((0.5, 0.42, 0.35), (0.38, 0.32, 0.27)),
        ((0.72, 0.72, 0.75), (0.6, 0.6, 0.64)),
        ((0.72, 0.86, 0.95), (0.62, 0.78, 0.9)),
    ]
    albedos, normals = [], []
    for t in range(n_types):
        hi, lo = palettes[t % len(palettes)]
        noise = value_noise(size, 8 + 4 * t, seed=11 + t)[..., 0][..., None]
        lo_a, hi_a = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
        albedos.append(lo_a + (hi_a - lo_a) * noise)
        normals.append(noise_normal_map(size, 8 + 2 * t, seed=101 + t))
    return np.stack(albedos), np.stack(normals)


def default_voxel_texture_arrays(n_types: int, size: int = 64, device="cuda"):
    """Per-voxel-type albedo and normal-map arrays (the analog of the arrays
    the reference's VoxelTypeRegistry builds from its texture sets)."""
    albedo, normal = _default_voxel_layers(n_types, size)
    return (build_texture_array(albedo, device=device),
            build_texture_array(normal, device=device))


def build_scene_texture_set(n_voxel_types: int, entity_layers, size: int = 64,
                            include_voxel_layers: bool = True, device="cuda") -> VoxelTextureSet:
    """The scene's texture set: the voxel-type layers (optional), then the
    textured-entity layers (``entity_layers``: (albedo, normal, props)
    triples of build_entity_material_layer)."""
    albedos, normals, props_l, full = [], [], [], []
    if include_voxel_layers and n_voxel_types > 0:
        va, vn = _default_voxel_layers(n_voxel_types, size)
        albedos += list(va)
        normals += list(vn)
        props_l += [np.zeros((size, size, 8), np.float32)] * n_voxel_types
        full += [0.0] * n_voxel_types
    for alb, nrm, pr in entity_layers:
        albedos.append(alb)
        normals.append(nrm)
        props_l.append(pr)
        full.append(1.0)
    need_props = any(f > 0 for f in full)
    return VoxelTextureSet(
        albedo=build_texture_array(np.stack(albedos), device=device),
        normal=build_texture_array(np.stack(normals), device=device),
        props=build_texture_array(np.stack(props_l), device=device) if need_props else None,
        full_pbr=torch.tensor(full, dtype=torch.float32, device=device) if need_props else None,
    )


# --- image import (ref: impact_texture/src/import.rs) ---------------------------


def _lanczos(x):
    """PIL's Lanczos window (support 3)."""
    def sinc(t):
        return np.where(t == 0.0, 1.0, np.sin(np.pi * t) / np.where(t == 0.0, 1.0, np.pi * t))

    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _lanczos_weights(in_size: int, out_size: int):
    """Normalized filter weights [out, in] of one axis, as PIL's resample
    pass computes them (double precision, support scaled on downsampling)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = _lanczos((np.arange(xmin, xmax) - center + 0.5) / filterscale)
        total = k.sum()
        w[xx, xmin:xmax] = k / total if total != 0.0 else k
    return w


def resize_lanczos(channel, size: int):
    """A float32 [H,W] image resized to [size,size] with a Lanczos filter:
    the horizontal pass, then the vertical, each in double precision and
    rounded to float32, as PIL resamples a mode "F" image."""
    a = np.asarray(channel, np.float32)
    h, w = a.shape
    if w != size:
        a = (a.astype(np.float64) @ _lanczos_weights(w, size).T).astype(np.float32)
    if h != size:
        a = (_lanczos_weights(h, size) @ a.astype(np.float64)).astype(np.float32)
    return a


def load_image_layer(path_or_bytes, resolution: int | None = None, srgb: bool = True):
    """One image file (a path or its bytes: JPEG, or PNG of any kind) → a
    float [H,W,3] layer in linear colour (ref: import.rs:174 and
    processing.rs' sRGB decode), read through ``load_image(..., mode="RGB")``
    as the reference reads it. ``resolution`` resizes with the Lanczos
    filter after linearization, clipped at 0."""
    from ..utils.image import load_image

    arr = load_image(path_or_bytes, mode="RGB").astype(np.float32) / 255.0
    if srgb:
        arr = np.where(arr <= 0.04045, arr / 12.92,
                       ((arr + 0.055) / 1.055) ** 2.4).astype(np.float32)
    if resolution is not None and arr.shape[:2] != (resolution, resolution):
        chans = [resize_lanczos(arr[..., c], resolution) for c in range(arr.shape[-1])]
        arr = np.clip(np.stack(chans, axis=-1), 0.0, None)
    return arr


def texture_array_from_images(sources, resolution: int = 256, srgb: bool = True,
                              generate_mipmaps: bool = True, device="cuda") -> TextureArray:
    """Image files (paths or the files' bytes, JPEG or PNG) → one mipmapped
    texture array, every layer resized to ``resolution`` (ref: import.rs:120)."""
    if not sources:
        raise ValueError("empty list of sources for texture array")
    layers = np.stack([load_image_layer(s, resolution, srgb) for s in sources])
    return build_texture_array(layers, generate_mipmaps, device=device)
