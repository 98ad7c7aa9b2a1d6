"""The deferred HDR render pipeline: geometry pass (G-buffer through K1) →
shadow pass (depth views through K1) → deferred shading → postprocess.

Port of ``impact_tpu/render/pipeline.py`` (ref: impact_rendering
render_command.rs:222-432). Every stage runs in float32: TF32 is turned off
for matmuls and for cuDNN convolutions (bloom is a convolution) while a stage
runs, because reduced-precision products visibly moved golden parity in the
reference (``pipeline.py:211-234`` there, commit e3def44).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from . import post, raster as rasterlib
from .camera import Camera, projection_matrix, view_matrix
from .lights import (
    MAX_SHADOW_MAP_CASCADES,
    OMNI_SHADOW_FAR,
    LightPools,
    quad_pack,
    render_omni_shadow_cubemap,
    render_uni_shadow_cascades,
    render_uni_shadow_map,
    shade,
)


@contextlib.contextmanager
def fp32_render():
    """Full-float32 matmuls and convolutions for the duration of a stage."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class RenderScene(NamedTuple):
    """Flattened corner-major world geometry for one frame ([:, 3c:3c+3] or
    [:, c] is corner c of the triangle)."""

    tri_pos: torch.Tensor  # f32[T,9]
    tri_pos_prev: torch.Tensor  # f32[T,9]
    tri_normal: torch.Tensor  # f32[T,9]
    tri_albedo: torch.Tensor  # f32[T,9]
    tri_f0: torch.Tensor  # f32[T,9]
    tri_roughness: torch.Tensor  # f32[T,3]
    tri_emissive: torch.Tensor  # f32[T,9]
    tri_material: torch.Tensor  # i32[T,3]
    tri_active: torch.Tensor  # bool[T]
    tri_shadow: torch.Tensor  # bool[T]


class RenderConfig(NamedTuple):
    """Static pipeline configuration (from the engine config)."""

    width: int = 256
    height: int = 192
    shadow_map_resolution: int = 256
    ao_enabled: bool = True
    ao_sample_count: int = 4
    ao_sample_radius: float = 1.0
    ao_intensity: float = 2.0
    ao_contrast: float = 0.75
    taa_enabled: bool = True
    taa_current_frame_weight: float = 0.1
    taa_variance_clipping_threshold: float = 1.0
    bloom_enabled: bool = True
    bloom_n_downsamplings: int = 4
    bloom_blur_filter_radius: float = 0.005
    bloom_blurred_luminance_weight: float = 0.04
    exposure_ev_compensation: float = 0.0
    exposure_lower: float = 1e-6
    exposure_upper: float = 1e-2
    exposure_iso: float | None = None
    relative_aperture: float = 4.0
    shutter_duration: float = 0.005
    luminance_lower: float = 100.0
    luminance_upper: float = 1e7
    exposure_current_frame_weight: float = 0.02
    tone_mapping: str = "ACES"
    shadows_enabled: bool = True
    csm_cascades: int = 1
    sky_luminance: tuple = (0.0, 0.0, 0.0)
    # textured-material path: triplanar voxel-type texture layers, and the
    # textured mesh entities' full-PBR layers, applied in deferred_shade
    textured: bool = False
    texture_scale: float = 0.5  # world units → uv tiling frequency
    normal_map_strength: float = 1.0
    shadow_pcf_downsample: int = 1
    ao_downsample: int = 1
    soft_shadows: bool = False
    procedural_sky: bool = False
    orthographic: bool = False
    bf16_shading: bool = False  # BRDF math in bfloat16 (render/lights.py:shade)
    max_triangles: int = 65536
    view_culling: bool = True
    # "kernel" = the K1 tile kernel (render/raster_pallas.py: CUDA on the card,
    # its plain version on CPU tensors); "raster" = the plain tile-binned
    # raster (render/raster.py), the reference's XLA path
    raster_backend: str = "kernel"


class RenderState(NamedTuple):
    """Cross-frame render state."""

    history_luminance: torch.Tensor  # f32[H,W,3] TAA history
    avg_luminance: torch.Tensor  # f32 smoothed scene luminance
    frame_index: int
    # cumulative raster candidates lost to window/big-block overflow; a
    # plain 0 where a state is built without it, as in the reference
    n_raster_drops: torch.Tensor | int = 0  # i64[]


def init_render_state(config: RenderConfig, device="cuda") -> RenderState:
    return RenderState(
        history_luminance=torch.zeros((config.height, config.width, 3), device=device),
        avg_luminance=torch.tensor(1000.0, device=device),
        frame_index=0,
        n_raster_drops=torch.zeros((), dtype=torch.int64, device=device),
    )


class GBuffer(NamedTuple):
    world_pos: torch.Tensor  # f32[H,W,3]
    normal: torch.Tensor  # f32[H,W,3]
    albedo: torch.Tensor  # f32[H,W,3]
    f0: torch.Tensor  # f32[H,W,3]
    roughness: torch.Tensor  # f32[H,W]
    emissive: torch.Tensor  # f32[H,W,3]
    material: torch.Tensor  # i32[H,W]
    motion: torch.Tensor  # f32[H,W,2]
    valid: torch.Tensor  # bool[H,W]


def compact_scene_triangles(scene: RenderScene, max_triangles: int) -> RenderScene:
    """Compact active triangle slots to the raster budget (stable, actives first)."""
    if scene.tri_active.shape[0] > max_triangles:
        order = torch.argsort((~scene.tri_active).to(torch.uint8), stable=True)[:max_triangles]
        scene = RenderScene(*(a[order] for a in scene))
    return scene


def project_corners(tri_pos9, vp):
    """Corner-major world positions [T,9] → clip positions [T,3,4]."""
    cols = [tri_pos9[:, 3 * c:3 * c + 3] @ vp[:, :3].T + vp[None, :, 3] for c in range(3)]
    return torch.stack(cols, dim=1)


def triangle_bounding_spheres(tri_pos9):
    c0, c1, c2 = tri_pos9[:, 0:3], tri_pos9[:, 3:6], tri_pos9[:, 6:9]
    center = (c0 + c1 + c2) * (1.0 / 3.0)
    rad = torch.sqrt(torch.maximum(
        ((c0 - center) ** 2).sum(dim=-1),
        torch.maximum(((c1 - center) ** 2).sum(dim=-1), ((c2 - center) ** 2).sum(dim=-1))))
    return center, rad


def cull_scene_to_frustum(scene: RenderScene, view_proj) -> RenderScene:
    """Mask ``tri_active`` to triangles whose bounding spheres meet the frustum."""
    from ..geometry.frustum import frustum_planes_from_view_proj, sphere_inside_frustum

    normals, disp = frustum_planes_from_view_proj(view_proj)
    center, rad = triangle_bounding_spheres(scene.tri_pos)
    vis = sphere_inside_frustum(normals, disp, center, rad)
    return scene._replace(tri_active=scene.tri_active & vis)


def pack_corner_attributes(scene: RenderScene):
    """The 20 attributes per corner, corner-major [T,60]: pos 0:3, prev pos
    3:6, normal 6:9, albedo 9:12, f0 12:15, roughness 15, emissive 16:19,
    material 19."""
    def corner(c):
        return torch.cat([
            scene.tri_pos[:, 3 * c:3 * c + 3],
            scene.tri_pos_prev[:, 3 * c:3 * c + 3],
            scene.tri_normal[:, 3 * c:3 * c + 3],
            scene.tri_albedo[:, 3 * c:3 * c + 3],
            scene.tri_f0[:, 3 * c:3 * c + 3],
            scene.tri_roughness[:, c:c + 1],
            scene.tri_emissive[:, 3 * c:3 * c + 3],
            scene.tri_material[:, c:c + 1].to(torch.float32),
        ], dim=-1)

    return torch.cat([corner(c) for c in range(3)], dim=-1)


def geometry_pass(scene: RenderScene, cam: Camera, cam_prev: Camera, frame_index: int,
                  config: RenderConfig):
    """Rasterize the G-buffer + motion vectors. Returns (GBuffer, n_drop);
    ``scene`` must already be compacted (compact_scene_triangles)."""
    h, w = config.height, config.width
    jitter = frame_index if config.taa_enabled else None
    ortho = config.orthographic
    vm = view_matrix(cam)
    pm = projection_matrix(cam, w, h, jitter, orthographic=ortho)
    vp = pm @ vm
    if config.view_culling:
        scene = cull_scene_to_frustum(scene, vp)
    vp_prev = projection_matrix(cam_prev, w, h, None, orthographic=ortho) @ view_matrix(cam_prev)

    packed = pack_corner_attributes(scene)
    t = scene.tri_active.shape[0]
    if config.raster_backend == "kernel":
        from .raster_pallas import rasterize_attributes_pos

        # windows fit to the view: the reference's fixed 256 per window
        # drops near triangles on dense views (ROADMAP Queue 3)
        out, near, valid, n_drop = rasterize_attributes_pos(
            scene.tri_pos, scene.tri_active, packed, vp, h, w,
            tile=32, k_per_range=None, return_drops=True)
    elif config.raster_backend == "raster":
        tri_clip = project_corners(scene.tri_pos, vp)
        idx = torch.arange(3 * t, device=packed.device).reshape(t, 3)
        # tile lists fit to the view, as K1's windows
        out, near, valid = rasterlib.rasterize_attributes(
            tri_clip, scene.tri_active, idx, packed.reshape(3 * t, 20), h, w, fit_k=True)
        n_drop = torch.zeros((), dtype=torch.int64, device=packed.device)
    else:
        raise ValueError(f"unknown raster_backend {config.raster_backend!r}")

    world_pos = out[..., 0:3]
    world_pos_prev = out[..., 3:6]
    normal = out[..., 6:9]
    normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1, keepdim=True),
                                  min=1e-9)
    roughness = out[..., 15] * out[..., 15]  # GGX alpha = perceptual roughness²
    material = torch.round(near[..., 19]).to(torch.int32)
    material = torch.where(valid, material, torch.full_like(material, -1))

    vp_cur_unjittered = projection_matrix(cam, w, h, None, orthographic=ortho) @ vm

    def ndc_xy(wp, m):
        x, y, z = wp[..., 0], wp[..., 1], wp[..., 2]
        cx = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
        cy = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
        cw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
        iw = 1.0 / torch.clamp(cw, min=1e-8)
        return cx * iw, cy * iw

    px_prev, py_prev = ndc_xy(world_pos_prev, vp_prev)
    px_cur, py_cur = ndc_xy(world_pos, vp_cur_unjittered)
    motion = torch.stack([(px_prev - px_cur) * 0.5, (py_prev - py_cur) * -0.5], dim=-1)
    motion = torch.where(valid[..., None], motion, torch.zeros((), device=motion.device))
    gb = GBuffer(world_pos=world_pos, normal=normal, albedo=out[..., 9:12],
                 f0=out[..., 12:15], roughness=roughness, emissive=out[..., 16:19],
                 material=material, motion=motion, valid=valid)
    return gb, n_drop


def shadow_pass(scene: RenderScene, lights: LightPools, cam: Camera, config: RenderConfig):
    """Render all shadow maps → (omni (quads [L,6,S,S,4], vps [L,6,4,4]),
    uni (quads [D,C,S,S,4], vps [D,C,4,4], splits [D,C+1]), n_drop), or
    (None, None, 0) when shadows are off. With ``csm_cascades`` C > 1 each
    directional light renders C cascades fit to the camera's sub-frusta
    (to 200 m at most); with one, a map covering the scene."""
    dev = scene.tri_pos.device
    n_drop = torch.zeros((), dtype=torch.int64, device=dev)
    if not config.shadows_enabled:
        return None, None, n_drop
    if not 1 <= config.csm_cascades <= MAX_SHADOW_MAP_CASCADES:
        raise ValueError(f"csm_cascades must be 1 to {MAX_SHADOW_MAP_CASCADES}")
    shadow_tris = scene.tri_active & scene.tri_shadow
    backend = config.raster_backend
    if config.view_culling:
        sph_center, sph_rad = triangle_bounding_spheres(scene.tri_pos)

    omni_d, omni_v = [], []
    for i in range(lights.omni_position.shape[0]):
        pos = lights.omni_position[i]
        tris = shadow_tris
        if config.view_culling:
            d2 = ((sph_center - pos[None, :]) ** 2).sum(dim=-1)
            tris = tris & (d2 <= (OMNI_SHADOW_FAR + sph_rad) ** 2)
        d, v, nd = render_omni_shadow_cubemap(pos, scene.tri_pos, tris,
                                              config.shadow_map_resolution, backend=backend)
        omni_d.append(d)
        omni_v.append(v)
        n_drop = n_drop + nd
    omni_shadows = (quad_pack(torch.stack(omni_d)), torch.stack(omni_v))

    if config.csm_cascades > 1:
        outs = [render_uni_shadow_cascades(
            lights.uni_direction[i], cam.position, cam.orientation, cam.vertical_fov,
            config.width / config.height, cam.near, torch.clamp(cam.far, max=200.0),
            scene.tri_pos, shadow_tris, config.shadow_map_resolution, config.csm_cascades,
            backend=backend) for i in range(lights.uni_direction.shape[0])]
        for o in outs:
            n_drop = n_drop + o[3]
        return omni_shadows, (quad_pack(torch.stack([o[0] for o in outs])),
                              torch.stack([o[1] for o in outs]),
                              torch.stack([o[2] for o in outs])), n_drop

    corner0 = scene.tri_pos[:, 0:3]
    act = scene.tri_active[:, None]
    scene_center = torch.where(act, corner0, torch.zeros((), device=dev)).sum(dim=0) / torch.clamp(
        scene.tri_active.sum(), min=1)
    scene_radius = torch.clamp(torch.where(
        scene.tri_active, torch.linalg.vector_norm(corner0 - scene_center, dim=-1),
        torch.zeros((), device=dev)).amax(), min=1.0)
    uni_d, uni_v = [], []
    for i in range(lights.uni_direction.shape[0]):
        d, v, nd = render_uni_shadow_map(lights.uni_direction[i], scene_center, scene_radius,
                                         scene.tri_pos, shadow_tris,
                                         config.shadow_map_resolution, backend=backend)
        uni_d.append(d)
        uni_v.append(v)
        n_drop = n_drop + nd
    uni_depths = torch.stack(uni_d)[:, None]
    uni_vps = torch.stack(uni_v)[:, None]
    splits = torch.stack([cam.near, cam.far])[None].repeat(lights.uni_mask.shape[0], 1)
    return omni_shadows, (quad_pack(uni_depths), uni_vps, splits), n_drop


def apply_textures(gb: GBuffer, cam: Camera, config: RenderConfig, textures) -> GBuffer:
    """The G-buffer with its textured pixels (material layer ≥ 0) re-shaded
    from ``textures`` (a ``VoxelTextureSet``): triplanar albedo and normal
    mapping at the mip level of each pixel's footprint; full-PBR layers
    (textured entities) also take roughness, metalness, specular and
    emissive from their property textures, after a one-step parallax shift
    of the sample position (ref: setup/physical.rs:36-214, the voxel-type
    texture arrays of voxel_types.rs)."""
    from .textures import lod_from_scale, sample_triplanar, triplanar_normal

    vm = view_matrix(cam)
    has_tex = gb.material >= 0
    # a layer past the last reads the last, as the reference's gathers clamp
    layer = torch.clamp(gb.material, 0, textures.albedo.mips[0].shape[0] - 1).long()
    # mip level from the texel footprint of one pixel at this depth
    view_depth = -(vm[2, 0] * gb.world_pos[..., 0] + vm[2, 1] * gb.world_pos[..., 1]
                   + vm[2, 2] * gb.world_pos[..., 2] + vm[2, 3])
    tex_size = textures.albedo.mips[0].shape[1]
    world_per_pixel = view_depth * (2.0 * torch.tan(0.5 * cam.vertical_fov) / config.height)
    lod = lod_from_scale(world_per_pixel * config.texture_scale * tex_size)
    scale = config.texture_scale

    wp = gb.world_pos
    props = None
    if textures.props is not None:
        props = sample_triplanar(textures.props, layer, wp, gb.normal, scale, lod)
        # one parallax step: shift the sample position along the view's
        # tangential part by the height sample (displacement scale baked)
        hgt = props[..., 4]
        v = cam.position - wp
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-6)
        ndv = (v * gb.normal).sum(dim=-1, keepdim=True)
        vtan = v - ndv * gb.normal
        wp = wp - vtan * (hgt / torch.clamp(ndv[..., 0], min=0.2))[..., None]
        props = sample_triplanar(textures.props, layer, wp, gb.normal, scale, lod)

    tex_albedo = sample_triplanar(textures.albedo, layer, wp, gb.normal, scale, lod)
    metal_mask = (gb.f0 > 0.5).any(dim=-1)
    albedo = torch.where((has_tex & ~metal_mask)[..., None], tex_albedo, gb.albedo)
    normal = triplanar_normal(textures.normal, layer, wp, gb.normal, config.normal_map_strength,
                              scale, lod)
    normal = torch.where(has_tex[..., None], normal, gb.normal)
    if props is None:
        return gb._replace(albedo=albedo, normal=normal)
    # full-PBR layers recompute the material from the sampled stack (the
    # reference's metal/dielectric mix: dielectric F0 = specular, diffuse =
    # colour; metal F0 = colour·specular, no diffuse); voxel-type layers
    # (full_pbr 0) keep the albedo and normal above
    fp = textures.full_pbr[layer] * has_tex
    rough_t, metal_t, spec_t, emis_t = props[..., 0], props[..., 1], props[..., 2], props[..., 3]
    m1 = metal_t[..., None]
    alb_full = tex_albedo * (1.0 - m1)
    f0_full = spec_t[..., None] * ((1.0 - m1) + tex_albedo * m1)
    emis_full = tex_albedo * emis_t[..., None]
    fpx = fp[..., None]
    return gb._replace(
        albedo=albedo * (1.0 - fpx) + alb_full * fpx,
        normal=normal,
        f0=gb.f0 * (1.0 - fpx) + f0_full * fpx,
        roughness=gb.roughness * (1.0 - fp) + rough_t * fp,
        emissive=gb.emissive * (1.0 - fpx) + emis_full * fpx,
    )


def deferred_shade(gb: GBuffer, lights: LightPools, cam: Camera, omni_shadows, uni_shadows,
                   config: RenderConfig, textures=None):
    """AO + deferred lighting → HDR luminance [H,W,3] (sky where no geometry).
    ``textures``: the scene's ``VoxelTextureSet`` when ``config.textured``
    (see ``apply_textures``)."""
    h, w = config.height, config.width
    vm = view_matrix(cam)

    def view_row(wp, m, i):
        return m[i, 0] * wp[..., 0] + m[i, 1] * wp[..., 1] + m[i, 2] * wp[..., 2] + m[i, 3]

    if config.textured and textures is not None:
        gb = apply_textures(gb, cam, config, textures)

    if config.ao_enabled:
        k = config.ao_downsample
        wp_k = gb.world_pos[::k, ::k]
        vpos = torch.stack([view_row(wp_k, vm, i) for i in range(3)], dim=-1)
        n_k = gb.normal[::k, ::k]
        vnorm = torch.stack(
            [vm[i, 0] * n_k[..., 0] + vm[i, 1] * n_k[..., 1] + vm[i, 2] * n_k[..., 2]
             for i in range(3)], dim=-1)
        occlusion = post.ambient_occlusion(
            vpos, vnorm, gb.valid[::k, ::k], cam.vertical_fov,
            sample_count=config.ao_sample_count, sample_radius=config.ao_sample_radius,
            intensity=config.ao_intensity, contrast=config.ao_contrast)
        if k > 1:
            occlusion = occlusion.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)[:h, :w]
    else:
        occlusion = torch.ones((h, w), device=gb.world_pos.device)

    view_depth = -view_row(gb.world_pos, vm, 2)
    lum = shade(lights, gb.world_pos, gb.normal, gb.albedo, gb.f0, gb.roughness, gb.emissive,
                occlusion, cam.position, gb.valid, omni_shadows, uni_shadows, view_depth,
                shadow_downsample=config.shadow_pcf_downsample,
                soft_shadows=config.soft_shadows, bf16=config.bf16_shading)
    if config.procedural_sky:
        from .sky import pixel_view_directions, procedural_sky

        rays = pixel_view_directions(cam.orientation, cam.vertical_fov, w, h)
        sun = lights.uni_direction[0] if lights.uni_mask.shape[0] > 0 else None
        sky = procedural_sky(rays, sun_direction=sun)
    else:
        sky = torch.tensor(config.sky_luminance, dtype=torch.float32, device=lum.device)
    return torch.where(gb.valid[..., None], lum, sky)


def postprocess(lum, motion, state: RenderState, config: RenderConfig):
    """TAA → bloom → auto-exposure → tone map → u8. Returns (img u8 [H,W,3],
    hdr luminance, new RenderState)."""
    first = state.frame_index == 0
    if config.taa_enabled:
        if first:
            lum_out = lum
        else:
            lum_out = post.temporal_anti_aliasing(
                lum, state.history_luminance, motion, config.taa_current_frame_weight,
                config.taa_variance_clipping_threshold)
        history = lum_out
    else:
        lum_out = lum
        history = state.history_luminance
    if config.bloom_enabled:
        lum_out = post.bloom(lum_out, config.bloom_n_downsamplings,
                             blur_filter_radius=config.bloom_blur_filter_radius,
                             blurred_luminance_weight=config.bloom_blurred_luminance_weight)
    frame_avg = post.average_luminance(lum_out, config.luminance_lower, config.luminance_upper)
    wgt = config.exposure_current_frame_weight
    avg = frame_avg if first else (1.0 - wgt) * state.avg_luminance + wgt * frame_avg
    if config.exposure_iso is not None:
        exposure = post.manual_exposure(config.relative_aperture, config.shutter_duration,
                                        config.exposure_iso, config.exposure_lower,
                                        config.exposure_upper)
    else:
        exposure = post.exposure_from_average_luminance(
            avg, config.exposure_ev_compensation, config.exposure_lower, config.exposure_upper)
    img = post.to_u8(post.to_srgb(post.tonemap(lum_out * exposure, config.tone_mapping)))
    new_state = RenderState(history_luminance=history, avg_luminance=avg,
                            frame_index=state.frame_index + 1,
                            n_raster_drops=state.n_raster_drops)
    return img, lum_out, new_state


def render_frame(scene: RenderScene, lights: LightPools, cam: Camera, cam_prev: Camera,
                 state: RenderState, config: RenderConfig, textures=None):
    """Render one frame → (u8 image [H,W,3], hdr luminance, new state)."""
    with fp32_render():
        scene = compact_scene_triangles(scene, config.max_triangles)
        gb, geo_drops = geometry_pass(scene, cam, cam_prev, state.frame_index, config)
        omni, uni, shadow_drops = shadow_pass(scene, lights, cam, config)
        state = state._replace(n_raster_drops=state.n_raster_drops + geo_drops + shadow_drops)
        lum = deferred_shade(gb, lights, cam, omni, uni, config, textures)
        return postprocess(lum, gb.motion, state, config)
