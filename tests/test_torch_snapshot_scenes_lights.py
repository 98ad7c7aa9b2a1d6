"""Cascaded and soft shadows in the port against impact_tpu on the CPU, and
the snapshot scenes that use shadow maps (part 2 of 3 of the snapshot
tests).

Inputs: the RenderingTest arrangement compiled by the port (its compile
equals the reference's, tests/test_torch_snapshot_scenes.py), its
corner-major render scene and camera handed to both packages as numpy.

* Cascade split depths and sub-frustum corners: within 1e-6 relative
  (float32 powers and a rotation).
* Cascaded directional maps (3 cascades): the port's plain tile raster
  (its tile lists fit to the view) against the reference's XLA raster
  without its cut of 256 a tile (k_per_tile past the most crowded tile of
  any cascade), with the repo's raster bars
  (tests/test_raster_pallas.py): coverage equal on ≥ 0.99 of the texels,
  depth within 2e-3 where both cover; view-projections within 1e-5.
* PCF visibility (hard and soft; cubemaps and cascades) and the whole
  ``shade`` with soft shadows on the same maps: the same formulas in
  float32, but a floor or a round on a value within an ulp of an integer
  may take another texel, so at most 0.2 % of the samples may differ by
  more than 1e-4, and the mean difference stays below 1e-4 (visibility)
  or 1e-4 relative (luminance).
* Frames: the shadowed feature scenes through the runner, against their
  goldens at ≥ 0.93.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_snapshot_scenes import check_frame

from impact_tpu.render import lights as jl
from impact_tpu_torch.apps import snapshot_tester as st
from impact_tpu_torch.models import rendering_test
from impact_tpu_torch.render import lights as tl
from impact_tpu_torch.render.camera import view_matrix
from impact_tpu_torch.render.pipeline import geometry_pass
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

RES = 256
N_CASCADES = 3


def J(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def T(a):
    return torch.tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def scene_state():
    """The RenderingTest scene with both light kinds: (runtime, scene)."""
    cfg = st.snapshot_config("raster")
    cfg.rendering.shadow_mapping.enabled = True
    cfg.tpu.csm_cascades = N_CASCADES
    cfg.tpu.soft_shadows = True
    rt = HeadlessRuntime(compile_scene(rendering_test(omni_extent=2.0, uni_extent=4.0), cfg,
                                       device="cpu"), cfg)
    return rt, rt.scene()


def _camera_args(rt):
    cam, rc = rt.params.camera, rt.render_config
    return (cam.position, cam.orientation, cam.vertical_fov, rc.width / rc.height, cam.near,
            torch.clamp(cam.far, max=200.0))


def _crowd(tri_pos9, tris, vps):
    """The most candidates one 32-px tile of the port's tile raster holds
    over the views ``vps``."""
    from impact_tpu_torch.render import raster as traster
    from impact_tpu_torch.render.pipeline import project_corners

    most = 0
    for vp in vps:
        clip2, _, act2 = traster.clip_triangles_near(project_corners(tri_pos9, vp), tris)
        b = traster._bin_small_and_big(clip2, act2, RES, RES, 32, 64, False)
        most = max(most, int(b.counts.max()))
    return most


@functools.lru_cache(maxsize=None)
def cascades():
    """(port (depths, vps, splits), reference (depths, vps, splits)) of the
    scene's directional light; the reference's tile raster runs without its
    cut (k_per_tile past the port's most crowded tile)."""
    rt, scene = scene_state()
    tris = scene.tri_active & scene.tri_shadow
    args = _camera_args(rt)
    d = rt.params.lights.uni_direction[0]
    got = tl.render_uni_shadow_cascades(d, *args, scene.tri_pos, tris, RES, N_CASCADES,
                                        backend="raster")[:3]
    k = max(256, _crowd(scene.tri_pos, tris, got[1]))
    cut = jl.rasterlib.rasterize

    def uncut(*a, **kw):
        return cut(*a, **{**kw, "k_per_tile": k, "tiles_per_chunk": 4})

    jl.rasterlib.rasterize = uncut
    try:
        ref = jl.render_uni_shadow_cascades(J(d), *(J(a) if isinstance(a, torch.Tensor) else a
                                                    for a in args),
                                            J(scene.tri_pos), J(tris), RES, N_CASCADES,
                                            backend="xla")[:3]
    finally:
        jl.rasterlib.rasterize = cut
    return got, ref


def test_cascade_splits_and_frusta_match_reference():
    rt, _ = scene_state()
    pos, ori, fov, aspect, near, far = _camera_args(rt)
    got = tl.cascade_partition_depths(near, far, 4)
    ref = jl.cascade_partition_depths(J(near), J(far), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    for c in range(4):
        g = tl._frustum_corners_world(pos, ori, fov, aspect, got[c], got[c + 1])
        r = jl._frustum_corners_world(J(pos), J(ori), J(fov), aspect, ref[c], ref[c + 1])
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-5)


def test_cascaded_maps_match_reference_within_raster_bars():
    (gd, gv, gs), (rd, rv, rs) = cascades()
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-5)
    gd, rd = gd.numpy(), np.asarray(rd)
    assert gd.shape == rd.shape == (N_CASCADES, RES, RES)
    for c in range(N_CASCADES):
        gc, rc = gd[c] < 1.0, rd[c] < 1.0
        assert rc.mean() > 0.01, c  # the cascade sees geometry
        assert (gc == rc).mean() >= 0.99, c
        both = gc & rc
        assert np.abs(gd[c][both] - rd[c][both]).max() <= 2e-3, c


def _agree(got, ref, what, rel=False):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, what
    diff = np.abs(got - ref)
    if rel:
        diff = diff / np.maximum(np.abs(ref), 1.0)
    assert (diff > 1e-4).mean() <= 2e-3, (what, (diff > 1e-4).mean())
    assert diff.mean() < 1e-4, (what, diff.mean())


def _receivers(rt):
    """The G-buffer of the scene's first frame (world positions, normals,
    view depth) as the receivers of the visibility tests."""
    gb, _ = geometry_pass(rt.scene(), rt.params.camera, rt.params.camera, 0, rt.render_config)
    vm = view_matrix(rt.params.camera)
    wp = gb.world_pos
    view_depth = -(vm[2, 0] * wp[..., 0] + vm[2, 1] * wp[..., 1] + vm[2, 2] * wp[..., 2]
                   + vm[2, 3])
    return gb, view_depth


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_cascade_visibility_matches_reference(soft):
    rt, _ = scene_state()
    gb, view_depth = _receivers(rt)
    _, (rd, rv, rs) = cascades()
    extent = float(rt.params.lights.uni_extent[0]) * np.pi / 180.0 if soft else None
    got = tl.uni_cascade_visibility(tl.quad_pack(T(rd)), T(rv), T(rs), view_depth,
                                    gb.world_pos, gb.normal, angular_extent=extent)
    ref = jl.uni_cascade_visibility(jl.quad_pack(rd), rv, rs, J(view_depth), J(gb.world_pos),
                                    J(gb.normal), angular_extent=extent)
    assert 0.05 < float(np.asarray(ref).mean()) < 0.999  # some receivers in shadow
    _agree(got, ref, "uni visibility")


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_cube_visibility_matches_reference(soft):
    rt, scene = scene_state()
    gb, _ = _receivers(rt)
    lp = rt.params.lights.omni_position[0]
    rd, rv, _ = jl.render_omni_shadow_cubemap(J(lp), J(scene.tri_pos),
                                              J(scene.tri_active & scene.tri_shadow), RES)
    extent = rt.params.lights.omni_extent[0] if soft else None
    got = tl.omni_shadow_visibility(lp, tl.quad_pack(T(rd)), T(rv), gb.world_pos,
                                    source_extent=extent)
    ref = jl.omni_shadow_visibility(J(lp), jl.quad_pack(rd), rv, J(gb.world_pos),
                                    source_extent=None if extent is None else J(extent))
    assert 0.05 < float(np.asarray(ref).mean()) < 0.999
    _agree(got, ref, "omni visibility")


def test_soft_cascaded_shade_matches_reference():
    rt, scene = scene_state()
    gb, view_depth = _receivers(rt)
    lights = rt.params.lights
    _, (rd, rv, rs) = cascades()
    od, ov, _ = jl.render_omni_shadow_cubemap(J(lights.omni_position[0]), J(scene.tri_pos),
                                              J(scene.tri_active & scene.tri_shadow), RES)
    occl = torch.ones(gb.valid.shape)
    t_omni = (tl.quad_pack(T(od))[None],
              T(ov)[None])
    t_uni = (tl.quad_pack(T(rd))[None],
             T(rv)[None], T(rs)[None])
    got = tl.shade(lights, gb.world_pos, gb.normal, gb.albedo, gb.f0, gb.roughness, gb.emissive,
                   occl, rt.params.camera.position, gb.valid, t_omni, t_uni, view_depth,
                   soft_shadows=True)
    jlights = jl.LightPools(*(J(x) for x in lights))
    ref = jl.shade(jlights, J(gb.world_pos), J(gb.normal), J(gb.albedo), J(gb.f0),
                   J(gb.roughness), J(gb.emissive), J(occl), J(rt.params.camera.position),
                   J(gb.valid), (jl.quad_pack(od)[None], ov[None]),
                   (jl.quad_pack(rd)[None], rv[None], rs[None]), J(view_depth),
                   soft_shadows=True)
    _agree(got, ref, "soft shade", rel=True)


@pytest.mark.parametrize("name", ["ShadowCubeMapping", "SoftShadowCubeMapping",
                                  "CascadedShadowMapping", "SoftCascadedShadowMapping",
                                  "Skybox"])
def test_frame_matches_golden(name):
    check_frame(name)
