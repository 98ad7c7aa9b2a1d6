"""The render names of the reference's surface against impact_tpu on the CPU.

* ``rasterize(method="chunk")`` (the brute-force raster, ``chunk``
  triangles at a time) against the reference's chunk raster on random
  triangle soups: depth within 2e-3 and coverage equal on > 0.99 of the
  pixels (the raster bars of ``tests/test_raster_pallas.py:41-60``), and
  triangle ids equal wherever no two covering candidates lie within 2e-3 in
  depth; a planted exact tie across chunks goes to the lower slot in both.
  ``clear_target``, ``resolve_barycentrics`` and ``interpolate_attribute``
  on the same target (within 1e-5: the port sums in another order).
* ``uni_shadow_visibility`` (within 1e-5), ``sample_sky_cubemap`` (equal)
  and ``material_params_for_types`` (within 1e-6).
* The textured box of ``tests/test_torch_textured_frame.py`` with the JPEG
  fixture ``tests/data/surface_images/base420.jpg`` as its colour texture
  (as ``chip_smoke.py``'s surface phase renders it on the card), compiled and
  rendered by each package from its own scene description: ≥ 0.95 against
  each other (``rgb_hybrid_compare``, the repo's parity bar), and the port's
  texture set within 1e-6 of the reference's.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import textured_box_config, textured_box_scene, textured_box_textures
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

from impact_tpu.ecs import World
from impact_tpu.ecs import components as C
from impact_tpu.render import lights as jlights
from impact_tpu.render import raster as jraster
from impact_tpu.render import sky as jsky
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.runtime.setup import register_texture as jregister
from impact_tpu.scene import materials as jmat
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch.geometry.projection import orthographic_projection_matrix
from impact_tpu_torch.render import lights as tlights
from impact_tpu_torch.render import raster as traster
from impact_tpu_torch.render import sky as tsky
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.runtime import setup as tsetup
from impact_tpu_torch.scene import materials as tmat
from impact_tpu_torch.utils.config import EngineConfig
from impact_tpu_torch.utils.image import rgb_hybrid_compare

JPEG = pathlib.Path(__file__).resolve().parent / "data" / "surface_images" / "base420.jpg"
PARITY_BAR = 0.95


@pytest.fixture(autouse=True)
def texture_registries():
    """Both packages' texture registries as they were before each test."""
    from impact_tpu.runtime import setup as jsetup

    saved = dict(tsetup.TEXTURE_SOURCES), dict(jsetup.TEXTURE_SOURCES)
    yield
    for reg, old in zip((tsetup.TEXTURE_SOURCES, jsetup.TEXTURE_SOURCES), saved):
        reg.clear()
        reg.update(old)


def random_soup(seed, n_tris, n_verts=64):
    """Clip positions [T,3,4] of a random triangle soup in front of a
    perspective camera (``tests/test_raster_pallas.py``'s scene), and the
    active mask."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-1.0, 1.0, (n_verts, 3)).astype(np.float32)
    verts[:, 2] -= 3.0
    tri = rng.integers(0, n_verts, (n_tris, 3))
    active = rng.uniform(size=n_tris) < 0.8
    f, near, far = 1.0 / np.tan(0.5), 0.1, 100.0
    a, b = far / (far - near), -far * near / (far - near)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    clip = np.stack([f * x, f * y, a * (-z) + b, -z], axis=-1).astype(np.float32)
    return clip[tri], active


def candidate_depths(clip2, act2, h, w):
    """Every clipped slot's covered depth at every pixel [T2,H,W] (inf where
    it does not cover), the chunk raster's per-slot test."""
    sx, sy, z, valid = traster._screen_coords(clip2, h, w)
    px = (torch.arange(w, dtype=torch.float32) + 0.5)[None, None, :]
    py = (torch.arange(h, dtype=torch.float32) + 0.5)[None, :, None]
    ax, ay, az = (v[:, 0, None, None] for v in (sx, sy, z))
    bx, by, bz = (v[:, 1, None, None] for v in (sx, sy, z))
    cx, cy, cz = (v[:, 2, None, None] for v in (sx, sy, z))
    area = traster._edge(ax, ay, bx, by, cx, cy)
    act = act2 & valid.all(dim=-1) & (area[:, 0, 0] < -1e-12)
    inv = 1.0 / torch.where(area.abs() > 1e-12, area, torch.ones_like(area))
    b0 = traster._edge(bx, by, cx, cy, px, py) * inv
    b1 = traster._edge(cx, cy, ax, ay, px, py) * inv
    b2 = traster._edge(ax, ay, bx, by, px, py) * inv
    zp = b0 * az + b1 * bz + b2 * cz
    cov = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & act[:, None, None] & (zp >= 0) & (zp <= 1)
    return torch.where(cov, zp, torch.full_like(zp, float("inf")))


@pytest.mark.parametrize("seed, n_tris, chunk", [(0, 40, 256), (1, 60, 16), (2, 120, 7)])
def test_chunk_raster_matches_the_reference(seed, n_tris, chunk):
    h, w = 48, 40
    clip, active = random_soup(seed, n_tris)
    ref, rclip2, rbary2 = jraster.rasterize(jnp.asarray(clip), jnp.asarray(active), h, w,
                                            chunk=chunk, method="chunk")
    got, clip2, bary2 = traster.rasterize(torch.from_numpy(clip), torch.from_numpy(active), h, w,
                                          chunk, True, "chunk")
    rd, gd = np.asarray(ref.depth), got.depth.numpy()
    assert np.mean((rd < 1.0) == (gd < 1.0)) > 0.99
    both = (rd < 1.0) & (gd < 1.0)
    np.testing.assert_allclose(gd[both], rd[both], atol=2e-3, rtol=0)
    cands = candidate_depths(clip2, torch.ones(clip2.shape[0], dtype=torch.bool)
                             & torch.cat([torch.from_numpy(active)] * 2), h, w)
    two = torch.topk(-cands, 2, dim=0).values.neg()  # the two nearest
    clear = (~torch.isfinite(two[1]) | (two[1] - two[0] > 2e-3)).numpy()
    assert clear.mean() > 0.6  # most pixels are held to the reference's id
    np.testing.assert_array_equal(got.tri_id.numpy()[clear], np.asarray(ref.tri_id)[clear])
    # the tiled raster of the same soup covers the same pixels
    tiled, _, _ = traster.rasterize(torch.from_numpy(clip), torch.from_numpy(active), h, w,
                                    method="tiled", k_per_tile=512, big_budget=128)
    assert np.mean((tiled.depth.numpy() < 1.0) == (gd < 1.0)) > 0.99
    # resolve and interpolate on the reference's own target
    n = clip.shape[0]
    target = traster.RasterTarget(torch.from_numpy(rd.copy()),
                                  torch.from_numpy(np.asarray(ref.tri_id).astype(np.int64)))
    np.testing.assert_allclose(clip2.numpy(), np.asarray(rclip2), atol=1e-6, rtol=1e-6)
    jb, jt, jv = jraster.resolve_barycentrics(rclip2, rbary2, ref, n)
    tb, tt, tv = traster.resolve_barycentrics(clip2, bary2, target, n)
    assert np.array_equal(tt.numpy(), np.asarray(jt)) and np.array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=0)
    rng = np.random.default_rng(seed)
    attrs = rng.normal(size=(64, 5)).astype(np.float32)
    tri_idx = rng.integers(0, 64, (n, 3))
    ji = jraster.interpolate_attribute(jnp.asarray(attrs), jnp.asarray(tri_idx), jt, jb, jv, -1.0)
    ti = traster.interpolate_attribute(torch.from_numpy(attrs), torch.from_numpy(tri_idx), tt, tb,
                                       tv, -1.0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5, rtol=0)


def test_exact_ties_go_to_the_lower_slot_across_chunks():
    h, w = 24, 24
    clip, active = random_soup(5, 12)
    clip = np.concatenate([clip, clip[::-1]])  # every triangle twice, in other chunks
    active = np.concatenate([active, active[::-1]])
    ref, _, _ = jraster.rasterize(jnp.asarray(clip), jnp.asarray(active), h, w, chunk=5,
                                  method="chunk")
    got, _, _ = traster.rasterize(torch.from_numpy(clip), torch.from_numpy(active), h, w, chunk=5,
                                  method="chunk")
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(ref.tri_id))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=2e-3, rtol=0)
    empty = traster.clear_target(h, w, device="cpu")
    jempty = jraster.clear_target(h, w)
    assert np.array_equal(empty.depth.numpy(), np.asarray(jempty.depth))
    assert np.array_equal(empty.tri_id.numpy(), np.asarray(jempty.tri_id))


def test_uni_shadow_visibility_sky_cubemap_and_material_params():
    rng = np.random.default_rng(7)
    depth = rng.uniform(0.2, 0.8, (32, 32)).astype(np.float32)
    vp = orthographic_projection_matrix(-4.0, 4.0, -4.0, 4.0, 0.1, 20.0, device="cpu")
    pos = rng.uniform(-5.0, 5.0, (500, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(-16.0, -2.0, 500)
    got = tlights.uni_shadow_visibility(torch.from_numpy(depth), vp, torch.from_numpy(pos))
    ref = jlights.uni_shadow_visibility(jnp.asarray(depth), jnp.asarray(vp.numpy()),
                                        jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert 0.0 < float(got.mean()) < 1.0

    cube = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(400, 3)).astype(np.float32)
    dirs[:6] = np.eye(3, dtype=np.float32).repeat(2, 0) * np.array([[1], [-1]] * 3, np.float32)
    got = tsky.sample_sky_cubemap(torch.from_numpy(cube), torch.from_numpy(dirs))
    ref = jsky.sample_sky_cubemap(jnp.asarray(cube), jnp.asarray(dirs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    specs = [dict(name="a", color=(0.5, 0.4, 0.3), metalness=0.0, roughness=0.7),
             dict(name="b", color=(1.0, 0.8, 0.3), metalness=1.0, specular_reflectance=0.9,
                  roughness=0.2),
             dict(name="c", color=(1.0, 0.3, 0.05), emissive_luminance=5000.0)]
    vt = rng.integers(-1, 5, (6, 7))
    got = tmat.material_params_for_types(tmat.make_voxel_type_registry(specs, device="cpu"), torch.from_numpy(vt))
    ref = jmat.material_params_for_types(jmat.make_voxel_type_registry(specs), jnp.asarray(vt))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)


def reference_jpeg_box_world():
    """The same box as the reference's entities, its colour texture the JPEG."""
    tex = textured_box_textures()
    tex["checker"] = str(JPEG)
    ids = {k: jregister(f"surface-box-{k}", v) for k, v in tex.items()}
    w = World()
    w.create_entity(C.ReferenceFrame(position=(0.0, 0.0, 0.0), orientation=(0.0, 1.0, 0.0, 0.0)),
                    C.PerspectiveCamera(vertical_field_of_view=np.radians(50),
                                        near_distance=0.01, far_distance=100.0))
    w.create_entity(C.AmbientEmission(illuminance=(3e3, 3e3, 3e3)))
    w.create_entity(C.BoxMesh(), C.ModelTransform(scale=1.4),
                    C.ReferenceFrame(position=(0.0, 0.0, 2.6)),
                    C.UniformColor(color=(0.6, 0.6, 0.6)),
                    C.TexturedColor(texture_id=ids["checker"]),
                    C.NormalMap(texture_id=ids["normal"]),
                    C.ParallaxMap(height_map_texture_id=ids["height"], displacement_scale=0.08))
    w.create_entity(C.UnidirectionalEmission(perpendicular_illuminance=(3e3, 3e3, 3e3),
                                             direction=(0.4, -0.4, 0.8),
                                             angular_source_extent=0.0))
    return w


def test_jpeg_textured_box_matches_reference_render():
    jcfg = textured_box_config(JConfig())
    jrt = JRuntime(jcompile(reference_jpeg_box_world(), jcfg), jcfg, enable_fracturing=False)
    ref = np.asarray(jrt.render())
    cfg = textured_box_config(EngineConfig())
    rt = HeadlessRuntime(compile_scene(textured_box_scene(JPEG), cfg, device="cpu"), cfg,
                         enable_fracturing=False)
    img = rt.render().numpy()
    for a, b in zip(rt.textures.albedo.mips + rt.textures.normal.mips + rt.textures.props.mips,
                    jrt._textures.albedo.mips + jrt._textures.normal.mips
                    + jrt._textures.props.mips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    face = img[28:68, 44:84].astype(np.float32)
    assert face.std(axis=(0, 1)).max() > 8.0
    parity = rgb_hybrid_compare(img, ref)
    assert parity >= PARITY_BAR, parity
    # the JPEG, not the checkerboard, colours the box
    checker = HeadlessRuntime(compile_scene(textured_box_scene(), cfg, device="cpu"), cfg,
                              enable_fracturing=False).render().numpy()
    assert np.abs(checker.astype(int) - img.astype(int)).max() > 8
