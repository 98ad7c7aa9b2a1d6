"""The port's textures (``impact_tpu_torch/render/textures.py``), the
textured shade branch and the drag-load maps against impact_tpu on the CPU,
on numpy-seeded inputs.

Bars:
* the procedural generators, the entity layers, the voxel-type layers and
  the drag-load tables: equal (the same numpy code);
* mip chains: within 1e-6 (2×2 means summed in another order);
* samples (every wrap mode, nearest and linear, trilinear and triplanar,
  the normal mapping, the parallax offset, the lookup table) at negative
  and wrapping coordinates: within 1e-6;
* the textured shade branch on one G-buffer (voxel-type and full-PBR
  entity layers, metal and dielectric pixels, untextured and sky pixels):
  albedo, normal, f0, roughness and emissive within 1e-5 of what the
  reference's ``deferred_shade`` hands its lighting;
* the port's per-body ``forces.sample_drag_load`` against the reference's
  ``drag_map.sample_drag_load``: within 1e-6 (arccos and atan2 in float32);
* the Lanczos resize of image import against PIL's: within 1e-5.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from impact_tpu.physics import drag_map as jdrag
from impact_tpu.render import pipeline as jpipe
from impact_tpu.render import textures as jtex
from impact_tpu.render.camera import Camera as JCamera
from impact_tpu.scene import mesh as jmesh
from impact_tpu_torch.physics import drag_map as tdrag
from impact_tpu_torch.physics import forces as tforces
from impact_tpu_torch.render import pipeline as tpipe
from impact_tpu_torch.render import textures as ttex
from impact_tpu_torch.render.camera import Camera
from impact_tpu_torch.scene import mesh as tmesh

ATOL = 1e-6
SHADE_ATOL = 1e-5


def T(a):
    return torch.tensor(np.asarray(a))


def close(got, ref, atol=ATOL, what=""):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(ref), atol=atol, rtol=0, err_msg=what)


def test_procedural_textures_are_bit_equal():
    for fn, kw in ((jtex.checkerboard, dict(size=32, tiles=8, color_a=(0.9, 0.1, 0.1))),
                   (jtex.value_noise, dict(size=64, cells=6, seed=5, channels=2)),
                   (jtex.noise_normal_map, dict(size=32, cells=6, seed=2, strength=4.0))):
        np.testing.assert_array_equal(getattr(ttex, fn.__name__)(**kw), fn(**kw))
    rng = np.random.default_rng(0)
    kw = dict(color=rng.uniform(size=(16, 16, 3)).astype(np.float32),
              normal=rng.uniform(size=(8, 8, 3)).astype(np.float32),
              roughness=rng.uniform(size=(32, 32)).astype(np.float32), metalness=0.3,
              specular=rng.uniform(size=(32, 32, 1)).astype(np.float32), emissive=2.0,
              height=rng.uniform(size=(4, 4)).astype(np.float32))
    for got, ref in zip(ttex.build_entity_material_layer(32, **kw),
                        jtex.build_entity_material_layer(32, **kw)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(ttex.build_entity_material_layer(8), jtex.build_entity_material_layer(8)):
        np.testing.assert_array_equal(got, ref)
    va, vn = ttex.default_voxel_texture_arrays(3, 16, device="cpu")
    ja, jn = jtex.default_voxel_texture_arrays(3, 16)
    np.testing.assert_array_equal(va.mips[0].numpy(), np.asarray(ja.mips[0]))
    np.testing.assert_array_equal(vn.mips[0].numpy(), np.asarray(jn.mips[0]))


@pytest.mark.parametrize("shape", [(3, 16, 16, 3), (2, 16, 4, 2), (1, 2, 8, 1)],
                         ids=["square", "wide", "one_wide_levels"])
def test_mip_chains_match_reference(shape):
    layers = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    got, ref = ttex.build_texture_array(layers, device="cpu"), jtex.build_texture_array(layers)
    assert got.n_levels == ref.n_levels
    for a, b in zip(got.mips, ref.mips):
        assert tuple(a.shape) == b.shape
        close(a, b)


def _uv_and_layers(rng, n, n_layers):
    """uv with negative, wrapping and far-out coordinates; layer indices."""
    uv = np.concatenate([rng.uniform(-3.0, 3.0, (n - 4, 2)),
                         [[-0.0, 1.0], [-1e-7, 0.9999999], [17.25, -5.5], [-0.5, 0.5]]])
    return uv.astype(np.float32), rng.integers(0, n_layers, n).astype(np.int32)


@pytest.mark.parametrize("wrap", [jtex.WRAP_REPEAT, jtex.WRAP_MIRROR, jtex.WRAP_CLAMP])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nearest"])
def test_samples_match_reference(wrap, linear):
    rng = np.random.default_rng(2)
    layers = rng.uniform(size=(3, 16, 16, 4)).astype(np.float32)
    tex, jt = ttex.build_texture_array(layers, device="cpu"), jtex.build_texture_array(layers)
    uv, layer = _uv_and_layers(rng, 300, 3)
    lod = rng.uniform(-1.0, 6.0, 300).astype(np.float32)
    for mip_linear in (True, False):
        ts = ttex.SamplerConfig(wrap, linear, mip_linear)
        js = jtex.SamplerConfig(wrap, linear, mip_linear)
        close(ttex.sample_level(tex.mips[1], T(layer), T(uv), ts),
              jtex.sample_level(jt.mips[1], jnp.asarray(layer), jnp.asarray(uv), js), what="level")
        close(ttex.sample_texture_array(tex, T(layer), T(uv), T(lod), ts),
              jtex.sample_texture_array(jt, jnp.asarray(layer), jnp.asarray(uv),
                                        jnp.asarray(lod), js), what="trilinear")
    close(ttex.sample_texture_array(tex, T(layer), T(uv), None),
          jtex.sample_texture_array(jt, jnp.asarray(layer), jnp.asarray(uv), None), what="base")


def test_triplanar_parallax_and_lookup_match_reference():
    rng = np.random.default_rng(3)
    layers = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    tex, jt = ttex.build_texture_array(layers, device="cpu"), jtex.build_texture_array(layers)
    n = 200
    wp = rng.uniform(-9.0, 9.0, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    nrm[:3] = [[0, 1, 0], [0, 0, -1], [1, 0, 0]]
    layer = rng.integers(0, 2, n).astype(np.int32)
    lod = rng.uniform(0.0, 4.0, n).astype(np.float32)
    args_t = (T(layer), T(wp), T(nrm))
    args_j = (jnp.asarray(layer), jnp.asarray(wp), jnp.asarray(nrm))
    close(ttex.triplanar_weights(T(nrm)), jtex.triplanar_weights(jnp.asarray(nrm)))
    close(ttex.sample_triplanar(tex, *args_t, 0.5, T(lod)),
          jtex.sample_triplanar(jt, *args_j, 0.5, jnp.asarray(lod)), what="triplanar")
    close(ttex.triplanar_normal(tex, *args_t, 1.5, 0.5, T(lod)),
          jtex.triplanar_normal(jt, *args_j, 1.5, 0.5, jnp.asarray(lod)), what="normal")
    uv = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    close(ttex.parallax_offset_uv(tex, T(layer), T(uv), T(nrm), 0.08),
          jtex.parallax_offset_uv(jt, jnp.asarray(layer), jnp.asarray(uv), jnp.asarray(nrm), 0.08),
          what="parallax")
    close(ttex.lod_from_scale(T(lod - 1.0)), jtex.lod_from_scale(jnp.asarray(lod - 1.0)))
    values = rng.uniform(size=(5, 7, 3, 2)).astype(np.float32)
    coords = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    close(ttex.LookupTable(T(values)).sample(T(coords)),
          jtex.LookupTable(jnp.asarray(values)).sample(jnp.asarray(coords)), what="lookup")


def _gbuffer(rng, h, w, n_layers):
    """A seeded G-buffer: surfaces at 2-12 m before the camera, unit
    normals, metal and dielectric f0, textured layers, -1 and invalid
    (sky) pixels."""
    wp = np.stack([rng.uniform(-4, 4, (h, w)), rng.uniform(-2, 3, (h, w)),
                   rng.uniform(-12, -2, (h, w))], -1).astype(np.float32)
    nrm = rng.normal(size=(h, w, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    f0 = np.where(rng.uniform(size=(h, w, 1)) < 0.2, 0.9, 0.04).astype(np.float32) * np.ones(3)
    material = rng.integers(-1, n_layers, (h, w)).astype(np.int32)
    valid = rng.uniform(size=(h, w)) < 0.9
    material = np.where(valid, material, -1).astype(np.int32)
    return dict(world_pos=wp, normal=nrm, albedo=rng.uniform(size=(h, w, 3)).astype(np.float32),
                f0=f0.astype(np.float32), roughness=rng.uniform(size=(h, w)).astype(np.float32),
                emissive=rng.uniform(size=(h, w, 3)).astype(np.float32), material=material,
                motion=np.zeros((h, w, 2), np.float32), valid=valid)


def test_textured_shade_branch_matches_reference(monkeypatch):
    """The G-buffer the reference's deferred_shade lights after its textured
    branch (captured at its ``shade`` call) against the port's
    ``apply_textures`` on the same inputs: two voxel-type layers and two
    full-PBR entity layers (a textured colour, normal and parallax map, and
    textured roughness and metalness)."""
    rng = np.random.default_rng(4)
    size, h, w = 16, 24, 32
    ent = [jtex.build_entity_material_layer(
               size, color=jtex.checkerboard(size, 4), normal=jtex.noise_normal_map(size, 4, 1),
               roughness=0.6, metalness=0.0, specular=0.5, emissive=0.0,
               height=jtex.value_noise(size, 4, 9)[..., 0] * 0.08),
           jtex.build_entity_material_layer(
               size, color=(0.8, 0.7, 0.2), roughness=jtex.value_noise(size, 4, 5)[..., 0],
               metalness=jtex.value_noise(size, 4, 6)[..., 0], specular=1.0, emissive=3.0)]
    jset = jtex.build_scene_texture_set(2, ent, size)
    tset = ttex.build_scene_texture_set(2, ent, size, device="cpu")
    for a, b in zip(tset.albedo.mips + tset.normal.mips + tset.props.mips,
                    jset.albedo.mips + jset.normal.mips + jset.props.mips):
        close(a, b)
    np.testing.assert_array_equal(tset.full_pbr.numpy(), np.asarray(jset.full_pbr))
    gb = _gbuffer(rng, h, w, 4)
    cam = dict(position=np.array([0.3, 1.0, 4.0], np.float32),
               orientation=np.array([0.05, 0.02, 0.0, 0.9985], np.float32),
               vertical_fov=np.float32(1.0), near=np.float32(0.05), far=np.float32(100.0))
    cam["orientation"] /= np.linalg.norm(cam["orientation"])
    config = dict(width=w, height=h, textured=True, texture_scale=0.5,
                  normal_map_strength=1.3, ao_enabled=False)
    seen = {}

    def capture(lights, world_pos, normal, albedo, f0, roughness, emissive, *rest, **kw):
        seen.update(normal=normal, albedo=albedo, f0=f0, roughness=roughness, emissive=emissive)
        return jnp.zeros(world_pos.shape, jnp.float32)

    monkeypatch.setattr(jpipe, "shade", capture)
    jgb = jpipe.GBuffer(**{k: jnp.asarray(v) for k, v in gb.items()})
    jpipe.deferred_shade(jgb, None, JCamera(**{k: jnp.asarray(v) for k, v in cam.items()}),
                         None, None, jpipe.RenderConfig(**config), jset)
    got = tpipe.apply_textures(tpipe.GBuffer(**{k: T(v) for k, v in gb.items()}),
                               Camera(**{k: T(v) for k, v in cam.items()}),
                               tpipe.RenderConfig(**config), tset)
    assert int((gb["material"] >= 2).sum()) > 100 and int((gb["material"] == -1).sum()) > 50
    for f in ("albedo", "normal", "f0", "roughness", "emissive"):
        close(getattr(got, f), seen[f], SHADE_ATOL, what=f)


def test_drag_tables_are_bit_equal_and_sampled_alike(tmp_path):
    sph = tmesh.sphere_mesh(radius=0.5, n_rings=12, n_segments=24)
    cap = tmesh.capsule_mesh(radius=0.4, segment_length=1.3, n_rings=8, n_segments=24)
    for got, ref in zip(cap, jmesh.capsule_mesh(radius=0.4, segment_length=1.3, n_rings=8,
                                                n_segments=24)):
        np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(400, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    for m, com in ((sph, (0.0, 0.0, 0.0)), (cap, (0.0, 0.3, 0.1))):
        got = tdrag.build_drag_load_map(m.positions, m.indices, com, n_theta=16, n_phi=32)
        ref = jdrag.build_drag_load_map(m.positions, m.indices, com, n_theta=16, n_phi=32)
        np.testing.assert_array_equal(got.table, np.asarray(ref.table))
        fc, tc = tforces.sample_drag_load(T(got.table)[None].expand(len(d), -1, -1, -1), T(d))
        jfc, jtc = jdrag.sample_drag_load(ref.table, jnp.asarray(d))
        close(fc, jfc)
        close(tc, jtc)
    # the disk cache: the reference's file name and table, read back equal
    a = tdrag.get_or_build_drag_load_map(sph.positions, sph.indices, directory=tmp_path / "t")
    b = jdrag.get_or_build_drag_load_map(sph.positions, sph.indices, directory=tmp_path / "j")
    assert [p.name for p in (tmp_path / "t").iterdir()] == [p.name for p in (tmp_path / "j").iterdir()]
    np.testing.assert_array_equal(a.table, np.asarray(b.table))
    again = tdrag.get_or_build_drag_load_map(sph.positions, sph.indices,
                                             directory=tmp_path / "j")
    np.testing.assert_array_equal(again.table, a.table)


def test_image_layers_match_reference(tmp_path):
    """A PNG layer decoded, linearized and resized (down and up) as the
    reference does it through PIL."""
    from impact_tpu_torch.utils.image import save_png

    img = np.random.default_rng(6).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    path = tmp_path / "layer.png"
    save_png(path, img)
    for res, srgb in ((16, True), (64, False), (None, True)):
        got = ttex.load_image_layer(str(path), res, srgb)
        ref = jtex.load_image_layer(str(path), res, srgb)
        close(got, ref, 1e-5, what=f"{res} {srgb}")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    arr = ttex.texture_array_from_images([buf.getvalue(), str(path)], 32, device="cpu")
    ref = jtex.texture_array_from_images([buf.getvalue(), str(path)], 32)
    for a, b in zip(arr.mips, ref.mips):
        close(a, b, 1e-5)
