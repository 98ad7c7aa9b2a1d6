"""``tpu.bf16_shading`` in the port against impact_tpu on the CPU.

The reference casts the BRDF inputs to bfloat16 when the field is set
(impact_tpu/render/lights.py:389,413-423): the normal, view direction,
albedo, f0, roughness, emissive and occlusion, and each light's direction,
illuminance and angular radius; positions and shadow projections stay
float32. Its XLA program rounds every operation to bfloat16 except the dot
products, which it sums in float32 and rounds once, and it rounds each
Python constant to bfloat16; the port does the same
(``render/brdf.py:_consts``, ``_dot``), so on the same inputs it gives the
reference's jitted values.

* The RON key is carried: ``EngineConfig`` and the render configuration.
* ``shade`` on one bridged G-buffer (the port's geometry pass of
  ShadowableOmnidirectionalLight, handed to both as numpy): the port's
  bfloat16 luminance against impact_tpu's jitted bfloat16 ``shade`` within
  2⁻⁶ of each pixel's magnitude + 1e-6 (bfloat16 keeps 8 significant
  bits); it is not the float32 luminance.
* The frame through the parity harness (128x96, 64² maps): the port's
  bfloat16 frame at least 0.95 against impact_tpu's bfloat16 frame, and not
  equal to the port's float32 frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_parity_scenes_frames import check_frame, port_runtime

from impact_tpu.render import lights as jl
from impact_tpu_torch.render import lights as tl
from impact_tpu_torch.render.pipeline import geometry_pass
from impact_tpu_torch.runtime.setup import render_config_from_engine_config
from impact_tpu_torch.utils.config import EngineConfig

SCENE = "ShadowableOmnidirectionalLight"


def test_ron_key_is_carried():
    assert EngineConfig().tpu.bf16_shading is False
    assert EngineConfig.from_obj({"tpu": {"bf16_shading": True}}).tpu.bf16_shading is True
    cfg = EngineConfig.from_ron_str("(tpu: (bf16_shading: true))")
    assert cfg.tpu.bf16_shading is True
    assert render_config_from_engine_config(cfg).bf16_shading is True
    assert render_config_from_engine_config(EngineConfig()).bf16_shading is False


def test_shade_matches_reference(monkeypatch):
    rt = port_runtime(SCENE, monkeypatch=monkeypatch)
    p = rt.params
    gb, _ = geometry_pass(rt.scene(), p.camera, p.camera, 0, rt.render_config)
    occlusion = torch.full(gb.valid.shape, 0.8)
    args = (gb.world_pos, gb.normal, gb.albedo, gb.f0, gb.roughness, gb.emissive, occlusion,
            p.camera.position, gb.valid)
    got = tl.shade(p.lights, *args, bf16=True).numpy()
    f32 = tl.shade(p.lights, *args).numpy()
    lights = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tuple(p.lights))
    jlights = jl.LightPools(*lights)
    ref = np.asarray(jax.jit(lambda *a: jl.shade(jlights, *a, bf16=True))(
        *(jnp.asarray(a.numpy()) for a in args)))
    mag = np.abs(ref).max(axis=-1, keepdims=True)
    err = np.abs(got - ref)
    print(f"bf16 shade: largest error {float((err / (mag + 1e-6)).max()):.3g} of the pixel's "
          f"magnitude; {int(gb.valid.sum())} covered pixels")
    assert (err <= 2.0 ** -6 * mag + 1e-6).all()
    assert got.dtype == np.float32 and not np.array_equal(got, f32)


def test_frame_matches_reference_and_differs_from_float32(monkeypatch):
    img = check_frame(SCENE, monkeypatch, bf16=True)
    f32 = port_runtime(SCENE, monkeypatch=monkeypatch).render().numpy()
    assert not np.array_equal(img, f32)
