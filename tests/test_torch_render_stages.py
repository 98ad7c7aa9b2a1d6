"""The port's shading and postprocess stages against impact_tpu's on the
same numpy-seeded G-buffer-like inputs: BRDF, sky, AO, TAA, bloom, exposure,
tone mapping and sRGB. Tolerances are relative 1e-4 (float32 round-off
through transcendental functions and convolution sums in another order);
u8 images may differ by one step where a value sits on a rounding edge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.render import brdf as jbrdf, post as jpost, sky as jsky
from impact_tpu_torch.render import brdf as tbrdf, post as tpost, sky as tsky

H, W = 24, 40


def _close(t, j, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_brdf(seed):
    rng = np.random.default_rng(seed)
    n, v, l = (_unit(rng, (H, W, 3)) for _ in range(3))
    albedo = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    f0 = rng.uniform(0.02, 0.9, (H, W, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, (H, W)).astype(np.float32)
    tan_r = rng.uniform(0.0, 0.2, (H, W)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    _close(tbrdf.evaluate_brdf(T(n), T(v), T(l), T(albedo), T(f0), T(rough), T(tan_r)),
           jbrdf.evaluate_brdf(J(n), J(v), J(l), J(albedo), J(f0), J(rough), J(tan_r)),
           rtol=2e-4, atol=1e-5)
    _close(tbrdf.ambient_brdf(T(n), T(v), T(albedo), T(f0), T(rough)),
           jbrdf.ambient_brdf(J(n), J(v), J(albedo), J(f0), J(rough)))


def test_sky():
    q = np.array([0.1, 0.2, -0.05, 0.97], np.float32)
    q /= np.linalg.norm(q)
    rt = tsky.pixel_view_directions(torch.from_numpy(q), 1.0, W, H)
    rj = jsky.pixel_view_directions(jnp.asarray(q), 1.0, W, H)
    _close(rt, rj, atol=1e-6)
    sun = (-0.35, -0.8, -0.48)
    _close(tsky.procedural_sky(rt, sun_direction=sun), jsky.procedural_sky(rj, sun_direction=sun),
           rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("seed", [0, 1])
def test_ambient_occlusion(seed):
    rng = np.random.default_rng(seed)
    z = -rng.uniform(5, 20, (H, W)).astype(np.float32)
    xy = rng.normal(size=(H, W, 2)).astype(np.float32)
    vpos = np.concatenate([xy, z[..., None]], -1)
    vnorm = _unit(rng, (H, W, 3))
    valid = rng.uniform(size=(H, W)) < 0.8
    T, J = torch.from_numpy, jnp.asarray
    _close(tpost.ambient_occlusion(T(vpos), T(vnorm), T(valid), 1.0),
           jpost.ambient_occlusion(J(vpos), J(vnorm), J(valid), 1.0), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_taa_bloom_exposure_tonemap(seed):
    rng = np.random.default_rng(seed)
    cur = rng.uniform(0, 5000, (H, W, 3)).astype(np.float32)
    hist = rng.uniform(0, 5000, (H, W, 3)).astype(np.float32)
    motion = rng.normal(scale=0.02, size=(H, W, 2)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    _close(tpost.temporal_anti_aliasing(T(cur), T(hist), T(motion)),
           jpost.temporal_anti_aliasing(J(cur), J(hist), J(motion)), rtol=1e-4, atol=1e-2)
    for n_down in (2, 4):
        _close(tpost.bloom(T(cur), n_down), jpost.bloom(J(cur), n_down), rtol=1e-4, atol=1e-2)
    avg_t = tpost.average_luminance(T(cur))
    _close(avg_t, jpost.average_luminance(J(cur)))
    exp_t = tpost.exposure_from_average_luminance(avg_t)
    _close(exp_t, jpost.exposure_from_average_luminance(J(avg_t.numpy())))
    assert tpost.manual_exposure(iso=400.0) == pytest.approx(jpost.manual_exposure(iso=400.0))
    for method in ("ACES", "KhronosPBRNeutral", "None"):
        ldr_t = tpost.tonemap(T(cur) * exp_t, method)
        ldr_j = jpost.tonemap(J(cur) * J(exp_t.numpy()), method)
        _close(ldr_t, ldr_j, rtol=1e-4, atol=1e-6)
        u8_t = tpost.to_u8(tpost.to_srgb(ldr_t)).numpy().astype(int)
        u8_j = np.asarray(jpost.to_u8(jpost.to_srgb(ldr_j))).astype(int)
        assert np.abs(u8_t - u8_j).max() <= 1
