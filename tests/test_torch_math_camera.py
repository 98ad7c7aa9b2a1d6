"""The port's math, geometry and camera modules against impact_tpu's.

Same numpy-seeded inputs through both packages; tolerance atol 1e-5 (float32
round-off of a few operations on values of order 1–100)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.geometry import frustum as jfr, projection as jproj
from impact_tpu.math import quaternion as jq, transform as jtf
from impact_tpu.render import camera as jcam
from impact_tpu_torch.geometry import frustum as tfr, projection as tproj
from impact_tpu_torch.math import quaternion as tq, transform as ttf
from impact_tpu_torch.render import camera as tcam

ATOL = 1e-5


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_quaternion_ops(seed):
    rng = np.random.default_rng(seed)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    T = torch.from_numpy
    _close(tq.mul(T(q1), T(q2)), jq.mul(jnp.asarray(q1), jnp.asarray(q2)))
    _close(tq.rotate(T(q1), T(v)), jq.rotate(jnp.asarray(q1), jnp.asarray(v)))
    _close(tq.inverse_rotate(T(q1), T(v)), jq.inverse_rotate(jnp.asarray(q1), jnp.asarray(v)))
    m = tq.to_rotation_matrix(T(q1))
    _close(m, jq.to_rotation_matrix(jnp.asarray(q1)))
    # quaternion sign is arbitrary: compare the rotations they produce
    _close(tq.to_rotation_matrix(tq.from_rotation_matrix(m)),
           jq.to_rotation_matrix(jq.from_rotation_matrix(jnp.asarray(m.numpy()))))


@pytest.mark.parametrize("seed", [0, 1])
def test_transforms(seed):
    rng = np.random.default_rng(seed)
    qa, qb = _quats(rng, 8), _quats(rng, 8)
    ta, tb = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(2))
    sa, sb = (rng.uniform(0.5, 2.0, 8).astype(np.float32) for _ in range(2))
    p = rng.normal(size=(8, 3)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    tsa, tsb = ttf.Similarity(T(ta), T(qa), T(sa)), ttf.Similarity(T(tb), T(qb), T(sb))
    jsa, jsb = jtf.Similarity(J(ta), J(qa), J(sa)), jtf.Similarity(J(tb), J(qb), J(sb))
    _close(ttf.sim_apply(ttf.sim_compose(tsa, tsb), T(p)),
           jtf.sim_apply(jtf.sim_compose(jsa, jsb), J(p)), atol=5e-5)
    _close(ttf.sim_to_matrix(tsa), jtf.sim_to_matrix(jsa))
    tia = ttf.Isometry(T(ta), T(qa))
    jia = jtf.Isometry(J(ta), J(qa))
    _close(ttf.iso_apply(ttf.iso_inverse(tia), T(p)), jtf.iso_apply(jtf.iso_inverse(jia), J(p)))


@pytest.mark.parametrize("seed", [0, 1])
def test_projection_and_frustum(seed):
    rng = np.random.default_rng(seed)
    fov, near, far = float(rng.uniform(0.5, 1.5)), 0.05, float(rng.uniform(50, 500))
    aspect = 16 / 9
    pt = tproj.perspective_projection_matrix(aspect, fov, near, far, device="cpu")
    pj = jproj.perspective_projection_matrix(aspect, fov, near, far)
    _close(pt, pj)
    ot = tproj.orthographic_projection_matrix(-3.0, 4.0, -2.0, 5.0, 0.1, 40.0, device="cpu")
    oj = jproj.orthographic_projection_matrix(-3.0, 4.0, -2.0, 5.0, 0.1, 40.0)
    _close(ot, oj)
    nt, dt = tfr.frustum_planes_from_view_proj(pt)
    nj, dj = jfr.frustum_planes_from_view_proj(pj)
    _close(nt, nj)
    _close(dt, dj, atol=1e-4)
    c = rng.normal(size=(64, 3)).astype(np.float32) * 20
    r = rng.uniform(0.1, 3, 64).astype(np.float32)
    np.testing.assert_array_equal(
        tfr.sphere_inside_frustum(nt, dt, torch.from_numpy(c), torch.from_numpy(r)).numpy(),
        np.asarray(jfr.sphere_inside_frustum(nj, dj, jnp.asarray(c), jnp.asarray(r))))


@pytest.mark.parametrize("jitter", [None, 0, 5, 37])
def test_camera_matrices(jitter):
    eye, target = (0.0, 14.0, 34.0), (0.0, 2.0, 0.0)
    qt = tcam.look_at(eye, target)
    qj = jcam.look_at(eye, target)
    _close(qt, qj)
    camt = tcam.Camera(torch.tensor(eye), qt, torch.tensor(np.pi / 3, dtype=torch.float32),
                       torch.tensor(0.05), torch.tensor(500.0))
    camj = jcam.Camera(jnp.asarray(eye, jnp.float32), qj, jnp.float32(np.pi / 3),
                       jnp.float32(0.05), jnp.float32(500.0))
    _close(tcam.view_matrix(camt), jcam.view_matrix(camj), atol=2e-5)
    for ortho in (False, True):
        _close(tcam.projection_matrix(camt, 192, 108, jitter, ortho),
               jcam.projection_matrix(camj, 192, 108, jitter, ortho))
        _close(tcam.view_proj(camt, 1920, 1080, jitter, ortho),
               jcam.view_proj(camj, 1920, 1080, jitter, ortho), atol=5e-5)
