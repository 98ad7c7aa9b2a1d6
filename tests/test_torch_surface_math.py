"""The math and geometry names of the reference's surface against
impact_tpu on the CPU, on the same numpy inputs: float results within 1e-6
of magnitude (1e-5 where the port's einsum or norm sums in another order),
integer and boolean results equal."""

import jax.numpy as jnp
import numpy as np
import torch

from impact_tpu.geometry import frustum as jfrustum
from impact_tpu.geometry import primitives as jprim
from impact_tpu.geometry import projection as jproj
from impact_tpu.math import quaternion as jquat
from impact_tpu.math import random as jrandom
from impact_tpu.math import transform as jtf
from impact_tpu_torch.geometry import frustum as tfrustum
from impact_tpu_torch.geometry import primitives as tprim
from impact_tpu_torch.geometry import projection as tproj
from impact_tpu_torch.math import quaternion as tquat
from impact_tpu_torch.math import random as trandom
from impact_tpu_torch.math import transform as ttf

RNG = np.random.default_rng(11)


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, tol=1e-6):
    r = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), r, rtol=0,
                               atol=tol * max(1.0, float(np.abs(r).max())))


def unit_quats(n):
    q = f32(n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_axis_angle_slerp_and_constants():
    q = unit_quats(64)
    q[0] = [0.0, 0.0, 0.0, 1.0]  # the identity takes the x axis
    q[1] = [0.0, 0.0, 0.0, -1.0]
    for g, r in zip(tquat.to_axis_angle(T(q)), jquat.to_axis_angle(jnp.asarray(q))):
        close(g, r, 1e-5)
    q1 = unit_quats(64)
    q1[:4] = q[:4]  # equal ends: the small-angle branch
    for t in (0.0, 0.3, 1.0):
        close(tquat.slerp(T(q), T(q1), t), jquat.slerp(jnp.asarray(q), jnp.asarray(q1), t), 1e-5)
    tt = np.linspace(0, 1, 64, dtype=np.float32)[:, None]
    close(tquat.slerp(T(q), T(q1), T(tt)), jquat.slerp(jnp.asarray(q), jnp.asarray(q1), tt), 1e-5)
    assert np.array_equal(tquat.IDENTITY.numpy(), jquat.IDENTITY)
    close(tquat.inverse(T(q)), jquat.inverse(jnp.asarray(q)))


def test_splitmix64():
    assert trandom.splitmix64_next(0) == jrandom.splitmix64_next(0)
    assert trandom.splitmix64_next(2 ** 64 - 1) == jrandom.splitmix64_next(2 ** 64 - 1)
    for seed in (0, 1, 12345, 2 ** 63 + 7):
        got, ref = trandom.splitmix64_sequence(seed, 40), jrandom.splitmix64_sequence(seed, 40)
        assert got.dtype == ref.dtype == np.uint64 and np.array_equal(got, ref)
    assert trandom.MASK64 == jrandom.MASK64


def test_isometry_and_similarity_names():
    q, t, v = unit_quats(16), f32(16, 3), f32(16, 3)
    s = np.abs(f32(16)) + 0.5
    iso_t, iso_j = ttf.Isometry(T(t), T(q)), jtf.Isometry(jnp.asarray(t), jnp.asarray(q))
    close(ttf.iso_apply_vector(iso_t, T(v)), jtf.iso_apply_vector(iso_j, jnp.asarray(v)), 1e-5)
    sim_t = ttf.Similarity(T(t), T(q), T(s))
    sim_j = jtf.Similarity(jnp.asarray(t), jnp.asarray(q), jnp.asarray(s))
    close(ttf.sim_apply_vector(sim_t, T(v)), jtf.sim_apply_vector(sim_j, jnp.asarray(v)), 1e-5)
    for g, r in zip(ttf.sim_inverse(sim_t), jtf.sim_inverse(sim_j)):
        close(g, r, 1e-5)
    for g, r in zip(ttf.sim_from_iso(iso_t), jtf.sim_from_iso(iso_j)):
        close(g, r)


def test_geometry_names():
    vp = np.asarray(jproj.perspective_projection_matrix(1.3, 0.9, 0.1, 50.0), np.float32)
    normals, disp = tfrustum.frustum_planes_from_view_proj(T(vp))
    lo = f32(100, 3) * 20
    hi = lo + np.abs(f32(100, 3)) * 5
    got = tfrustum.aabb_inside_frustum(normals, disp, T(lo), T(hi))
    ref = jfrustum.aabb_inside_frustum(jnp.asarray(normals.numpy()), jnp.asarray(disp.numpy()),
                                       jnp.asarray(lo), jnp.asarray(hi))
    assert np.array_equal(got.numpy(), np.asarray(ref)) and 0 < int(got.sum()) < 100
    n = f32(50, 3)
    p = f32(50, 3) * 3
    d = f32(50)
    close(tprim.plane_signed_distance(T(n), T(d), T(p)),
          jprim.plane_signed_distance(jnp.asarray(n), jnp.asarray(d), jnp.asarray(p)))
    c, r = f32(50, 3), np.abs(f32(50))
    close(tprim.sphere_sdf(T(c), T(r), T(p)),
          jprim.sphere_sdf(jnp.asarray(c), jnp.asarray(r), jnp.asarray(p)), 1e-5)
    he = np.abs(f32(3)) + 0.5
    close(tprim.box_sdf(T(he), T(p)), jprim.box_sdf(jnp.asarray(he), jnp.asarray(p)), 1e-5)
    proj = np.asarray(jproj.perspective_projection_matrix(1.5, 1.0, 0.1, 30.0))
    pts = f32(80, 3)
    pts[:, 2] = -np.abs(pts[:, 2]) * 10 - 0.2
    pts[0] = [0.0, 0.0, 0.0]  # w = 0: the guarded divide
    for g, r in zip(tproj.project_points(T(proj), T(pts)),
                    jproj.project_points(jnp.asarray(proj), jnp.asarray(pts))):
        close(g, r, 1e-5)
    depth = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    close(tproj.view_z_from_depth(T(depth), 0.1, 30.0),
          jproj.view_z_from_depth(jnp.asarray(depth), 0.1, 30.0), 1e-6)
