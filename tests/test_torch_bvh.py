"""Morton codes, axis-aligned boxes and the object BVH of the port
(``math/morton.py``, ``geometry/aabb.py``, ``geometry/bvh.py``) against
impact_tpu on the CPU, on the same inputs from a numpy seed.

* Morton codes (int64 in the port, uint32 in the reference): equal, on
  random integer coordinates (negative ones and ones past 10 bits
  included: both keep the low 10 bits) and on quantized points in and
  outside the box (truncated toward zero after the clip).
* The eight aabb functions: equal (elementwise min/max, halves, masks;
  the transformed box's einsum within 1e-6).
* ``build_object_bvh`` on random pools with dead slots and tied centres:
  the codes' sort order, every level's ``lo``, ``hi`` and ``active``
  exactly equal (torch's sort is stable, as ``jnp.argsort`` is).
* The reference's own cases (tests/test_math.py TestMorton,
  tests/test_geometry.py TestAabb) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.geometry import aabb as jaabb
from impact_tpu.geometry import bvh as jbvh
from impact_tpu.math import morton as jmorton
from impact_tpu.math import quaternion as jquat
from impact_tpu_torch.geometry import aabb
from impact_tpu_torch.geometry.bvh import build_object_bvh
from impact_tpu_torch.math import morton
from impact_tpu_torch.math import quaternion as quat


def T(a):
    return torch.tensor(np.asarray(a))


def test_morton_encode_matches_reference():
    rng = np.random.default_rng(0)
    ijk = rng.integers(-2000, 3000, size=(3, 500)).astype(np.int32)
    ref = np.asarray(jmorton.morton_encode_3d(*(jnp.asarray(c) for c in ijk)))
    got = morton.morton_encode_3d(*(T(c) for c in ijk)).numpy()
    assert ref.dtype == np.uint32 and got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("bits", [10, 6])
def test_morton_codes_for_points_match_reference(bits):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.5, 2.5, size=(400, 3)).astype(np.float32)
    pts[:50] = np.round(pts[:50] * 4) / 4  # points on quantization steps
    lo, hi = np.float32([-1.0, 0.0, 0.5]), np.float32([2.0, 1.0, 0.5])  # a flat box axis
    ref = np.asarray(jmorton.morton_codes_for_points(jnp.asarray(pts), jnp.asarray(lo),
                                                     jnp.asarray(hi), bits))
    got = morton.morton_codes_for_points(T(pts), T(lo), T(hi), bits).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def _boxes(rng, n):
    lo = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0, 3, size=(n, 3)).astype(np.float32)


def test_aabb_functions_match_reference():
    rng = np.random.default_rng(2)
    lo, hi = _boxes(rng, 40)
    lo2, hi2 = _boxes(rng, 40)
    pts = rng.uniform(-6, 8, size=(40, 3)).astype(np.float32)
    mask = rng.uniform(size=40) < 0.7
    J, P = jnp.asarray, T
    cloud = rng.normal(size=(5, 7, 3)).astype(np.float32)
    for got, ref in [
        (aabb.from_points(P(cloud)), jaabb.from_points(J(cloud))),
        (aabb.from_points(P(cloud), axis=0), jaabb.from_points(J(cloud), axis=0)),
        (aabb.union(P(lo), P(hi), P(lo2), P(hi2)), jaabb.union(J(lo), J(hi), J(lo2), J(hi2))),
        ((aabb.center(P(lo), P(hi)),), (jaabb.center(J(lo), J(hi)),)),
        ((aabb.half_extents(P(lo), P(hi)),), (jaabb.half_extents(J(lo), J(hi)),)),
        ((aabb.contains_point(P(lo), P(hi), P(pts)),),
         (jaabb.contains_point(J(lo), J(hi), J(pts)),)),
        ((aabb.overlaps(P(lo), P(hi), P(lo2), P(hi2)),),
         (jaabb.overlaps(J(lo), J(hi), J(lo2), J(hi2)),)),
        ((aabb.pairwise_overlap_matrix(P(lo), P(hi), P(mask)),),
         (jaabb.pairwise_overlap_matrix(J(lo), J(hi), J(mask)),)),
        (aabb.aabb_of_sphere(P(pts), P(hi[:, 0])), jaabb.aabb_of_sphere(J(pts), J(hi[:, 0]))),
    ]:
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    q = rng.normal(size=(40, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = quat.to_rotation_matrix(P(q))
    jrot = jquat.to_rotation_matrix(J(q))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=1e-6)
    got = aabb.aabb_of_transformed_box(P(lo), P(hi), P(np.asarray(jrot)), P(pts))
    ref = jaabb.aabb_of_transformed_box(J(lo), J(hi), jrot, J(pts))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n, n_levels, seed", [(37, 4, 0), (64, 4, 1), (5, 4, 2), (1, 3, 3),
                                               (100, 6, 4)])
def test_object_bvh_matches_reference(n, n_levels, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    centers[n // 2:n // 2 + n // 4] = centers[0]  # tied centres (tied codes)
    radii = rng.uniform(0.1, 3.0, size=n).astype(np.float32)
    alive = rng.uniform(size=n) < 0.75
    alive[0] = True
    ref = jax.jit(jbvh.build_object_bvh, static_argnums=3)(
        jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(alive), n_levels)
    got = build_object_bvh(T(centers), T(radii), T(alive), n_levels)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref.order))
    assert len(got.lo) == len(ref.lo) == min(n_levels, int(np.log2(n)) + 1)
    for field in ("lo", "hi", "active"):
        for g, r in zip(getattr(got, field), getattr(ref, field)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=field)
    # live objects come first, dead ones (code 0xFFFFFFFF) after them in slot order
    order = got.order.numpy()
    assert alive[order[:alive.sum()]].all()
    np.testing.assert_array_equal(order[alive.sum():], np.flatnonzero(~alive))


# --- the reference's own cases (tests/test_math.py TestMorton,
# tests/test_geometry.py TestAabb) on the port ------------------------------------


def test_encode_ordering():
    def code(i, j, k):
        return int(morton.morton_encode_3d(torch.tensor(i), torch.tensor(j), torch.tensor(k)))

    assert code(0, 0, 0) == 0
    assert code(1, 0, 0) == 1
    assert code(0, 1, 0) == 2
    assert code(0, 0, 1) == 4


def test_points_quantization():
    codes = morton.morton_codes_for_points(torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]),
                                           torch.zeros(3), torch.ones(3))
    assert int(codes[0]) == 0
    assert int(codes[1]) == (1 << 30) - 1


def test_overlap():
    lo = torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    hi = torch.tensor([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0], [1.5, 1.5, 1.5]])
    m = aabb.pairwise_overlap_matrix(lo, hi, torch.ones(3, dtype=torch.bool))
    assert not bool(m[0, 1])  # disjoint
    assert bool(m[0, 2])  # overlapping
    assert not bool(m[2, 0])  # upper triangle only
    m2 = aabb.pairwise_overlap_matrix(lo, hi, torch.tensor([True, True, False]))
    assert not bool(m2[0, 2])  # a masked-out entity makes no pairs


def test_transformed_box():
    r = quat.to_rotation_matrix(quat.from_axis_angle(torch.tensor([0.0, 0.0, 1.0]),
                                                     torch.tensor(np.pi / 4)))
    nlo, nhi = aabb.aabb_of_transformed_box(torch.full((3,), -1.0), torch.ones(3), r,
                                            torch.zeros(3))
    np.testing.assert_allclose(float(nhi[0]), np.sqrt(2.0), atol=1e-5)
    np.testing.assert_allclose(float(nhi[2]), 1.0, atol=1e-5)
