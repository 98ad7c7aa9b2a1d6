"""The port's host tessellation library (``native.py``, built from its own
copy of the C++ source, ``cpp/tessellation.cpp``) against impact_tpu's on
the CPU: the Delaunay tetrahedralizations and Voronoi cells of
``tests/test_native_and_mesh.py`` are equal (the same source, so exact),
and the checks of that file hold. A failed build raises."""

import numpy as np
import pytest

from impact_tpu import native as jnative
from impact_tpu_torch import native as tnative


def clouds():
    rng1, rng2, rng3 = (np.random.default_rng(s) for s in (1, 2, 3))
    return {
        "cube and centre": np.array(
            [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1],
             [1, 1, 1], [0.5, 0.5, 0.5]], np.float32),
        "random 96": rng1.uniform(0, 5, (96, 3)).astype(np.float32),
        "random 24": rng2.uniform(0, 1, (24, 3)).astype(np.float32),
        "random 40": rng3.uniform(0, 5, (40, 3)).astype(np.float32),
        "fracture seeds": np.random.default_rng(3).uniform(-6.0, 6.0, (12, 3)).astype(np.float32),
    }


def tet_volume(pts, t):
    a, b, c, d = pts[t]
    return abs(np.linalg.det(np.stack([b - a, c - a, d - a]))) / 6


@pytest.mark.parametrize("name", list(clouds()))
def test_tessellation_equals_the_reference(name):
    pts = clouds()[name]
    got, ref = tnative.delaunay_tetrahedralize(pts), jnative.delaunay_tetrahedralize(pts)
    assert got.dtype == np.int32 and len(got) > 0
    np.testing.assert_array_equal(got, ref)
    for site in (0, len(pts) // 2):
        cell = tnative.voronoi_cell_vertices(pts, got, site)
        np.testing.assert_array_equal(cell, jnative.voronoi_cell_vertices(pts, ref, site))
        assert len(cell) > 0 and np.isfinite(cell).all()
    vol = sum(tet_volume(pts.astype(np.float64), t) for t in got)
    if name == "cube and centre":
        assert vol == pytest.approx(1.0, abs=1e-4)
    elif name == "random 96":
        from scipy.spatial import ConvexHull

        assert vol == pytest.approx(ConvexHull(pts).volume, rel=1e-3)


def test_delaunay_circumspheres_are_empty():
    pts = clouds()["random 24"].astype(np.float64)
    for t in tnative.delaunay_tetrahedralize(pts.astype(np.float32))[:20]:
        a, b, c, d = pts[t]
        m = 2 * np.stack([b - a, c - a, d - a])
        cc = np.linalg.solve(m, np.array([b @ b - a @ a, c @ c - a @ a, d @ d - a @ a]))
        inside = np.linalg.norm(pts - cc, axis=1) < np.linalg.norm(a - cc) - 1e-5
        inside[t] = False
        assert not inside.any()


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="tessellation build failed"):
        tnative.delaunay_tetrahedralize(clouds()["cube and centre"])
    assert not list(tmp_path.iterdir())
