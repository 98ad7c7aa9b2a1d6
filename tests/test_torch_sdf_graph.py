"""The port's atomic SDF graphs (``voxel/sdf.py``) against impact_tpu's on
the CPU.

Every node kind (the sphere, box and capsule primitives; the translation,
rotation and scaling transforms; union, subtraction and intersection, sharp
and smooth; the multifractal noise modifier) and nested graphs, each built
by both packages' constructors (equal dicts), at seeded points in [-6, 6)³:

* ``evaluate`` (the port's in torch, the reference's in JAX) within 1e-5
  absolute: the same float32 operations, with reductions that may round
  in another order;
* ``evaluate_np`` equal: both are the same numpy operations;
* ``estimate_bounds`` equal;
* a graph saved by either package loads in the other as an equal dict;
* ``validate`` rejects what the reference rejects, with the same error.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.voxel import sdf as jsdf
from impact_tpu_torch.voxel import sdf as tsdf

ATOL = 1e-5
Q = (0.1825742, 0.3651484, 0.5477226, 0.7302967)  # a unit quaternion, (x, y, z, w)


def graphs(m):
    """name → graph, built with module ``m``'s constructors."""
    s, b, c = m.sphere(1.5), m.box((2.0, 1.0, 3.0)), m.capsule(0.7, 2.5)
    out = {"sphere": s, "box": b, "capsule": c,
           "translation": m.translation(b, (1.0, -0.5, 2.0)),
           "rotation": m.rotation(c, Q),
           "scaling": m.scaling(b, 1.7),
           "noise": m.noise_modifier(s, octaves=3, frequency=0.9, lacunarity=2.1,
                                     persistence=0.45, amplitude=0.6, seed=11)}
    for op in ("union", "subtraction", "intersection"):
        for sm in (0.0, 0.8):
            out[f"{op}_{sm}"] = getattr(m, op)(m.translation(s, (0.6, 0.0, 0.0)), b, sm)
    inner = m.union(m.rotation(m.translation(c, (0.0, 1.0, 0.0)), Q),
                    m.scaling(m.subtraction(b, s, 0.3), 0.8), 0.5)
    out["nested_smooth"] = m.noise_modifier(
        m.intersection(inner, m.sphere(3.0), 0.4), octaves=2, frequency=0.5, amplitude=0.3,
        seed=3)
    out["nested_sharp"] = m.subtraction(m.union(inner, m.translation(s, (-2.0, 0.0, 1.0))),
                                        m.rotation(m.box((0.5, 4.0, 0.5)), Q))
    return out


NAMES = list(graphs(tsdf))


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(0).uniform(-6.0, 6.0, size=(4096, 3)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_graph_matches_reference(name, points):
    got, ref = graphs(tsdf)[name], graphs(jsdf)[name]
    assert got == ref
    d_got = tsdf.evaluate(got, torch.from_numpy(points)).numpy()
    d_ref = np.asarray(jsdf.evaluate(ref, jnp.asarray(points)))
    assert d_got.dtype == np.float32 and d_got.shape == (len(points),)
    np.testing.assert_allclose(d_got, d_ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tsdf.evaluate_np(got, points), jsdf.evaluate_np(ref, points))
    for a, b in zip(tsdf.estimate_bounds(got), jsdf.estimate_bounds(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_saved_graph_loads_in_the_other_package(saver, tmp_path):
    path = tmp_path / "graph.json"
    g = graphs(tsdf)["nested_smooth"]
    save, load = ((tsdf.save_graph, jsdf.load_graph) if saver == "port"
                  else (jsdf.save_graph, tsdf.load_graph))
    save(path, g)
    loaded = load(path)
    assert loaded == json.loads(json.dumps(g))
    p = np.random.default_rng(1).uniform(-4.0, 4.0, size=(512, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsdf.evaluate_np(loaded, p), jsdf.evaluate_np(g, p))


BAD = {
    "not a dict": [1, 2],
    "no kind": {"radius": 1.0},
    "unknown kind": {"kind": "torus", "radius": 1.0},
    "unknown child": {"kind": "translation", "offset": (0, 0, 0),
                      "child": {"kind": "cone"}},
    "bad grandchild": {"kind": "union", "smoothness": 0.0,
                       "children": [{"kind": "sphere", "radius": 1.0},
                                    {"kind": "scaling", "scale": 2.0, "child": 3}]},
}


@pytest.mark.parametrize("what", list(BAD))
def test_validate_rejects_what_the_reference_rejects(what):
    with pytest.raises(ValueError) as ref:
        jsdf.validate(BAD[what])
    with pytest.raises(ValueError) as got:
        tsdf.validate(BAD[what])
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown SDF node kind"):
        tsdf.evaluate({"kind": "torus"}, torch.zeros(1, 3))


def test_validate_accepts_every_kind():
    for name, g in graphs(tsdf).items():
        assert tsdf.validate(g) is g and jsdf.validate(g) is g, name
