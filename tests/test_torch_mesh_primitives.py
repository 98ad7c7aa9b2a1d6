"""The port's triangle meshes (``scene/mesh.py``) against impact_tpu's on
the CPU.

Every procedural primitive, at the parameters of
``tests/test_native_and_mesh.py`` and at each function's defaults:
positions and normals within 1e-6 absolute, indices equal. OBJ files (with
normals, without them, with quads and polygons, with negative indices) and
ASCII PLY files (with normals, without them, with quads) written to a
temporary directory load equally in both packages. ``mesh_to_static_geometry``
gives the reference's arrays.
"""

import numpy as np
import pytest

from impact_tpu.scene import mesh as jmesh
from impact_tpu_torch.scene import mesh as tmesh

ATOL = 1e-6

PRIMITIVES = [
    ("box_mesh", dict(extents=(2.0, 1.0, 3.0))),
    ("sphere_mesh", dict(radius=2.0, n_rings=32, n_segments=64)),
    ("cylinder_mesh", dict(radius=1.0, length=2.0, n_segments=64)),
    ("cone_mesh", dict(radius=1.0, length=3.0, n_segments=64)),
    ("capsule_mesh", dict(radius=1.0, segment_length=2.0, n_rings=24, n_segments=48)),
    ("hemisphere_mesh", dict(radius=1.5, n_rings=8, n_segments=18)),
    ("rectangle_mesh", dict(width=3.0, depth=2.0)),
    ("circular_frustum_mesh", dict(bottom_radius=0.7, top_radius=0.2, length=1.3,
                                   n_segments=11)),
] + [(name, {}) for name in ("box_mesh", "rectangle_mesh", "sphere_mesh", "hemisphere_mesh",
                             "cylinder_mesh", "cone_mesh", "capsule_mesh", "screen_quad_mesh",
                             "circular_frustum_mesh")]


def assert_meshes_equal(got, ref):
    assert [a.dtype for a in got] == [np.float32, np.float32, np.int32]
    assert got.positions.shape == ref.positions.shape
    np.testing.assert_allclose(got.positions, ref.positions, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.normals, ref.normals, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.indices, ref.indices)


@pytest.mark.parametrize("name,kw", PRIMITIVES,
                         ids=[f"{n}-{'defaults' if not kw else 'params'}" for n, kw in PRIMITIVES])
def test_primitive_matches_reference(name, kw):
    assert_meshes_equal(getattr(tmesh, name)(**kw), getattr(jmesh, name)(**kw))


def write_obj(path, mesh, normals=True, negative=False):
    with open(path, "w") as f:
        f.write("# a test mesh\no shape\n")
        for v in mesh.positions:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if normals:
            for n in mesh.normals:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        nv = len(mesh.positions)
        for t in mesh.indices:
            refs = [int(i) - nv if negative else int(i) + 1 for i in t]
            f.write("f " + " ".join(f"{r}//{r}" if normals else str(r) for r in refs) + "\n")


OBJ_CASES = {
    "with normals": lambda p: write_obj(p, jmesh.cylinder_mesh(n_segments=9)),
    "without normals": lambda p: write_obj(p, jmesh.cone_mesh(n_segments=7), normals=False),
    "negative indices": lambda p: write_obj(p, jmesh.box_mesh((1.0, 2.0, 0.5)), negative=True),
    "quads and a pentagon": lambda p: p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\nv 0 0 1\nv 1 0 1\n"
        "f 1 2 3 4\nf 1/1/1 6/2/1 7/3/1 2/4/1\nf 1 2 3 5 4\n"),
}


@pytest.mark.parametrize("case", list(OBJ_CASES))
def test_obj_loads_as_reference(case, tmp_path):
    path = tmp_path / "mesh.obj"
    OBJ_CASES[case](path)
    got, ref = tmesh.load_obj(path), jmesh.load_obj(path)
    assert_meshes_equal(got, ref)
    if case == "quads and a pentagon":
        assert len(got.indices) == 2 + 2 + 3


def ply_text(mesh, normals, quads=False):
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals else [])
    faces = ([[int(a), int(b), int(c), int(d)] for (a, b, c), (_, _, d) in
              zip(mesh.indices[0::2], mesh.indices[1::2])] if quads
             else mesh.indices.tolist())
    lines = ["ply", "format ascii 1.0", "comment a test mesh", f"element vertex {len(mesh.positions)}"]
    lines += [f"property float {p}" for p in props]
    lines += [f"element face {len(faces)}", "property list uchar int vertex_indices", "end_header"]
    for v, n in zip(mesh.positions, mesh.normals):
        vals = list(v) + (list(n) if normals else [])
        lines.append(" ".join(repr(float(x)) for x in vals))
    lines += [" ".join(str(x) for x in [len(f)] + f) for f in faces]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("normals,quads", [(True, False), (False, False), (False, True)],
                         ids=["with normals", "without normals", "quads"])
def test_ply_loads_as_reference(normals, quads, tmp_path):
    path = tmp_path / "mesh.ply"
    path.write_text(ply_text(jmesh.box_mesh((2.0, 1.0, 3.0)), normals, quads))
    got, ref = tmesh.load_ply(path), jmesh.load_ply(path)
    assert_meshes_equal(got, ref)
    assert len(got.indices) == 12


def test_binary_ply_is_refused(tmp_path):
    path = tmp_path / "mesh.ply"
    path.write_text("ply\nformat binary_little_endian 1.0\nelement vertex 0\nend_header\n")
    with pytest.raises(ValueError, match="only ASCII"):
        tmesh.load_ply(path)


def test_static_geometry_matches_reference():
    m = jmesh.cone_mesh(n_segments=10)
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    transform = ((1.0, 2.0, 3.0), rot, 1.5)
    got = tmesh.mesh_to_static_geometry(tmesh.cone_mesh(n_segments=10), albedo=(0.2, 0.3, 0.4),
                                        f0=0.05, roughness=0.4, emissive=(1.0, 0.0, 0.0),
                                        transform=transform, device="cpu")
    ref = jmesh.mesh_to_static_geometry(m, albedo=(0.2, 0.3, 0.4), f0=0.05, roughness=0.4,
                                        emissive=(1.0, 0.0, 0.0), transform=transform)
    for f in ref._fields:
        r = getattr(ref, f)
        if r is None:
            continue
        g = getattr(got, f).numpy()
        np.testing.assert_allclose(g, np.asarray(r), atol=ATOL, rtol=0, err_msg=f)
