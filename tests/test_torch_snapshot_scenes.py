"""The snapshot tester's scenes in the port, against impact_tpu and the
committed goldens, on the CPU (part 1 of 3; the files split the frames so
that ``--dist loadfile`` spreads them over workers).

* Scene compile: the port's ``compile_scene`` of Blank, BallPit and the
  RenderingTest arrangement (its light kinds, the emissive sphere) against
  the reference's: body kinds, masses and inertias, poses, collidable and
  force pools, lights, mesh instances and their baked corners, the voxel
  pool and the contact responses. Bars: equal, or within 1e-6 for floats
  computed by the same formulas; the voxel bodies' mass properties are
  float32 sums over ~10⁴ voxels taken in another order (relative 1e-4, as
  tests/test_torch_engine_step.py holds them, and an absolute 1e-6 of the
  field's largest magnitude for the off-diagonal inertia of ~0).
* PNG: ``utils/image.py:load_png`` equal to PIL on every golden and on
  images written with each of the five scanline filters.
* The runner's scene table equals the reference harness's, all 20 scenes
  run, and ``TexturedMaterials`` builds and renders.
* Frames: each scene through the runner on the CPU (K1's plain version,
  the runner's scored frame, with windows fit to each view so that nothing
  drops), scored against its golden at ≥ 0.93; Blank and BallPit also hold
  it against the plain tile raster's frame of the same state at ≥ 0.95, the
  runner's side check.
"""

import functools
import importlib.util
import pathlib
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

from impact_tpu.models import SCENES as JSCENES
from impact_tpu.models import rendering_test as jrendering_test
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu_torch.apps import snapshot_tester as st
from impact_tpu_torch.models import SCENES
from impact_tpu_torch.physics.state import KIND_DYNAMIC
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.utils.image import load_png, rgb_hybrid_compare

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def reference_harness():
    """The reference's apps/snapshot_tester.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location("reference_snapshot_tester",
                                                  ROOT / "apps" / "snapshot_tester.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scene_args(name):
    """(reference world, port world, harness config mutator) of a scene
    name, or of ("RenderingTest", kwargs)."""
    if isinstance(name, tuple):
        kwargs = dict(name[1])
        return jrendering_test(**kwargs), SCENES["RenderingTest"](**kwargs)
    return JSCENES[name](), SCENES[name]()


@functools.lru_cache(maxsize=None)
def reference_build(name):
    world, _ = _scene_args(name)
    return jcompile(world, reference_harness()._snapshot_config())


def port_build(name):
    _, scene = _scene_args(name)
    return compile_scene(scene, st.snapshot_config(), device="cpu")


def _close(got, ref, what, atol=1e-6, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if got.dtype == np.bool_ or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=what)


SCENE_CASES = ["Blank", "BallPit",
               ("RenderingTest", (("emissive_sphere", True),)),
               ("RenderingTest", (("ambient", (0, 0, 0)), ("omni", "plain"), ("uni", "plain"),
                                  ("omni_extent", 2.0)))]


@pytest.mark.parametrize("name", SCENE_CASES, ids=["Blank", "BallPit", "RenderingTest_emissive",
                                                   "RenderingTest_plain_lights"])
def test_scene_compile_matches_reference(name):
    ref, got = reference_build(name), port_build(name)
    rb, gb = ref.sim.phys.bodies, got.sim.phys.bodies
    voxel = np.zeros(rb.kind.shape[0], bool)
    voxel[np.asarray(ref.sim.voxels.body_index)] = True
    for f in rb._fields:
        a, b = getattr(gb, f), np.asarray(getattr(rb, f))
        # voxel bodies: mass properties and COM-shifted poses are float32
        # sums over the voxels in another order
        _close(a[~voxel], b[~voxel], f)
        _close(a[voxel], b[voxel], f"voxel {f}", rtol=1e-4,
               atol=1e-6 * max(float(np.abs(b[voxel]).max(initial=0.0)), 1.0))
    rp, gp = ref.params, got.params
    for group in ("collidables", "forces"):
        ra, ga = getattr(rp.phys_params, group), getattr(gp.phys_params, group)
        for f in ga._fields:
            _close(getattr(ga, f), getattr(ra, f), f"{group}.{f}")
    for f in gp.lights._fields:
        _close(getattr(gp.lights, f), getattr(rp.lights, f), f"lights.{f}")
    for f in gp.mesh_instances._fields:
        _close(getattr(gp.mesh_instances, f), getattr(rp.mesh_instances, f),
               f"mesh_instances.{f}")
    for f in ("voxel_response", "fracturable", "type_density", "material_table"):
        _close(getattr(gp, f), getattr(rp, f), f)
    for f in ("alive", "body_index", "voxel_extent", "sdf", "vtype", "casts_shadows"):
        _close(getattr(got.sim.voxels, f), getattr(ref.sim.voxels, f), f"voxels.{f}")
    _close(got.sim.voxels.origin, ref.sim.voxels.origin, "voxels.origin", rtol=1e-4)
    for k, a in (gp.static_geometry.corners or {}).items():
        _close(a, rp.static_geometry.corners[k], f"static corners {k}")
    assert got.info["n_voxel_objects"] == ref.info["n_voxel_objects"]
    assert got.info["n_regular_bodies"] == ref.info["n_regular_bodies"]


def test_inertia_and_meshes_match_reference():
    """physics/inertia.py and scene/mesh.py against the reference's: masses
    in double precision equal, tensors equal, meshes equal."""
    import jax.numpy as jnp

    from impact_tpu.physics import inertia as jinertia
    from impact_tpu.scene import mesh as jmesh
    from impact_tpu_torch.physics import inertia as tinertia
    from impact_tpu_torch.scene import mesh as tmesh

    assert tinertia.sphere_mass(1200.0, 0.5) == float(jinertia.sphere_mass(1200.0, 0.5))
    assert tinertia.capsule_mass(3.0, 0.5, 2.0) == float(jinertia.capsule_mass(3.0, 0.5, 2.0))
    ext = np.array([1.0, 2.0, 3.5], np.float32)
    _close(tinertia.box_mass(2.0, torch.from_numpy(ext)), jinertia.box_mass(2.0, jnp.asarray(ext)),
           "box mass")
    m, r, length = np.float32(5.0), np.float32(0.5), np.float32(2.0)
    for got, ref in (
        (tinertia.sphere_inertia(torch.tensor(m), torch.tensor(r)),
         jinertia.sphere_inertia(jnp.asarray(m), jnp.asarray(r))),
        (tinertia.box_inertia(torch.tensor(m), torch.from_numpy(ext)),
         jinertia.box_inertia(jnp.asarray(m), jnp.asarray(ext))),
        (tinertia.capsule_inertia(torch.tensor(m), torch.tensor(r), torch.tensor(length)),
         jinertia.capsule_inertia(jnp.asarray(m), jnp.asarray(r), jnp.asarray(length))),
    ):
        _close(got, ref, "inertia", rtol=1e-6)
    for fn, args in ((tmesh.box_mesh, ((1.0, 2.0, 3.0),)), (tmesh.sphere_mesh, (1.0, 12, 26))):
        got, ref = fn(*args), getattr(jmesh, fn.__name__)(*args)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    sph = tmesh.sphere_mesh(1.0, 6, 14)
    np.testing.assert_array_equal(tmesh.compute_vertex_normals(sph.positions, sph.indices),
                                  jmesh.compute_vertex_normals(sph.positions, sph.indices))


def test_rendering_test_objects_start_kinematic_and_sync_dynamic():
    """RenderingTest's objects carry no DynamicVoxels: their bodies start
    kinematic, and the setup's mass sync makes every voxel body with mass
    dynamic, in both packages; they carry no collidable either (zero
    contact response)."""
    got = port_build(("RenderingTest", ()))
    bi = got.sim.voxels.body_index[:3]
    assert bool((got.sim.phys.bodies.kind[bi] == KIND_DYNAMIC).all())
    assert float(got.params.voxel_response.abs().sum()) == 0.0
    assert not got.params.phys_params.forces.const_accel_mask.any()


def test_empty_scene_compiles_and_renders():
    build = port_build("Blank")
    assert build.info["n_voxel_objects"] == 0
    assert int(build.meshes.tri_active.sum()) == 0
    assert build.params.static_geometry.tri_active.shape[0] == 0
    assert build.params.mesh_instances.alive.shape[0] == 0


def test_scene_table_matches_the_reference_harness():
    ref = reference_harness()
    assert st.TEST_SCENES == ref.TEST_SCENES
    assert list(st.FEATURE_SCENES) == list(ref.FEATURE_SCENES)
    for name, (kwargs, _) in st.FEATURE_SCENES.items():
        assert kwargs == ref.FEATURE_SCENES[name][0], name
    assert st.MIN_SCORE_TO_PASS == ref.MIN_SCORE_TO_PASS
    assert st.PORTED_SCENES == st.ALL_SCENES and st.NOT_PORTED == ()
    assert len(st.PORTED_SCENES) == 20


def test_textured_materials_raise_until_the_next_slice():
    """TexturedMaterials raised until the textured shade path was ported;
    the same calls now build it and render it (here at 64x48)."""
    rt = st.build_runtime("TexturedMaterials", "cpu")
    assert rt.render_config.textured and rt.textures is not None
    cfg = st.snapshot_config()
    cfg.tpu.textured_voxels = True
    cfg.tpu.render_width, cfg.tpu.render_height = 64, 48
    rt = HeadlessRuntime(compile_scene(SCENES["RenderingTest"](), cfg, device="cpu"), cfg)
    img = rt.render()
    assert img.shape == (48, 64, 3) and rt.textures.albedo.n_layers == 3
    assert bool((rt.last_gbuffer.material >= 0).any())


def test_load_png_equals_pil_on_every_golden():
    goldens = sorted((ROOT / "apps" / "snapshots" / "reference").glob("*.png"))
    assert len(goldens) == 20
    for path in goldens:
        np.testing.assert_array_equal(load_png(path), np.asarray(Image.open(path).convert("RGB")),
                                      err_msg=path.name)


def _png_with_filter(img, kind):
    """An 8-bit RGB(A) PNG of ``img`` whose every row uses filter ``kind``."""
    h, w, ch = img.shape
    x = img.reshape(h, w * ch).astype(np.int64)
    up = np.vstack([np.zeros((1, w * ch), np.int64), x[:-1]])
    left = np.hstack([np.zeros((h, ch), np.int64), x[:, :-ch]])
    upleft = np.hstack([np.zeros((h, ch), np.int64), up[:, :-ch]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.hstack([np.full((h, 1), kind, np.int64), (x - pred) & 0xFF]).astype(np.uint8)

    def chunk(tag, body):
        return (len(body).to_bytes(4, "big") + tag + body
                + (zlib.crc32(tag + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2 if ch == 3 else 6, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("channels", [3, 4])
def test_load_png_reads_every_filter(kind, channels, tmp_path):
    rng = np.random.default_rng(kind * 10 + channels)
    img = rng.integers(0, 256, (19, 23, channels), dtype=np.uint8)
    img[4:9, 3:17] = img[4, 3]  # runs that the filters predict exactly
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filter(img, kind))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(load_png(path), img[..., :3])


def test_save_png_round_trips_through_pil(tmp_path):
    from impact_tpu_torch.utils.image import save_png

    img = np.random.default_rng(3).integers(0, 256, (7, 11, 3), dtype=np.uint8)
    save_png(tmp_path / "s.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "s.png")), img)


def check_frame(name):
    """The scene through the port's runner on the CPU: its K1 frame (the
    kernel's plain version on CPU tensors) against its golden at the
    harness's bar, with no raster drops."""
    img, rt = st.render_scene(name, "cpu")
    score = st.score(name, img)
    assert score >= st.MIN_SCORE_TO_PASS, (name, score, rt.last_drops)
    assert rt.last_drops == (0, 0)
    assert all(bool(torch.isfinite(getattr(rt.sim.phys.bodies, f)).all())
               for f in ("position", "orientation", "momentum"))
    return img, rt


@pytest.mark.parametrize("name", ["Blank", "BallPit"])
def test_frame_matches_golden(name):
    img, rt = check_frame(name)
    # the runner's side check: the plain tile raster's frame of the same state
    parity = rgb_hybrid_compare(img, st.render_again(rt, "raster"))
    assert parity >= st.RASTER_PARITY_BAR, (name, parity)
