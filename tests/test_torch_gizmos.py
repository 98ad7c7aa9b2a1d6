"""The port's gizmos (``render/gizmos.py``, the line-segment meshes of
``scene/mesh.py`` and the runtime's gizmo overlay) against impact_tpu on the
CPU.

Part 1, ``build_gizmo_lines``: one small state with two voxel boxes, sphere,
capsule and plane colliders of all three kinds (dynamic, static, phantom),
a ball joint, a shadowable omni light, a shadowable directional light with
2 cascades and active contacts. The reference compiles it, the bridge
carries it into the port, the port steps it twice (so that bodies move and
contacts are active), and the stepped body, contact, voxel and probe state
is handed back to the reference by field name. Each of the 22 kinds alone
(the 21 of ``ALL_GIZMO_TYPES`` and ``colliders``): starts and ends within
rtol 1e-5 and an atol of 1e-6 of each field's magnitude, colours within
1e-6, ``active`` equal.

Part 2, ``overlay_lines``: seeded crossing lines through a perspective
view-projection over a seeded image: the u8 frame equal to the reference's
on at least 99.9 % of the pixels that either one writes (a sample on a
pixel edge may round the other way: the reference's einsum sums in another
order; the count that differs is printed); and lines through exactly
computed pixels (identity view-projection, dyadic endpoints, 5 samples),
where every pixel is equal, the last line in order winning where lines
cross, as the reference's scatter applies its updates in order.

Part 3: ``wireframe_of`` and ``line_mesh_to_gizmo_lines`` equal to the
reference's; the runtime's ``show``/``hide``/``set_visible`` and its frames
(tests/test_runtime_features.py:53-81): an overlaid frame differs from the
base frame, hiding every kind gives the base frame back, all 21 kinds
draw.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_parity_scenes import cache_small_compiles, jcompile  # noqa: F401
from test_torch_runtime_services import tiny_runtime

from impact_tpu.ecs import World
from impact_tpu.ecs import components as C
from impact_tpu.render import gizmos as jgizmos
from impact_tpu.scene import mesh as jmesh
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch import bridge
from impact_tpu_torch.render import gizmos
from impact_tpu_torch.render.camera import projection_matrix, view_matrix
from impact_tpu_torch.runtime import HeadlessRuntime
from impact_tpu_torch.scene import mesh
from impact_tpu_torch.utils.config import EngineConfig

ASPECT, CASCADES = 4.0 / 3.0, 2
KINDS = gizmos.ALL_GIZMO_TYPES + (gizmos.GIZMO_COLLIDERS,)


def configure(cfg):
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 4, 24, 64, 16
    t.render_width, t.render_height = 64, 48
    t.csm_cascades = CASCADES
    cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = 64
    cfg.physics.rigid_body_force.drag_load_map_config.directory = None
    return cfg


def gizmo_world():
    w = World()
    w.create_entity(C.ReferenceFrame(position=(0.0, 4.0, 18.0)),
                    C.PerspectiveCamera(vertical_field_of_view=0.9, near_distance=0.1,
                                        far_distance=60.0))
    w.create_entity(C.ReferenceFrame(position=(2.0, 8.0, 3.0)),
                    C.ShadowableOmnidirectionalEmission(luminous_intensity=(3e5, 3e5, 3e5),
                                                        source_extent=0.4))
    w.create_entity(C.ShadowableUnidirectionalEmission(perpendicular_illuminance=(1e4,) * 3,
                                                       direction=(-0.3, -1.0, -0.2)))
    for kind, x in ((1, 0.0), (2, 3.0), (0, -3.0)):  # ground, phantom and dynamic planes
        comps = [C.ReferenceFrame(position=(x, 0.0, -4.0 * kind))]
        if kind == 0:
            comps.append(C.DynamicRigidBodySubstance(mass_density=200.0))
        normal = (0.0, 1.0, 0.0) if kind == 1 else (0.3, 0.9, 0.1)
        w.create_entity(*comps, C.PlanarCollidable(kind=kind, normal=normal,
                                                   displacement=0.5 * kind))
    bodies = []
    for kind in (0, 1, 2):  # spheres and capsules of each kind
        dyn = [C.DynamicRigidBodySubstance(mass_density=500.0),
               C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0))] if kind == 0 else []
        # the dynamic sphere starts 5 cm into the ground: a contact from step 1
        bodies.append(w.create_entity(
            C.ReferenceFrame(position=(-4.0 + 3.0 * kind, 0.55 if kind == 0 else 2.0, 1.0)),
            C.Motion(linear_velocity=(0.5, 0.0, 0.0), angular_velocity=(0.0, 0.4, 0.2)),
            C.SphericalCollidable(kind=kind, radius=0.6, center=(0.0, 0.0, 0.1 * kind)), *dyn))
        bodies.append(w.create_entity(
            C.ReferenceFrame(position=(-4.0 + 3.0 * kind, 3.5, -2.0),
                             orientation=(0.0, 0.0, 0.3826834, 0.9238795)),
            C.CapsularCollidable(kind=kind, radius=0.3, segment_start=(0.0, -0.4, 0.0),
                                 segment_end=(0.0, 0.6, 0.0)), *dyn,
            *([C.LocalForce(force=(0.0, 0.0, 2.0), point=(0.0, 0.5, 0.0))] if kind == 0
              else [])))
    w.create_entity(C.SphericalJoint(entity_a=bodies[0], entity_b=bodies[1],
                                     anchor_a=(0.3, 0.5, 0.0), anchor_b=(0.0, -0.5, 0.0)))
    for x in (-1.0, 1.3):  # two voxel boxes resting on the ground, their spheres overlapping
        w.create_entity(C.ReferenceFrame(position=(x, 0.95, 4.0)),
                        C.VoxelBox(voxel_extent=0.25, extent_x=6.0, extent_y=6.0, extent_z=6.0),
                        C.SameVoxelType(voxel_type=1), C.DynamicVoxels(),
                        C.VoxelCollidable(kind=0),
                        C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)))
    return w


def to_reference(got, ref):
    """A port NamedTuple handed back into the reference's template ``ref``
    by field name (fields the port lacks keep the template's)."""
    if hasattr(ref, "_fields"):
        return type(ref)(**{f: to_reference(getattr(got, f), getattr(ref, f))
                            if hasattr(got, f) else getattr(ref, f) for f in ref._fields})
    return jnp.asarray(got.numpy()).astype(ref.dtype)


@functools.lru_cache(maxsize=None)
def states():
    """(port sim, port params, reference sim, reference params) after two
    port steps of the bridged state."""
    ref = jcompile(gizmo_world(), configure(JConfig()))
    cfg = configure(EngineConfig())
    rt = HeadlessRuntime(bridge.scene_build_from_reference(ref, "cpu"), cfg)
    rt.step(2)
    sim = rt.sim
    jsim = ref.sim._replace(
        phys=ref.sim.phys._replace(bodies=to_reference(sim.phys.bodies, ref.sim.phys.bodies),
                                   solver_cache=to_reference(sim.phys.solver_cache,
                                                             ref.sim.phys.solver_cache)),
        voxels=to_reference(sim.voxels, ref.sim.voxels),
        probes=to_reference(sim.probes, ref.sim.probes))
    return sim, rt.params, jsim, ref.params


def test_state_has_what_the_gizmos_draw():
    sim, params, _, _ = states()
    coll = params.phys_params.collidables
    for prefix in ("sph", "cap", "pln"):
        kinds = getattr(coll, f"{prefix}_kind")[getattr(coll, f"{prefix}_mask")]
        assert sorted(set(kinds.tolist())) == [0, 1, 2], prefix
    assert int(sim.phys.solver_cache.active.sum()) > 0
    assert int(sim.voxels.alive.sum()) == 2 and bool(sim.probes.active.any())
    assert bool(params.phys_params.joints.mask.any())
    assert bool((params.lights.omni_mask & params.lights.omni_shadowable).any())
    assert bool((params.lights.uni_mask & params.lights.uni_shadowable).any())


@pytest.mark.parametrize("kind", KINDS)
def test_build_gizmo_lines_matches_reference(kind):
    sim, params, jsim, jparams = states()
    got = gizmos.build_gizmo_lines(sim, params, (kind,), aspect=ASPECT, n_cascades=CASCADES)
    ref = jgizmos.build_gizmo_lines(jsim, jparams, (kind,), aspect=ASPECT, n_cascades=CASCADES)
    active = np.asarray(ref.active)
    np.testing.assert_array_equal(got.active.numpy(), active)
    assert active.any(), kind
    for f in ("start", "end"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * float(np.abs(b).max()),
                                   err_msg=f)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color), rtol=0, atol=1e-6)


def test_all_kinds_at_once_match_reference():
    sim, params, jsim, jparams = states()
    got = gizmos.build_gizmo_lines(sim, params, KINDS, aspect=ASPECT, n_cascades=CASCADES)
    ref = jgizmos.build_gizmo_lines(jsim, jparams, KINDS, aspect=ASPECT, n_cascades=CASCADES)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    b = np.asarray(ref.end)
    np.testing.assert_allclose(got.end.numpy(), b, rtol=1e-5, atol=1e-6 * float(np.abs(b).max()))


# --- overlay_lines -------------------------------------------------------------------


def _overlay_both(image, lines_np, view_proj, samples):
    got = gizmos.overlay_lines(torch.tensor(image), gizmos.GizmoLines(
        *(torch.tensor(x) for x in lines_np)), torch.tensor(view_proj), samples).numpy()
    ref = np.asarray(jax.jit(jgizmos.overlay_lines, static_argnums=3)(
        jnp.asarray(image), jgizmos.GizmoLines(*(jnp.asarray(x) for x in lines_np)),
        jnp.asarray(view_proj), samples))
    return got, ref


def test_overlay_crossing_lines_match_reference():
    rng = np.random.default_rng(5)
    h, w, n = 48, 64, 60
    image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    start = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    end = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    start[:, 2] -= 8.0
    end[:, 2] -= 8.0
    end[:5, 2] = 30.0  # lines that pass behind the camera
    color = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    active = rng.uniform(size=n) < 0.85
    cam_pos = torch.tensor([0.5, 1.0, 4.0])
    from impact_tpu_torch.render.camera import Camera

    cam = Camera(cam_pos, torch.tensor([0.0, 0.0872, 0.0, 0.9962]), torch.tensor(1.0),
                 torch.tensor(0.1), torch.tensor(50.0))
    vp = (projection_matrix(cam, w, h, None) @ view_matrix(cam)).numpy()
    got, ref = _overlay_both(image, (start, end, color, active), vp, 32)
    written = ((got != image) | (ref != image)).any(axis=-1)
    differ = (got != ref).any(axis=-1)
    print(f"overlay: {int(differ.sum())} of {int(written.sum())} written pixels differ")
    assert written.sum() > 300
    assert differ.sum() <= 0.001 * written.sum()


def test_overlay_exact_pixels_last_line_wins():
    h, w = 16, 32
    image = np.full((h, w, 3), 7, np.uint8)

    def ndc(px, py):  # the centre of pixel (px, py)
        return [2.0 * (px + 0.5) / w - 1.0, 1.0 - 2.0 * (py + 0.5) / h, 0.5]

    # a horizontal line, a vertical line through it, a diagonal through the
    # crossing, and an inactive line over all of them
    start = np.float32([ndc(4, 8), ndc(8, 2), ndc(4, 4), ndc(4, 8)])
    end = np.float32([ndc(12, 8), ndc(8, 14), ndc(12, 12), ndc(12, 8)])
    color = np.float32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]])
    active = np.array([True, True, True, False])
    got, ref = _overlay_both(image, (start, end, color, active), np.eye(4, dtype=np.float32), 5)
    np.testing.assert_array_equal(got, ref)
    assert got[8, 8].tolist() == [0, 0, 255]  # the last line through the crossing wins
    assert got[8, 4].tolist() == [255, 0, 0] and got[2, 8].tolist() == [0, 255, 0]
    assert (got != image).any(axis=-1).sum() == 13  # 5 + 5 + 5 samples, 2 shared pixels


# --- line-segment meshes and the runtime ------------------------------------------


def test_wireframe_and_gizmo_lines_match_reference():
    tri = mesh.box_mesh((1.0, 2.0, 0.5))
    wire = mesh.wireframe_of(tri)
    ref = jmesh.wireframe_of(jmesh.box_mesh((1.0, 2.0, 0.5)))
    np.testing.assert_array_equal(wire.indices, ref.indices)
    np.testing.assert_array_equal(wire.positions, ref.positions)
    got = mesh.line_mesh_to_gizmo_lines(wire, color=(0.2, 0.4, 0.6), device="cpu")
    jlines = jmesh.line_mesh_to_gizmo_lines(ref, color=(0.2, 0.4, 0.6))
    for g, r in zip(got, jlines):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    seg = mesh.line_segment_mesh([[0, 0, 0], [1, 0, 0], [1, 1, 0]], [[0, 1], [1, 2]])
    assert seg.positions.dtype == np.float32 and seg.indices.tolist() == [[0, 1], [1, 2]]


def test_runtime_gizmo_overlay():
    """Overlays draw over the frame, with the commands of the reference
    (tests/test_runtime_features.py:53-81); every pass renders from the
    same render state, so hiding the gizmos gives the base frame back."""
    rt = tiny_runtime()
    rt.step(3)
    start = rt.sim
    base = rt.render().numpy()
    rt.enqueue_command("gizmo", "show", "reference_frame_axes")
    rt.enqueue_command("gizmo", "show", "linear_velocity")
    rt.apply_commands()
    assert rt.visible_gizmos == ("linear_velocity", "reference_frame_axes")
    rt.sim = start
    overlaid = rt.render().numpy()
    assert (overlaid != base).any() and "gizmos" in rt.stage_ms
    rt.enqueue_command("gizmo", "hide", "linear_velocity")
    rt.enqueue_command("gizmo", "hide", "reference_frame_axes")
    rt.apply_commands()
    rt.sim = start
    np.testing.assert_array_equal(rt.render().numpy(), base)
    rt.enqueue_command("gizmo", "set_visible", gizmos.ALL_GIZMO_TYPES)
    rt.apply_commands()
    assert len(gizmos.ALL_GIZMO_TYPES) == 21 and len(rt.visible_gizmos) == 21
    rt.sim = start
    everything = rt.render().numpy()
    assert everything.shape == base.shape and (everything != base).any()
    rt.enqueue_command("gizmo", "set_visible", ())
    rt.apply_commands()
    assert rt.visible_gizmos == ()
    rt.sim = start
    np.testing.assert_array_equal(rt.render().numpy(), base)
    # step_and_render draws them too
    rt.visible_gizmos = ("reference_frame_axes",)
    rt.sim = start
    stepped = rt.step_and_render().numpy()
    rt.visible_gizmos = ()
    rt.sim = start
    assert (stepped != rt.step_and_render().numpy()).any()
