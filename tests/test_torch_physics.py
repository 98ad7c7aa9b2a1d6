"""The port's rigid-body physics against impact_tpu on the CPU: narrow phase,
contact compaction, the jacobi contact solve on both accumulation paths,
joints, forces and motion drivers, on numpy-seeded inputs.

Bars: contact keys, masks and body indices exactly equal (integer work and
stable sorts); contact geometry within 1e-5 (float32 round-off of the same
formulas). The jacobi solve sums per-body impulses in another order than
JAX, so it is held to a tolerance taken from the reference itself: 8× the
largest difference between impact_tpu's own one-hot and segment-sum
accumulation paths on the same inputs, plus 1e-6 of the quantity's
magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import impact_tpu.physics.solver as jsolver
from impact_tpu.physics import collision as jcoll
from impact_tpu.physics import driven_motion as jdrive
from impact_tpu.physics import forces as jforces
from impact_tpu.physics import state as jstate
from impact_tpu.utils.config import ConstraintSolverConfig as JSolverConfig
from impact_tpu_torch import bridge
from impact_tpu_torch.physics import collision as tcoll
from impact_tpu_torch.physics import driven_motion as tdrive
from impact_tpu_torch.physics import forces as tforces
from impact_tpu_torch.physics import solver as tsolver
from impact_tpu_torch.physics import state as tstate
from impact_tpu_torch.utils.config import ConstraintSolverConfig

FIELDS = ("position", "orientation", "momentum", "angular_momentum", "velocity",
          "angular_velocity")


def _unit(rng, n, d):
    v = rng.normal(size=(n, d))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def random_bodies(n, seed):
    """A jax BodyState of n bodies: dynamic, kinematic and empty slots;
    body 0 is kinematic (the ground)."""
    rng = np.random.default_rng(seed)
    kind = rng.choice([1, 1, 1, 1, 1, 1, 1, 2, 0], size=n).astype(np.int32)
    kind[0] = 2
    mass = rng.uniform(1.0, 5.0, n).astype(np.float32)
    a = rng.normal(size=(n, 3, 3)) * 0.3
    inertia = (np.eye(3) * rng.uniform(1.0, 3.0, (n, 1, 1)) + a @ a.transpose(0, 2, 1))
    inertia = inertia.astype(np.float32)
    dyn = kind == 1
    f32 = np.float32
    return jstate.BodyState(
        kind=jnp.asarray(kind), mass=jnp.asarray(mass),
        inv_mass=jnp.asarray(np.where(dyn, 1.0 / mass, 0.0).astype(f32)),
        inertia_body=jnp.asarray(inertia),
        inv_inertia_body=jnp.asarray(np.where(dyn[:, None, None], np.linalg.inv(inertia),
                                              0.0).astype(f32)),
        position=jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(f32)),
        orientation=jnp.asarray(_unit(rng, n, 4)),
        momentum=jnp.asarray((rng.normal(size=(n, 3)) - [0.0, 4.0, 0.0]).astype(f32)),
        angular_momentum=jnp.asarray(rng.normal(size=(n, 3)).astype(f32)),
        velocity=jnp.asarray(rng.normal(size=(n, 3)).astype(f32)),
        angular_velocity=jnp.asarray(rng.normal(size=(n, 3)).astype(f32)),
        total_force=jnp.asarray(rng.normal(size=(n, 3)).astype(f32)),
        total_torque=jnp.asarray(rng.normal(size=(n, 3)).astype(f32)),
    )


def port(cls, obj):
    return bridge.tuple_from_reference(cls, obj, device="cpu")


def assert_tuple_close(got, ref, atol=1e-5, rtol=1e-5):
    for f in ref._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f)


def random_collidables(n_bodies, seed):
    rng = np.random.default_rng(seed)
    pools = jcoll.empty_collidable_pools(n_spheres=8, n_planes=2, n_capsules=5)
    f32 = np.float32
    return pools._replace(
        sph_body=jnp.asarray(rng.integers(0, n_bodies, 8).astype(np.int32)),
        sph_center=jnp.asarray(rng.uniform(-0.3, 0.3, (8, 3)).astype(f32)),
        sph_radius=jnp.asarray(rng.uniform(0.5, 1.5, 8).astype(f32)),
        sph_kind=jnp.asarray(rng.choice([0, 0, 0, 1, 2], 8).astype(np.int32)),
        sph_response=jnp.asarray(rng.uniform(0.1, 0.9, (8, 3)).astype(f32)),
        sph_mask=jnp.asarray(rng.uniform(size=8) < 0.85),
        pln_body=jnp.asarray(np.array([0, 1], np.int32)),
        pln_normal=jnp.asarray(np.array([[0, 1, 0], [0.6, 0.8, 0]], f32)),
        pln_disp=jnp.asarray(np.array([-1.0, -3.0], f32)),
        pln_response=jnp.asarray(rng.uniform(0.1, 0.9, (2, 3)).astype(f32)),
        pln_mask=jnp.asarray(np.array([True, True])),
        cap_body=jnp.asarray(rng.integers(0, n_bodies, 5).astype(np.int32)),
        cap_start=jnp.asarray(rng.uniform(-1, 1, (5, 3)).astype(f32)),
        cap_end=jnp.asarray(rng.uniform(-1, 1, (5, 3)).astype(f32)),
        cap_radius=jnp.asarray(rng.uniform(0.3, 1.0, 5).astype(f32)),
        cap_response=jnp.asarray(rng.uniform(0.1, 0.9, (5, 3)).astype(f32)),
        cap_mask=jnp.asarray(rng.uniform(size=5) < 0.9),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_narrow_phase_matches_reference(seed):
    jb = random_bodies(12, seed)
    jp = random_collidables(12, seed)
    jw = jcoll.synchronize_collidables(jp, jb.position, jb.orientation)
    ref = jcoll.narrow_phase(jp, jw, 48)
    tp = port(tcoll.CollidablePools, jp)
    tw = tcoll.synchronize_collidables(tp, port(tstate.BodyState, jb).position,
                                       port(tstate.BodyState, jb).orientation)
    got = tcoll.narrow_phase(tp, tw, 48)
    assert int(np.asarray(ref.active).sum()) > 5
    assert_tuple_close(got, ref)


def test_compact_contacts_keys_match_reference():
    rng = np.random.default_rng(7)
    n = 300
    key = np.sort(rng.choice(1 << 31, n, replace=False)).astype(np.uint32)
    active = rng.uniform(size=n) < 0.4
    ba, bb = rng.integers(0, 50, n).astype(np.int32), rng.integers(0, 50, n).astype(np.int32)
    pos, nrm = rng.normal(size=(n, 3)).astype(np.float32), _unit(rng, n, 3)
    dep, resp = rng.uniform(size=n).astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32)
    for cap in (64, 400):  # with and without overflow
        ref = jcoll.compact_contacts(*(jnp.asarray(x) for x in (key, active, ba, bb, pos, nrm,
                                                                  dep, resp)), cap)
        got = tcoll.compact_contacts(torch.from_numpy(key.astype(np.int64)),
                                     torch.from_numpy(active), torch.from_numpy(ba).long(),
                                     torch.from_numpy(bb).long(), torch.from_numpy(pos),
                                     torch.from_numpy(nrm), torch.from_numpy(dep),
                                     torch.from_numpy(resp), cap)
        assert_tuple_close(got, ref, atol=0, rtol=0)
        assert np.all(np.diff(got.key.numpy()[got.active.numpy()]) > 0)


def random_contacts(bodies, n_contacts, seed):
    """A compacted jax ContactBuffer: at most two contacts per dynamic body,
    against the ground (body 0) or another dynamic body. (With many stiff
    contacts on one body, or contacts between two bodies that cannot move,
    the jacobi solve diverges in the reference as in the port.)"""
    rng = np.random.default_rng(seed)
    dyn = np.flatnonzero(np.asarray(bodies.kind) == 1)
    n_act = min(n_contacts * 3 // 4, dyn.size)
    key = np.full(n_contacts, 0xFFFFFFFF, np.uint32)
    key[:n_act] = np.sort(rng.choice(1 << 20, n_act, replace=False))
    active = np.arange(n_contacts) < n_act
    ba = np.zeros(n_contacts, np.int32)
    ba[:n_act] = rng.permutation(dyn)[:n_act]
    other = rng.permutation(dyn)[:n_act]
    bb = np.zeros(n_contacts, np.int32)
    bb[:n_act] = np.where((rng.uniform(size=n_act) < 0.4) & (other != ba[:n_act]), other, 0)
    f32 = np.float32
    up = _unit(rng, n_contacts, 3) * 0.3 + np.array([0.0, 1.0, 0.0])
    up_normals = (up / np.linalg.norm(up, axis=-1, keepdims=True)).astype(f32)
    return jcoll.ContactBuffer(
        active=jnp.asarray(active), key=jnp.asarray(key), body_a=jnp.asarray(ba),
        body_b=jnp.asarray(bb), position=jnp.asarray(rng.uniform(-2, 2, (n_contacts, 3)).astype(f32)),
        normal=jnp.asarray(up_normals),
        depth=jnp.asarray(rng.uniform(0, 0.05, n_contacts).astype(f32)),
        response=jnp.asarray(rng.uniform(0.1, 0.8, (n_contacts, 3)).astype(f32)),
    )


def _solve_twice(mod, bodies, contacts, contacts2, cache, config):
    """prepare + jacobi solve, then again from the first solve's cache (warm
    start) on the second contact set."""
    prep = mod.prepare_contacts(bodies, contacts, cache, config)
    bodies, cache = mod.solve_contacts(bodies, prep, config, mode="jacobi")
    prep = mod.prepare_contacts(bodies, contacts2, cache, config)
    return mod.solve_contacts(bodies, prep, config, mode="jacobi")


@pytest.mark.parametrize("n_bodies", [20, 160], ids=["one_hot", "segment_sum"])
def test_jacobi_solve_matches_reference_within_reference_spread(n_bodies, monkeypatch):
    jb = random_bodies(n_bodies, 11)
    c1, c2 = random_contacts(jb, 256, 12), random_contacts(jb, 256, 12)
    n_act = int(np.asarray(c1.active).sum())
    c2 = c2._replace(depth=c2.depth * 0.5)  # same keys: the second solve warm-starts
    jcfg, tcfg = JSolverConfig(), ConstraintSolverConfig()
    jcache = jsolver.empty_solver_cache(256)
    ref_b, ref_c = _solve_twice(jsolver, jb, c1, c2, jcache, jcfg)
    # the reference's other accumulation path on the same inputs
    other = 10 ** 9 if n_bodies >= jsolver.SEGMENT_ACCUMULATION_MIN_BODIES else 0
    monkeypatch.setattr(jsolver, "SEGMENT_ACCUMULATION_MIN_BODIES", other)
    alt_b, alt_c = _solve_twice(jsolver, jb, c1, c2, jcache, jcfg)
    monkeypatch.undo()
    got_b, got_c = _solve_twice(tsolver, port(tstate.BodyState, jb),
                                port(tcoll.ContactBuffer, c1), port(tcoll.ContactBuffer, c2),
                                port(tsolver.SolverCache, jcache), tcfg)
    assert int(np.asarray(ref_c.active).sum()) == n_act
    assert float(np.abs(np.asarray(ref_c.impulses)).max()) > 0.1  # warm-started work
    pairs = [(f, getattr(got_b, f), getattr(ref_b, f), getattr(alt_b, f)) for f in FIELDS]
    pairs.append(("impulses", got_c.impulses, ref_c.impulses, alt_c.impulses))
    for f, got, ref, alt in pairs:
        ref, alt, got = np.asarray(ref), np.asarray(alt), got.numpy()
        spread = np.abs(ref - alt).max()
        tol = 8 * spread + 1e-6 * max(np.abs(ref).max(), 1.0)
        assert np.abs(got - ref).max() <= tol, (f, np.abs(got - ref).max(), spread)
    np.testing.assert_array_equal(got_c.key.numpy(), np.asarray(ref_c.key))


def test_scan_mode_is_not_ported():
    """The scan mode is ported (it raised before the port had it): one scan
    solve on these random bodies and contacts matches impact_tpu's within
    rtol 1e-5 and 1e-6 of each field's magnitude, the bar of
    tests/test_torch_scan_solver.py."""
    jb = random_bodies(8, 0)
    jc = random_contacts(jb, 16, 1)
    jprep = jsolver.prepare_contacts(jb, jc, jsolver.empty_solver_cache(16), JSolverConfig())
    ref_b, ref_c = jsolver.solve_contacts(jb, jprep, JSolverConfig(), mode="scan")
    got_b, got_c = tsolver.solve_contacts(port(tstate.BodyState, jb),
                                          port(tsolver.PreparedContacts, jprep),
                                          ConstraintSolverConfig(), mode="scan")
    assert int(np.asarray(jprep.active).sum()) > 0
    for f in FIELDS:
        ref = np.asarray(getattr(ref_b, f))
        np.testing.assert_allclose(getattr(got_b, f).numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(ref).max(), 1.0), err_msg=f)
    ref = np.asarray(ref_c.impulses)
    np.testing.assert_allclose(got_c.impulses.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * max(np.abs(ref).max(), 1.0))


def test_solve_joints_matches_reference():
    jb = random_bodies(10, 5)
    rng = np.random.default_rng(5)
    jj = jsolver.empty_joint_pools(6)._replace(
        body_a=jnp.asarray(np.array([1, 2, 3, 0, 0, 0], np.int32)),
        body_b=jnp.asarray(np.array([4, 5, 0, 0, 0, 0], np.int32)),
        anchor_a=jnp.asarray(rng.uniform(-0.5, 0.5, (6, 3)).astype(np.float32)),
        anchor_b=jnp.asarray(rng.uniform(-0.5, 0.5, (6, 3)).astype(np.float32)),
        mask=jnp.asarray(np.array([True, True, True, False, False, False])))
    ref = jsolver.solve_joints(jb, jj, JSolverConfig())
    got = tsolver.solve_joints(port(tstate.BodyState, jb), port(tsolver.JointPools, jj),
                               ConstraintSolverConfig())
    assert_tuple_close(got, ref, atol=2e-4, rtol=1e-4)


def test_forces_match_reference():
    n = 16
    jb = random_bodies(n, 9)
    rng = np.random.default_rng(9)
    f32 = np.float32
    jp = jforces.empty_force_pools(n, cap_accel=8, cap_local=4, cap_springs=4, cap_align=4)
    jp = jp._replace(
        const_accel_body=jnp.asarray(np.arange(8, dtype=np.int32)),
        const_accel=jnp.asarray(np.tile([[0.0, -9.81, 0.0]], (8, 1)).astype(f32)),
        const_accel_mask=jnp.asarray(np.arange(8) < 6),
        local_force_body=jnp.asarray(np.array([1, 2, 3, 3], np.int32)),
        local_force=jnp.asarray(rng.normal(size=(4, 3)).astype(f32)),
        local_point=jnp.asarray(rng.normal(size=(4, 3)).astype(f32)),
        local_force_mask=jnp.asarray(np.array([True, True, True, False])),
        spring_body_a=jnp.asarray(np.array([1, 2, 0, 0], np.int32)),
        spring_body_b=jnp.asarray(np.array([5, 6, 0, 0], np.int32)),
        spring_attach_a=jnp.asarray(rng.normal(size=(4, 3)).astype(f32) * 0.3),
        spring_attach_b=jnp.asarray(rng.normal(size=(4, 3)).astype(f32) * 0.3),
        spring_stiffness=jnp.asarray(np.full(4, 50.0, f32)),
        spring_damping=jnp.asarray(np.full(4, 2.0, f32)),
        spring_rest_length=jnp.asarray(np.full(4, 0.5, f32)),
        spring_mask=jnp.asarray(np.array([True, True, False, False])),
        align_body=jnp.asarray(np.array([4, 0, 0, 0], np.int32)),
        align_strength=jnp.asarray(np.full(4, 3.0, f32)),
        align_damping=jnp.asarray(np.full(4, 0.5, f32)),
        align_mask=jnp.asarray(np.array([True, False, False, False])),
        gravity_participant=jnp.asarray(rng.uniform(size=n) < 0.5),
        gravitational_constant=jnp.asarray(f32(0.1)),
        drag_coef=jnp.asarray(rng.uniform(0, 1, n).astype(f32)),
        medium_density=jnp.asarray(f32(1.2)),
        medium_velocity=jnp.asarray(np.array([1.0, 0.0, 0.5], f32)),
    )
    ref = jforces.apply_forces_and_torques(jb, jp)
    got = tforces.apply_forces_and_torques(port(tstate.BodyState, jb),
                                           port(tforces.ForcePools, jp))
    for f in ("total_force", "total_torque"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=2e-4, rtol=1e-5, err_msg=f)


def test_motion_drivers_match_reference():
    jb = random_bodies(12, 4)
    rng = np.random.default_rng(4)
    f32 = np.float32
    on = jnp.asarray(np.array([True, True, False, False]))
    jd = jdrive.empty_motion_driver_pools(4)._replace(
        circ_body=jnp.asarray(np.array([1, 2, 0, 0], np.int32)), circ_mask=on,
        circ_center=jnp.asarray(rng.normal(size=(4, 3)).astype(f32)),
        circ_radius=jnp.asarray(np.full(4, 2.0, f32)), circ_speed=jnp.asarray(np.full(4, 1.5, f32)),
        circ_axis=jnp.asarray(_unit(rng, 4, 3)),
        lin_body=jnp.asarray(np.array([3, 0, 0, 0], np.int32)),
        lin_v0=jnp.asarray(rng.normal(size=(4, 3)).astype(f32)),
        lin_mask=jnp.asarray(np.array([True, False, False, False])),
        rot_body=jnp.asarray(np.array([4, 0, 0, 0], np.int32)),
        rot_omega=jnp.asarray(rng.normal(size=(4, 3)).astype(f32)),
        rot_mask=jnp.asarray(np.array([True, False, False, False])),
        osc_body=jnp.asarray(np.array([5, 0, 0, 0], np.int32)),
        osc_dir=jnp.asarray(_unit(rng, 4, 3)), osc_amplitude=jnp.asarray(np.full(4, 0.7, f32)),
        osc_mask=jnp.asarray(np.array([True, False, False, False])),
        orb_body=jnp.asarray(np.array([6, 0, 0, 0], np.int32)),
        orb_e=jnp.asarray(np.full(4, 0.3, f32)), orb_a=jnp.asarray(np.full(4, 4.0, f32)),
        orb_mask=jnp.asarray(np.array([True, False, False, False])),
    )
    ref = jdrive.apply_motion_drivers(jb, jd, jnp.float32(1.3))
    got = tdrive.apply_motion_drivers(port(tstate.BodyState, jb),
                                      port(tdrive.MotionDriverPools, jd), torch.tensor(1.3))
    assert_tuple_close(got, ref, atol=1e-5)
