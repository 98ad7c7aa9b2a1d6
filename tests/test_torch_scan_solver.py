"""The port's ``scan`` contact solve (Gauss-Seidel over the contact slots)
against impact_tpu's ``solve_contacts(mode="scan")`` on the CPU.

Inputs: states of the reference's own physics scenes (tests/test_physics.py:
a sphere resting on a plane, a head-on collision of two spheres, a sphere
sliding with friction) stepped by the reference into contact; random bodies
and contacts solved twice (the second solve warm-started); and the snapshot
tester's voxel box tumbler (4 boxes, 128 contact slots) compiled by the port
with its boxes set down on the floor. Both packages prepare the contacts
and solve once on the same numbers.

Tolerance: the two packages walk the slots in the same order with the same
formulas, but XLA may fuse a multiply and an add where torch rounds twice,
and a sequential solve carries each slot's rounding into the next. Every
body field and the accumulated impulses are held within rtol 1e-5 and an
atol of 1e-6 of the field's largest magnitude."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_physics import (
    MAX_CONTACTS,
    add_dynamic_sphere,
    add_ground_plane,
    enable_kinematic,
    make_scene,
    run_steps,
)
from test_torch_physics import random_bodies, random_contacts

import impact_tpu.physics.solver as jsolver
import impact_tpu.physics.step as jstep
from impact_tpu.math import quaternion as jquat
from impact_tpu.physics import collision as jcoll
from impact_tpu.physics import state as jstate
from impact_tpu.utils.config import ConstraintSolverConfig as JSolverConfig
from impact_tpu_torch import bridge
from impact_tpu_torch.physics import scan_solver
from impact_tpu_torch.physics import solver as tsolver
from impact_tpu_torch.physics import state as tstate
from impact_tpu_torch.physics import step as tstep
from impact_tpu_torch.utils.config import ConstraintSolverConfig

FIELDS = ("position", "orientation", "momentum", "angular_momentum", "velocity",
          "angular_velocity")
RTOL, ATOL_OF_MAGNITUDE = 1e-5, 1e-6
DT = 0.005


def port(cls, obj):
    return bridge.tuple_from_reference(cls, obj, device="cpu")


def assert_solves_agree(got_b, got_c, ref_b, ref_c):
    pairs = [(f, getattr(got_b, f), getattr(ref_b, f)) for f in FIELDS]
    pairs.append(("impulses", got_c.impulses, ref_c.impulses))
    for f, got, ref in pairs:
        ref = np.asarray(ref)
        atol = ATOL_OF_MAGNITUDE * max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=atol, err_msg=f)
    np.testing.assert_array_equal(got_c.active.numpy(), np.asarray(ref_c.active))


def solve_both(jbodies, jprep):
    """One scan solve in each package on the reference's prepared contacts."""
    ref_b, ref_c = jsolver.solve_contacts(jbodies, jprep, JSolverConfig(), mode="scan")
    got_b, got_c = tsolver.solve_contacts(port(tstate.BodyState, jbodies),
                                          port(tsolver.PreparedContacts, jprep),
                                          ConstraintSolverConfig(), mode="scan")
    return got_b, got_c, ref_b, ref_c


def reference_scene(name):
    """A scene of tests/test_physics.py stepped into contact by the reference
    → (phys, params)."""
    phys, params = make_scene()
    if name == "resting_sphere":
        phys, params = add_dynamic_sphere(phys, params, 0, (0, 0.5, 0), collider_slot=0,
                                          gravity=True)
        phys, params = enable_kinematic(phys, 7), add_ground_plane(params)
        n = 40
    elif name == "head_on":
        phys, params = add_dynamic_sphere(phys, params, 0, (-1.0, 0, 0), vel=(2, 0, 0),
                                          collider_slot=0, restitution=1.0)
        phys, params = add_dynamic_sphere(phys, params, 1, (1.0, 0, 0), collider_slot=1,
                                          restitution=1.0)
        n = 98  # the spheres touch at step ~100
    else:  # sliding
        phys, params = add_dynamic_sphere(phys, params, 0, (0, 0.5, 0), vel=(3, 0, 0),
                                          collider_slot=0, sf=0.8, df=0.6, gravity=True)
        phys, params = enable_kinematic(phys, 7), add_ground_plane(params, sf=0.8, df=0.6)
        n = 40
    return run_steps(phys, params, n, dt=DT), params


@pytest.mark.parametrize("name", ["resting_sphere", "head_on", "sliding"])
def test_scan_solve_matches_reference_on_physics_scenes(name):
    phys, params = reference_scene(name)
    jprep, jbodies = None, phys.bodies
    for _ in range(4):  # a few substeps, so the solve is warm-started
        world = jcoll.synchronize_collidables(params.collidables, jbodies.position,
                                              jbodies.orientation)
        contacts = jcoll.narrow_phase(params.collidables, world, MAX_CONTACTS)
        jprep = jsolver.prepare_contacts(jbodies, contacts, phys.solver_cache, JSolverConfig())
        jbodies = jstate.advance_momenta(jbodies, DT)
        got_b, got_c, ref_b, ref_c = solve_both(jbodies, jprep)
        assert_solves_agree(got_b, got_c, ref_b, ref_c)
        phys = phys._replace(solver_cache=ref_c)
        jbodies = jstate.advance_configurations(ref_b, DT, (jstate.KIND_DYNAMIC,))
    assert bool(np.asarray(jprep.active).any())
    assert float(np.abs(np.asarray(ref_c.impulses)).max()) > 0.0


def test_scan_solve_matches_reference_on_random_contacts():
    jb = random_bodies(20, 11)
    c1 = random_contacts(jb, 48, 12)
    c2 = random_contacts(jb, 48, 12)
    c2 = c2._replace(depth=c2.depth * 0.5)  # same keys: the second solve warm-starts
    jcache = jsolver.empty_solver_cache(48)
    jprep = jsolver.prepare_contacts(jb, c1, jcache, JSolverConfig())
    got_b, got_c, ref_b, ref_c = solve_both(jb, jprep)
    assert_solves_agree(got_b, got_c, ref_b, ref_c)
    jprep2 = jsolver.prepare_contacts(ref_b, c2, ref_c, JSolverConfig())
    assert float(np.abs(np.asarray(jprep2.warm_impulses)).max()) > 0.0
    got_b, got_c, ref_b, ref_c = solve_both(ref_b, jprep2)
    assert_solves_agree(got_b, got_c, ref_b, ref_c)


def record_solver_inputs(monkeypatch):
    """Patch the port's physics step to keep the (bodies, prepared contacts)
    of each scan solve."""
    seen = []
    run = tstep.solve_contacts

    def spy(bodies, prep, config, mode="scan"):
        seen.append((bodies, prep))
        return run(bodies, prep, config, mode=mode)

    monkeypatch.setattr(tstep, "solve_contacts", spy)
    return seen


def to_reference(cls, obj):
    """A port NamedTuple → the reference's: int64 indices back to i32, keys
    to u32."""
    vals = {}
    for f in cls._fields:
        a = getattr(obj, f).numpy()
        if f == "key":
            a = a.astype(np.uint32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        vals[f] = jnp.asarray(a)
    return cls(**vals)


def test_scan_solve_matches_reference_on_snapshot_tumbler(monkeypatch):
    from impact_tpu_torch.apps.snapshot_tester import snapshot_config
    from impact_tpu_torch.models import voxel_box_tumbler
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

    torch.set_num_threads(2)
    cfg = snapshot_config()
    build = compile_scene(voxel_box_tumbler(), cfg, device="cpu")
    b = build.sim.phys.bodies
    bi = build.sim.voxels.body_index[:4]
    # set the four boxes down on the floor, their lowest corners ~5 cm deep
    pos = b.position.clone()
    pos[bi, 1] = torch.tensor([1.2, 1.5, 1.4, 1.3])
    build.sim = build.sim._replace(phys=build.sim.phys._replace(bodies=b._replace(position=pos)))
    seen = record_solver_inputs(monkeypatch)
    HeadlessRuntime(build, cfg, enable_fracturing=False).step(1)
    bodies, prep = seen[0]
    n_active = int(prep.active.sum())
    assert prep.active.shape[0] == 128 and 8 <= n_active < 128
    jbodies = to_reference(jstate.BodyState, bodies)
    jprep = to_reference(jsolver.PreparedContacts, prep)
    got_b, got_c, ref_b, ref_c = solve_both(jbodies, jprep)
    assert_solves_agree(got_b, got_c, ref_b, ref_c)


def test_inactive_slots_renormalize_orientations():
    """Every slot is walked: a correction sweep over inactive slots changes no
    velocity or position but renormalizes the orientations of the bodies
    the slots point at (quaternion integration with a zero rate), as the
    reference's one_correction does; bodies no slot points at keep theirs."""
    jb = random_bodies(8, 3)
    ori = np.asarray(jb.orientation) * np.array([[2.0], [0.5], [3.0], [1.0], [1.5], [0.7],
                                                 [1.2], [4.0]], np.float32)
    tb = port(tstate.BodyState, jb)._replace(orientation=torch.from_numpy(ori))
    c = random_contacts(jb, 16, 4)
    prep = tsolver.prepare_contacts(tb, port(tsolver.ContactBuffer, c),
                                    tsolver.empty_solver_cache(16, device="cpu"), ConstraintSolverConfig())
    pairs = torch.tensor([[1, 2], [4, 4], [1, 6], [2, 1]] * 4)
    prep = prep._replace(active=torch.zeros(16, dtype=torch.bool), body_a=pairs[:, 0],
                         body_b=pairs[:, 1])
    v, w = tstate.compute_velocities(tb)
    out = scan_solver.scan_iterations_plain(
        v, w, tb.position, tb.orientation, tb.inv_mass, tstate.world_inv_inertia(tb), prep,
        prep.warm_impulses, 8, 3, 0.2)
    torch.testing.assert_close(out[0], v, rtol=0, atol=0)
    torch.testing.assert_close(out[1], w, rtol=0, atol=0)
    torch.testing.assert_close(out[3], tb.position, rtol=0, atol=0)
    touched = [1, 2, 4, 6]
    ref = np.asarray(jquat.integrate_angular_velocity(jnp.asarray(ori[touched]),
                                                      jnp.zeros((4, 3)), 1.0))
    np.testing.assert_allclose(out[4][touched].numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(out[4][touched].numpy(), axis=-1), 1.0,
                               atol=1e-6)
    untouched = [0, 3, 5, 7]
    np.testing.assert_array_equal(out[4][untouched].numpy(), ori[untouched])


def test_cpu_tensors_take_the_plain_loop_without_a_launch():
    jb = random_bodies(12, 5)
    tb = port(tstate.BodyState, jb)
    prep = tsolver.prepare_contacts(tb, port(tsolver.ContactBuffer, random_contacts(jb, 24, 6)),
                                    tsolver.empty_solver_cache(24, device="cpu"), ConstraintSolverConfig())
    v, w = tstate.compute_velocities(tb)
    args = (v, w, tb.position, tb.orientation, tb.inv_mass, tstate.world_inv_inertia(tb),
            prep, prep.warm_impulses, 8, 3, 0.2)
    scan_solver.LAUNCHES.reset()
    got = scan_solver.scan_iterations(*args)
    ref = scan_solver.scan_iterations_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert sum(scan_solver.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        scan_solver.scan_iterations(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                                      for a in args))


def test_scan_is_the_default_solver_mode_in_both_packages():
    for fn in (tstep.physics_substep, tstep.physics_step, jstep.physics_substep,
               jstep.physics_step):
        assert inspect.signature(fn).parameters["solver_mode"].default == "scan"
    assert inspect.signature(tsolver.solve_contacts).parameters["mode"].default == "scan"
    from impact_tpu.utils.config import TpuConfig as JTpu
    from impact_tpu_torch.utils.config import TpuConfig

    assert TpuConfig().solver_mode == JTpu().solver_mode == "scan"
    with pytest.raises(ValueError, match="scan"):
        tb = port(tstate.BodyState, random_bodies(4, 0))
        tsolver.solve_contacts(tb, None, ConstraintSolverConfig(), mode="gauss")


def test_bound_is_bytes_at_the_snapshot_and_bench_widths():
    for n, c in ((24, 128), (80, 1024)):
        ms, by = scan_solver.bound_ms(n, c, 8, 3)
        assert ms > 0.0 and by == "bytes"
