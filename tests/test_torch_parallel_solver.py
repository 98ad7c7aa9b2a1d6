"""The contact solve with the bodies split over the ``objects`` axis and the
contacts replicated (``impact_tpu_torch/parallel/solver.py``) on 8 CPU ranks
over gloo, on the 4×2 mesh of ``tests/test_parallel.py:205-242``.

* Gathered, the sharded solve is ``torch.equal`` to the port's
  single-process ``solve_contacts`` (run under one thread, as the ranks
  run) on every body leaf, and every rank's cache on every cache leaf:
  jacobi on the segment path (1024 bodies, 2048 contact slots at one
  velocity and one correction iteration, 4096 at the default 8 and 3) and
  on the one-hot path (64 × 128), ``scan`` at 128 × 256, each also
  warm-started (the contacts prepared against a full cache).
* Against the reference's ``solve_contacts`` on the same numpy inputs
  (``tests/test_parallel.py``'s own scene): velocities and impulses within
  that test's atol and rtol of 1e-5 at the sizes where the random contact
  graph stays tame (the default iterations at 1024 × 4096 blow the
  velocities up to ~1e6 in both packages, so there only the port's
  equality holds).
* The collectives are objects-axis gathers of body rows only, none shaped
  by the contacts, in the count the mode sets; N that does not divide over
  the axis raises ValueError; the placements follow the reference test's
  rule.

The 8 ranks are spawned once for the module."""

import contextlib

import jax
import numpy as np
import pytest
import test_parallel
import torch
from chip_smoke import solve_collectives_ok
from torch.distributed.tensor import Replicate, Shard

from impact_tpu.physics.solver import solve_contacts as jsolve_contacts
from impact_tpu_torch.parallel import body_shardings, jobs
from impact_tpu_torch.parallel.mesh import OBJECTS, REPLICATED, leaves_with_path
from impact_tpu_torch.parallel.world import World
from impact_tpu_torch.physics.solver import SEGMENT_ACCUMULATION_MIN_BODIES, solve_contacts
from impact_tpu_torch.physics.state import empty_body_state

SEED = 5  # tests/test_parallel.py:216
MESH = jobs.SOLVE_MESH
TOL = 1e-5  # tests/test_parallel.py:234-241

# (mode, bodies, contact slots, (velocity, correction) iterations or None
# for the default, warm-started)
CASES = [
    pytest.param(("jacobi", 1024, 2048, (1, 1), False), id="jacobi-segment-1024x2048"),
    pytest.param(("jacobi", 1024, 4096, None, False), id="jacobi-segment-1024x4096-default"),
    pytest.param(("jacobi", 64, 128, None, False), id="jacobi-onehot-64x128"),
    pytest.param(("scan", 128, 256, None, False), id="scan-128x256"),
    pytest.param(("jacobi", 1024, 2048, (1, 1), True), id="jacobi-segment-1024x2048-warm"),
    pytest.param(("jacobi", 64, 128, None, True), id="jacobi-onehot-64x128-warm"),
    pytest.param(("scan", 128, 256, (1, 1), True), id="scan-128x256-warm"),
]
REFERENCE_CASES = [CASES[0], CASES[2], CASES[3]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(8, device="cpu", store_dir=tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved(world):
    """case → (the ranks' results, the single-process (bodies, cache),
    config), each case solved once for the module."""
    done = {}

    def get(case, while_ranks_run=None):
        if case not in done:
            mode, n, c, iterations, warm = case
            world.submit(jobs.solve_job, n, c, mode, iterations, SEED, warm)
            extra = while_ranks_run() if while_ranks_run else None
            with one_thread():
                b, prep, cfg = jobs.solver_scene(n, c, "cpu", SEED, warm)
                cfg = jobs.solver_config(cfg, iterations)
                single = solve_contacts(b, prep, cfg, mode=mode)
            done[case] = [r for r in world.collect() if r is not None], single, cfg, extra
        return done[case]

    return get


@pytest.mark.parametrize("case", CASES)
def test_sharded_solve_equals_single_process(solved, case):
    mode, n, c, _, _ = case
    res, (want_b, want_c), _, _ = solved(case)
    assert len(res) == 8 and {r["local_rows"] for r in res} == {n // MESH[0]}
    got = res[0]["bodies"]
    for f in want_b._fields:
        assert torch.equal(torch.from_numpy(got[f]), getattr(want_b, f)), f
    for r in res:
        for f in want_c._fields:
            assert torch.equal(torch.from_numpy(r["cache"][f]), getattr(want_c, f)), \
                (r["rank"], f)
    assert np.isfinite(got["velocity"]).all()
    # the path the accumulation took, and the scan's one call per solve
    assert (n < SEGMENT_ACCUMULATION_MIN_BODIES) == (n == 64)
    assert all((r["scan"] is not None) == (mode == "scan") for r in res)


def _reference_solve(n, c, mode, iterations):
    """``tests/test_parallel.py``'s scene (seed 5) solved by the reference."""
    jb, jprep, jcfg = test_parallel.TestPodScaleSolver._scene(None, n, c, seed=SEED)
    if iterations is not None:
        jcfg.n_iterations, jcfg.n_positional_correction_iterations = iterations
    out, cache = jax.jit(lambda b, p: jsolve_contacts(b, p, jcfg, mode=mode))(jb, jprep)
    return np.asarray(out.velocity), np.asarray(cache.impulses)


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_sharded_solve_within_reference_bars(solved, case):
    mode, n, c, iterations, _ = case
    res, _, _, ref = solved(case, lambda: _reference_solve(n, c, mode, iterations))
    if ref is None:  # the case was solved before, without the reference
        ref = _reference_solve(n, c, mode, iterations)
    np.testing.assert_allclose(res[0]["bodies"]["velocity"], ref[0], atol=TOL, rtol=TOL)
    for r in res:
        np.testing.assert_allclose(r["cache"]["impulses"], ref[1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3]])
def test_collectives_are_body_row_gathers(solved, case):
    """Objects-axis gathers of body rows only: jacobi one [N, 6] velocity
    gather a velocity iteration, the inverse masses and inertias [N, 10]
    once, positions and orientations [N, 7] each correction iteration and
    the written-back positions [N, 3]; scan one [N, 23] gather of the
    bodies' rows. None is shaped by the contacts; under jacobi none is
    larger than [N, 10] words."""
    mode, n, c, _, _ = case
    res, _, cfg, _ = solved(case)
    for r in res:
        assert solve_collectives_ok(r["records"], n, c, mode, cfg) is None, r["rank"]
        assert max(x["bytes"] for x in r["records"]) <= n * (10 if mode == "jacobi" else 23) * 4
        assert r["staged_bytes"] == 0  # CPU tensors ride gloo as they are
    velocity = [x for x in res[0]["records"] if x["bytes"] == n * 6 * 4]
    assert len(velocity) == (4 * max(cfg.n_iterations, 1) if mode == "jacobi" else 0)


@pytest.mark.parametrize("n_bodies,divides", [(1022, False), (1024, True)])
def test_bodies_that_do_not_divide_raise(world, n_bodies, divides):
    res = world.run(jobs.solve_guard_job, n_bodies)
    for r in res:
        if divides:
            assert r is None
        else:
            assert "does not divide" in r and "over 4 ranks" in r, r


def test_body_placements_follow_the_reference_rule():
    """``tests/test_parallel.py:220-229``: P("objects") for a leaf with
    ndim ≥ 1 and a leading dim of N, P() for any other."""
    b = empty_body_state(16, device="cpu")
    assert all(p == OBJECTS for _, p in leaves_with_path(body_shardings(None, b)))
    assert OBJECTS == (Shard(0), Replicate())
    odd = b._replace(mass=torch.ones(()), total_torque=torch.zeros((3, 3)))
    placements = dict(leaves_with_path(body_shardings(None, odd)))
    assert placements["mass"] == REPLICATED and placements["total_torque"] == REPLICATED
    assert placements["position"] == OBJECTS
