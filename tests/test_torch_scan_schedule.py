"""The scan solver's schedule (``physics/scan_solver.py:scan_schedule``),
which the CUDA kernels walk, against the sequential plain loop on the CPU.

A plain executor walks each sweep as the kernels do: level by level, each
slot of a level computed from the state at the level's start (the slots
of a level run in parallel on the card) and taken in reverse slot order, to
show that order within a level does not matter; it stores nothing to a
fixed body, asserts that no two slots of a level write one body, skips
inactive velocity slots and applies each correction run as a renormalization
repeated to its fixed point. Its per-slot arithmetic is ``_velocity_plain``
and ``_correction_plain`` on one slot. Bar: ``torch.equal`` with
``scan_iterations_plain`` in v, w, the impulses, positions and orientations
(the schedule's claim is exactness; only the sign of a zero may differ,
which equality does not see), and levels equal to hand-worked ones.

Inputs: a ground body at identity that slots share (fixed, no dependency),
the same body with a non-unit quaternion (fixed in the velocity sweeps, a
dependency in the correction), the same body moving (a dependency in
both), a compacted tail on
body 0 whose quaternion is scaled by 3 (its run renormalizes more than once),
inactive slots in mid-buffer on another pair, an active slot with a = b, and
-0.0 components in v and w; 16 and 48 slots, 3 velocity and 2 correction
sweeps."""

import numpy as np
import pytest
import torch
from test_torch_scan_cuda import random_inputs

from impact_tpu_torch.physics import scan_solver as ss

N_ITERATIONS, N_CORRECTIONS, FACTOR = 3, 2, 0.2
# the crafted scene: slots 5-6 inactive mid-buffer, 10-15 the compacted tail
PAIRS = [(1, 0), (2, 0), (3, 0), (1, 2), (4, 4), (5, 6), (5, 6), (3, 4), (2, 3), (6, 0)] \
    + [(0, 0)] * 6
ACTIVE = [1, 1, 1, 1, 1, 0, 0, 1, 1, 1] + [0] * 6
# body 0 fixed: ground contacts do not chain, the tail is no node (the
# velocity sweeps of every ground with zero inverse mass and inertia)
GROUND_VELOCITY = [1, 1, 1, 2, 1, 0, 0, 2, 3, 1, 0, 0, 0, 0, 0, 0]
GROUND_CORRECTION = [1, 1, 1, 2, 1, 1, 1, 2, 3, 2, 0, 0, 0, 0, 0, 0]
# body 0 not fixed: every slot on it chains, the tail is one run after them
LOOSE_VELOCITY = [1, 2, 3, 3, 1, 0, 0, 4, 5, 4, 0, 0, 0, 0, 0, 0]
LOOSE_CORRECTION = [1, 2, 3, 3, 1, 1, 1, 4, 5, 4, 5, 5, 5, 5, 5, 5]


def one_slot(prep, c):
    return prep._replace(**{f: getattr(prep, f)[c:c + 1] for f in prep._fields})


def renormalize(q, times):
    """The zero-rate step applied up to ``times`` times, stopping at its
    fixed point → (q, steps that changed it)."""
    signs = [torch.tensor(s) for s in ss._SIGN]
    for k in range(times):
        r = ss._integrate(q, torch.zeros(3), signs)
        if torch.equal(r, q):
            return q, k
        q = r
    return q, times


def scheduled_walk(v, w, pos, ori, inv_mass, inv_inertia, prep, acc, n_iterations,
                   n_corrections, factor):
    """The scan solve walked in ``scan_schedule``'s order → (v, w, acc,
    pos, ori, schedule, most renormalizations a run applied)."""
    sch = ss.scan_schedule(prep.body_a, prep.body_b, prep.active, inv_mass, inv_inertia, ori)
    pairs = list(zip(prep.body_a.tolist(), prep.body_b.tolist()))
    v, w, acc, pos, ori = (t.clone() for t in (v, w, acc, pos, ori))

    def level_slots(levels, lv):
        return [c for c, x in enumerate(levels.tolist()) if x == lv][::-1]

    def store(fixed, written, body, *pairs_of_rows):
        if fixed[body]:
            return
        assert body not in written, f"two slots of one level write body {body}"
        written.add(body)
        for dst, src in pairs_of_rows:
            dst[body] = src[body]

    fixed = sch.velocity_fixed.tolist()
    for _ in range(n_iterations):
        for lv in range(1, sch.velocity_depth + 1):
            v0, w0, written = v.clone(), w.clone(), set()
            for c in level_slots(sch.velocity_level, lv):
                nv, nw, na = ss._velocity_plain(v0, w0, inv_mass, inv_inertia,
                                                one_slot(prep, c), acc[c:c + 1], 1)
                for body in set(pairs[c]):
                    store(fixed, written, body, (v, nv), (w, nw))
                acc[c] = na[0]
    fixed = sch.correction_fixed.tolist()
    run_len = {c: k for c, k in sch.runs.tolist()}
    most = 0
    for _ in range(n_corrections):
        for lv in range(1, sch.correction_depth + 1):
            p0, o0, written = pos.clone(), ori.clone(), set()
            for c in level_slots(sch.correction_level, lv):
                a, b = pairs[c]
                if c in run_len:
                    new = o0.clone()
                    times = run_len[c] * (2 if a == b else 1)
                    for body in {a, b} - {i for i in (a, b) if fixed[i]}:
                        new[body], k = renormalize(o0[body], times)
                        most = max(most, k)
                        store(fixed, written, body, (ori, new))
                elif bool(prep.active[c]):
                    np_, no = ss._correction_plain(p0, o0, inv_mass, inv_inertia,
                                                   one_slot(prep, c), factor, 1)
                    for body in {a, b}:
                        store(fixed, written, body, (pos, np_), (ori, no))
    return v, w, acc, pos, ori, sch, most


def assert_walks_equal(args):
    got = scheduled_walk(*args)
    ref = ss.scan_iterations_plain(*args)
    for name, g, r in zip(("v", "w", "impulses", "position", "orientation"), got, ref):
        assert torch.equal(g, r), (name, (g - r).abs().max().item())
    return got[5], got[6]


GROUNDS = ("at_identity", "not_unit", "moving")


def crafted(ground, seed=3):
    """The crafted scene: 8 bodies, 16 slots, body 0 (``ground``) at the
    identity with zero inverse mass and inertia (fixed), the same with its
    quaternion a unit one scaled by 3 (a tilted ground that renormalization
    changes: fixed in the velocity sweeps only), or that with the inverse
    mass and inertia of a dynamic body (fixed in neither); -0.0 in v and w
    of bodies 0, 5, 6."""
    v, w, pos, ori, im, ii, prep, acc, _, _, _ = random_inputs(8, 16, seed, "cpu")
    prep = prep._replace(body_a=torch.tensor([p[0] for p in PAIRS]),
                         body_b=torch.tensor([p[1] for p in PAIRS]),
                         active=torch.tensor(ACTIVE, dtype=torch.bool))
    acc = prep.warm_impulses * prep.active[:, None]
    if ground != "moving":
        im[0], ii[0] = 0.0, 0.0
    if ground == "at_identity":
        ori[0] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    else:
        ori[0] = 3.0 * quaternion_renormalized_twice()
    for body in (0, 5, 6):
        v[body] = torch.tensor([-0.0, 0.0, -0.0])
        w[body] = torch.tensor([0.0, -0.0, -0.0])
    return (v, w, pos, ori, im, ii, prep, acc, N_ITERATIONS, N_CORRECTIONS, FACTOR)


def quaternion_renormalized_twice():
    """A unit quaternion q (seeded) for which the zero-rate step changes 3q
    twice before it stops changing it."""
    rng = np.random.default_rng(1)
    for _ in range(64):
        q = rng.normal(size=4)
        q = torch.tensor(q / np.linalg.norm(q), dtype=torch.float32)
        if renormalize(3.0 * q, 8)[1] >= 2:
            return q
    raise AssertionError("no quaternion in 64 draws needs two steps")


@pytest.mark.parametrize("ground", GROUNDS, ids=[f"ground_{g}" for g in GROUNDS])
def test_crafted_scene_levels_and_walk(ground):
    args = crafted(ground)
    sch, most = assert_walks_equal(args)
    # body 6 is kinematic with a random orientation: fixed in the velocity
    # sweeps, not in the correction
    assert sch.velocity_fixed.tolist() == [ground != "moving"] + [False] * 5 + [True, False]
    assert sch.correction_fixed.tolist() == [ground == "at_identity"] + [False] * 7
    vel = LOOSE_VELOCITY if ground == "moving" else GROUND_VELOCITY
    corr = GROUND_CORRECTION if ground == "at_identity" else LOOSE_CORRECTION
    assert sch.velocity_level.tolist() == vel
    assert sch.correction_level.tolist() == corr
    assert (sch.velocity_depth, sch.correction_depth) == (max(vel), max(corr))
    if ground == "at_identity":
        assert sch.runs.tolist() == [[5, 2]]  # the tail on two fixed bodies is no node
    else:
        assert sch.runs.tolist() == [[5, 2], [10, 6]]
        assert most >= 2  # the tail's run renormalized 3q more than once


@pytest.mark.parametrize("seed", [0, 1])
def test_random_compacted_slots_walk_equal(seed):
    """48 slots over 12 bodies as compaction leaves them: 30 active slots
    first (a fifth on the ground body 0, one with a = b), two inactive on
    another pair among them, then the tail on (0, 0)."""
    rng = np.random.default_rng(seed)
    v, w, pos, ori, im, ii, prep, acc, _, _, _ = random_inputs(12, 48, 100 + seed, "cpu")
    a = rng.integers(1, 12, 48)
    b = np.where(rng.uniform(size=48) < 0.2, 0, rng.integers(1, 12, 48))
    b[7] = a[7]
    active = np.arange(48) < 30
    active[[12, 13]] = False
    a[13], b[13] = a[12], b[12]
    a[30:], b[30:] = 0, 0
    prep = prep._replace(body_a=torch.from_numpy(a), body_b=torch.from_numpy(b),
                         active=torch.from_numpy(active))
    acc = prep.warm_impulses * prep.active[:, None]
    im[0], ii[0], ori[0] = 0.0, 0.0, torch.tensor([0.0, 0.0, 0.0, 1.0])
    sch, _ = assert_walks_equal((v, w, pos, ori, im, ii, prep, acc, N_ITERATIONS,
                                 N_CORRECTIONS, FACTOR))
    assert 1 < sch.velocity_depth < 30 and 1 < sch.correction_depth < 30
    assert sch.velocity_level[30:].eq(0).all() and sch.correction_level[30:].eq(0).all()


def test_one_body_in_every_slot_is_one_chain():
    args = list(random_inputs(6, 12, 4, "cpu", same_body="a"))
    args[8], args[9] = N_ITERATIONS, N_CORRECTIONS
    # body 1, in every slot, is kinematic in these inputs: make it dynamic
    args[4], args[5] = args[4].clone(), args[5].clone()
    args[4][1], args[5][1] = 0.5, 0.5 * torch.eye(3)
    sch, _ = assert_walks_equal(tuple(args))
    on = args[6].active.to(torch.int32)
    assert sch.velocity_level.tolist() == torch.cumsum(on, 0).mul(on).tolist()
    assert sch.correction_depth == len(sch.runs) + int(on.sum())


def test_cpu_wrapper_returns_the_schedule_and_chain_bound():
    args = crafted("not_unit")
    *out, packed = ss.scan_iterations(*args, with_schedule=True)
    sch = ss.scan_schedule(args[6].body_a, args[6].body_b, args[6].active, args[4], args[5],
                           args[3])
    assert torch.equal(packed, sch.packed()) and packed.shape == (2 * 16 + 2 + 2 * 8,)
    assert packed[32:34].tolist() == [3, 5]
    assert packed[34:].tolist() == [1, 0, 0, 0, 0, 0, 1, 0] + [0] * 8
    for g, r in zip(out, ss.scan_iterations_plain(*args)):
        assert torch.equal(g, r)
    clock_hz = 1.98e9
    ms = ss.chain_bound_ms(3, 3, 8, 3, clock_hz)
    assert ms == pytest.approx((8 * 3 * ss.VELOCITY_CHAIN_CYCLES
                                + 3 * 3 * ss.CORRECTION_CHAIN_CYCLES) / clock_hz * 1e3)
    assert ss.chain_bound_ms(6, 3, 8, 3, clock_hz) > ms > ss.bound_ms(16, 8, 8, 3)[0]
    # the chain counts each kind of operation at its latency
    assert ss.VELOCITY_CHAIN_CYCLES == sum(
        k * ss.OP_LATENCY_CYCLES[op] for op, k in ss.VELOCITY_CHAIN_OPS.items())
