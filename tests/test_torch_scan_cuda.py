"""The scan solver's CUDA kernels (``csrc/scan_solver.cu``) against their
plain PyTorch version (``physics/scan_solver.py:scan_iterations_plain``) on
the card, on random contact sets: slot counts that are not a multiple of 32,
body pools past a block's shared memory (the walk then reads and writes
global memory), every slot inactive, one body in every slot (a chain as
deep as the slots), no slot, the crafted scenes of
``tests/test_torch_scan_schedule.py`` widened to 1024 and 4096 slots with a
long tail, a level wider than the block, and inputs that are not finite.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU or interpret mode),
so these tests skip elsewhere; they import no JAX, so they run on the GPU
host: ``python -m pytest --noconftest -q -m cuda tests/test_torch_scan_cuda.py``.
Bar: equal. The kernels round every float operation as the plain version's
elementwise torch ops do, in the same order, and keep each body's slots in
slot order, so v, w, the impulses, positions and orientations must be
equal; the schedule the kernels write out must equal ``scan_schedule``'s."""

import numpy as np
import pytest
import torch

from impact_tpu_torch.physics import scan_solver
from impact_tpu_torch.physics.solver import PreparedContacts, _construct_tangents


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _unit(rng, n, d):
    x = rng.normal(size=(n, d))
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def random_inputs(n, c, seed, device, active_share=0.7, same_body=None):
    """scan_iterations' arguments for n bodies and c slots: dynamic bodies
    with SPD world inverse inertia (a fifth kinematic, with zero inverse
    mass and inertia), contacts between random bodies with unit normals and
    their tangents, and a warm start."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    inv_mass = rng.uniform(0.2, 1.0, n)
    a = rng.normal(size=(n, 3, 3)) * 0.3
    inv_inertia = np.eye(3) * rng.uniform(0.3, 1.0, (n, 1, 1)) + a @ a.transpose(0, 2, 1)
    kin = rng.uniform(size=n) < 0.2
    inv_mass[kin], inv_inertia[kin] = 0.0, 0.0
    body_a = rng.integers(0, n, c)
    body_b = rng.integers(0, n, c)
    if same_body == "both":
        body_a[:], body_b[:] = 1, 1
    elif same_body == "a":
        body_a[:] = 1
    normal = torch.tensor(_unit(rng, c, 3), dtype=torch.float32)
    t1, t2 = _construct_tangents(normal)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    prep = PreparedContacts(
        active=t(rng.uniform(size=c) < active_share, torch.bool),
        body_a=t(body_a, torch.int64), body_b=t(body_b, torch.int64),
        normal=normal.to(device), tangent=t1.to(device), bitangent=t2.to(device),
        disp_a=t(rng.uniform(-1, 1, (c, 3)).astype(f32)),
        disp_b=t(rng.uniform(-1, 1, (c, 3)).astype(f32)),
        local_a=t(rng.uniform(-1, 1, (c, 3)).astype(f32)),
        local_b=t(rng.uniform(-1, 1, (c, 3)).astype(f32)),
        eff_mass=t(rng.uniform(0.1, 2.0, (c, 3)).astype(f32)),
        friction_coef=t(rng.uniform(0.2, 0.9, c).astype(f32)),
        target_sep_vel=t(np.where(rng.uniform(size=c) < 0.3, rng.uniform(0, 2, c), 0.0)),
        warm_impulses=t(rng.uniform(0, 0.3, (c, 3)).astype(f32)),
        key=t(np.arange(c), torch.int64),
    )
    return (t(rng.normal(size=(n, 3))), t(rng.normal(size=(n, 3))),
            t(rng.uniform(-3, 3, (n, 3))), t(_unit(rng, n, 4) * rng.uniform(0.9, 1.1, (n, 1))),
            t(inv_mass), t(inv_inertia), prep, prep.warm_impulses, 8, 3, 0.2)


def run_both(args, equal=torch.equal):
    scan_solver.LAUNCHES.reset()
    *got, sched = scan_solver.scan_iterations(*args, with_schedule=True)
    torch.cuda.synchronize()
    assert scan_solver.LAUNCHES["scan_velocity_iterations"] == 1
    assert scan_solver.LAUNCHES["scan_position_correction"] == 1
    ref = scan_solver.scan_iterations_plain(*args)
    for name, g, r in zip(("v", "w", "impulses", "position", "orientation"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert equal(g, r), (name, (g - r).abs().max().item())
    prep = args[6]
    want = scan_solver.scan_schedule(prep.body_a, prep.body_b, prep.active, args[4], args[5],
                                     args[3])
    assert torch.equal(sched, want.packed())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(24, 128), (24, 45), (80, 200), (7, 1), (30, 0)])
def test_kernel_matches_plain_on_card(cuda_device, n, c):
    got = run_both(random_inputs(n, c, n * 1000 + c, cuda_device))
    assert all(bool(torch.isfinite(x).all()) for x in got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3600, 4000])
def test_bodies_past_shared_memory(cuda_device, n):
    """The velocity walk keeps 16 floats a body in shared memory: 3600
    bodies (230 kB) leave no room for the schedule or 64 slots' contacts
    beside them, and the correction's 17 floats a body do not fit; at 4000
    (256 kB) both walks read and write global memory."""
    run_both(random_inputs(n, 64, n, cuda_device))


@pytest.mark.cuda
def test_every_slot_inactive(cuda_device):
    args = random_inputs(24, 77, 5, cuda_device, active_share=0.0)
    v, w, acc, pos, ori = run_both(args)
    assert torch.equal(v, args[0]) and torch.equal(w, args[1]) and torch.equal(pos, args[2])
    # the correction still renormalizes every orientation a slot points at
    touched = torch.unique(torch.cat([args[6].body_a, args[6].body_b]))
    norms = torch.linalg.vector_norm(ori[touched], dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("same", ["both", "a"])
def test_one_body_in_every_slot(cuda_device, same):
    run_both(random_inputs(24, 96, 9, cuda_device, same_body=same))


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1024, 4096])
@pytest.mark.parametrize("ground", ["at_identity", "not_unit", "moving"],
                         ids=["ground_at_identity", "ground_not_unit", "ground_moving"])
def test_crafted_scenes_with_a_long_tail(cuda_device, slots, ground):
    """The crafted scenes of test_torch_scan_schedule.py (a shared ground
    body, fixed in both loops, in the velocity's only, or in neither, a = b,
    inactive slots mid-buffer, -0.0 in v and w) padded to 1024 bodies and
    ``slots`` slots with copies of their tail slot (chip_smoke.py's
    ``pad_inputs``); at 4096 the contacts stay in global memory."""
    from test_torch_scan_schedule import crafted

    from chip_smoke import pad_inputs

    args = pad_inputs(crafted(ground), 1024, slots, like_body=0)
    prep = args[6]._replace(**{f: getattr(args[6], f).to(cuda_device)
                               for f in PreparedContacts._fields})
    run_both(tuple(prep if i == 6 else a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                   for i, a in enumerate(args)))


@pytest.mark.cuda
def test_a_level_wider_than_the_block(cuda_device):
    """600 active slots, each between its own body and a fixed ground body:
    one level of 600 slots, more than the block's 256 threads."""
    args = list(random_inputs(601, 640, 17, cuda_device, active_share=1.0))
    prep = args[6]
    ids = torch.arange(1, 601, device=cuda_device)
    zero = torch.zeros(40, dtype=torch.int64, device=cuda_device)
    args[6] = prep._replace(body_a=torch.cat([ids, zero]), body_b=torch.cat([ids * 0, zero]),
                            active=torch.arange(640, device=cuda_device) < 600)
    im, ii, ori = args[4].clone(), args[5].clone(), args[3].clone()
    im[0], ii[0] = 0.0, 0.0
    ori[0] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=cuda_device)
    args[3], args[4], args[5] = ori, im, ii
    run_both(tuple(args))
    sch = scan_solver.scan_schedule(args[6].body_a, args[6].body_b, args[6].active, im, ii, ori)
    assert (sch.velocity_depth, sch.correction_depth) == (1, 1)


def equal_or_both_nan(g, r):
    return torch.equal(torch.isnan(g), torch.isnan(r)) and torch.equal(
        torch.nan_to_num(g, nan=0.0), torch.nan_to_num(r, nan=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["inactive_slot_normal", "body_velocity"])
def test_inputs_not_finite_walk_in_slot_order(cuda_device, where):
    """A NaN normal on an inactive slot (which the schedule would skip) or an
    infinite velocity: the kernels walk every slot in slot order and give
    the plain loop's values, NaN where it has NaN."""
    args = list(random_inputs(24, 128, 21, cuda_device))
    prep = args[6]
    if where == "inactive_slot_normal":
        c = int(torch.nonzero(~prep.active)[0])
        normal = prep.normal.clone()
        normal[c, 0] = float("nan")
        args[6] = prep._replace(normal=normal)
    else:
        v = args[0].clone()
        v[int(prep.body_a[0]), 1] = float("inf")
        args[0] = v
    got = run_both(tuple(args), equal=equal_or_both_nan)
    assert not all(bool(torch.isfinite(x).all()) for x in got)
