"""The sequential (Gauss-Seidel) contact solve of the ``scan`` solver mode:
the CUDA kernels' wrapper, their plain PyTorch version and their schedule.

Port of the two ``lax.scan`` loops of ``impact_tpu/physics/solver.py``
(``one_contact`` inside the velocity iterations, :258-298, and
``one_correction`` inside the positional correction, :415-448): each slot,
in slot order, reads what the slots before it wrote. No Pallas kernel of the
reference does this; the reference calls the mode "bitwise-deterministic,
used for reference parity".

``scan_iterations`` runs both loops. On CUDA tensors it launches the two
kernels of ``csrc/scan_solver.cu`` (one block each); on CPU tensors it runs
``scan_iterations_plain``, a loop over slots that repeats the reference's
operations in its order, each float operation a separate torch op. The
kernels round each operation the same way, so on the same inputs the two
agree bit for bit (up to the sign of a zero). There is no fallback: on a
CUDA tensor the kernel launches or the call raises. ``LAUNCHES`` counts the
launches.

The kernels do not walk the slots one by one. They walk the levels of
``scan_schedule``: a slot's level is one more than the largest level of an
earlier slot on one of its bodies, so each body still sees its slots in
slot order, and the slots of one level run in parallel. Inactive slots
change no velocity and no position (their change is ±0); in the correction
they still renormalize the orientations of their bodies, as the
reference's do, and a run of them on one pair is applied as one node.
Bodies no slot can change (``fixed_bodies``: the ground plane; in the
velocity sweeps any body with zero inverse mass and inertia) are no
dependency. ``csrc/scan_solver.cu``'s note gives the argument in full.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..utils.launches import LaunchCounter

LAUNCHES = LaunchCounter(scan_velocity_iterations=0, scan_position_correction=0)

# float32 operations per slot of each loop, counted from the kernel bodies
# of csrc/scan_solver.cu: each rounded add, sub, mul, div and sqrt, and each
# compare or max (clamp_min), counts one; negations count none.
#   velocity: relative velocity 27 (two crosses 18, three vector adds and
#     subs 9), three impulse rows 22 (dots 15, the target's sub, three muls,
#     three adds), the Coulomb clamp 11, the three deltas 6, dp 15, v of a
#     and b 12, w of a and b 54 (crosses 18, matvecs 30, adds 6): 147;
#   correction: two contact points 66 (rotate 30 and an add of 3, each),
#     depth 8, the two lever arms 6, their crosses with the normal 18, the
#     effective mass's denominator 43 and inverse 2, the active-and-
#     penetrating factor 2, the pseudo-impulse 3, dp 3, pos of a and b 12,
#     the two angular changes 48, two quaternion integrations 106 (53 each:
#     product 28, step 12, length 8, clamp 1, four divs): 317
VELOCITY_OPS_PER_SLOT = 147
CORRECTION_OPS_PER_SLOT = 317
# The longest dependent path of one slot's own arithmetic, from the load of
# its bodies' state to the last value it stores (an angular velocity, an
# orientation), by kind of operation, counted from velocity_apply and
# correction_apply in csrc/scan_solver.cu (clamp: clamp_min, a compare and
# a select; select: the Coulomb scale's; the mul by dt = 1 counts):
#   velocity: w × d (mul, sub), + v, rel (2 adds), a tangent's dot (mul, 2
#     adds), the mul by -e and the add of old, s1·s1 + s2·s2 (mul, add),
#     the square root, the clamp, the division, the select, the mul by
#     scale, fresh − old and the mul by on, dp (mul, 2 adds), d × dp (mul,
#     sub), the matvec's dot (mul, 2 adds), the add into w: 14 adds, 9 muls;
#   correction: rotate (3 muls, 3 adds), + pos, pb − pos, × normal (mul,
#     sub), the matvec's and the quadratic's dots (2 muls, 4 adds), the last
#     two adds of the denominator, the clamp, the division, the pseudo-
#     impulse (3 muls), dp (mul), d × dp (mul, sub), the matvec's dot (mul,
#     2 adds), the quaternion product (mul, 3 adds), the step (0.5·, 1·, +),
#     the squares and their sum (mul, 3 adds), the square root, the clamp,
#     the division: 22 adds, 16 muls.
# Loads, stores and barriers are left out: they are the design's.
VELOCITY_CHAIN_OPS = dict(add=14, mul=9, clamp=1, select=1, sqrt=1, div=1)
CORRECTION_CHAIN_OPS = dict(add=22, mul=16, clamp=2, sqrt=1, div=2)
# SM cycles of one dependent operation of each kind on the H100 (add.rn,
# mul.rn, a setp and selp, a selp, sqrt.rn, div.rn through its divisor),
# measured by devtools/probe_scan_walk.py on an NVIDIA H100 80GB HBM3 at
# 700 W: one slot's chain is then 192.4 cycles (velocity), 301.6 (correction)
OP_LATENCY_CYCLES = dict(add=4.069, mul=4.071, clamp=8.108, select=4.109, sqrt=42.413,
                         div=44.173)
VELOCITY_CHAIN_CYCLES = sum(k * OP_LATENCY_CYCLES[op] for op, k in VELOCITY_CHAIN_OPS.items())
CORRECTION_CHAIN_CYCLES = sum(k * OP_LATENCY_CYCLES[op]
                              for op, k in CORRECTION_CHAIN_OPS.items())


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device: torch.device):
    return torch.tensor(values, device=device)


def _cross(x, y):
    """x × y componentwise: (x1·y2 − x2·y1, x2·y0 − x0·y2, x0·y1 − x1·y0)."""
    p1, p2 = _index((1, 2, 0), x.device), _index((2, 0, 1), x.device)
    return (x.index_select(-1, p1) * y.index_select(-1, p2)
            - x.index_select(-1, p2) * y.index_select(-1, p1))


def _dot(x, y):
    """(x0·y0 + x1·y1) + x2·y2 over the last axis."""
    p = x * y
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _matvec(m, x):
    """Rows of m [...,3,3] dotted with x [...,3], each as ``_dot``."""
    return _dot(m, x[..., None, :])


def _clamp_impulses(s, friction):
    """Unilateral normal and Coulomb cone clamp of one accumulated impulse
    [3] (solver.py:_clamp_impulses)."""
    n = torch.clamp(s[0], min=0.0)
    max_t = friction * n
    t = s[1:]
    t2 = t * t
    t_mag = torch.sqrt(t2[0] + t2[1])
    scale = torch.where(t_mag > max_t, max_t / torch.clamp(t_mag, min=1e-12), 1.0)
    return torch.cat([n[None], t * scale])


def _rotate(q, v):
    """v + w·t + u × t with t = 2·(u × v) (math/quaternion.py:rotate)."""
    t = 2.0 * _cross(q[..., :3], v)
    return (v + q[..., 3:4] * t) + _cross(q[..., :3], t)


# Hamilton product (ω, 0) ⊗ q as four terms, each a factor of (ω, 0) times
# a permutation of q with signs, summed in the reference's order
_PERM = ((3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))
_SIGN = ([1.0, -1.0, 1.0, -1.0], [1.0, 1.0, -1.0, -1.0], [-1.0, 1.0, 1.0, -1.0])


def _integrate(q, om, signs):
    """normalize(q + 1·(0.5·(ω, 0) ⊗ q)) over rows q [...,4], ω [...,3]
    (math/quaternion.py:integrate_angular_velocity with dt = 1)."""
    m = 0.0 * q
    for k in range(3):
        m = m + om[..., k:k + 1] * (q.index_select(-1, _index(_PERM[k], q.device)) * signs[k])
    n = q + 1.0 * (0.5 * m)
    sq = n * n
    length = torch.sqrt(((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3])
    return n / torch.clamp(length, min=1e-12)[..., None]


def _velocity_plain(v, w, inv_mass, inv_inertia, prep, acc, n_iterations):
    v, w, acc = v.clone(), w.clone(), acc.clone()
    n_slots = prep.active.shape[0]
    if n_iterations <= 0 or n_slots == 0:
        return v, w, acc
    ab = torch.stack([prep.body_a, prep.body_b], dim=1)
    pairs, on_list = ab.tolist(), prep.active.tolist()
    zero = torch.zeros_like(prep.target_sep_vel)
    # per-slot rows, unbound once: the loop indexes Python lists
    rows = list(zip(
        ab.unbind(0),
        prep.active.to(torch.float32).unbind(0),
        torch.stack([prep.normal, prep.tangent, prep.bitangent], dim=1).unbind(0),
        torch.stack([prep.disp_a, prep.disp_b], dim=1).unbind(0),
        (-prep.eff_mass).unbind(0),
        torch.stack([prep.target_sep_vel, zero, zero], dim=-1).unbind(0),
        prep.friction_coef.unbind(0),
        torch.stack([inv_mass[prep.body_a], -inv_mass[prep.body_b]], dim=1)[..., None].unbind(0),
        inv_inertia[ab].unbind(0),
    ))
    sign = torch.tensor([[1.0], [-1.0]], device=v.device)
    for _ in range(n_iterations):
        for c, (idx, on, basis, disp, neg_em, target, friction, ims, inv_ab) in enumerate(rows):
            a, b = pairs[c]
            old = acc[c]
            vel = v.index_select(0, idx) + _cross(w.index_select(0, idx), disp)
            fresh = _clamp_impulses(old + neg_em * (_dot(basis, vel[0] - vel[1]) - target),
                                    friction)
            q = ((fresh - old) * on)[:, None] * basis
            dp = (q[0] + q[1]) + q[2]
            dv = ims * dp
            dw = _matvec(inv_ab, _cross(disp, dp)) * sign
            v[a].add_(dv[0])
            v[b].add_(dv[1])
            w[a].add_(dw[0])
            w[b].add_(dw[1])
            if on_list[c]:
                acc[c] = fresh
    return v, w, acc


def _correction_plain(pos, ori, inv_mass, inv_inertia, prep, factor, n_iterations):
    pos, ori = pos.clone(), ori.clone()
    n_slots = prep.active.shape[0]
    if n_iterations <= 0 or n_slots == 0:
        return pos, ori
    dev = pos.device
    ab = torch.stack([prep.body_a, prep.body_b], dim=1)
    pairs = ab.tolist()
    rows = list(zip(
        ab.unbind(0),
        prep.active.to(torch.float32).unbind(0),
        prep.normal.unbind(0),
        torch.stack([prep.local_a, prep.local_b], dim=1).unbind(0),
        (inv_mass[prep.body_a] + inv_mass[prep.body_b]).unbind(0),
        torch.stack([inv_mass[prep.body_a], -inv_mass[prep.body_b]], dim=1)[..., None].unbind(0),
        inv_inertia[ab].unbind(0),
    ))
    sign = torch.tensor([[1.0], [-1.0]], device=dev)
    signs = [torch.tensor(s, device=dev) for s in _SIGN]
    for _ in range(n_iterations):
        for c, (idx, on, nrm, local, im_sum, ims, inv_ab) in enumerate(rows):
            a, b = pairs[c]
            x = pos.index_select(0, idx)
            p = x + _rotate(ori.index_select(0, idx), local)  # (pa, pb)
            depth = _dot(nrm, p[1] - p[0])
            d = p[1] - x  # (pb − pos[a], pb − pos[b])
            cr = _cross(d, nrm)
            quad = _dot(cr, _matvec(inv_ab, cr))
            em = 1.0 / torch.clamp((im_sum + quad[0]) + quad[1], min=1e-12)
            dp = (((em * factor) * depth) * (on * (depth > 0.0).to(torch.float32))) * nrm
            dx = ims * dp
            dw = _matvec(inv_ab, _cross(d, dp)) * sign
            pos[a].add_(dx[0])
            pos[b].add_(dx[1])
            if a != b:
                ori[idx] = _integrate(ori.index_select(0, idx), dw, signs)
            else:
                ori[a] = _integrate(ori[a], dw[0], signs)
                ori[b] = _integrate(ori[b], dw[1], signs)
    return pos, ori


def scan_iterations_plain(v, w, pos, ori, inv_mass, inv_inertia, prep, acc, n_iterations: int,
                          n_corrections: int, factor: float):
    """The scan mode's loops in plain PyTorch: ``n_iterations`` velocity
    sweeps over the slots (``one_contact``), then ``n_corrections``
    pseudo-impulse sweeps (``one_correction``), on copies of the inputs.
    ``inv_inertia`` is the bodies' world inverse inertia before the solve;
    the correction keeps it. Returns (v, w, acc, pos, ori)."""
    v, w, acc = _velocity_plain(v, w, inv_mass, inv_inertia, prep, acc, n_iterations)
    pos, ori = _correction_plain(pos, ori, inv_mass, inv_inertia, prep, factor, n_corrections)
    return v, w, acc, pos, ori


def fixed_bodies(inv_mass, inv_inertia, ori=None):
    """Bodies no slot can change: zero inverse mass and an all-zero world
    inverse inertia (the velocity sweeps, ``ori`` None) and, for the
    correction, a finite orientation ``ori`` that the zero-rate integration
    (``_integrate``, the kernels' rounding) leaves bitwise as it is →
    bool [N]."""
    zero = (inv_mass == 0.0) & (inv_inertia.reshape(-1, 9) == 0.0).all(-1)
    if ori is None:
        return zero
    ori = ori.contiguous()
    signs = [torch.tensor(s, device=ori.device) for s in _SIGN]
    step = _integrate(ori, torch.zeros_like(ori[:, :3]), signs).contiguous()
    same = (step.view(torch.int32) == ori.view(torch.int32)).all(-1)
    return zero & torch.isfinite(ori).all(-1) & same


class ScanSchedule(NamedTuple):
    """The kernels' walk of one sweep (``scan_schedule``)."""
    velocity_fixed: torch.Tensor    # bool [N]
    correction_fixed: torch.Tensor  # bool [N]
    velocity_level: torch.Tensor    # int32 [C]; 0: skipped (inactive)
    correction_level: torch.Tensor  # int32 [C]; a run's slots share its level, 0: none
    runs: torch.Tensor              # int64 [R, 2]: first slot and length of each run walked
    velocity_depth: int
    correction_depth: int

    def packed(self):
        """int32 [2C + 2 + 2N] as the kernels write it: velocity levels,
        correction levels, the two depths, the two loops' fixed flags."""
        dev = self.velocity_level.device
        depths = torch.tensor([self.velocity_depth, self.correction_depth], dtype=torch.int32,
                              device=dev)
        return torch.cat([self.velocity_level, self.correction_level, depths,
                          self.velocity_fixed.to(torch.int32),
                          self.correction_fixed.to(torch.int32)])


def scan_schedule(body_a, body_b, active, inv_mass, inv_inertia, ori) -> ScanSchedule:
    """The levels the kernels walk, in plain torch on any device. A node is
    an active slot (both loops) or, in the correction, a run: consecutive
    inactive slots on one (a, b) pair, which renormalizes ori[a] and ori[b]
    once a slot. A node's level is 1 + the largest level of an earlier
    node on body a or b, fixed bodies (each loop's ``fixed_bodies``) not
    counted; a run on two fixed bodies has none. Each sweep walks levels
    1..depth in order."""
    v_fixed = fixed_bodies(inv_mass, inv_inertia)
    c_fixed = fixed_bodies(inv_mass, inv_inertia, ori)
    a_list, b_list = body_a.tolist(), body_b.tolist()
    on = active.tolist()
    n_slots = len(on)

    def walk(nodes, fx):
        """nodes: (first slot, length, walked on two fixed bodies) → levels, depth"""
        last, levels, depth = [0] * len(fx), [0] * n_slots, 0
        for c, k, always in nodes:
            a, b = a_list[c], b_list[c]
            if fx[a] and fx[b] and not always:
                continue
            lv = max(0 if fx[a] else last[a], 0 if fx[b] else last[b]) + 1
            for body in (a, b):
                if not fx[body]:
                    last[body] = lv
            levels[c:c + k] = [lv] * k
            depth = max(depth, lv)
        return levels, depth

    vel, v_depth = walk([(c, 1, True) for c in range(n_slots) if on[c]], v_fixed.tolist())
    nodes, c = [], 0
    while c < n_slots:
        e = c + 1
        if not on[c]:
            while e < n_slots and not on[e] and (a_list[e], b_list[e]) == (a_list[c], b_list[c]):
                e += 1
        nodes.append((c, e - c, bool(on[c])))
        c = e
    corr, c_depth = walk(nodes, c_fixed.tolist())
    runs = [(c, k) for c, k, is_slot in nodes if not is_slot and corr[c] > 0]
    dev = body_a.device
    return ScanSchedule(
        v_fixed, c_fixed, torch.tensor(vel, dtype=torch.int32, device=dev),
        torch.tensor(corr, dtype=torch.int32, device=dev),
        torch.tensor(runs, dtype=torch.int64, device=dev).reshape(-1, 2), v_depth, c_depth)


def _f32(t, shape, what):
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{what} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def scan_iterations(v, w, pos, ori, inv_mass, inv_inertia, prep, acc, n_iterations: int,
                    n_corrections: int, factor: float, with_schedule: bool = False):
    """``scan_iterations_plain``'s function: its plain version on CPU tensors,
    the two kernels of ``csrc/scan_solver.cu`` on CUDA tensors (one launch
    each). Body indices must lie in [0, N). With ``with_schedule`` it also
    returns the schedule the kernels walked, as ``ScanSchedule.packed``
    gives it (on CPU tensors ``scan_schedule``'s)."""
    dev = v.device
    if dev.type == "cpu":
        out = scan_iterations_plain(v, w, pos, ori, inv_mass, inv_inertia, prep, acc,
                                    n_iterations, n_corrections, factor)
        if not with_schedule:
            return out
        return (*out, scan_schedule(prep.body_a, prep.body_b, prep.active, inv_mass,
                                    inv_inertia, ori).packed())
    if dev.type != "cuda":
        raise ValueError(f"the scan solver runs on cuda or cpu tensors, not {dev}")
    from .. import _build

    return _launch(_build.load(), v, w, pos, ori, inv_mass, inv_inertia, prep, acc,
                   n_iterations, n_corrections, factor, with_schedule)


def _launch(lib, v, w, pos, ori, inv_mass, inv_inertia, prep, acc, n_iterations,
            n_corrections, factor, with_schedule):
    """The two kernels of ``lib`` (the package's library, or a build of
    ``csrc/scan_solver.cu`` with other flags) on CUDA tensors."""
    dev = v.device
    n, c = v.shape[0], prep.active.shape[0]
    if n == 0:
        raise ValueError("the scan solver needs at least one body")
    if n_iterations < 0 or n_corrections < 0:
        raise ValueError("iteration counts must be non-negative")
    ins = [_f32(t, s, k) for t, s, k in (
        (v, (n, 3), "v"), (w, (n, 3), "w"), (acc, (c, 3), "acc"), (pos, (n, 3), "pos"),
        (ori, (n, 4), "ori"))]
    outs = [torch.empty_like(t) for t in ins]
    im = _f32(inv_mass, (n,), "inv_mass")
    ii = _f32(inv_inertia, (n, 3, 3), "inv_inertia")
    ia = prep.body_a.to(torch.int32).contiguous()
    ib = prep.body_b.to(torch.int32).contiguous()
    on = prep.active.to(torch.float32).contiguous()
    f3 = {k: _f32(getattr(prep, k), (c, 3), k) for k in (
        "normal", "tangent", "bitangent", "disp_a", "disp_b", "eff_mass", "local_a", "local_b")}
    fr = _f32(prep.friction_coef, (c,), "friction_coef")
    tsv = _f32(prep.target_sep_vel, (c,), "target_sep_vel")
    # the schedule written out (2C + 2 + 2N), then the kernels' scratch
    # (4C + 2 + 2N) for a schedule that shared memory does not hold
    work = torch.empty(6 * c + 4 + 4 * n, dtype=torch.int32, device=dev)
    sched, scratch = work[:2 * c + 2 + 2 * n], work[2 * c + 2 + 2 * n:]
    sched_ptr = sched.data_ptr() if with_schedule else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    (v_in, w_in, acc_in, pos_in, ori_in), (v, w, acc, pos, ori) = ins, outs
    rc = lib.scan_velocity_iterations(
        v_in.data_ptr(), w_in.data_ptr(), acc_in.data_ptr(), v.data_ptr(), w.data_ptr(),
        acc.data_ptr(), im.data_ptr(), ii.data_ptr(), ia.data_ptr(),
        ib.data_ptr(), on.data_ptr(), f3["normal"].data_ptr(), f3["tangent"].data_ptr(),
        f3["bitangent"].data_ptr(), f3["disp_a"].data_ptr(), f3["disp_b"].data_ptr(),
        f3["eff_mass"].data_ptr(), fr.data_ptr(), tsv.data_ptr(), sched_ptr,
        scratch.data_ptr(), n, c, int(n_iterations), stream)
    if rc != 0:
        raise RuntimeError(f"scan_velocity_iterations launch failed: cudaError {rc}")
    LAUNCHES["scan_velocity_iterations"] += 1
    rc = lib.scan_position_correction(
        pos_in.data_ptr(), ori_in.data_ptr(), pos.data_ptr(), ori.data_ptr(), im.data_ptr(),
        ii.data_ptr(), ia.data_ptr(), ib.data_ptr(), on.data_ptr(), f3["normal"].data_ptr(),
        f3["local_a"].data_ptr(), f3["local_b"].data_ptr(), sched_ptr,
        scratch.data_ptr(), float(factor), n, c, int(n_corrections), stream)
    if rc != 0:
        raise RuntimeError(f"scan_position_correction launch failed: cudaError {rc}")
    LAUNCHES["scan_position_correction"] += 1
    return (v, w, acc, pos, ori, sched) if with_schedule else (v, w, acc, pos, ori)


def bound_ms(n_bodies: int, n_slots: int, n_iterations: int, n_corrections: int,
             peak_bytes_per_s=3.35e12, peak_flops=67e12):
    """Least time (ms) an H100 could take for one ``scan_iterations`` call,
    the larger of two times:
      bytes: the prepared contacts (velocity: 2 indices, the active flag,
        friction, target, 6 three-vectors and the impulses, 26 words;
        correction: 2 indices, the flag, normal, two local points, 12 words)
        and the bodies (v, w, inverse mass, inverse inertia; pos, ori,
        inverse mass, inverse inertia) read once, the impulses, v, w, pos
        and ori written once;
      operations: every slot of every sweep, VELOCITY_OPS_PER_SLOT and
        CORRECTION_OPS_PER_SLOT float32 operations, at the non-tensor rate.
    Returns (ms, "bytes" | "operations")."""
    read = 4 * (n_slots * (26 + 12) + n_bodies * (16 + 17))
    written = 4 * (n_slots * 3 + n_bodies * (6 + 7))
    ops = n_slots * (n_iterations * VELOCITY_OPS_PER_SLOT
                     + n_corrections * CORRECTION_OPS_PER_SLOT)
    t_bytes = (read + written) / peak_bytes_per_s
    t_ops = ops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def chain_bound_ms(velocity_depth: int, correction_depth: int, n_iterations: int,
                   n_corrections: int, clock_hz: float):
    """Least time (ms) the function's dependency chain takes on the card:
    every sweep walks its levels (the schedule's depths: each body's slots
    in slot order) one after another, and a level takes at least the
    longest dependent path of one slot's own arithmetic
    (VELOCITY_CHAIN_CYCLES, CORRECTION_CHAIN_CYCLES) at the SM clock
    ``clock_hz``. Loads, stores, barriers and the schedule's build are not
    counted."""
    cycles = (n_iterations * velocity_depth * VELOCITY_CHAIN_CYCLES
              + n_corrections * correction_depth * CORRECTION_CHAIN_CYCLES)
    return cycles / clock_hz * 1e3
