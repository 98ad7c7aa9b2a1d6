"""Impulse-based contact and joint solver (port of
``impact_tpu/physics/solver.py``; ref: impact_physics/src/constraint/
solver.rs and contact.rs:233-520).

The ``jacobi`` mode is ported: every contact computes its impulse from the
same velocities, and the under-relaxed deltas accumulate per body. The
accumulation keeps the reference's two paths: below
SEGMENT_ACCUMULATION_MIN_BODIES bodies a one-hot incidence product
(``torch.matmul`` in float32, TF32 off), at or above it a sort by body once
per solve and per-body differences of a prefix sum; given a row range
(the body-sharded solve of ``parallel/solver.py``), the warm start and
the accumulation give those bodies' rows only, each summed as in the
whole solve. The warm start scatters with ``index_add``, whose float sums
on CUDA run in atomic order, so results are held to a tolerance, not to
equality. The sequential ``scan`` mode
(Gauss-Seidel, the default) walks the slots in order in
``physics/scan_solver.py``: one CUDA kernel per loop on the card, a plain
loop over slots on the CPU.

Warm starting is a sorted join on contact keys (both frames' compacted
buffers hold ascending keys).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import quaternion as quat
from ..math.quaternion import cross
from .collision import EMPTY_KEY, ContactBuffer
from .scan_solver import scan_iterations
from .state import BodyState, compute_velocities, synchronize_momenta, world_inv_inertia

NORMAL_SPEED_FOR_BOUNCE = 0.4  # ref: contact.rs:236
SQUARED_SLIP_SPEED_FOR_DYNAMIC_FRICTION = 1e-4  # ref: contact.rs:238
WARM_START_DIRECTION_THRESHOLD = 1e-2  # ref: contact.rs:318
SEGMENT_ACCUMULATION_MIN_BODIES = 128
JACOBI_RELAXATION = 0.8


class SolverCache(NamedTuple):
    """Warm-start impulses carried across steps, and the last solve's contact
    bodies and points (read by fracturing)."""

    key: torch.Tensor  # i64[C] ascending; EMPTY_KEY = empty
    impulses: torch.Tensor  # f32[C,3] accumulated (normal, tangent, bitangent)
    normal: torch.Tensor  # f32[C,3]
    tangent: torch.Tensor  # f32[C,3]
    active: torch.Tensor  # bool[C]
    body_a: torch.Tensor  # i64[C]
    body_b: torch.Tensor  # i64[C]
    position: torch.Tensor  # f32[C,3] contact point at prepare time


def empty_solver_cache(max_contacts: int, device="cuda") -> SolverCache:
    z3 = torch.zeros((max_contacts, 3), device=device)
    zi = torch.zeros(max_contacts, dtype=torch.int64, device=device)
    return SolverCache(
        key=torch.full((max_contacts,), EMPTY_KEY, dtype=torch.int64, device=device),
        impulses=z3, normal=z3.clone(), tangent=z3.clone(),
        active=torch.zeros(max_contacts, dtype=torch.bool, device=device),
        body_a=zi, body_b=zi.clone(), position=z3.clone(),
    )


class PreparedContacts(NamedTuple):
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    normal: torch.Tensor
    tangent: torch.Tensor
    bitangent: torch.Tensor
    disp_a: torch.Tensor  # contact point − COM_a (world, at prepare)
    disp_b: torch.Tensor
    local_a: torch.Tensor  # deepest point on A in A's body frame
    local_b: torch.Tensor  # deepest point on B in B's body frame
    eff_mass: torch.Tensor  # f32[C,3] (n, t, b)
    friction_coef: torch.Tensor
    target_sep_vel: torch.Tensor
    warm_impulses: torch.Tensor
    key: torch.Tensor


def _construct_tangents(normal):
    """Tangent basis (ref: contact.rs:813-830)."""
    nx, ny, nz = normal.unbind(-1)
    zero = torch.zeros_like(nx)
    t_yz = torch.stack([zero, nz, -ny], dim=-1)
    t_xy = torch.stack([ny, -nx, zero], dim=-1)
    t1 = torch.where((nx.abs() < 0.57735)[..., None], t_yz, t_xy)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-12)
    return t1, cross(normal, t1)


def _effective_mass(inv_mass_a, inv_mass_b, inv_in_a, inv_in_b, disp_a, disp_b, direction):
    """1 / (mA⁻¹ + mB⁻¹ + (rA×d)ᵀIA⁻¹(rA×d) + (rB×d)ᵀIB⁻¹(rB×d))."""
    ca = cross(disp_a, direction)
    cb = cross(disp_b, direction)
    denom = (inv_mass_a + inv_mass_b
             + (ca * torch.einsum("...ij,...j->...i", inv_in_a, ca)).sum(dim=-1)
             + (cb * torch.einsum("...ij,...j->...i", inv_in_b, cb)).sum(dim=-1))
    return 1.0 / torch.clamp(denom, min=1e-12)


def prepare_contacts(bodies: BodyState, contacts: ContactBuffer, cache: SolverCache,
                     config) -> PreparedContacts:
    """Contact preparation on pre-force velocities (ref: contact.rs:233-316)
    and the warm-start join."""
    v, w = compute_velocities(bodies)
    inv_inertia = world_inv_inertia(bodies)
    ia, ib = contacts.body_a, contacts.body_b
    disp_a = contacts.position - bodies.position[ia]
    disp_b = contacts.position - bodies.position[ib]
    normal = contacts.normal
    t1, t2 = _construct_tangents(normal)
    pos_on_a = contacts.position - contacts.depth[:, None] * normal
    local_a = quat.inverse_rotate(bodies.orientation[ia], pos_on_a - bodies.position[ia])
    local_b = quat.inverse_rotate(bodies.orientation[ib], contacts.position - bodies.position[ib])
    em = torch.stack([
        _effective_mass(bodies.inv_mass[ia], bodies.inv_mass[ib], inv_inertia[ia],
                        inv_inertia[ib], disp_a, disp_b, d)
        for d in (normal, t1, t2)], dim=-1)

    rel_vel = (v[ia] + cross(w[ia], disp_a)) - (v[ib] + cross(w[ib], disp_b))
    sep_vel = (normal * rel_vel).sum(dim=-1)
    target_sep_vel = torch.where(sep_vel.abs() >= NORMAL_SPEED_FOR_BOUNCE,
                                 -contacts.response[:, 0] * sep_vel, 0.0)
    slip2 = (t1 * rel_vel).sum(dim=-1) ** 2 + (t2 * rel_vel).sum(dim=-1) ** 2
    friction = torch.where(slip2 >= SQUARED_SLIP_SPEED_FOR_DYNAMIC_FRICTION,
                           contacts.response[:, 2], contacts.response[:, 1])

    # warm-start join: both key arrays ascend
    idx = torch.clamp(torch.searchsorted(cache.key, contacts.key), 0, cache.key.shape[0] - 1)
    matched = (cache.key[idx] == contacts.key) & contacts.active
    thr = 1.0 - WARM_START_DIRECTION_THRESHOLD
    can_warm = (((normal * cache.normal[idx]).sum(dim=-1) > thr)
                & ((t1 * cache.tangent[idx]).sum(dim=-1) > thr))
    warm = torch.where((matched & can_warm)[:, None],
                       cache.impulses[idx] * config.old_impulse_weight, 0.0)
    return PreparedContacts(
        active=contacts.active, body_a=ia, body_b=ib, normal=normal, tangent=t1,
        bitangent=t2, disp_a=disp_a, disp_b=disp_b, local_a=local_a, local_b=local_b,
        eff_mass=em, friction_coef=friction, target_sep_vel=target_sep_vel,
        warm_impulses=warm, key=contacts.key,
    )


def _clamp_impulses(imp, friction_coef):
    """Unilateral normal + Coulomb cone clamp (ref: contact.rs:371-397)."""
    n = torch.clamp(imp[..., 0], min=0.0)
    max_t = friction_coef * n
    t_mag = torch.sqrt(imp[..., 1] ** 2 + imp[..., 2] ** 2)
    scale = torch.where(t_mag > max_t, max_t / torch.clamp(t_mag, min=1e-12), 1.0)
    return torch.stack([n, imp[..., 1] * scale, imp[..., 2] * scale], dim=-1)


def _momentum_change(prep: PreparedContacts, imp):
    return (imp[..., 0:1] * prep.normal + imp[..., 1:2] * prep.tangent
            + imp[..., 2:3] * prep.bitangent)


def _local_rows(idx, rows):
    """Body indices → row indices of the range ``rows`` = (lo, hi): a body
    outside it goes to the spare row hi − lo."""
    lo, hi = rows
    return torch.where((idx >= lo) & (idx < hi), idx - lo, hi - lo)


def _with_spare_row(t):
    return torch.cat([t, torch.zeros_like(t[:1])])


def warm_start(prep: PreparedContacts, v, w, inv_mass, inv_inertia, rows=None):
    """The warm start: the cached impulses scatter-added into the velocities
    → (acc, v, w). With ``rows`` = (lo, hi), ``v``, ``w``, ``inv_mass`` and
    ``inv_inertia`` are the rows of bodies [lo, hi) and only they receive,
    each its contacts' terms in contact order, as in the whole scatter."""
    act3 = prep.active[:, None]
    acc = prep.warm_impulses * act3
    dp = _momentum_change(prep, acc) * act3
    ia, ib = prep.body_a, prep.body_b
    if rows is not None:
        ia, ib = _local_rows(ia, rows), _local_rows(ib, rows)
        v, w, inv_mass, inv_inertia = map(_with_spare_row, (v, w, inv_mass, inv_inertia))
    v = v.index_add(0, ia, inv_mass[ia, None] * dp)
    v = v.index_add(0, ib, -inv_mass[ib, None] * dp)
    w = w.index_add(0, ia, torch.einsum("cij,cj->ci", inv_inertia[ia], cross(prep.disp_a, dp)))
    w = w.index_add(0, ib, -torch.einsum("cij,cj->ci", inv_inertia[ib],
                                         cross(prep.disp_b, dp)))
    if rows is not None:
        v, w = v[:-1], w[:-1]
    return acc, v, w


def _accumulator(prep: PreparedContacts, n: int, inv_mass, inv_inertia, rows=None):
    """[C,3] world momentum changes → per-body (dv [N,3], dw [N,3]). With
    ``rows`` = (lo, hi), the rows of bodies [lo, hi) of N only: ``inv_mass``
    and ``inv_inertia`` are those rows', and each row sums what it sums in
    the whole accumulation, in the same order."""
    ia, ib, act = prep.body_a, prep.body_b, prep.active
    lo, hi = (0, n) if rows is None else rows
    if n < SEGMENT_ACCUMULATION_MIN_BODIES:
        # one-hot incidence products, built once per solve; a row range
        # slices the whole product (a product over a block of columns may
        # sum in another order)
        body_ids = torch.arange(n, device=ia.device)
        oh_a = ((ia[:, None] == body_ids[None, :]) & act[:, None]).float()  # [C,N]
        oh_b = ((ib[:, None] == body_ids[None, :]) & act[:, None]).float()

        def accumulate(dp):
            lin = (oh_a.T @ dp - oh_b.T @ dp)[lo:hi]
            ang = (oh_a.T @ cross(prep.disp_a, dp) - oh_b.T @ cross(prep.disp_b, dp))[lo:hi]
            return inv_mass[:, None] * lin, torch.einsum("nij,nj->ni", inv_inertia, ang)

        return accumulate

    # 2C sided (body, ±Δp) entries sorted by body once per solve; each call
    # reduces with a prefix sum over all of them and per-body boundary
    # differences (a row range reads its rows' boundaries)
    sid = torch.cat([torch.where(act, ia, n), torch.where(act, ib, n)])
    sid_sorted, order = torch.sort(sid, stable=True)
    body_ids = torch.arange(lo, hi, device=ia.device)
    seg_start = torch.searchsorted(sid_sorted, body_ids, side="left")
    seg_end = torch.searchsorted(sid_sorted, body_ids, side="right")

    def accumulate(dp):
        vals = torch.cat([torch.cat([dp, cross(prep.disp_a, dp)], -1),
                          -torch.cat([dp, cross(prep.disp_b, dp)], -1)])[order]
        csum = torch.cat([torch.zeros((1, 6), device=dp.device), torch.cumsum(vals, dim=0)])
        seg = csum[seg_end] - csum[seg_start]
        return inv_mass[:, None] * seg[:, :3], torch.einsum("nij,nj->ni", inv_inertia,
                                                            seg[:, 3:])

    return accumulate


def _whole(tensors):
    return tensors


def jacobi_sweeps(prep: PreparedContacts, config, relaxation: float, n: int, v, w, acc, pos,
                  ori, inv_mass, inv_inertia, rows=None, gather=_whole):
    """The jacobi mode's velocity iterations and positional correction →
    (v, w, acc, pos, ori). Every contact computes its impulse from the same
    velocities, and the under-relaxed deltas accumulate per body.

    With ``rows`` = (lo, hi) of N bodies, the body tensors are the rows of
    bodies [lo, hi) and only they are updated; ``gather`` (a list of such
    rows → the same tensors whole) gives the whole velocities each
    iteration, the whole inverse masses and inertias once before the
    correction and the whole positions and orientations each correction
    iteration. The contacts and impulses are whole in any case."""
    ia, ib, act = prep.body_a, prep.body_b, prep.active
    act3 = act[:, None]
    accumulate = _accumulator(prep, n, inv_mass, inv_inertia, rows)
    for _ in range(max(config.n_iterations, 1) * 4):
        v_all, w_all = gather([v, w])
        rel = ((v_all[ia] + cross(w_all[ia], prep.disp_a))
               - (v_all[ib] + cross(w_all[ib], prep.disp_b)))
        imp = torch.stack([
            -prep.eff_mass[:, 0] * ((prep.normal * rel).sum(dim=-1) - prep.target_sep_vel),
            -prep.eff_mass[:, 1] * (prep.tangent * rel).sum(dim=-1),
            -prep.eff_mass[:, 2] * (prep.bitangent * rel).sum(dim=-1),
        ], dim=-1)
        new_acc = _clamp_impulses(acc + relaxation * imp, prep.friction_coef)
        dv, dw = accumulate(_momentum_change(prep, torch.where(act3, new_acc - acc, 0.0)))
        v, w = v + dv, w + dw
        acc = torch.where(act3, new_acc, acc)

    # positional correction: parallel pseudo-impulses, same accumulation
    corr = config.positional_correction_factor
    if config.n_positional_correction_iterations > 0:
        im_all, ii_all = gather([inv_mass, inv_inertia])
    for _ in range(config.n_positional_correction_iterations):
        pos_all, ori_all = gather([pos, ori])
        pa = pos_all[ia] + quat.rotate(ori_all[ia], prep.local_a)
        pb = pos_all[ib] + quat.rotate(ori_all[ib], prep.local_b)
        depth = (prep.normal * (pb - pa)).sum(dim=-1)
        em = _effective_mass(im_all[ia], im_all[ib], ii_all[ia], ii_all[ib],
                             pb - pos_all[ia], pb - pos_all[ib], prep.normal)
        pseudo = em * corr * depth * (act & (depth > 0.0)) * relaxation
        dpos, dw = accumulate(pseudo[:, None] * prep.normal)
        pos = pos + dpos
        ori = quat.integrate_angular_velocity(ori, dw, 1.0)
    return v, w, acc, pos, ori


def solve_contacts(bodies: BodyState, prep: PreparedContacts, config, mode: str = "scan",
                   jacobi_relaxation: float = JACOBI_RELAXATION):
    """Velocity iterations + positional correction → (bodies, cache)
    (ref: solver.rs:296 compute_and_apply_constrained_state). ``scan``
    solves the slots in order (Gauss-Seidel), ``jacobi`` all at once with
    under-relaxation."""
    check_mode(mode)
    v, w = compute_velocities(bodies)
    inv_inertia = world_inv_inertia(bodies)
    inv_mass = bodies.inv_mass
    acc, v, w = warm_start(prep, v, w, inv_mass, inv_inertia)
    if mode == "scan":
        v, w, acc, pos, ori = scan_iterations(
            v, w, bodies.position, bodies.orientation, inv_mass, inv_inertia, prep, acc,
            config.n_iterations, config.n_positional_correction_iterations,
            config.positional_correction_factor)
    else:
        v, w, acc, pos, ori = jacobi_sweeps(prep, config, jacobi_relaxation, bodies.n, v, w,
                                            acc, bodies.position, bodies.orientation,
                                            inv_mass, inv_inertia)
    bodies = write_back(bodies, participants(bodies.n, prep.body_a, prep.body_b, prep.active),
                        v, w, pos, ori)
    return bodies, solver_cache(prep, acc, bodies.position)


def check_mode(mode: str):
    if mode not in ("scan", "jacobi"):
        raise ValueError(f"solver mode must be 'scan' or 'jacobi', not {mode!r}")


def participants(n, ia, ib, act):
    """bool [N, 1]: the bodies in at least one active constraint."""
    part = torch.zeros(n + 1, dtype=torch.bool, device=ia.device)
    part[torch.where(act, ia, n)] = True
    part[torch.where(act, ib, n)] = True
    return part[:n, None]


def write_back(bodies: BodyState, pm, v, w, pos, ori) -> BodyState:
    """The solved state of the bodies marked in ``pm`` (only bodies in ≥1
    active constraint are written back: the reference's
    ConstrainedBodyManager holds exactly those)."""
    bodies = bodies._replace(position=torch.where(pm, pos, bodies.position),
                             orientation=torch.where(pm, ori, bodies.orientation))
    synced = synchronize_momenta(bodies, v, w)
    return bodies._replace(
        momentum=torch.where(pm, synced.momentum, bodies.momentum),
        angular_momentum=torch.where(pm, synced.angular_momentum, bodies.angular_momentum),
        velocity=torch.where(pm, synced.velocity, bodies.velocity),
        angular_velocity=torch.where(pm, synced.angular_velocity, bodies.angular_velocity),
    )


def solver_cache(prep: PreparedContacts, acc, position) -> SolverCache:
    """The solve's cache; ``position``: every body's position after the
    write-back."""
    return SolverCache(
        key=prep.key, impulses=acc, normal=prep.normal, tangent=prep.tangent,
        active=prep.active, body_a=prep.body_a, body_b=prep.body_b,
        position=position[prep.body_b] + prep.disp_b,
    )


# --- spherical joints (ref: constraint/spherical_joint.rs) ---------------------


class JointPools(NamedTuple):
    """Ball joints: body-frame anchors that must coincide."""

    body_a: torch.Tensor  # i64[J]
    body_b: torch.Tensor  # i64[J]
    anchor_a: torch.Tensor  # f32[J,3]
    anchor_b: torch.Tensor  # f32[J,3]
    mask: torch.Tensor  # bool[J]


def empty_joint_pools(cap: int = 16, device="cuda") -> JointPools:
    zi = torch.zeros(cap, dtype=torch.int64, device=device)
    return JointPools(body_a=zi, body_b=zi.clone(), anchor_a=torch.zeros((cap, 3), device=device),
                      anchor_b=torch.zeros((cap, 3), device=device),
                      mask=torch.zeros(cap, dtype=torch.bool, device=device))


def _skew(v):
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


def solve_joints(bodies: BodyState, joints: JointPools, config) -> BodyState:
    """Velocity + positional solve for ball joints (unclamped 3D impulses),
    run after the contacts each step. Masked-off joints change nothing."""
    if joints is None or joints.mask.shape[0] == 0:
        return bodies
    v, w = compute_velocities(bodies)
    inv_inertia = world_inv_inertia(bodies)
    inv_mass = bodies.inv_mass
    ia, ib, act = joints.body_a, joints.body_b, joints.mask
    act3 = act[:, None]
    eye = torch.eye(3, device=ia.device)

    def anchors(pos, ori):
        return (pos[ia] + quat.rotate(ori[ia], joints.anchor_a),
                pos[ib] + quat.rotate(ori[ib], joints.anchor_b))

    def k_inv(pos, ori):
        pa, pb = anchors(pos, ori)
        ra, rb = pa - pos[ia], pb - pos[ib]
        sa, sb = _skew(ra), _skew(rb)
        k = ((inv_mass[ia] + inv_mass[ib])[:, None, None] * eye
             + torch.einsum("jik,jkl,jml->jim", sa, inv_inertia[ia], sa)
             + torch.einsum("jik,jkl,jml->jim", sb, inv_inertia[ib], sb))
        return torch.linalg.inv(k + eye * 1e-9), ra, rb

    kinv, ra, rb = k_inv(bodies.position, bodies.orientation)
    for _ in range(config.n_iterations):
        rel = (v[ia] + cross(w[ia], ra)) - (v[ib] + cross(w[ib], rb))
        imp = -torch.einsum("jik,jk->ji", kinv, rel) * act3
        v = v.index_add(0, ia, inv_mass[ia, None] * imp)
        v = v.index_add(0, ib, -inv_mass[ib, None] * imp)
        w = w.index_add(0, ia, torch.einsum("jik,jk->ji", inv_inertia[ia], cross(ra, imp)))
        w = w.index_add(0, ib, -torch.einsum("jik,jk->ji", inv_inertia[ib], cross(rb, imp)))

    pos, ori = bodies.position, bodies.orientation
    for _ in range(config.n_positional_correction_iterations):
        kinv_c, ra_c, rb_c = k_inv(pos, ori)
        pa, pb = anchors(pos, ori)
        pseudo = -torch.einsum("jik,jk->ji", kinv_c, pa - pb) * (
            config.positional_correction_factor * act)[:, None]
        pos = pos.index_add(0, ia, inv_mass[ia, None] * pseudo)
        pos = pos.index_add(0, ib, -inv_mass[ib, None] * pseudo)
        dwa = torch.einsum("jik,jk->ji", inv_inertia[ia], cross(ra_c, pseudo))
        dwb = -torch.einsum("jik,jk->ji", inv_inertia[ib], cross(rb_c, pseudo))
        # masked-off joints rewrite their (non-participating) bodies, which
        # the write-back below leaves untouched
        ori = ori.index_copy(0, ia, quat.integrate_angular_velocity(ori[ia], dwa * act3, 1.0))
        ori = ori.index_copy(0, ib, quat.integrate_angular_velocity(ori[ib], dwb * act3, 1.0))

    pm = participants(bodies.n, ia, ib, act)
    bodies = bodies._replace(position=torch.where(pm, pos, bodies.position),
                             orientation=torch.where(pm, ori, bodies.orientation))
    synced = synchronize_momenta(bodies, v, w)
    return bodies._replace(
        momentum=torch.where(pm, synced.momentum, bodies.momentum),
        angular_momentum=torch.where(pm, synced.angular_momentum, bodies.angular_momentum),
        velocity=torch.where(pm, v, bodies.velocity),
        angular_velocity=torch.where(pm, w, bodies.angular_velocity),
    )
