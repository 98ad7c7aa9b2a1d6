"""Collidable pools, narrow phase and contact compaction (port of
``impact_tpu/physics/collision.py``; ref: impact_physics/src/collision.rs).

Contact conventions follow the reference (contact.rs:48-62): ``position`` is
the deepest point on body B, ``normal`` B's outward normal there, ``depth``
≥ 0 along it; responses combine as max(restitution) and sqrt-product
frictions (material.rs:43-51). Every candidate pair has a deterministic
integer key; active contacts are compacted by a stable sort, so active slots
hold ascending keys and the warm-start join is a sorted search. Keys are the
reference's u32 values held in int64 (torch sorts and searches int64).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.primitives import closest_point_on_segment, segment_segment_closest_points
from ..math import quaternion as quat

KIND_DYNAMIC_COLLIDABLE = 0
KIND_STATIC_COLLIDABLE = 1
KIND_PHANTOM_COLLIDABLE = 2
EMPTY_KEY = 0xFFFFFFFF


class CollidablePools(NamedTuple):
    """Fixed-capacity collidable pools: local-frame geometry + body binding."""

    sph_body: torch.Tensor  # i64[Ns]
    sph_center: torch.Tensor  # f32[Ns,3] body frame
    sph_radius: torch.Tensor  # f32[Ns]
    sph_kind: torch.Tensor  # i32[Ns]
    sph_response: torch.Tensor  # f32[Ns,3] (restitution, static_f, dynamic_f)
    sph_mask: torch.Tensor  # bool[Ns]
    pln_body: torch.Tensor  # i64[Np]
    pln_normal: torch.Tensor  # f32[Np,3] body-frame unit normal
    pln_disp: torch.Tensor  # f32[Np]
    pln_kind: torch.Tensor  # i32[Np]
    pln_response: torch.Tensor  # f32[Np,3]
    pln_mask: torch.Tensor  # bool[Np]
    cap_body: torch.Tensor  # i64[Nc]
    cap_start: torch.Tensor  # f32[Nc,3]
    cap_end: torch.Tensor  # f32[Nc,3]
    cap_radius: torch.Tensor  # f32[Nc]
    cap_kind: torch.Tensor  # i32[Nc]
    cap_response: torch.Tensor  # f32[Nc,3]
    cap_mask: torch.Tensor  # bool[Nc]


def empty_collidable_pools(n_spheres=64, n_planes=8, n_capsules=16, device="cuda") -> CollidablePools:
    """Pools with every slot masked off; planes face +y and are static."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def one(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    up = torch.tensor([[0.0, 1.0, 0.0]], device=device).repeat(n_planes, 1)
    return CollidablePools(
        sph_body=z(n_spheres, dtype=torch.int64), sph_center=z(n_spheres, 3),
        sph_radius=one(n_spheres), sph_kind=z(n_spheres, dtype=torch.int32),
        sph_response=z(n_spheres, 3), sph_mask=z(n_spheres, dtype=torch.bool),
        pln_body=z(n_planes, dtype=torch.int64), pln_normal=up, pln_disp=z(n_planes),
        pln_kind=torch.ones(n_planes, dtype=torch.int32, device=device),
        pln_response=z(n_planes, 3), pln_mask=z(n_planes, dtype=torch.bool),
        cap_body=z(n_capsules, dtype=torch.int64), cap_start=z(n_capsules, 3),
        cap_end=z(n_capsules, 3), cap_radius=one(n_capsules),
        cap_kind=z(n_capsules, dtype=torch.int32), cap_response=z(n_capsules, 3),
        cap_mask=z(n_capsules, dtype=torch.bool))


class WorldCollidables(NamedTuple):
    """World-space collidable geometry for one substep."""

    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    pln_normal: torch.Tensor
    pln_disp: torch.Tensor
    cap_start: torch.Tensor
    cap_end: torch.Tensor
    cap_radius: torch.Tensor


def synchronize_collidables(pools: CollidablePools, position, orientation) -> WorldCollidables:
    """Transform local collidable geometry by each bound body's pose."""
    n_w = quat.rotate(orientation[pools.pln_body], pools.pln_normal)
    return WorldCollidables(
        sph_center=position[pools.sph_body]
        + quat.rotate(orientation[pools.sph_body], pools.sph_center),
        sph_radius=pools.sph_radius,
        pln_normal=n_w,
        pln_disp=pools.pln_disp + (n_w * position[pools.pln_body]).sum(dim=-1),
        cap_start=position[pools.cap_body]
        + quat.rotate(orientation[pools.cap_body], pools.cap_start),
        cap_end=position[pools.cap_body]
        + quat.rotate(orientation[pools.cap_body], pools.cap_end),
        cap_radius=pools.cap_radius,
    )


class ContactBuffer(NamedTuple):
    """Fixed-capacity compacted contacts; active slots hold ascending keys."""

    active: torch.Tensor  # bool[C]
    key: torch.Tensor  # i64[C] (u32 values; EMPTY_KEY for empty slots)
    body_a: torch.Tensor  # i64[C]
    body_b: torch.Tensor  # i64[C]
    position: torch.Tensor  # f32[C,3] deepest point on B (world)
    normal: torch.Tensor  # f32[C,3] B's surface normal (world)
    depth: torch.Tensor  # f32[C]
    response: torch.Tensor  # f32[C,3] combined (restitution, sf, df)


def combine_response(ra, rb):
    """(max restitution, sqrt-product frictions) (ref: material.rs:43-51)."""
    return torch.stack([torch.maximum(ra[..., 0], rb[..., 0]),
                        torch.sqrt(ra[..., 1] * rb[..., 1]),
                        torch.sqrt(ra[..., 2] * rb[..., 2])], dim=-1)


def _phantom_or_static_pair(kind_a, kind_b):
    phantom = (kind_a == KIND_PHANTOM_COLLIDABLE) | (kind_b == KIND_PHANTOM_COLLIDABLE)
    both_static = (kind_a == KIND_STATIC_COLLIDABLE) & (kind_b == KIND_STATIC_COLLIDABLE)
    return phantom | both_static


class _Emitter:
    """Collects candidate contact blocks for one compaction."""

    def __init__(self):
        self.parts = []

    def emit(self, key, active, ba, bb, pos, nrm, dep, resp):
        shape = active.shape
        self.parts.append((key.expand(shape).reshape(-1), active.reshape(-1),
                           ba.expand(shape).reshape(-1), bb.expand(shape).reshape(-1),
                           pos.expand(shape + (3,)).reshape(-1, 3),
                           nrm.expand(shape + (3,)).reshape(-1, 3),
                           dep.expand(shape).reshape(-1),
                           resp.expand(shape + (3,)).reshape(-1, 3)))

    def compact(self, max_contacts: int) -> ContactBuffer:
        cols = [torch.cat(c) for c in zip(*self.parts)]
        return compact_contacts(*cols, max_contacts)


def _pair_key(base, n_a, n_b, dev):
    return (base + torch.arange(n_a, dtype=torch.int64, device=dev)[:, None] * n_b
            + torch.arange(n_b, dtype=torch.int64, device=dev)[None, :])


def _unit_or_z(disp, dist, eps):
    z = torch.tensor([0.0, 0.0, 1.0], device=disp.device)
    return torch.where((dist > eps)[..., None], disp / torch.clamp(dist, min=eps)[..., None], z)


def narrow_phase(pools: CollidablePools, world: WorldCollidables,
                 max_contacts: int) -> ContactBuffer:
    """All-pairs narrow phase over the collidable pools → compacted contacts.

    Pair families and key ranges in the reference's order: sphere-sphere
    (i<j), sphere-plane, capsule-plane, capsule-sphere, capsule-capsule (i<j)
    (ref: collision/collidable/basic.rs:57-140)."""
    ns = pools.sph_mask.shape[0]
    npl = pools.pln_mask.shape[0]
    nc = pools.cap_mask.shape[0]
    dev = pools.sph_mask.device
    eps = 1e-8
    out = _Emitter()
    key_base = 0

    # sphere-sphere (A=i, B=j, i<j)
    cj = world.sph_center[None, :, :]
    disp = world.sph_center[:, None, :] - cj
    d2 = (disp * disp).sum(dim=-1)
    rsum = world.sph_radius[:, None] + world.sph_radius[None, :]
    iu = torch.triu(torch.ones((ns, ns), dtype=torch.bool, device=dev), diagonal=1)
    pair_ok = (iu & pools.sph_mask[:, None] & pools.sph_mask[None, :]
               & ~_phantom_or_static_pair(pools.sph_kind[:, None], pools.sph_kind[None, :])
               & (pools.sph_body[:, None] != pools.sph_body[None, :]))
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    nrm = _unit_or_z(disp, dist, eps)
    out.emit(_pair_key(key_base, ns, ns, dev), pair_ok & (d2 <= rsum * rsum),
             pools.sph_body[:, None], pools.sph_body[None, :],
             cj + world.sph_radius[None, :, None] * nrm, nrm,
             torch.clamp(rsum - dist, min=0.0),
             combine_response(pools.sph_response[:, None, :], pools.sph_response[None, :, :]))
    key_base += ns * ns

    # sphere-plane (A=sphere, B=plane)
    sd = ((world.sph_center[:, None, :] * world.pln_normal[None, :, :]).sum(dim=-1)
          - world.pln_disp[None, :])
    dep = world.sph_radius[:, None] - sd
    pair_ok = (pools.sph_mask[:, None] & pools.pln_mask[None, :]
               & ~_phantom_or_static_pair(pools.sph_kind[:, None], pools.pln_kind[None, :]))
    nrm = world.pln_normal[None, :, :].expand(ns, npl, 3)
    out.emit(_pair_key(key_base, ns, npl, dev), pair_ok & (dep >= 0.0),
             pools.sph_body[:, None], pools.pln_body[None, :],
             world.sph_center[:, None, :] - sd[..., None] * nrm, nrm, dep,
             combine_response(pools.sph_response[:, None, :], pools.pln_response[None, :, :]))
    key_base += ns * npl

    # capsule-plane (A=capsule, B=plane)
    sd_s = ((world.cap_start[:, None, :] * world.pln_normal[None, :, :]).sum(dim=-1)
            - world.pln_disp[None, :])
    sd_e = ((world.cap_end[:, None, :] * world.pln_normal[None, :, :]).sum(dim=-1)
            - world.pln_disp[None, :])
    use_start = sd_s <= sd_e
    lowest_sd = torch.where(use_start, sd_s, sd_e)
    closest = torch.where(use_start[..., None], world.cap_start[:, None, :],
                          world.cap_end[:, None, :])
    dep = world.cap_radius[:, None] - lowest_sd
    nrm = world.pln_normal[None, :, :].expand(nc, npl, 3)
    pair_ok = (pools.cap_mask[:, None] & pools.pln_mask[None, :]
               & ~_phantom_or_static_pair(pools.cap_kind[:, None], pools.pln_kind[None, :]))
    out.emit(_pair_key(key_base, nc, npl, dev), pair_ok & (dep >= 0.0),
             pools.cap_body[:, None], pools.pln_body[None, :],
             closest - lowest_sd[..., None] * nrm, nrm, dep,
             combine_response(pools.cap_response[:, None, :], pools.pln_response[None, :, :]))
    key_base += nc * npl

    # capsule-sphere (A=capsule, B=sphere)
    cp, _ = closest_point_on_segment(world.cap_start[:, None, :], world.cap_end[:, None, :],
                                     world.sph_center[None, :, :])
    disp = world.sph_center[None, :, :] - cp
    d2 = (disp * disp).sum(dim=-1)
    rsum = world.cap_radius[:, None] + world.sph_radius[None, :]
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    nrm = -_unit_or_z(disp, dist, eps)
    pair_ok = (pools.cap_mask[:, None] & pools.sph_mask[None, :]
               & ~_phantom_or_static_pair(pools.cap_kind[:, None], pools.sph_kind[None, :])
               & (pools.cap_body[:, None] != pools.sph_body[None, :]))
    out.emit(_pair_key(key_base, nc, ns, dev), pair_ok & (d2 <= rsum * rsum),
             pools.cap_body[:, None], pools.sph_body[None, :],
             world.sph_center[None, :, :] + world.sph_radius[None, :, None] * nrm, nrm,
             torch.clamp(rsum - dist, min=0.0),
             combine_response(pools.cap_response[:, None, :], pools.sph_response[None, :, :]))
    key_base += nc * ns

    # capsule-capsule (A=i, B=j, i<j)
    c1, c2 = segment_segment_closest_points(world.cap_start[:, None, :], world.cap_end[:, None, :],
                                            world.cap_start[None, :, :], world.cap_end[None, :, :])
    disp = c1 - c2
    d2 = (disp * disp).sum(dim=-1)
    rsum = world.cap_radius[:, None] + world.cap_radius[None, :]
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    nrm = _unit_or_z(disp, dist, eps)
    iu = torch.triu(torch.ones((nc, nc), dtype=torch.bool, device=dev), diagonal=1)
    pair_ok = (iu & pools.cap_mask[:, None] & pools.cap_mask[None, :]
               & ~_phantom_or_static_pair(pools.cap_kind[:, None], pools.cap_kind[None, :])
               & (pools.cap_body[:, None] != pools.cap_body[None, :]))
    out.emit(_pair_key(key_base, nc, nc, dev), pair_ok & (d2 <= rsum * rsum),
             pools.cap_body[:, None], pools.cap_body[None, :],
             c2 + world.cap_radius[None, :, None] * nrm, nrm, torch.clamp(rsum - dist, min=0.0),
             combine_response(pools.cap_response[:, None, :], pools.cap_response[None, :, :]))

    return out.compact(max_contacts)


def compact_contacts(key, active, body_a, body_b, position, normal, depth, response,
                     max_contacts: int) -> ContactBuffer:
    """Stable-compact the active contacts into ``max_contacts`` slots. Active
    entries keep their flatten order (ascending keys); overflow is dropped."""
    order = torch.argsort((~active).to(torch.uint8), stable=True)
    take = order[:max_contacts]
    sel = active[take]
    sel3 = sel[:, None]
    z = torch.tensor([0.0, 0.0, 1.0], device=active.device)
    return ContactBuffer(
        active=sel,
        key=torch.where(sel, key[take], EMPTY_KEY),
        body_a=torch.where(sel, body_a[take], 0),
        body_b=torch.where(sel, body_b[take], 0),
        position=torch.where(sel3, position[take], 0.0),
        normal=torch.where(sel3, normal[take], z),
        depth=torch.where(sel, depth[take], 0.0),
        response=torch.where(sel3, response[take], 0.0),
    )
