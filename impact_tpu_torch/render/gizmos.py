"""Debug-visualization gizmos drawn over the rendered frame (port of
``impact_tpu/render/gizmos.py``; ref: impact_gizmo, the 21 GizmoTypes of
lib.rs:39-61: reference-frame axes, bounding volumes, light spheres, centre
of mass, velocities, forces, colliders, contacts, voxel chunks, ...).

Gizmos are a masked pool of coloured line segments [L] built from the
simulation state by :func:`build_gizmo_lines`; :func:`overlay_lines`
projects S samples of each segment and writes their colour into the u8
frame. Where samples of several segments land on one pixel, the sample
that comes last in (segment, sample) order wins, as the reference's XLA
scatter applies its updates in order: the winner is picked explicitly
(a ``scatter_reduce`` max of the sample's flat index per pixel), since
``index_put_`` leaves it undefined on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math import quaternion as quat

# gizmo kinds (ref: impact_gizmo/src/lib.rs:39-61)
GIZMO_AXES = "reference_frame_axes"
GIZMO_LINEAR_VELOCITY = "linear_velocity"
GIZMO_ANGULAR_VELOCITY = "angular_velocity"
GIZMO_ANGULAR_MOMENTUM = "angular_momentum"
GIZMO_FORCE = "force"
GIZMO_TORQUE = "torque"
GIZMO_CENTER_OF_MASS = "center_of_mass"
GIZMO_CONTACTS = "contacts"
GIZMO_COLLIDERS = "colliders"  # all collider kinds at once
GIZMO_BOUNDING_SPHERES = "bounding_spheres"
GIZMO_VOXEL_CHUNKS = "voxel_chunks"
GIZMO_LIGHT_SPHERES = "light_spheres"
GIZMO_BVH = "bounding_volume_hierarchy"
GIZMO_SHADOW_CUBEMAP_FACES = "shadow_cubemap_faces"
GIZMO_SHADOW_CASCADES = "shadow_map_cascades"
GIZMO_ANCHORS = "anchors"
GIZMO_DYNAMIC_COLLIDERS = "dynamic_colliders"
GIZMO_STATIC_COLLIDERS = "static_colliders"
GIZMO_PHANTOM_COLLIDERS = "phantom_colliders"
GIZMO_COLLISION_PROBES = "collision_probes"
GIZMO_VOXEL_SDS = "voxel_signed_distances"
GIZMO_VOXEL_INTERSECTIONS = "voxel_intersections"

#: every gizmo type of the reference's 21-member GizmoType enum;
#: GIZMO_COLLIDERS (the dynamic, static and phantom union) is not counted
ALL_GIZMO_TYPES = (
    GIZMO_AXES, GIZMO_BOUNDING_SPHERES, GIZMO_BVH, GIZMO_LIGHT_SPHERES,
    GIZMO_SHADOW_CUBEMAP_FACES, GIZMO_SHADOW_CASCADES, GIZMO_CENTER_OF_MASS,
    GIZMO_LINEAR_VELOCITY, GIZMO_ANGULAR_VELOCITY, GIZMO_ANGULAR_MOMENTUM,
    GIZMO_FORCE, GIZMO_TORQUE, GIZMO_ANCHORS, GIZMO_DYNAMIC_COLLIDERS,
    GIZMO_STATIC_COLLIDERS, GIZMO_PHANTOM_COLLIDERS, GIZMO_COLLISION_PROBES,
    GIZMO_CONTACTS, GIZMO_VOXEL_CHUNKS, GIZMO_VOXEL_SDS,
    GIZMO_VOXEL_INTERSECTIONS,
)

AXIS_COLORS = np.asarray(
    [[0.9, 0.15, 0.15], [0.15, 0.9, 0.15], [0.2, 0.35, 0.95]], np.float32
)

# the 12 edges of a box, as (lo/hi per axis) corner pairs
BOX_EDGES = (
    ((0, 0, 0), (1, 0, 0)), ((0, 0, 0), (0, 1, 0)), ((0, 0, 0), (0, 0, 1)),
    ((1, 1, 0), (0, 1, 0)), ((1, 1, 0), (1, 0, 0)), ((1, 1, 0), (1, 1, 1)),
    ((1, 0, 1), (0, 0, 1)), ((1, 0, 1), (1, 0, 0)), ((1, 0, 1), (1, 1, 1)),
    ((0, 1, 1), (0, 0, 1)), ((0, 1, 1), (0, 1, 0)), ((0, 1, 1), (1, 1, 1)),
)


class GizmoLines(NamedTuple):
    start: torch.Tensor  # f32[L,3]
    end: torch.Tensor  # f32[L,3]
    color: torch.Tensor  # f32[L,3]
    active: torch.Tensor  # bool[L]


def _concat(parts):
    return GizmoLines(*(torch.cat(f) for f in zip(*parts)))


def _vec(values, device):
    """A float32 [3] constant (float64 values round to float32 as the
    reference's ``jnp.asarray`` of them does)."""
    return torch.tensor(np.asarray(values, np.float32), device=device)


def _unit(axis, device):
    return torch.eye(3, device=device)[axis]


def build_gizmo_lines(sim, params,
                      kinds=(GIZMO_AXES, GIZMO_LINEAR_VELOCITY, GIZMO_CONTACTS),
                      aspect: float = 16.0 / 9.0, n_cascades: int = 1) -> GizmoLines:
    """The line pool of the requested gizmo kinds from the simulation state
    and the scene constants. ``aspect`` and ``n_cascades`` are read only by
    the shadow-cascade gizmo (render-config statics, not state)."""
    bodies = sim.phys.bodies
    dev = bodies.position.device
    n = bodies.n
    alive = bodies.alive
    parts = []

    def color(values, rows):
        return _vec(values, dev).expand(rows, 3)

    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1)

    if GIZMO_AXES in kinds:
        for axis in range(3):
            d = quat.rotate(bodies.orientation, _unit(axis, dev)[None].expand(n, 3))
            parts.append(GizmoLines(bodies.position, bodies.position + d,
                                    color(AXIS_COLORS[axis], n), alive))

    if GIZMO_LINEAR_VELOCITY in kinds:
        parts.append(GizmoLines(bodies.position, bodies.position + bodies.velocity * 0.5,
                                color([1.0, 0.9, 0.1], n),
                                alive & (norm(bodies.velocity) > 1e-3)))

    if GIZMO_ANGULAR_VELOCITY in kinds:
        parts.append(GizmoLines(bodies.position, bodies.position + bodies.angular_velocity * 0.5,
                                color([0.9, 0.2, 0.9], n),
                                alive & (norm(bodies.angular_velocity) > 1e-3)))

    if GIZMO_CONTACTS in kinds:
        cache = sim.phys.solver_cache
        parts.append(GizmoLines(cache.position, cache.position + cache.normal * 0.5,
                                color([1.0, 0.3, 0.1], cache.position.shape[0]), cache.active))

    if GIZMO_ANGULAR_MOMENTUM in kinds:
        parts.append(GizmoLines(bodies.position, bodies.position + bodies.angular_momentum * 0.1,
                                color([0.6, 0.1, 0.9], n),
                                alive & (norm(bodies.angular_momentum) > 1e-3)))

    if GIZMO_FORCE in kinds:
        parts.append(GizmoLines(bodies.position, bodies.position + bodies.total_force * 0.01,
                                color([0.95, 0.55, 0.1], n),
                                alive & (norm(bodies.total_force) > 1e-3)))

    if GIZMO_TORQUE in kinds:
        parts.append(GizmoLines(bodies.position, bodies.position + bodies.total_torque * 0.01,
                                color([0.55, 0.95, 0.1], n),
                                alive & (norm(bodies.total_torque) > 1e-3)))

    if GIZMO_CENTER_OF_MASS in kinds:
        # a small cross at every dynamic body's centre of mass
        for axis in range(3):
            d = _unit(axis, dev) * 0.15
            parts.append(GizmoLines(bodies.position - d, bodies.position + d,
                                    color([1.0, 1.0, 1.0], n), alive & bodies.is_dynamic))

    pool = sim.voxels
    o = pool.n_objects
    q_obj = bodies.orientation[pool.body_index]
    x_obj = bodies.position[pool.body_index]

    def radii_and_centers():
        from ..voxel.collision import bounding_radii

        return bounding_radii(pool), x_obj

    if GIZMO_BOUNDING_SPHERES in kinds:
        # voxel-object bounding spheres as 3 great-circle polylines
        radii, centers = radii_and_centers()
        n_seg = 24
        ang = np.linspace(0.0, 2.0 * np.pi, n_seg + 1)
        for plane in ((0, 1), (0, 2), (1, 2)):
            for i in range(n_seg):
                d0 = np.zeros(3, np.float32)
                d1 = np.zeros(3, np.float32)
                d0[plane[0]], d0[plane[1]] = np.cos(ang[i]), np.sin(ang[i])
                d1[plane[0]], d1[plane[1]] = np.cos(ang[i + 1]), np.sin(ang[i + 1])
                parts.append(GizmoLines(centers + radii[:, None] * _vec(d0, dev),
                                        centers + radii[:, None] * _vec(d1, dev),
                                        color([0.3, 0.8, 0.3], o), pool.alive))

    if GIZMO_VOXEL_CHUNKS in kinds:
        # grid-extent boxes around each voxel object (12 edges)
        lo = pool.origin  # body frame
        hi = pool.origin + pool.grid_size * pool.voxel_extent[:, None]

        def corner(mask):
            m = torch.tensor(mask, dtype=torch.bool, device=dev)
            return quat.rotate(q_obj, torch.where(m[None, :], hi, lo)) + x_obj

        for a, b in BOX_EDGES:
            parts.append(GizmoLines(corner(a), corner(b), color([0.9, 0.8, 0.2], o), pool.alive))

    lights = params.lights
    if GIZMO_LIGHT_SPHERES in kinds:
        nl = lights.omni_mask.shape[0]
        for axis in range(3):
            d = _unit(axis, dev)[None, :] * torch.clamp(lights.omni_extent, min=0.25)[:, None]
            parts.append(GizmoLines(lights.omni_position - d, lights.omni_position + d,
                                    color([1.0, 1.0, 0.5], nl), lights.omni_mask))

    # collider gizmos, split by kind (ref GizmoType::DynamicCollider /
    # StaticCollider / PhantomCollider, lib.rs:52-55; GIZMO_COLLIDERS = all)
    from ..physics.collision import (
        KIND_DYNAMIC_COLLIDABLE,
        KIND_PHANTOM_COLLIDABLE,
        KIND_STATIC_COLLIDABLE,
    )

    collider_requests = []
    if GIZMO_COLLIDERS in kinds:
        collider_requests.append((None, [0.2, 0.9, 0.9]))
    if GIZMO_DYNAMIC_COLLIDERS in kinds:
        collider_requests.append((KIND_DYNAMIC_COLLIDABLE, [0.2, 0.9, 0.9]))
    if GIZMO_STATIC_COLLIDERS in kinds:
        collider_requests.append((KIND_STATIC_COLLIDABLE, [0.5, 0.5, 0.95]))
    if GIZMO_PHANTOM_COLLIDERS in kinds:
        collider_requests.append((KIND_PHANTOM_COLLIDABLE, [0.95, 0.4, 0.95]))
    for want_kind, rgb in collider_requests:
        coll = params.phys_params.collidables

        def of_kind(kind, mask):
            return mask if want_kind is None else mask & (kind == want_kind)

        # sphere colliders: three axis-aligned cross lines through the centre
        c = bodies.position[coll.sph_body] + quat.rotate(bodies.orientation[coll.sph_body],
                                                         coll.sph_center)
        sph_act = of_kind(coll.sph_kind, coll.sph_mask)
        for axis in range(3):
            d = _unit(axis, dev) * coll.sph_radius[:, None]
            parts.append(GizmoLines(c - d, c + d, color(rgb, c.shape[0]), sph_act))
        # capsule colliders: the segment axis and radius crosses at both ends
        qb = bodies.orientation[coll.cap_body]
        pb = bodies.position[coll.cap_body]
        a = pb + quat.rotate(qb, coll.cap_start)
        e = pb + quat.rotate(qb, coll.cap_end)
        cap_act = of_kind(coll.cap_kind, coll.cap_mask)
        parts.append(GizmoLines(a, e, color(rgb, a.shape[0]), cap_act))
        for axis in range(3):
            d = _unit(axis, dev) * coll.cap_radius[:, None]
            for p0 in (a, e):
                parts.append(GizmoLines(p0 - d, p0 + d, color(rgb, a.shape[0]), cap_act))
        # plane colliders: a cross of two in-plane tangents at the point
        # nearest the world origin (planes are unbounded)
        nrm = quat.rotate(bodies.orientation[coll.pln_body], coll.pln_normal)
        pp = bodies.position[coll.pln_body]
        p_pt = pp + nrm * (coll.pln_disp[:, None] - (pp * nrm).sum(dim=-1, keepdim=True))
        helper = torch.where(nrm[:, 2:3].abs() < 0.9, _vec([0.0, 0.0, 1.0], dev),
                             _vec([1.0, 0.0, 0.0], dev))
        t0 = quat.cross(nrm, helper)
        t0 = t0 / torch.clamp(torch.linalg.vector_norm(t0, dim=-1, keepdim=True), min=1e-9)
        t1 = quat.cross(nrm, t0)
        pln_act = of_kind(coll.pln_kind, coll.pln_mask)
        for t in (t0, t1):
            parts.append(GizmoLines(p_pt - 2.0 * t, p_pt + 2.0 * t, color(rgb, p_pt.shape[0]),
                                    pln_act))

    if GIZMO_ANCHORS in kinds:
        # joint anchors: a line from anchor a to anchor b, and crosses
        j = params.phys_params.joints
        pa = bodies.position[j.body_a] + quat.rotate(bodies.orientation[j.body_a], j.anchor_a)
        pb = bodies.position[j.body_b] + quat.rotate(bodies.orientation[j.body_b], j.anchor_b)
        rgb = [1.0, 0.6, 0.9]
        parts.append(GizmoLines(pa, pb, color(rgb, pa.shape[0]), j.mask))
        for axis in range(3):
            d = _unit(axis, dev) * 0.1
            for p in (pa, pb):
                parts.append(GizmoLines(p - d, p + d, color(rgb, p.shape[0]), j.mask))

    if GIZMO_COLLISION_PROBES in kinds or GIZMO_VOXEL_SDS in kinds:
        pr = sim.probes
        n_probes = pr.active.shape[1]
        wp = quat.rotate(q_obj[:, None, :], pr.pos_local) + x_obj[:, None, :]
        act = (pr.active & pool.alive[:, None]).reshape(o * n_probes)

    if GIZMO_COLLISION_PROBES in kinds:
        # the cached voxel collision probes as small vertical ticks
        tick = _unit(1, dev) * (0.35 * pool.voxel_extent)[:, None, None]
        parts.append(GizmoLines((wp - tick).reshape(-1, 3), (wp + tick).reshape(-1, 3),
                                color([0.95, 0.9, 0.2], o * n_probes), act))

    if GIZMO_VOXEL_SDS in kinds:
        # signed distances at the collision probes: a line along the local
        # SDF gradient, length |sd| clipped to [0.1, 3], green outside and
        # red inside
        eps = 0.5 * pool.voxel_extent[:, None, None]
        sd = _sample_pool_sdf_local(pool, pr.pos_local)
        grad = torch.stack([_sample_pool_sdf_local(pool, pr.pos_local + eps * _unit(k, dev)) - sd
                            for k in range(3)], dim=-1)
        grad = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-9)
        gw = quat.rotate(q_obj[:, None, :], grad)
        length = torch.clamp(sd.abs(), 0.1, 3.0)[..., None]
        rgb = torch.where((sd > 0.0)[..., None], _vec([0.2, 0.95, 0.3], dev),
                          _vec([0.95, 0.25, 0.2], dev))
        parts.append(GizmoLines(wp.reshape(-1, 3), (wp + gw * length).reshape(-1, 3),
                                rgb.reshape(-1, 3), act))

    if GIZMO_VOXEL_INTERSECTIONS in kinds:
        # centre-to-centre links of the voxel-object pairs whose bounding
        # spheres overlap (the candidate pairs of the voxel narrow phase)
        radii, centers = radii_and_centers()
        d2 = ((centers[:, None, :] - centers[None, :, :]) ** 2).sum(dim=-1)
        rsum = radii[:, None] + radii[None, :]
        idx = torch.arange(o, device=dev)
        hit = (d2 < rsum * rsum) & pool.alive[:, None] & pool.alive[None, :] & (
            idx[:, None] < idx[None, :])
        parts.append(GizmoLines(centers[:, None, :].expand(o, o, 3).reshape(-1, 3),
                                centers[None, :, :].expand(o, o, 3).reshape(-1, 3),
                                color([0.95, 0.5, 0.1], o * o), hit.reshape(-1)))

    if GIZMO_BVH in kinds:
        # the implicit LBVH's node boxes over the voxel objects
        from ..geometry.bvh import build_object_bvh

        radii, centers = radii_and_centers()
        bvh = build_object_bvh(centers, radii, pool.alive, n_levels=4)
        shades = np.linspace(0.95, 0.4, max(len(bvh.lo), 1))
        for lo, hi, act_l, shade in zip(bvh.lo, bvh.hi, bvh.active, shades):
            parts.extend(_aabb_edge_lines(lo, hi, _vec([shade, shade * 0.7, 0.1], dev), act_l))

    if GIZMO_SHADOW_CUBEMAP_FACES in kinds:
        # the 6 cube-map face frusta of every shadowable omni light: apex to
        # far-corner pyramid edges
        nl = lights.omni_mask.shape[0]
        act_l = lights.omni_mask & lights.omni_shadowable
        reach = torch.clamp(3.0 * torch.clamp(lights.omni_extent, min=1.0), min=5.0)
        rgb = [0.4, 0.7, 0.95]
        for face in range(6):
            axis, sign = face // 2, 1.0 - 2.0 * (face % 2)
            fwd = _unit(axis, dev) * sign
            u = _unit((axis + 1) % 3, dev)
            v = _unit((axis + 2) % 3, dev)
            corners = [lights.omni_position + reach[:, None] * (fwd + su * u + sv * v)
                       for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
            for k in range(4):
                parts.append(GizmoLines(lights.omni_position, corners[k], color(rgb, nl), act_l))
                parts.append(GizmoLines(corners[k], corners[(k + 1) % 4], color(rgb, nl), act_l))

    if GIZMO_SHADOW_CASCADES in kinds:
        # the camera sub-frustum each cascade's orthographic map is fit to
        from .lights import _frustum_corners_world, cascade_partition_depths

        cam = params.camera
        splits = cascade_partition_depths(cam.near, cam.far, n_cascades)
        cascade_colors = np.asarray([[0.2, 0.9, 0.4], [0.9, 0.9, 0.2], [0.9, 0.5, 0.2],
                                     [0.9, 0.2, 0.2]], np.float32)
        uni_any = torch.any(lights.uni_mask & lights.uni_shadowable)[None]
        quad = (0, 1, 3, 2)  # corner order is (-y-x, -y+x, +y-x, +y+x)
        for c in range(n_cascades):
            corners = _frustum_corners_world(cam.position, cam.orientation, cam.vertical_fov,
                                             aspect, splits[c], splits[c + 1])
            col = _vec(cascade_colors[min(c, 3)], dev)[None]
            for ring in (0, 4):
                for k in range(4):
                    parts.append(GizmoLines(corners[quad[k] + ring][None],
                                            corners[quad[(k + 1) % 4] + ring][None], col,
                                            uni_any))
            for k in range(4):
                parts.append(GizmoLines(corners[quad[k]][None], corners[quad[k] + 4][None], col,
                                        uni_any))

    return _concat(parts)


def _aabb_edge_lines(lo, hi, color, active):
    """The 12 box-edge GizmoLines parts of the AABBs lo/hi f32[K,3]."""
    def corner(mask):
        m = torch.tensor(mask, dtype=torch.bool, device=lo.device)
        return torch.where(m[None, :], hi, lo)

    k = lo.shape[0]
    return [GizmoLines(corner(a), corner(b), color.expand(k, 3), active) for a, b in BOX_EDGES]


def _sample_pool_sdf_local(pool, pts_local):
    """Trilinear SDF sample at body-frame points pts_local f32[O,P,3] (the
    stored values as floats, i8 codes unscaled, as in the reference; positive
    outside)."""
    g = pool.grid_size
    ext = pool.voxel_extent[:, None, None]
    gridc = (pts_local - pool.origin[:, None, :]) / torch.clamp(ext, min=1e-9) - 0.5
    i0 = torch.clamp(torch.floor(gridc).to(torch.int64), 0, g - 2)
    f = torch.clamp(gridc - i0, 0.0, 1.0)
    sdf = pool.sdf.to(torch.float32)
    oi = torch.arange(pts_local.shape[0], device=pts_local.device)[:, None]

    def at(dx, dy, dz):
        return sdf[oi, i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def overlay_lines(image_u8, lines: GizmoLines, view_proj, samples_per_line: int = 32):
    """Splat line segments over a rendered u8 frame [H,W,3] → u8 [H,W,3].

    Each segment is sampled at ``samples_per_line`` points from its start to
    its end; a sample is drawn where its segment is active, it lies in
    front of the camera (w > 1e-6, 0 < ndc z < 1) and its pixel (NDC
    truncated toward zero, as the reference's ``astype(int32)``) is inside
    the frame. Samples that are not drawn go to no pixel. Where several
    samples hit one pixel, the last in (segment, sample) order sets it."""
    h, w, _ = image_u8.shape
    dev = image_u8.device
    s = samples_per_line
    # jnp.linspace(0, 1, s): i · float32(1/(s−1)), the last point exactly 1
    t = torch.arange(s, dtype=torch.float32, device=dev) * (1.0 / max(s - 1, 1))
    t[-1] = 1.0
    t = t[None, :, None]
    pts = lines.start[:, None, :] + t * (lines.end - lines.start)[:, None, :]
    x3, y3, z3 = pts.unbind(-1)
    # the clip coordinates one row at a time, in a fixed order on every device
    clip = [view_proj[i, 0] * x3 + view_proj[i, 1] * y3 + view_proj[i, 2] * z3 + view_proj[i, 3]
            for i in range(4)]
    wc = clip[3]
    wd = torch.clamp(wc, min=1e-6)
    nx, ny, nz = (c / wd for c in clip[:3])
    xf = (nx * 0.5 + 0.5) * w
    yf = (0.5 - ny * 0.5) * h
    # trunc(xf) ∈ [0, w) iff −1 < xf < w
    ok = ((wc > 1e-6) & lines.active[:, None] & (xf > -1.0) & (xf < w) & (yf > -1.0)
          & (yf < h) & (nz > 0) & (nz < 1))
    xi = torch.clamp(xf, -1.0, float(w)).to(torch.int64)
    yi = torch.clamp(yf, -1.0, float(h)).to(torch.int64)
    pix = (yi * w + xi).reshape(-1)[ok.reshape(-1)]
    sample = torch.arange(ok.numel(), device=dev)[ok.reshape(-1)]
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, pix, sample, "amax")
    hit = winner >= 0
    line_color = torch.clamp(lines.color * 255.0, 0.0, 255.0).to(torch.uint8)
    out = image_u8.reshape(h * w, 3).clone()
    out[hit] = line_color[winner[hit] // s]
    return out.reshape(h, w, 3)
