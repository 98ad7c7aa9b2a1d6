"""Tile-binned z-buffer rasterizer in plain PyTorch.

Port of ``impact_tpu/render/raster.py`` (the reference's XLA raster, its CPU
oracle and fallback): triangles are near-clipped, binned into the ≤2×2 screen
tiles their bounding box touches (larger ones go to a global nearest-first
"big" list every tile tests), and each tile reduces (depth, candidate) over
its nearest ``k_per_tile`` candidates. In this package it is the
``raster_backend="raster"`` path: a second, independent rasterizer that the
tile kernel K1 (``raster_pallas.py``) is compared against on the card.
With a fixed ``k_per_tile`` overflow drops the farthest candidates and is
not counted, as in the reference; with ``fit_k`` (the port's render
passes) each tile keeps every candidate, so no tile list is truncated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NO_TRI = -1


class RasterTarget(NamedTuple):
    depth: torch.Tensor  # f32[H,W] NDC depth in [0,1], 1 = far (cleared)
    tri_id: torch.Tensor  # i64[H,W] winning clipped slot or −1


def _edge(ax, ay, bx, by, px, py):
    """2D edge function: cross((b-a), (p-a))."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def clip_triangles_near(clip_pos, tri_active, eps: float = 1e-6):
    """Clip triangles [T,3,4] against the near plane (clip z = 0).

    Returns (clip2 [2T,3,4], bary2 [2T,3,3], active2 [2T]): slot t holds the
    first output triangle of input t and slot t+T the second (quad case);
    ``bary2[j, i]`` are vertex i's barycentric weights w.r.t. the ORIGINAL
    triangle j % T."""
    t = clip_pos.shape[0]
    dev = clip_pos.device
    z = clip_pos[..., 2]
    inside = z > eps
    count = inside.sum(dim=-1)
    eye3 = torch.eye(3, dtype=clip_pos.dtype, device=dev)
    ar3 = torch.arange(3, device=dev)

    def rotated(k):
        idx = (k[:, None] + ar3[None, :]) % 3
        oh = (idx[..., None] == ar3[None, None, :]).to(clip_pos.dtype)
        v = torch.einsum("tij,tjc->tic", oh, clip_pos)
        return v, oh

    def lerp(va, ba, vb, bb):
        za, zb = va[..., 2], vb[..., 2]
        d = za - zb
        tt = za / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        tt = torch.clamp(tt, 0.0, 1.0)[..., None]
        return va + tt * (vb - va), ba + tt * (bb - ba)

    k1 = torch.argmax(inside.to(torch.uint8), dim=-1)
    v1, b1 = rotated(k1)
    i_ab_v, i_ab_b = lerp(v1[:, 0], b1[:, 0], v1[:, 1], b1[:, 1])
    i_ca_v, i_ca_b = lerp(v1[:, 0], b1[:, 0], v1[:, 2], b1[:, 2])
    tri1_v = torch.stack([v1[:, 0], i_ab_v, i_ca_v], dim=1)
    tri1_b = torch.stack([b1[:, 0], i_ab_b, i_ca_b], dim=1)

    k2 = torch.argmax((~inside).to(torch.uint8), dim=-1)
    v2, b2 = rotated(k2)
    j_ab_v, j_ab_b = lerp(v2[:, 1], b2[:, 1], v2[:, 0], b2[:, 0])
    j_ca_v, j_ca_b = lerp(v2[:, 2], b2[:, 2], v2[:, 0], b2[:, 0])
    quad_t1_v = torch.stack([j_ab_v, v2[:, 1], v2[:, 2]], dim=1)
    quad_t1_b = torch.stack([j_ab_b, b2[:, 1], b2[:, 2]], dim=1)
    quad_t2_v = torch.stack([j_ab_v, v2[:, 2], j_ca_v], dim=1)
    quad_t2_b = torch.stack([j_ab_b, b2[:, 2], j_ca_b], dim=1)

    full_b = eye3[None].expand(t, 3, 3)
    c2 = (count == 2)[:, None, None]
    c3 = (count == 3)[:, None, None]
    out1_v = torch.where(c3, clip_pos, torch.where(c2, quad_t1_v, tri1_v))
    out1_b = torch.where(c3, full_b, torch.where(c2, quad_t1_b, tri1_b))
    clip2 = torch.cat([out1_v, quad_t2_v], dim=0)
    bary2 = torch.cat([out1_b, quad_t2_b], dim=0)
    act2 = torch.cat([tri_active & (count > 0), tri_active & (count == 2)], dim=0)
    return clip2, bary2, act2


def _screen_coords(cp, height: int, width: int):
    """clip [...,4] → (sx, sy, z_ndc, valid). y flipped: row 0 = top."""
    w = cp[..., 3]
    valid = w > 1e-8
    inv_w = 1.0 / torch.where(valid, w, torch.ones_like(w))
    sx = (cp[..., 0] * inv_w * 0.5 + 0.5) * width
    sy = (0.5 - cp[..., 1] * inv_w * 0.5) * height
    return sx, sy, cp[..., 2] * inv_w, valid


class _Binned(NamedTuple):
    th: int
    tw: int
    starts: torch.Tensor  # i64[n_tiles]
    counts: torch.Tensor  # i64[n_tiles]
    tri_sorted: torch.Tensor  # i64[4·T2] clipped-slot ids by (tile, depth)
    big_order: torch.Tensor  # i64[nb]
    big_sel: torch.Tensor  # bool[nb]
    sx: torch.Tensor
    sy: torch.Tensor
    z: torch.Tensor
    inv_area: torch.Tensor


def _bin_small_and_big(clip2, act2, height, width, tile, big_budget, cull_backfaces):
    """Screen setup + (tile, depth) binning of ≤2×2-tile triangles and the
    nearest-first big list shared by every tile."""
    dev = clip2.device
    t2 = clip2.shape[0]
    th = -(-height // tile)
    tw = -(-width // tile)
    n_tiles = th * tw
    sx, sy, z, valid = _screen_coords(clip2, height, width)
    act = act2 & valid.all(dim=-1)
    area = _edge(sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2])
    act = act & ((area < -1e-12) if cull_backfaces else (area.abs() > 1e-12))
    xmin, xmax = sx.amin(dim=-1), sx.amax(dim=-1)
    ymin, ymax = sy.amin(dim=-1), sy.amax(dim=-1)
    act = act & (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height)

    def tcoord(v, n):
        return torch.clamp(torch.floor(v / tile).to(torch.int64), 0, n - 1)

    tx0, tx1 = tcoord(xmin, tw), tcoord(xmax, tw)
    ty0, ty1 = tcoord(ymin, th), tcoord(ymax, th)
    small = act & (tx1 - tx0 < 2) & (ty1 - ty0 < 2)
    big = act & ~small

    ddx = torch.tensor([0, 1, 0, 1], device=dev)
    ddy = torch.tensor([0, 0, 1, 1], device=dev)
    ptx = tx0[:, None] + ddx[None, :]
    pty = ty0[:, None] + ddy[None, :]
    pair_ok = small[:, None] & (ptx <= tx1[:, None]) & (pty <= ty1[:, None])
    pair_tile = torch.where(pair_ok, pty * tw + ptx, n_tiles).reshape(-1)
    near_z = z.amin(dim=-1)
    pair_depth = near_z[:, None].expand(t2, 4).reshape(-1)
    pair_tri = torch.arange(t2, device=dev)[:, None].expand(t2, 4).reshape(-1)
    # two-key (tile, depth) stable sort: depth first, then tile
    o1 = torch.sort(pair_depth, stable=True).indices
    o2 = torch.sort(pair_tile[o1], stable=True).indices
    order = o1[o2]
    tile_sorted = pair_tile[order]
    tri_sorted = pair_tri[order]
    tids = torch.arange(n_tiles, device=dev)
    starts = torch.searchsorted(tile_sorted, tids)
    ends = torch.searchsorted(tile_sorted, tids, right=True)

    nb = min(big_budget, t2)
    big_key = torch.where(big, near_z, torch.full_like(near_z, float("inf")))
    big_order = torch.sort(big_key, stable=True).indices[:nb]
    inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, torch.ones_like(area))
    return _Binned(th, tw, starts, ends - starts, tri_sorted, big_order,
                   big[big_order], sx, sy, z, inv_area)


def _tile_candidates(b: _Binned, tiles, k, tile):
    """Candidate ids [TC,KK], have-mask, and per-candidate barycentrics and
    depth against the tile's pixel centers ([TC,KK,S²] each)."""
    dev = b.starts.device
    tc = tiles.shape[0]
    st, cn = b.starts[tiles], b.counts[tiles]
    x0 = ((tiles % b.tw) * tile).to(torch.float32)
    y0 = ((tiles // b.tw) * tile).to(torch.float32)
    ar = torch.arange(k, device=dev)
    idx = torch.clamp(st[:, None] + ar[None, :], 0, b.tri_sorted.shape[0] - 1)
    have = ar[None, :] < cn[:, None]
    nb = b.big_order.shape[0]
    tri = torch.cat([b.tri_sorted[idx], b.big_order[None, :].expand(tc, nb)], dim=1)
    have = torch.cat([have, b.big_sel[None, :].expand(tc, nb)], dim=1)

    lc = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    lx = lc[None, :].expand(tile, tile).reshape(-1)[None, None, :]
    ly = lc[:, None].expand(tile, tile).reshape(-1)[None, None, :]

    def rel(a, o):
        return (a[tri] - o[:, None])[..., None]

    rax, ray = rel(b.sx[:, 0], x0), rel(b.sy[:, 0], y0)
    rbx, rby = rel(b.sx[:, 1], x0), rel(b.sy[:, 1], y0)
    rcx, rcy = rel(b.sx[:, 2], x0), rel(b.sy[:, 2], y0)
    ia = b.inv_area[tri][..., None]
    b0 = _edge(rbx, rby, rcx, rcy, lx, ly) * ia
    b1 = _edge(rcx, rcy, rax, ray, lx, ly) * ia
    b2 = _edge(rax, ray, rbx, rby, lx, ly) * ia
    covered = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & have[..., None]
    zpix = (b0 * b.z[:, 0][tri][..., None] + b1 * b.z[:, 1][tri][..., None]
            + b2 * b.z[:, 2][tri][..., None])
    covered = covered & (zpix >= 0.0) & (zpix <= 1.0)
    zpix = torch.where(covered, zpix, torch.full_like(zpix, float("inf")))
    return tri, zpix, (b0, b1, b2)


def _untile(arr, th, tw, tile, height, width):
    extra = tuple(arr.shape[2:])
    n = len(extra)
    return (
        arr.reshape((th, tw, tile, tile) + extra)
        .permute((0, 2, 1, 3) + tuple(range(4, 4 + n)))
        .reshape((th * tile, tw * tile) + extra)[:height, :width]
    )


def _default_k(n_tiles, t2):
    cap = 1024 if n_tiles < 256 else 512
    return int(min(cap, max(128, (2 * t2) // max(n_tiles, 1))))


def _tile_chunks(b: _Binned, k, tile, tiles_per_chunk, budget, fit_k):
    """(tile indices, k) chunks: the tiles in order with ``k`` candidates
    each, or with ``fit_k`` the most crowded tiles first, each chunk taking
    its most crowded tile's count as k (one host read), so that no tile
    drops a candidate and a crowded tile does not pad the others."""
    n_tiles = b.th * b.tw
    dev = b.starts.device
    if not fit_k:
        tc = tiles_per_chunk or max(8, min(128, n_tiles, budget // (k * tile * tile)))
        for s0 in range(0, n_tiles, tc):
            yield torch.arange(s0, min(s0 + tc, n_tiles), device=dev), k
        return
    counts, order = torch.sort(b.counts, descending=True, stable=True)
    counts = counts.tolist()
    s0 = 0
    while s0 < n_tiles:
        kc = max(1, counts[s0])
        tc = max(1, min(n_tiles - s0, budget // (kc * tile * tile)))
        yield order[s0:s0 + tc], kc
        s0 += tc


def clear_target(height: int, width: int, device="cuda") -> RasterTarget:
    """A cleared target: depth 1.0, no triangle (ref: clearing_pass.rs:20
    CLEAR_DEPTH = 1.0)."""
    return RasterTarget(
        depth=torch.ones((height, width), dtype=torch.float32, device=device),
        tri_id=torch.full((height, width), NO_TRI, dtype=torch.int64, device=device))


def rasterize(clip_pos, tri_active, height: int, width: int, chunk: int = 256,
              cull_backfaces: bool = True, method: str = "tiled", k_per_tile: int | None = None,
              big_budget: int = 32, tiles_per_chunk: int | None = None, *, tile: int = 32,
              fit_k: bool = False):
    """Depth raster of T triangle slots ([T,3,4] clip positions) into an
    H×W target. Returns (RasterTarget over CLIPPED slots, clip2, bary2);
    feed clip2/bary2 to :func:`resolve_barycentrics`. ``method`` "tiled"
    (the default) bins triangles into ``tile``-pixel screen tiles; "chunk"
    is the reference's brute-force oracle, every triangle against every
    pixel, ``chunk`` triangles at a time."""
    clip2, bary2, act2 = clip_triangles_near(clip_pos, tri_active)
    if method == "chunk":
        return _rasterize_chunks(clip2, act2, height, width, chunk, cull_backfaces), clip2, bary2
    if method != "tiled":
        raise ValueError(f"unknown raster method {method!r} (tiled | chunk)")
    t2 = clip2.shape[0]
    b = _bin_small_and_big(clip2, act2, height, width, tile, big_budget, cull_backfaces)
    n_tiles = b.th * b.tw
    k = k_per_tile or _default_k(n_tiles, t2)
    dev = clip2.device
    depth_t = torch.ones((n_tiles, tile * tile), dtype=torch.float32, device=dev)
    tri_t = torch.full((n_tiles, tile * tile), NO_TRI, dtype=torch.int64, device=dev)
    for tiles, k in _tile_chunks(b, k, tile, tiles_per_chunk, 1 << 25, fit_k):
        tri, zpix, _ = _tile_candidates(b, tiles, k, tile)
        best_z, best = zpix.min(dim=1)
        best_tri = torch.gather(tri, 1, best)
        fin = torch.isfinite(best_z)
        depth_t[tiles] = torch.where(fin, best_z, torch.ones_like(best_z))
        tri_t[tiles] = torch.where(fin, best_tri, torch.full_like(best_tri, NO_TRI))
    depth = _untile(depth_t, b.th, b.tw, tile, height, width)
    tri_id = _untile(tri_t, b.th, b.tw, tile, height, width)
    return RasterTarget(depth=depth, tri_id=tri_id), clip2, bary2


def _rasterize_chunks(clip2, act2, height: int, width: int, chunk: int,
                      cull_backfaces: bool) -> RasterTarget:
    """The reference's ``_rasterize_clipped``: per chunk of clipped slots,
    [chunk,H,W] edge functions and depths, the chunk's nearest covering slot
    per pixel (the first on a tie), kept where nearer than the target so far
    (an earlier chunk wins a tie). So each pixel takes the nearest covering
    slot, the lowest on a tie, which is what chunks of only the slots that
    can cover (active, valid, front-facing) give too: they are gathered
    first, in slot order (one host read)."""
    dev = clip2.device
    sx, sy, z, valid = _screen_coords(clip2, height, width)
    area = _edge(sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2])
    act = act2 & valid.all(dim=-1)
    act = act & ((area < -1e-12) if cull_backfaces else (area.abs() > 1e-12))
    slots = torch.nonzero(act).flatten()
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    target = clear_target(height, width, dev)
    depth_buf, tri_buf = target.depth, target.tri_id
    inf = torch.tensor(float("inf"), device=dev)
    for s0 in range(0, slots.shape[0], chunk):
        ids = slots[s0:s0 + chunk]
        ax, ay, az = (v[ids, 0, None, None] for v in (sx, sy, z))
        bx, by, bz = (v[ids, 1, None, None] for v in (sx, sy, z))
        cx, cy, cz = (v[ids, 2, None, None] for v in (sx, sy, z))
        inv_area = (1.0 / area[ids])[:, None, None]
        b0 = _edge(bx, by, cx, cy, px, py) * inv_area
        b1 = _edge(cx, cy, ax, ay, px, py) * inv_area
        b2 = _edge(ax, ay, bx, by, px, py) * inv_area
        zpix = b0 * az + b1 * bz + b2 * cz
        covered = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (zpix >= 0.0) & (zpix <= 1.0)
        zpix = torch.where(covered, zpix, inf)
        best = torch.argmin(zpix, dim=0)
        best_z = torch.gather(zpix, 0, best[None])[0]
        closer = best_z < depth_buf
        depth_buf = torch.where(closer, best_z, depth_buf)
        tri_buf = torch.where(closer, ids[best], tri_buf)
    return RasterTarget(depth=depth_buf, tri_id=tri_buf)


def resolve_barycentrics(clip2, bary2, target: RasterTarget, n_orig_tris: int):
    """Per-pixel perspective-correct barycentrics w.r.t. the ORIGINAL
    triangles of a :func:`rasterize` target. Returns (bary [H,W,3], tri
    [H,W] original-slot ids, valid [H,W])."""
    h, w = target.depth.shape
    dev = target.depth.device
    tri = torch.clamp(target.tri_id, min=0)
    cp = clip2[tri]  # [H,W,3,4]
    inv_w = 1.0 / torch.clamp(cp[..., 3], min=1e-8)
    sx = (cp[..., 0] * inv_w * 0.5 + 0.5) * w
    sy = (0.5 - cp[..., 1] * inv_w * 0.5) * h
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :].expand(h, w)
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(h, w)
    ax, ay, bx, by, cx, cy = sx[..., 0], sy[..., 0], sx[..., 1], sy[..., 1], sx[..., 2], sy[..., 2]
    area = _edge(ax, ay, bx, by, cx, cy)
    inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, torch.ones_like(area))
    b0 = _edge(bx, by, cx, cy, px, py) * inv_area
    b1 = _edge(cx, cy, ax, ay, px, py) * inv_area
    b2 = 1.0 - b0 - b1
    pb = torch.stack([b0, b1, b2], dim=-1) * inv_w
    pb = pb / torch.clamp(pb.sum(dim=-1, keepdim=True), min=1e-12)
    orig_bary = torch.einsum("hwi,hwij->hwj", pb, bary2[tri])
    return orig_bary, tri % n_orig_tris, target.tri_id >= 0


def interpolate_attribute(attr_per_vertex, tri_indices, tri, bary, valid, fill=0.0):
    """A per-vertex attribute [V,K] interpolated over resolved pixels:
    ``tri_indices`` [T,3] vertex slots, ``tri`` [H,W], ``bary`` [H,W,3]."""
    vals = attr_per_vertex[tri_indices[tri]]  # [H,W,3,K]
    out = torch.einsum("hwv,hwvk->hwk", bary, vals)
    return torch.where(valid[..., None], out, torch.as_tensor(fill, dtype=out.dtype,
                                                              device=out.device))


def rasterize_attributes(clip_pos, tri_active, tri_indices, vert_attrs, height: int,
                         width: int, tile: int = 32, k_per_tile: int | None = None,
                         big_budget: int = 32, tiles_per_chunk: int | None = None,
                         cull_backfaces: bool = True, *, fit_k: bool = False):
    """Tile-binned raster with per-candidate attribute interpolation.
    Returns (interp [H,W,A], nearest-corner [H,W,A], valid [H,W])."""
    t = clip_pos.shape[0]
    a_dim = vert_attrs.shape[1]
    clip2, bary2, act2 = clip_triangles_near(clip_pos, tri_active)
    t2 = clip2.shape[0]
    dev = clip2.device
    b = _bin_small_and_big(clip2, act2, height, width, tile, big_budget, cull_backfaces)
    n_tiles = b.th * b.tw
    k = k_per_tile or _default_k(n_tiles, t2)
    s2 = tile * tile
    inv_w = 1.0 / torch.clamp(clip2[..., 3], min=1e-8)
    vids = tri_indices[torch.arange(t2, device=dev) % t]
    interp_t = torch.zeros((n_tiles, s2, a_dim), dtype=torch.float32, device=dev)
    near_t = torch.zeros_like(interp_t)
    valid_t = torch.zeros((n_tiles, s2), dtype=torch.bool, device=dev)
    for tiles, k in _tile_chunks(b, k, tile, tiles_per_chunk, 1 << 24, fit_k):
        tri, zpix, (b0, b1, b2) = _tile_candidates(b, tiles, k, tile)
        best_z, best = zpix.min(dim=1)
        vmask = torch.isfinite(best_z)

        def take(x):
            return torch.gather(x, 1, best[:, None, :])[:, 0, :]

        wtri = torch.gather(tri, 1, best)  # [TC,S²] winning clipped slot
        iw = inv_w[wtri]  # [TC,S²,3]
        av = torch.einsum("tsij,tsja->tsia", bary2[wtri], vert_attrs[vids[wtri]])
        pb = torch.stack([take(b0), take(b1), take(b2)], dim=-1) * iw
        pb = pb / torch.clamp(pb.sum(dim=-1, keepdim=True), min=1e-12)
        interp = torch.einsum("tsi,tsia->tsa", pb, av)
        nearest = torch.argmax(pb, dim=-1)
        near = torch.gather(av, 2, nearest[..., None, None].expand(-1, -1, 1, a_dim))[:, :, 0]
        zero = torch.zeros((), device=dev)
        interp_t[tiles] = torch.where(vmask[..., None], interp, zero)
        near_t[tiles] = torch.where(vmask[..., None], near, zero)
        valid_t[tiles] = vmask
    return (_untile(interp_t, b.th, b.tw, tile, height, width),
            _untile(near_t, b.th, b.tw, tile, height, width),
            _untile(valid_t, b.th, b.tw, tile, height, width))
