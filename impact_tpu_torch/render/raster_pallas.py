"""Tile rasterizer K1: torch prologue, CUDA kernel wrappers, plain version.

Port of ``impact_tpu/render/raster_pallas.py`` (the module keeps the
reference's name so the two packages line up file for file; its kernel is
CUDA C++, ``csrc/raster.cu``, not Pallas).

  prologue (torch): projection, near clip and screen-plane coefficients on
      flat [T] component arrays (``_project_soa``, ``_clip_near_soa``,
      ``_plane_soa``); ``_bin_planes`` bins each triangle to the top-left
      tile of its bbox on the fine grid, or on the 4× coarse grid when it
      spans more than 2×2 fine tiles, sorts by (bin << 14 | quantized z),
      and cuts four candidate windows per tile (2×2 fine, 2×2 coarse), each
      truncated to ``k_per_range`` nearest-first (``k_per_range=None``: as
      long as the view's longest window, read once on the host, so nothing
      is truncated; the port's render passes take this, the reference's
      fixed 256 overflows on dense views). Larger triangles and the
      second halves of near-plane quad splits go to one nearest-first "big"
      block every tile tests. Overflow is counted in ``n_drop``.
  kernel (K1): per tile, the coverage/depth test of every window candidate
      and the big block against every pixel — a z-min (depth variant) or a
      packed (masked z | window position) key min plus the winner's
      attribute interpolation (attribute variant).

Z test (kept from the reference): the attribute variant compares z with its
low ``pos_bits`` (≥ 11) mantissa bits masked and breaks ties by window
position, exactly as the TPU kernel does, so the port picks the same winner
and the same drops as the reference; the output depth is re-derived exactly
from the winner's plane.

``tile_raster`` takes the kernel's plain PyTorch version for CPU tensors and
launches the CUDA kernel for CUDA tensors (or raises); ``LAUNCHES`` counts
kernel launches per variant.
"""

from __future__ import annotations

import torch

from ..utils.launches import LaunchCounter
from .raster import _edge, _screen_coords, clip_triangles_near

GEOM_ROWS = 12  # a0 b0 c0 | a1 b1 c1 | za zb zc | iw0 iw1 iw2
_INF = 3.0e38
_LANES = 128
_ZKEY_BITS = 14
_ZKEY_SCALE = float((1 << _ZKEY_BITS) - 2)
COARSE_FACTOR = 4
_N_WINDOWS = 4
_KEY_INF = 0x7FFFFFFF
_MAX_PAYLOAD_ROWS = 1 << 28  # the attribute kernel flags big-block winners with bit 28
_MAX_ATTR = 2048  # csrc/raster.cu:kMaxAttr


LAUNCHES = LaunchCounter(k1_raster_depth=0, k1_raster_attributes=0)


# --- SoA prologue -------------------------------------------------------------


def _project_soa(tri_pos9, vp):
    """World corner positions [T,9] × vp[4,4] → (x, y, z, w) lists of three [T]."""
    vx, vy, vz, vw = [], [], [], []
    for c in range(3):
        px = tri_pos9[:, 3 * c]
        py = tri_pos9[:, 3 * c + 1]
        pz = tri_pos9[:, 3 * c + 2]
        vx.append(vp[0, 0] * px + vp[0, 1] * py + vp[0, 2] * pz + vp[0, 3])
        vy.append(vp[1, 0] * px + vp[1, 1] * py + vp[1, 2] * pz + vp[1, 3])
        vz.append(vp[2, 0] * px + vp[2, 1] * py + vp[2, 2] * pz + vp[2, 3])
        vw.append(vp[3, 0] * px + vp[3, 1] * py + vp[3, 2] * pz + vp[3, 3])
    return vx, vy, vz, vw


def _clip_near_soa(vx, vy, vz, vw, act, eps=1e-6, need_bary=False):
    """Componentwise near-plane clip (semantics of raster.clip_triangles_near).
    Returns ((cx, cy, cz, cw) lists of three [2T], bary[i][c] or None, act2)."""
    inside = [vz[i] > eps for i in range(3)]
    count = inside[0].int() + inside[1].int() + inside[2].int()
    zero = torch.zeros_like(count)
    k1 = torch.where(inside[0], zero, torch.where(inside[1], zero + 1, zero + 2))
    k2 = torch.where(~inside[0], zero, torch.where(~inside[1], zero + 1, zero + 2))

    def sel(k, comps, i):
        s = k + i
        s = torch.where(s >= 3, s - 3, s)
        return torch.where(s == 0, comps[0], torch.where(s == 1, comps[1], comps[2]))

    comps = (vx, vy, vz, vw)

    def rot(k):
        return [[sel(k, q, i) for i in range(3)] for q in comps]

    def rot_bary(k):
        return [
            [(torch.where(k + i >= 3, k + i - 3, k + i) == c).to(vx[0].dtype) for c in range(3)]
            for i in range(3)
        ]

    def lerp_t(za, zb):
        d = za - zb
        tt = za / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        return torch.clamp(tt, 0.0, 1.0)

    def mix(a, b, tt):
        return a + tt * (b - a)

    r1 = rot(k1)
    t_ab = lerp_t(r1[2][0], r1[2][1])
    t_ca = lerp_t(r1[2][0], r1[2][2])
    tri1 = [[q[0], mix(q[0], q[1], t_ab), mix(q[0], q[2], t_ca)] for q in r1]

    r2 = rot(k2)
    t1 = lerp_t(r2[2][1], r2[2][0])
    t2 = lerp_t(r2[2][2], r2[2][0])
    jab = [mix(q[1], q[0], t1) for q in r2]
    jca = [mix(q[2], q[0], t2) for q in r2]
    quad1 = [[jab[qi], r2[qi][1], r2[qi][2]] for qi in range(4)]
    quad2 = [[jab[qi], r2[qi][2], jca[qi]] for qi in range(4)]

    c2m = count == 2
    c3m = count == 3
    out1 = [
        [torch.where(c3m, comps[qi][i], torch.where(c2m, quad1[qi][i], tri1[qi][i]))
         for i in range(3)]
        for qi in range(4)
    ]
    outs = tuple(
        [torch.cat([out1[qi][i], quad2[qi][i]]) for i in range(3)] for qi in range(4)
    )
    act_out = torch.cat([act & (count > 0), act & c2m])

    bary = None
    if need_bary:
        b1r = rot_bary(k1)
        b2r = rot_bary(k2)
        tri1_b = [[b1r[0][c], mix(b1r[0][c], b1r[1][c], t_ab), mix(b1r[0][c], b1r[2][c], t_ca)]
                  for c in range(3)]
        jab_b = [mix(b2r[1][c], b2r[0][c], t1) for c in range(3)]
        jca_b = [mix(b2r[2][c], b2r[0][c], t2) for c in range(3)]
        quad1_b = [[jab_b[c], b2r[1][c], b2r[2][c]] for c in range(3)]
        quad2_b = [[jab_b[c], b2r[2][c], jca_b[c]] for c in range(3)]
        out1_b = [
            [torch.where(c3m, torch.full_like(vx[0], 1.0 if i == c else 0.0),
                         torch.where(c2m, quad1_b[c][i], tri1_b[c][i]))
             for c in range(3)]
            for i in range(3)
        ]
        bary = [[torch.cat([out1_b[i][c], quad2_b[c][i]]) for c in range(3)] for i in range(3)]
    return outs, bary, act_out


def _planes(sx, sy, z, iws, act, height, width, cull_backfaces):
    """Screen-plane coefficients from per-corner screen coords (lists of [T2])."""
    area = _edge(sx[0], sy[0], sx[1], sy[1], sx[2], sy[2])
    if cull_backfaces:
        act = act & (area < -1e-12)
    else:
        act = act & (area.abs() > 1e-12)
    xmin = torch.minimum(sx[0], torch.minimum(sx[1], sx[2]))
    xmax = torch.maximum(sx[0], torch.maximum(sx[1], sx[2]))
    ymin = torch.minimum(sy[0], torch.minimum(sy[1], sy[2]))
    ymax = torch.maximum(sy[0], torch.maximum(sy[1], sy[2]))
    act = act & (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height)

    ia = 1.0 / torch.where(area.abs() > 1e-12, area, torch.ones_like(area))
    ax, ay = sx[0], sy[0]
    bx, by = sx[1], sy[1]
    cx, cy = sx[2], sy[2]
    a0 = -(cy - by) * ia
    b0 = (cx - bx) * ia
    c0 = (-by * (cx - bx) + bx * (cy - by)) * ia
    a1 = -(ay - cy) * ia
    b1 = (ax - cx) * ia
    c1 = (-cy * (ax - cx) + cx * (ay - cy)) * ia
    za = a0 * (z[0] - z[2]) + a1 * (z[1] - z[2])
    zb = b0 * (z[0] - z[2]) + b1 * (z[1] - z[2])
    zc = c0 * (z[0] - z[2]) + c1 * (z[1] - z[2]) + z[2]
    c0 = torch.where(act, c0, torch.full_like(c0, -1.0))
    a0 = torch.where(act, a0, torch.zeros_like(a0))
    b0 = torch.where(act, b0, torch.zeros_like(b0))
    geom = [a0, b0, c0, a1, b1, c1, za, zb, zc, iws[0], iws[1], iws[2]]
    near_z = torch.where(act, torch.minimum(z[0], torch.minimum(z[1], z[2])),
                         torch.full_like(z[0], float("inf")))
    return geom, act, (xmin, xmax, ymin, ymax), near_z


def _plane_soa(cx, cy, cz, cw, act2, height, width, cull_backfaces):
    sx, sy, z, valid = [], [], [], []
    for i in range(3):
        v = cw[i] > 1e-8
        iw = 1.0 / torch.where(v, cw[i], torch.ones_like(cw[i]))
        sx.append((cx[i] * iw * 0.5 + 0.5) * width)
        sy.append((0.5 - cy[i] * iw * 0.5) * height)
        z.append(cz[i] * iw)
        valid.append(v)
    act = act2 & valid[0] & valid[1] & valid[2]
    iws = [1.0 / torch.clamp(w, min=1e-8) for w in cw]
    return _planes(sx, sy, z, iws, act, height, width, cull_backfaces)


def _plane_coefficients(clip2, act2, height, width, cull_backfaces):
    sx, sy, z, valid = _screen_coords(clip2, height, width)  # [T2,3]
    act = act2 & valid.all(dim=-1)
    iw = 1.0 / torch.clamp(clip2[..., 3], min=1e-8)
    return _planes(sx.unbind(-1), sy.unbind(-1), z.unbind(-1), iw.unbind(-1), act,
                   height, width, cull_backfaces)


class Binned:
    """Prologue output: what K1 reads (all on the device of the inputs)."""

    def __init__(self, payload, ranges, big, big_have, n_drop, th, tw, tile,
                 k_per_range, height, width):
        self.payload = payload  # f32[P, R] candidate-major, sorted by (bin, zq)
        self.ranges = ranges  # i32[n_tiles, 8]: 4 window starts, 4 counts
        self.big = big  # f32[nb, R] nearest-first big block
        # bool[nb]: one byte of 0 or 1 per slot, which K1 reads as it is
        self.big_have = big_have
        self.n_drop = n_drop  # i64[] candidates lost to window/big overflow
        self.th, self.tw, self.tile = th, tw, tile
        self.k_per_range = k_per_range
        self.height, self.width = height, width

    @property
    def rows(self) -> int:
        return self.payload.shape[1]

    @property
    def n_blocks(self) -> int:
        """Window span in 128-position blocks (the reference's DMA window)."""
        return 1 + -(-self.k_per_range // _LANES)

    @property
    def pos_bits(self) -> int:
        n_parts = _N_WINDOWS * self.n_blocks + 1
        return max(11, (n_parts * _LANES - 1).bit_length())


def _bin_planes(geom, act, bbox, near_z, height, width, tile, k_per_range, big_budget,
                attr_corners, n_first) -> Binned:
    """Binning from precomputed screen planes (all flat [T2] tensors)."""
    xmin, xmax, ymin, ymax = bbox
    dev = act.device
    t2 = act.shape[0]
    th = -(-height // tile)
    tw = -(-width // tile)
    n_tiles = th * tw

    def tcoord(v, size, n):
        return torch.clamp(torch.floor(v / size).to(torch.int64), 0, n - 1)

    tx0, tx1 = tcoord(xmin, tile, tw), tcoord(xmax, tile, tw)
    ty0, ty1 = tcoord(ymin, tile, th), tcoord(ymax, tile, th)
    ctile = tile * COARSE_FACTOR
    tcw = -(-tw // COARSE_FACTOR)
    tch = -(-th // COARSE_FACTOR)
    n_ctiles = tch * tcw
    cx0, cx1 = tcoord(xmin, ctile, tcw), tcoord(xmax, ctile, tcw)
    cy0, cy1 = tcoord(ymin, ctile, tch), tcoord(ymax, ctile, tch)

    first = torch.arange(t2, device=dev) < n_first
    fits_fine = (tx1 - tx0 <= 1) & (ty1 - ty0 <= 1)
    fits_coarse = (cx1 - cx0 <= 1) & (cy1 - cy0 <= 1)
    small = act & fits_fine & first
    medium = act & ~fits_fine & fits_coarse & first
    big = act & ~small & ~medium
    btile = torch.where(
        small, ty0 * tw + tx0,
        torch.where(medium, n_tiles + cy0 * tcw + cx0,
                    torch.full_like(tx0, n_tiles + n_ctiles)),
    )

    # partition by bin; nearest-first within a bin by a quantized-z sub-key,
    # so window truncation drops the farthest candidates (stable sort, as the
    # reference's lax.sort)
    zq = torch.clamp(near_z, 0.0, 1.0)
    zq = torch.where(small | medium, (zq * _ZKEY_SCALE).to(torch.int64),
                     torch.full_like(btile, (1 << _ZKEY_BITS) - 1))
    key = (btile[:n_first] << _ZKEY_BITS) | zq[:n_first]
    key_s, order = torch.sort(key, stable=True)
    rows = list(geom) + (list(attr_corners) if attr_corners is not None else [])
    full = torch.stack(rows, dim=-1)  # [T2, R]
    payload = full[:n_first][order].contiguous()
    tile_s = key_s >> _ZKEY_BITS
    bounds = torch.searchsorted(tile_s, torch.arange(n_tiles + n_ctiles + 1, device=dev))

    tids = torch.arange(n_tiles, device=dev)
    ttx = tids % tw
    tty = tids // tw
    rel = torch.tensor([-1, 0], device=dev)
    lo_x = torch.clamp(ttx - 1, min=0)
    rows2 = tty[:, None] + rel[None, :]
    rows_c = torch.clamp(rows2, min=0)
    r_start = bounds[rows_c * tw + lo_x[:, None]]
    r_end = bounds[rows_c * tw + ttx[:, None] + 1]
    r_len = torch.where(rows2 >= 0, r_end - r_start, torch.zeros_like(r_end))
    ctx = ttx // COARSE_FACTOR
    cty = tty // COARSE_FACTOR
    lo_cx = torch.clamp(ctx - 1, min=0)
    crows2 = cty[:, None] + rel[None, :]
    crows_c = torch.clamp(crows2, min=0)
    cr_start = bounds[n_tiles + crows_c * tcw + lo_cx[:, None]]
    cr_end = bounds[n_tiles + crows_c * tcw + ctx[:, None] + 1]
    cr_len = torch.where(crows2 >= 0, cr_end - cr_start, torch.zeros_like(cr_end))
    starts4 = torch.cat([r_start, cr_start], dim=-1)
    lens4 = torch.cat([r_len, cr_len], dim=-1)
    if k_per_range is None:
        # windows as long as this view's longest (one host read): nothing drops
        longest = int(lens4.max()) if lens4.numel() else 0
        k_per_range = max(_LANES, -(-longest // _LANES) * _LANES)
    counts4 = torch.clamp(lens4, max=k_per_range)
    n_drop = (lens4 - counts4).sum()

    # big block: nearest-first, lower index first among ties (lax.top_k order)
    nb = int(min(big_budget, _LANES, t2))
    big_key = torch.where(big, near_z, torch.full_like(near_z, float("inf")))
    big_order = torch.sort(big_key, stable=True).indices[:nb]
    big_have = big[big_order]
    big_rows = torch.where(big_have[:, None], full[big_order], torch.zeros((), device=dev))
    big_rows[:, 2] = torch.where(big_have, big_rows[:, 2], torch.full_like(big_rows[:, 2], -1.0))
    n_drop = n_drop + torch.clamp(big.sum() - nb, min=0)

    ranges = torch.cat([torch.clamp(starts4, max=n_first), counts4], dim=-1)
    return Binned(payload, ranges.to(torch.int32).contiguous(), big_rows.contiguous(),
                  big_have.contiguous(), n_drop, th, tw, tile, k_per_range, height, width)


# --- K1: plain version and kernel dispatch -------------------------------------


def _plane_eval(g, px, py, i):
    """(a·px + b·py) + c for plane i of candidate rows g[..., 12]."""
    return (g[..., 3 * i] * px + g[..., 3 * i + 1] * py) + g[..., 3 * i + 2]


def _tile_chunk_candidates(b: Binned, tiles, kmax):
    """Per tile: candidate payload rows [nt, C, R], their key positions
    [nt, C] and have-mask [nt, C] (four windows of kmax, then the big block)."""
    dev = b.payload.device
    nt = tiles.shape[0]
    span = b.n_blocks * _LANES
    ar = torch.arange(kmax, device=dev)
    rng = b.ranges[tiles].long()
    starts, counts = rng[:, :4], rng[:, 4:]
    idx = starts[:, :, None] + ar[None, None, :]  # [nt,4,kmax]
    have = ar[None, None, :] < counts[:, :, None]
    p = max(b.payload.shape[0], 1)
    idx = torch.clamp(idx, 0, p - 1)
    pos = (torch.arange(4, device=dev)[None, :, None] * span
           + (starts % _LANES)[:, :, None] + ar[None, None, :])
    nb = b.big.shape[0]
    if b.payload.shape[0] > 0:
        rows = b.payload[idx.reshape(nt, -1)]
    else:
        rows = torch.zeros((nt, 4 * kmax, b.rows), device=dev)
    rows = torch.cat([rows, b.big[None].expand(nt, nb, b.rows)], dim=1)
    pos = torch.cat([pos.reshape(nt, -1),
                     (4 * span + torch.arange(nb, device=dev))[None].expand(nt, nb)], dim=1)
    have = torch.cat([have.reshape(nt, -1), b.big_have[None].expand(nt, nb)], dim=1)
    return rows, pos, have


def _pixel_centers(b: Binned, tiles):
    tile = b.tile
    dev = tiles.device
    x0 = ((tiles % b.tw) * tile).to(torch.float32)
    y0 = ((tiles // b.tw) * tile).to(torch.float32)
    pc = torch.arange(tile * tile, device=dev)
    px = (x0[:, None] + (pc % tile).to(torch.float32)[None, :]) + 0.5
    py = (y0[:, None] + (pc // tile).to(torch.float32)[None, :]) + 0.5
    return px, py  # [nt, S²]


def _scatter_tiles(vals, tiles, b: Binned, out):
    """Write per-tile pixel values [nt, S², ...] into an [H, W, ...] output."""
    tile = b.tile
    dev = tiles.device
    pc = torch.arange(tile * tile, device=dev)
    x = (tiles % b.tw)[:, None] * tile + (pc % tile)[None, :]
    y = (tiles // b.tw)[:, None] * tile + (pc // tile)[None, :]
    ok = (x < b.width) & (y < b.height)
    out[y[ok], x[ok]] = vals[ok]


def _chunks(b: Binned):
    """(tile indices, kmax) chunks, the most crowded tiles first, each with
    its longest window and sized to bound the [nt, S², C] temporaries (a
    crowded tile does not pad the others)."""
    n_tiles = b.th * b.tw
    longest = b.ranges[:, 4:].amax(dim=1)
    k_sorted, order = torch.sort(longest.long(), descending=True, stable=True)
    k_sorted = k_sorted.tolist()
    s0 = 0
    while s0 < n_tiles:
        kmax = k_sorted[s0]
        c = 4 * kmax + b.big.shape[0]
        nt = max(1, min(n_tiles - s0, (1 << 24) // max(1, c * b.tile * b.tile)))
        yield order[s0:s0 + nt], kmax
        s0 += nt


def _cover(rows, px, py, have):
    """Coverage [nt,S²,C] and z [nt,S²,C] of candidate rows against pixels."""
    g = rows[:, None, :, :GEOM_ROWS]
    pxe, pye = px[:, :, None], py[:, :, None]
    b0 = _plane_eval(g, pxe, pye, 0)
    b1 = _plane_eval(g, pxe, pye, 1)
    z = _plane_eval(g, pxe, pye, 2)
    b2 = (1.0 - b0) - b1
    cov = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (z >= 0) & (z <= 1) & have[:, None, :]
    return cov, z


def raster_depth_plain(b: Binned):
    """Plain PyTorch version of K1's depth variant → depth f32[H, W]."""
    dev = b.payload.device
    out = torch.ones((b.height, b.width), dtype=torch.float32, device=dev)
    for tiles, kmax in _chunks(b):
        rows, _, have = _tile_chunk_candidates(b, tiles, kmax)
        px, py = _pixel_centers(b, tiles)
        cov, z = _cover(rows, px, py, have)
        best = torch.where(cov, z, torch.full_like(z, _INF)).amin(dim=-1)
        best = torch.where(best >= _INF, torch.ones_like(best), best)
        _scatter_tiles(best, tiles, b, out)
    return out


def raster_attributes_plain(b: Binned, n_attr: int):
    """Plain PyTorch version of K1's attribute variant →
    (interp [H,W,A], near [H,W,A], z [H,W], valid bool[H,W])."""
    dev = b.payload.device
    h, w = b.height, b.width
    interp_o = torch.zeros((h, w, n_attr), dtype=torch.float32, device=dev)
    near_o = torch.zeros_like(interp_o)
    z_o = torch.ones((h, w), dtype=torch.float32, device=dev)
    valid_o = torch.zeros((h, w), dtype=torch.bool, device=dev)
    pos_bits = b.pos_bits
    zmask = (0x7FFFFFFF >> pos_bits) << pos_bits
    for tiles, kmax in _chunks(b):
        rows, pos, have = _tile_chunk_candidates(b, tiles, kmax)
        px, py = _pixel_centers(b, tiles)
        cov, z = _cover(rows, px, py, have)
        keys = (z.view(torch.int32) & zmask) | pos[:, None, :].to(torch.int32)
        keys = torch.where(cov, keys, torch.full_like(keys, _KEY_INF))
        bk, arg = keys.min(dim=-1)  # [nt,S²]; positions are unique per tile
        valid = bk != _KEY_INF
        sel = torch.gather(rows, 1, arg[..., None].expand(-1, -1, b.rows))  # [nt,S²,R]
        b0 = _plane_eval(sel, px, py, 0)
        b1 = _plane_eval(sel, px, py, 1)
        b2 = (1.0 - b0) - b1
        pb0, pb1, pb2 = b0 * sel[..., 9], b1 * sel[..., 10], b2 * sel[..., 11]
        norm = 1.0 / torch.clamp((pb0 + pb1) + pb2, min=1e-12)
        pb0, pb1, pb2 = pb0 * norm, pb1 * norm, pb2 * norm
        a0 = sel[..., GEOM_ROWS:GEOM_ROWS + n_attr]
        a1 = sel[..., GEOM_ROWS + n_attr:GEOM_ROWS + 2 * n_attr]
        a2 = sel[..., GEOM_ROWS + 2 * n_attr:GEOM_ROWS + 3 * n_attr]
        pb0e, pb1e, pb2e = pb0[..., None], pb1[..., None], pb2[..., None]
        interp = (pb0e * a0 + pb1e * a1) + pb2e * a2
        m01 = pb0e >= pb1e
        m = torch.where(m01, pb0e, pb1e)
        near = torch.where(m >= pb2e, torch.where(m01, a0, a1), a2)
        z_exact = _plane_eval(sel, px, py, 2)
        vf = valid[..., None]
        zero = torch.zeros((), device=dev)
        _scatter_tiles(torch.where(vf, interp, zero), tiles, b, interp_o)
        _scatter_tiles(torch.where(vf, near, zero), tiles, b, near_o)
        _scatter_tiles(torch.where(valid, z_exact, torch.ones_like(z_exact)), tiles, b, z_o)
        _scatter_tiles(valid, tiles, b, valid_o)
    return interp_o, near_o, z_o, valid_o


def _check_binned(b: Binned):
    for name in ("payload", "big"):
        t = getattr(b, name)
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"K1 {name} must be contiguous float32")
    if b.ranges.dtype != torch.int32 or b.ranges.shape != (b.th * b.tw, 8):
        raise ValueError("K1 ranges must be int32 [n_tiles, 8]")
    if b.big.shape[0] > _LANES or b.big_have.shape != (b.big.shape[0],):
        raise ValueError("K1 big block holds at most 128 candidates")
    if b.big_have.dtype != torch.bool or not b.big_have.is_contiguous():
        raise ValueError("K1 big_have must be contiguous bool")
    if b.payload.shape[0] >= _MAX_PAYLOAD_ROWS:
        raise ValueError(f"K1 takes fewer than {_MAX_PAYLOAD_ROWS} payload rows")
    if b.tile not in (16, 32):
        raise ValueError(f"K1 supports tiles of 16 or 32 px, not {b.tile}")
    devs = {t.device for t in (b.payload, b.ranges, b.big, b.big_have)}
    if len(devs) != 1:
        raise ValueError(f"K1 inputs on several devices: {devs}")


def _launch_check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _ptr(t):
    return t.data_ptr() if t.numel() else None


def raster_depth(b: Binned):
    """K1 depth variant: plain version on CPU tensors, CUDA kernel on CUDA."""
    if b.payload.device.type == "cpu":
        return raster_depth_plain(b)
    _check_binned(b)
    if b.payload.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {b.payload.device}")
    from .. import _build

    lib = _build.load()
    out = torch.empty((b.height, b.width), dtype=torch.float32, device=b.payload.device)
    rc = lib.k1_raster_depth(
        _ptr(b.payload), b.rows, _ptr(b.ranges), _ptr(b.big), _ptr(b.big_have),
        b.big.shape[0], out.data_ptr(), b.height, b.width, b.tile, b.tw, b.th * b.tw,
        torch.cuda.current_stream(b.payload.device).cuda_stream,
    )
    _launch_check(rc, "k1_raster_depth")
    LAUNCHES["k1_raster_depth"] += 1
    return out


def raster_attributes(b: Binned, n_attr: int):
    """K1 attribute variant: plain version on CPU tensors, CUDA kernel on CUDA."""
    if b.payload.device.type == "cpu":
        return raster_attributes_plain(b, n_attr)
    _check_binned(b)
    if b.rows != GEOM_ROWS + 3 * n_attr:
        raise ValueError(f"payload rows {b.rows} != 12 + 3*{n_attr}")
    if not 1 <= n_attr <= _MAX_ATTR:
        raise ValueError(f"K1 takes 1 to {_MAX_ATTR} attributes, not {n_attr}")
    if b.payload.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {b.payload.device}")
    from .. import _build

    lib = _build.load()
    dev = b.payload.device
    h, w = b.height, b.width
    interp = torch.empty((h, w, n_attr), dtype=torch.float32, device=dev)
    near = torch.empty((h, w, n_attr), dtype=torch.float32, device=dev)
    z = torch.empty((h, w), dtype=torch.float32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)  # written as bytes 0 or 1
    rc = lib.k1_raster_attributes(
        _ptr(b.payload), b.rows, _ptr(b.ranges), _ptr(b.big), _ptr(b.big_have),
        b.big.shape[0], n_attr, b.n_blocks, b.pos_bits,
        interp.data_ptr(), near.data_ptr(), z.data_ptr(), valid.data_ptr(),
        h, w, b.tile, b.tw, b.th * b.tw, torch.cuda.current_stream(dev).cuda_stream,
    )
    _launch_check(rc, "k1_raster_attributes")
    LAUNCHES["k1_raster_attributes"] += 1
    return interp, near, z, valid


# --- public wrappers (same signatures as the reference's) ----------------------


def _attr_rows(bary, vert_attrs):
    """Attributes of the clipped corners as a list of [2T] rows:
    row (i, j) = Σ_c bary[i][c] · corner_c[:, j]."""
    a_dim = vert_attrs.shape[1] // 3
    ca = [torch.cat([vert_attrs[:, c * a_dim:(c + 1) * a_dim]] * 2, dim=0) for c in range(3)]
    return a_dim, [
        bary[i][0] * ca[0][:, j] + bary[i][1] * ca[1][:, j] + bary[i][2] * ca[2][:, j]
        for i in range(3)
        for j in range(a_dim)
    ]


def bin_attributes_pos(tri_pos9, tri_active, vert_attrs, vp, height, width, *, tile=16,
                       k_per_range=128, big_budget=128, cull_backfaces=True):
    """SoA prologue of ``rasterize_attributes_pos`` → (Binned, n_attr)."""
    t = tri_pos9.shape[0]
    vx, vy, vz, vw = _project_soa(tri_pos9, vp)
    (cx, cy, cz, cw), bary, act2 = _clip_near_soa(vx, vy, vz, vw, tri_active, need_bary=True)
    a_dim, attr_rows = _attr_rows(bary, vert_attrs)
    geom, act, bbox, near_z = _plane_soa(cx, cy, cz, cw, act2, height, width, cull_backfaces)
    return _bin_planes(geom, act, bbox, near_z, height, width, tile, k_per_range,
                       big_budget, attr_rows, n_first=t), a_dim


def bin_depth_pos(tri_pos9, tri_active, vp, height, width, *, tile=16, k_per_range=128,
                  big_budget=128, cull_backfaces=True) -> Binned:
    """SoA prologue of ``rasterize_depth_pos``."""
    t = tri_pos9.shape[0]
    vx, vy, vz, vw = _project_soa(tri_pos9, vp)
    (cx, cy, cz, cw), _, act2 = _clip_near_soa(vx, vy, vz, vw, tri_active)
    geom, act, bbox, near_z = _plane_soa(cx, cy, cz, cw, act2, height, width, cull_backfaces)
    return _bin_planes(geom, act, bbox, near_z, height, width, tile, k_per_range,
                       big_budget, None, n_first=t)


def rasterize_attributes_pos(tri_pos9, tri_active, vert_attrs, vp, height: int, width: int,
                             *, tile: int = 16, k_per_range: int | None = 128,
                             big_budget: int = 128, cull_backfaces: bool = True,
                             return_drops: bool = False):
    """Corner-major attribute raster: world corner positions [T,9], corner-major
    attributes [T,3A], view-projection [4,4] → (interp [H,W,A], near [H,W,A],
    valid [H,W]) and, with ``return_drops``, the overflow count n_drop."""
    b, a_dim = bin_attributes_pos(
        tri_pos9, tri_active, vert_attrs, vp, height, width, tile=tile,
        k_per_range=k_per_range, big_budget=big_budget, cull_backfaces=cull_backfaces)
    interp, near, _, valid = raster_attributes(b, a_dim)
    if return_drops:
        return interp, near, valid, b.n_drop
    return interp, near, valid


def rasterize_depth_pos(tri_pos9, tri_active, vp, height: int, width: int, *,
                        tile: int = 16, k_per_range: int | None = 128, big_budget: int = 128,
                        cull_backfaces: bool = True, return_drops: bool = False):
    """Corner-major depth raster (shadow maps) → depth f32[H,W] (and n_drop)."""
    b = bin_depth_pos(tri_pos9, tri_active, vp, height, width, tile=tile,
                      k_per_range=k_per_range, big_budget=big_budget,
                      cull_backfaces=cull_backfaces)
    depth = raster_depth(b)
    if return_drops:
        return depth, b.n_drop
    return depth


def rasterize_attributes(clip_pos, tri_active, tri_indices, vert_attrs, height: int,
                         width: int, *, tile: int = 16, k_per_range: int | None = 128,
                         big_budget: int = 128, cull_backfaces: bool = True,
                         corner_major: bool = False, return_drops: bool = False):
    """Attribute raster from clip positions [T,3,4]; ``vert_attrs`` is [V,A]
    indexed by ``tri_indices`` or, with ``corner_major``, [T,3A]."""
    t = clip_pos.shape[0]
    clip2, bary2, act2 = clip_triangles_near(clip_pos, tri_active)
    if corner_major:
        a_dim = vert_attrs.shape[1] // 3
        ca = [torch.cat([vert_attrs[:, c * a_dim:(c + 1) * a_dim]] * 2, dim=0)
              for c in range(3)]
    else:
        a_dim = vert_attrs.shape[1]
        ca = [torch.cat([vert_attrs[tri_indices[:, c]]] * 2, dim=0) for c in range(3)]
    attr_rows = [
        bary2[:, i, 0] * ca[0][:, j] + bary2[:, i, 1] * ca[1][:, j] + bary2[:, i, 2] * ca[2][:, j]
        for i in range(3)
        for j in range(a_dim)
    ]
    geom, act, bbox, near_z = _plane_coefficients(clip2, act2, height, width, cull_backfaces)
    b = _bin_planes(geom, act, bbox, near_z, height, width, tile, k_per_range, big_budget,
                    attr_rows, n_first=t)
    interp, near, _, valid = raster_attributes(b, a_dim)
    if return_drops:
        return interp, near, valid, b.n_drop
    return interp, near, valid


def rasterize_depth(clip_pos, tri_active, height: int, width: int, *, tile: int = 16,
                    k_per_range: int | None = 128, big_budget: int = 128,
                    cull_backfaces: bool = True, return_drops: bool = False):
    """Depth raster from clip positions [T,3,4] → depth f32[H,W] (and n_drop)."""
    t = clip_pos.shape[0]
    clip2, _, act2 = clip_triangles_near(clip_pos, tri_active)
    geom, act, bbox, near_z = _plane_coefficients(clip2, act2, height, width, cull_backfaces)
    b = _bin_planes(geom, act, bbox, near_z, height, width, tile, k_per_range, big_budget,
                    None, n_first=t)
    depth = raster_depth(b)
    if return_drops:
        return depth, b.n_drop
    return depth


def bound_ms(b: Binned, n_attr: int, peak_bytes_per_s=3.35e12, peak_flops=67e12,
             flops_per_eval=14):
    """Least time (ms) an H100 could take for this K1 call on these inputs,
    the larger of two times:
      bytes: every payload row some window (or the big block) references,
        read once, plus the ranges, plus every output pixel written once
        (4 B depth; 8·A + 5 B for interp, near, z and valid);
      operations: one plane evaluation per (in-image pixel, tile candidate) —
        three planes at 2 multiplies + 2 adds and b2 at 2 subtracts, 14 FP32
        operations (compares not counted) — at the FP32 non-tensor rate.
    Returns (ms, "bytes" | "operations")."""
    dev = b.ranges.device
    starts = b.ranges[:, :4].reshape(-1).long()
    counts = b.ranges[:, 4:].reshape(-1).long()
    p = b.payload.shape[0]
    marks = torch.zeros(p + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, starts, (counts > 0).long())
    marks.index_add_(0, torch.clamp(starts + counts, max=p), -(counts > 0).long())
    rows_read = int((torch.cumsum(marks, 0)[:p] > 0).sum()) + int(b.big_have.sum())
    read = rows_read * b.rows * 4 + b.ranges.numel() * 4
    px = b.height * b.width
    written = px * 4 if n_attr == 0 else px * (8 * n_attr + 5)
    tiles = torch.arange(b.th * b.tw, device=dev)
    tile_px = (torch.clamp(b.width - (tiles % b.tw) * b.tile, max=b.tile)
               * torch.clamp(b.height - (tiles // b.tw) * b.tile, max=b.tile))
    cand = b.ranges[:, 4:].long().sum(dim=1) + int(b.big_have.sum())
    evals = int((cand * tile_px).sum())
    t_bytes = (read + written) / peak_bytes_per_s
    t_ops = evals * flops_per_eval / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
