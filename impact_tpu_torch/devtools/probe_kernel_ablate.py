"""P2: the depth-kernel ablation of the tile rasterizer, as a Hopper kernel
(``csrc/probe_ablate.cu``) with its plain PyTorch version and entry point.

Port of the reference's TPU probe ``devtools/probe_kernel_ablate.py``
(``make_variant``/``run_variant``): a depth-only K1 at 512² over 262,144
random triangles, binned by the port's own prologue (``render/
raster_pallas.py``), that writes per pixel the nearest covered z of the
candidates of each tile's first ``windows`` windows (256 candidates from the
window start floored to 128, masked to [start, start + count)), or 1.0. The
big block is not read. Its six variants toggle ``conds`` (skip a block past
the count), ``mxu`` (planes on the tensor cores in TF32), ``dbuf`` (prefetch
the next tile's windows) and ``windows`` (4 or 2); all compute the same
function, the TF32 ones with the plane coefficients rounded to TF32.

The triangles follow the reference's ``main()``: centres uniform in
[-1, 1]³ with z·20 − 25, corner offsets normal × 0.004·(−z), and clip z =
a·z + a·0.1 with w = −z. For every z in [-45, -5] that clip z is negative,
so the near clip drops every triangle and the frame is empty; the port
reproduces the probe as written, and ``flip_clip_z`` gives the frame the
projection meant (ROADMAP Queue 3).

P2 reads a ``Binned`` whose payload is padded (zeros, c0 = −1) so that
every window's 256 candidates lie inside, as the reference pads its
lane-major payload; a window load is clamped to the payload all the same
(no device read, so a timed launch has no host sync). The ``dbuf``
variants take tiles from a counter in device memory that each launch
leaves at zero (``_tile_counter``). ``probe_ablate`` launches the kernel
on CUDA tensors and runs the plain version on CPU tensors; ``LAUNCHES``
counts launches per variant. ``edge_inputs`` gives the tests their range
edges. Run on the card:
``python -m impact_tpu_torch.devtools.probe_kernel_ablate``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..render.raster_pallas import (
    Binned,
    _bin_planes,
    _clip_near_soa,
    _plane_coefficients,
)
from ..utils.launches import LaunchCounter
from . import card_line, cuda_time_ms

T = 262144
S = 512
TILE = 16
K_PER_RANGE = 128
LANES = 128
WINDOW = 2 * LANES  # candidates per window from its floored start
_INF = 3.0e38

# the reference's six variants (probe_kernel_ablate.py:170-183), in its order
VARIANTS = (
    ("conds+mxu+dbuf (current)", dict(conds=True, mxu=True, dbuf=True, windows=4)),
    ("NO conds, mxu, dbuf", dict(conds=False, mxu=True, dbuf=True, windows=4)),
    ("conds, NO mxu, dbuf", dict(conds=True, mxu=False, dbuf=True, windows=4)),
    ("NO conds, NO mxu, dbuf", dict(conds=False, mxu=False, dbuf=True, windows=4)),
    ("conds+mxu NO dbuf", dict(conds=True, mxu=True, dbuf=False, windows=4)),
    ("2 windows (fine only) conds+mxu+dbuf", dict(conds=True, mxu=True, dbuf=True, windows=2)),
)


def variant_key(conds: bool, mxu: bool, dbuf: bool, windows: int) -> str:
    """Launch-counter key of a variant, e.g. ``p2_ablate_conds_mxu_dbuf_w4``."""
    parts = [n for n, on in (("conds", conds), ("mxu", mxu), ("dbuf", dbuf)) if on]
    return "p2_ablate_" + "_".join(parts + [f"w{windows}"])


LAUNCHES = LaunchCounter({variant_key(**kw): 0 for _, kw in VARIANTS})


def probe_clip(centers, normals, size_scale: float = 1.0, flip_clip_z: bool = False):
    """Clip positions [T,3,4] of the reference's triangles from centres
    uniform in [-1, 1]³ [T,3] and standard normal offsets [T,3,3]."""
    z = centers[:, 2] * 20 - 25
    c = torch.stack([centers[:, 0], centers[:, 1], z], dim=-1)
    size = 0.004 * size_scale * (-c[:, 2:3])
    verts = c[:, None, :] + normals * size[:, None]
    f = 1.0 / math.tan(0.5)
    a = 100.0 / (100.0 - 0.1)
    x, y, zz = verts[..., 0], verts[..., 1], verts[..., 2]
    cz = a * zz + a * 0.1
    return torch.stack([f * x, f * y, -cz if flip_clip_z else cz, -zz], dim=-1)


def random_triangles(n: int, generator: torch.Generator):
    """(centres uniform in [-1, 1]³, normal offsets) from ``generator``."""
    dev = generator.device
    centers = torch.rand((n, 3), generator=generator, device=dev) * 2 - 1
    normals = torch.randn((n, 3, 3), generator=generator, device=dev)
    return centers, normals


def bin_probe(clip, height: int = S, width: int = S) -> Binned:
    """The reference's prologue (near clip, then ``_bin(..., tile 16, k 128,
    big 128, no culling)``) through the port's own, with the payload padded
    as the reference pads its lane-major one."""
    t = clip.shape[0]
    act = torch.ones(t, dtype=torch.bool, device=clip.device)
    comps = [[clip[:, i, q] for i in range(3)] for q in range(4)]
    (cx, cy, cz, cw), _, act2 = _clip_near_soa(*comps, act)
    clip2 = torch.stack([torch.stack(q, dim=-1) for q in (cx, cy, cz, cw)], dim=-1)
    geom, act, bbox, near_z = _plane_coefficients(clip2, act2, height, width, False)
    b = _bin_planes(geom, act, bbox, near_z, height, width, TILE, K_PER_RANGE, 128, None,
                    n_first=t)
    p = b.payload.shape[0]
    p_pad = -(-(p + WINDOW) // LANES) * LANES
    pad = torch.zeros((p_pad - p, b.rows), dtype=torch.float32, device=clip.device)
    pad[:, 2] = -1.0
    b.payload = torch.cat([b.payload, pad]).contiguous()
    return b


def tf32_round(x):
    """x rounded to TF32 (10-bit mantissa, to nearest, ties away from zero:
    ``cvt.rna.tf32.f32``), as float32."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def probe_ablate_plain(inp: Binned, *, conds: bool, mxu: bool, dbuf: bool, windows: int,
                       tiles_per_chunk: int = 64):
    """Plain PyTorch version of one P2 variant → f32[n_tiles, 1, 256]. The
    flags ``conds`` and ``dbuf`` change how the kernel works, not what it
    computes; ``mxu`` rounds the plane coefficients to TF32."""
    del conds, dbuf
    dev = inp.payload.device
    rows = inp.payload[:, :9]
    if mxu:
        rows = tf32_round(rows)
    pc = torch.arange(TILE * TILE, device=dev)
    ar = torch.arange(WINDOW, device=dev)
    n_tiles = inp.ranges.shape[0]
    outs = []
    for s0 in range(0, n_tiles, tiles_per_chunk):
        tiles = torch.arange(s0, min(s0 + tiles_per_chunk, n_tiles), device=dev)
        rng = inp.ranges[tiles].long()
        s, cnt = rng[:, :windows], rng[:, 4:4 + windows]
        a = s - s % LANES
        idx = a[:, :, None] + ar  # [nt, W, 256] candidate positions
        have = ((idx >= s[..., None]) & (idx < (s + cnt)[..., None])).flatten(1)
        load = torch.clamp(a, 0, rows.shape[0] - WINDOW)[:, :, None] + ar
        g = rows[load.flatten(1)][:, None]  # [nt, 1, C, 9]
        x0 = ((tiles % inp.tw) * TILE).to(torch.float32)
        y0 = ((tiles // inp.tw) * TILE).to(torch.float32)
        px = ((x0[:, None] + (pc % TILE).to(torch.float32)) + 0.5)[..., None]  # [nt, 256, 1]
        py = ((y0[:, None] + (pc // TILE).to(torch.float32)) + 0.5)[..., None]
        b0 = (g[..., 0] * px + g[..., 1] * py) + g[..., 2]
        b1 = (g[..., 3] * px + g[..., 4] * py) + g[..., 5]
        z = (g[..., 6] * px + g[..., 7] * py) + g[..., 8]
        b2 = (1.0 - b0) - b1
        m = torch.minimum(b0, torch.minimum(b1, b2))
        cov = (m >= 0) & (z >= 0) & (z <= 1) & have[:, None, :]
        best = torch.where(cov, z, _INF).amin(dim=-1)
        outs.append(torch.where(best >= _INF, 1.0, best)[:, None, :])
    return torch.cat(outs)


def _check(inp: Binned):
    r, p = inp.ranges, inp.payload
    if (r.dtype != torch.int32 or r.shape != (inp.th * inp.tw, 8) or not r.is_contiguous()
            or inp.tile != TILE):
        raise ValueError(f"P2 takes int32 ranges [n_tiles, 8] of {TILE} px tiles, got "
                         f"{r.dtype} {tuple(r.shape)}, tile {inp.tile}")
    if p.dtype != torch.float32 or p.ndim != 2 or p.shape[1] != 12 or not p.is_contiguous():
        raise ValueError(f"P2 payload must be contiguous float32 [P, 12], got {p.dtype} "
                         f"{tuple(p.shape)}")
    if p.shape[0] < WINDOW:
        raise ValueError(f"P2 payload must hold a window of {WINDOW} candidates")
    if r.device != p.device:
        raise ValueError("P2 ranges and payload on different devices")


_COUNTERS = {}


def _tile_counter(dev):
    """The ``dbuf`` variants' tile counter on ``dev`` (a tensor's device):
    int32[2], zeroed once; each launch takes its tiles from it and its last
    block sets it back to zero, so launches on one device must not overlap
    (one stream)."""
    counter = _COUNTERS.get(dev)
    if counter is None:
        counter = _COUNTERS[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return counter


def probe_ablate(inp: Binned, *, conds: bool, mxu: bool, dbuf: bool, windows: int):
    """One P2 variant: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors → f32[n_tiles, 1, 256]."""
    _check(inp)
    kw = dict(conds=conds, mxu=mxu, dbuf=dbuf, windows=windows)
    key = variant_key(**kw)
    if key not in LAUNCHES:
        raise ValueError(f"P2 runs the reference's six variants, not {kw}")
    dev = inp.payload.device
    if dev.type == "cpu":
        return probe_ablate_plain(inp, **kw)
    if dev.type != "cuda":
        raise ValueError(f"P2 runs on cuda or cpu tensors, not {dev}")
    from .. import _build

    lib = _build.load()
    n_tiles = inp.ranges.shape[0]
    out = torch.empty((n_tiles, 1, TILE * TILE), dtype=torch.float32, device=dev)
    counter = _tile_counter(dev).data_ptr() if dbuf else None
    rc = lib.p2_probe_ablate(int(conds), int(mxu), int(dbuf), windows, inp.ranges.data_ptr(),
                             inp.payload.data_ptr(), inp.payload.shape[0], out.data_ptr(),
                             n_tiles, inp.tw, counter,
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"p2_probe_ablate ({key}) launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    return out


def bound_ms(inp: Binned, windows: int, mxu: bool, peak_bytes_per_s=3.35e12,
             peak_flops=67e12, peak_tf32=495e12, flops_per_eval=14, plane_flops=12):
    """Least time (ms) an H100 could take for one P2 launch on these inputs,
    the larger of two times:
      bytes: the 9 plane floats of every candidate the first ``windows``
        windows hold, read once, + the ranges + 4 B per output pixel;
      operations: 14 per (pixel, window candidate) — counted from the
        windows' counts, what these inputs need — at the FP32 non-tensor
        rate, or with ``mxu`` the 12 of the three planes at the TF32 tensor
        rate and b2's 2 at the FP32 rate.
    Returns (ms, "bytes" | "operations")."""
    r = inp.ranges.long()
    starts = r[:, :windows].reshape(-1)
    counts = r[:, 4:4 + windows].reshape(-1)
    p = inp.payload.shape[0]
    marks = torch.zeros(p + 1, dtype=torch.int64, device=r.device)
    marks.index_add_(0, starts, (counts > 0).long())
    marks.index_add_(0, torch.clamp(starts + counts, max=p), -(counts > 0).long())
    cand_read = int((torch.cumsum(marks, 0)[:p] > 0).sum())
    n_px = inp.ranges.shape[0] * TILE * TILE
    n_bytes = cand_read * 9 * 4 + inp.ranges.numel() * 4 + n_px * 4
    t_ops = _evals_s(int(counts.sum()) * TILE * TILE, mxu, peak_flops, peak_tf32,
                     flops_per_eval, plane_flops)
    t_bytes = n_bytes / peak_bytes_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _evals_s(evals, mxu, peak_flops, peak_tf32, flops_per_eval, plane_flops):
    """Seconds of ``evals`` plane evaluations at the FP32 rate, or with
    ``mxu`` the plane operations at the TF32 tensor rate and b2's at FP32."""
    if mxu:
        return (evals * plane_flops / peak_tf32
                + evals * (flops_per_eval - plane_flops) / peak_flops)
    return evals * flops_per_eval / peak_flops


def dense_bound_ms(inp: Binned, windows: int, mxu: bool = False, peak_flops=67e12,
                   peak_tf32=495e12, flops_per_eval=14, plane_flops=12):
    """The operation bound of evaluating every candidate slot of every
    window (256 × ``windows`` per pixel), whatever the counts: what the
    variants without ``conds`` evaluate, at ``bound_ms``'s rates (with
    ``mxu`` the TF32 split)."""
    evals = inp.ranges.shape[0] * TILE * TILE * windows * WINDOW
    return _evals_s(evals, mxu, peak_flops, peak_tf32, flops_per_eval, plane_flops) * 1e3


def reference_inputs(device, seed: int = 0, flip_clip_z: bool = False, n: int = T,
                     size: int = S, size_scale: float = 1.0) -> Binned:
    """The reference's input at full size, drawn on ``device`` from ``seed``
    (``size_scale`` scales the triangles)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centers, normals = random_triangles(n, gen)
    clip = probe_clip(centers, normals, size_scale=size_scale, flip_clip_z=flip_clip_z)
    return bin_probe(clip, size, size)


def edge_inputs(device, seed: int = 0, height: int = 256, width: int = 272, n: int = 65536,
                size_scale: float = 8.0) -> Binned:
    """P2 inputs for the range edges, drawn on ``device`` from ``seed``: the
    probe's triangles with clip z negated at ``height`` × ``width`` (272
    tiles at the defaults, which no persistent grid of 132·k blocks
    divides), then every third tile's windows emptied (count 0, beside
    crowded tiles) and every second window's start moved 1-5 candidates
    down, its count grown to match as far as its 256 slots reach, so that
    starts and counts sit off the 128 boundary. The first candidate of the
    first window with one is a signed-zero triangle: b0 = z = -0.0 over its
    tiles (a, b and c all -0.0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centers, normals = random_triangles(n, gen)
    inp = bin_probe(probe_clip(centers, normals, size_scale=size_scale, flip_clip_z=True),
                    height, width)
    r = inp.ranges.long()
    s, c = r[:, :4], r[:, 4:]
    n_tiles = r.shape[0]
    shift = (torch.arange(4 * n_tiles, device=device).view(n_tiles, 4) % 5 + 1) * (
        torch.arange(4, device=device) % 2 == 0)
    s2 = torch.clamp(s - shift, min=0)
    c2 = torch.minimum(c + (s - s2), WINDOW - s2 % LANES)
    c2[torch.arange(n_tiles, device=device) % 3 == 0] = 0
    inp.ranges = torch.cat([s2, c2], dim=1).to(torch.int32).contiguous()
    first = int(s2[c2 > 0][0])
    inp.payload[first, :9] = torch.tensor([-0.0, -0.0, -0.0, 0.0, 0.0, 0.5, -0.0, -0.0, -0.0])
    return inp


def run_ablation(inp: Binned, reps: int = 20, log=print, tag: str = ""):
    """Every variant on ``inp`` (CUDA): one line each with ms, bound and the
    covered share of pixels. Returns {name: dict(ms, bound_ms, bound_by,
    covered)}."""
    rows = {}
    for name, kw in VARIANTS:
        out = probe_ablate(inp, **kw)
        covered = (out < 1.0).float().mean().item()
        ms = cuda_time_ms(lambda kw=kw: probe_ablate(inp, **kw), reps=reps)
        bnd, by = bound_ms(inp, kw["windows"], kw["mxu"])
        dense = dense_bound_ms(inp, kw["windows"], kw["mxu"])
        rows[name] = dict(ms=ms, bound_ms=bnd, bound_by=by, covered=covered,
                          dense_bound_ms=dense)
        log(f"P2{tag} {name:38s}: {ms:.4f} ms; bound {bnd:.6f} ms ({by}), all-slot bound "
            f"{dense:.4f} ms; covered {covered:.4f} of pixels")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flip-clip-z", action="store_true",
                    help="negate clip z (the projection the probe meant): a non-empty frame")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_kernel_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    inp = reference_inputs(torch.device("cuda"), args.seed, args.flip_clip_z)
    print(f"{T} triangles at {S}x{S}: {int(inp.ranges[:, 4:].sum())} window candidates",
          flush=True)
    rows = run_ablation(inp, log=lambda s: print(s, flush=True))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
