"""P1: the per-tile cost ladder of the tile rasterizer, as a Hopper kernel
(``csrc/probe_floor.cu``) with its plain PyTorch version and entry point.

Port of the reference's TPU probe ``devtools/probe_kernel_floor.py``
(``make(mode)``, one Pallas kernel per mode): over the 8160 tiles of 16 px
that cover 1080p, each mode writes one [256 px, 72] f32 block per tile and
adds one part of K1's per-tile work to the one before it:

  empty   write zeros;
  dma     + copy two windows of 3 payload blocks [3, 72, 128] (block starts
          ``ranges[t, 0:2]``) on chip; write zeros + the first copied float;
  eval    + per pixel the nearest covered candidate over both windows'
          3 × 128 candidates (planes b0, b1, z in rows 0-8, tile-local pixel
          coordinates without +0.5); write [z, index, z × 70 copies];
  cond    + skip block j of window r unless ``ranges[t, 2 + r]`` > 128·j;
  select  + sum, over both windows, the 72-row payload column of the
          winner's window-local index (blocks passing the same test).

Within a block the lowest lane wins a tie; across blocks only a strictly
nearer block replaces the best. A pixel nothing covers keeps z = 3e38 and
index −1, and selects nothing. A window start is clamped to [0, P − 3] so
no window reads past the payload (the reference's interpret mode raises on
such a start; the probe's own starts are inside); the clamp needs no device
read, so a timed launch has no host sync.

``probe_floor`` launches the kernel on CUDA tensors and runs the plain
version on CPU tensors; ``LAUNCHES`` counts launches per mode.
``tie_inputs`` gives the tests planted ties and range edges. Run on the
card: ``python -m impact_tpu_torch.devtools.probe_kernel_floor``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..render.raster_pallas import LaunchCounter
from . import card_line, cuda_time_ms

TILE = 16
H, W = 1080, 1920
TH, TW = -(-H // TILE), -(-W // TILE)
N_TILES = TH * TW
S2 = TILE * TILE
ROWS = 72
NB = 3
LANES = 128
P_BLOCKS = 4100
MODES = ("empty", "dma", "eval", "cond", "select")
# the reference's ranges for every tile: window starts 17 and 910 (in
# payload blocks), 256 candidates in each
REFERENCE_RANGES = (17, 910, 256, 256)
_INF = 3.0e38
_IMAX = 0x7FFFFFFF

LAUNCHES = LaunchCounter({f"p1_floor_{m}": 0 for m in MODES})


def reference_inputs(device, seed: int = 0, n_tiles: int = N_TILES, p_blocks: int = P_BLOCKS):
    """The reference's inputs: (ranges i32[n_tiles, 4], payload f32
    [p_blocks, 72, 128] standard normal from a seeded generator)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    payload = torch.randn((p_blocks, ROWS, LANES), generator=gen, device=device)
    ranges = torch.tensor(REFERENCE_RANGES, dtype=torch.int32, device=device).repeat(n_tiles, 1)
    return ranges, payload


EDGE_COUNTS = (0, 1, 127, 128, 129, 255, 256)


def tie_inputs(device, seed: int = 0, n_tiles: int = 4, p_blocks: int = 16,
               past_end: bool = False):
    """P1 inputs for the tie rules and range edges, drawn with numpy from
    ``seed``: (ranges i32[n_tiles, 4], payload f32[p_blocks, 72, 128]).

    Tile 0 has its windows on blocks 0-2 and 3-5 with 256 candidates each;
    the winners of its plain ``eval`` get twins (plane rows 0-8 copied) at
    lane + 1 of their block and of the next block, so each ties with
    candidates visited after it, in another thread group of the kernel.
    Block 2 lane 126 (window 0, index 382) and block 3 lane 127 (window 1,
    index 127) hold one small triangle at z = 0.001 around pixel (5, 5):
    there the first visited wins, not the smaller index; block 4 lane 5
    covers pixel (0, 0) alone with b0 = z = -0.0 (its c = -0.0). Tile 1 has both
    windows on block 0. The other tiles draw starts and counts (from
    ``EDGE_COUNTS``); with ``past_end`` their first window starts in turn at
    P - 3, P - 1, P + 7 and -5 (clamped to [0, P - 3])."""
    rng = np.random.default_rng(seed)
    payload = rng.standard_normal((p_blocks, ROWS, LANES)).astype(np.float32)
    ranges = np.empty((n_tiles, 4), np.int32)
    ranges[:, :2] = rng.integers(0, p_blocks - NB + 1, (n_tiles, 2))
    ranges[:, 2:] = rng.choice(EDGE_COUNTS, (n_tiles, 2))
    ranges[0] = (0, NB, 256, 256)
    ranges[1:2] = (0, 0, 256, 256)
    if past_end:
        edge = (p_blocks - NB, p_blocks - 1, p_blocks + 7, -5)
        ranges[2:, 0] = [edge[i % 4] for i in range(n_tiles - 2)]
    first = probe_floor_plain("eval", torch.from_numpy(ranges[:1]), torch.from_numpy(payload))
    for i in torch.unique(first[0, :, 1]).long().tolist():
        j, lane = divmod(i, LANES)
        if i < 0 or lane + 1 >= LANES:
            continue
        for r in range(2):
            blk = ranges[0, r] + j
            for twin in (blk, blk + 1):
                if twin < p_blocks:
                    payload[twin, :9, lane + 1] = payload[blk, :9, lane]
    near = (0.25, 0.0, -0.95, 0.0, 0.25, -0.95, 0.0, 0.0, 0.001)  # b0, b1 = 0.3 at (5, 5)
    payload[NB - 1, :9, LANES - 2] = near
    payload[NB, :9, LANES - 1] = near
    payload[NB + 1, :9, 5] = (-0.5, -0.5, -0.0, -1.0, -1.0, 0.5, 0.0, 0.0, -0.0)
    return torch.from_numpy(ranges).to(device), torch.from_numpy(payload).to(device)


def _plane(geo, k, px, py):
    """(a·px + b·py) + c for plane k of blocks geo [nt, 72, 128] at pixels
    px, py [S2] → [nt, S2, 128]."""
    a, b, c = (geo[:, 3 * k + i, None, :] for i in range(3))
    return (a * px[None, :, None] + b * py[None, :, None]) + c


def _chunk_plain(mode, ranges, payload):
    """The plain version for one chunk of tiles → [nt, 256, 72]."""
    nt = ranges.shape[0]
    dev = payload.device
    rng = ranges.long()
    rng[:, :2] = torch.clamp(rng[:, :2], 0, payload.shape[0] - NB)
    if mode == "empty":
        return torch.zeros((nt, S2, ROWS), device=dev)
    if mode == "dma":
        first = payload[rng[:, 0], 0, 0]
        return torch.zeros((nt, S2, ROWS), device=dev) + first[:, None, None]
    pc = torch.arange(S2, device=dev)
    px = (pc % TILE).to(torch.float32)
    py = (pc // TILE).to(torch.float32)
    lane = torch.arange(LANES, device=dev, dtype=torch.int32)
    best_z = torch.full((nt, S2), _INF, device=dev)
    best_i = torch.full((nt, S2), -1, dtype=torch.int32, device=dev)
    gated = mode in ("cond", "select")
    for r in range(2):
        for j in range(NB):
            on = rng[:, 2 + r] > LANES * j if gated else torch.ones(nt, dtype=torch.bool,
                                                                    device=dev)
            geo = payload[rng[:, r] + j]  # [nt, 72, 128]
            b0 = _plane(geo, 0, px, py)
            b1 = _plane(geo, 1, px, py)
            z = _plane(geo, 2, px, py)
            b2 = (1.0 - b0) - b1
            cov = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (z >= 0) & (z <= 1)
            zm = torch.where(cov, z, _INF)
            m = zm.amin(dim=-1)
            bi = torch.where(zm <= m[..., None], j * LANES + lane, _IMAX).amin(dim=-1)
            upd = (m < best_z) & on[:, None]
            best_z = torch.where(upd, m, best_z)
            best_i = torch.where(upd, bi, best_i)
    if mode in ("eval", "cond"):
        out = best_z[..., None].expand(nt, S2, ROWS).clone()
        out[..., 1] = best_i.to(torch.float32)
        return out
    sel = torch.zeros((nt, S2, ROWS), device=dev)
    j = torch.clamp(best_i, min=0).long() // LANES
    lidx = torch.clamp(best_i, min=0).long() % LANES
    for r in range(2):
        on = (best_i >= 0) & (rng[:, 2 + r, None] > LANES * j)
        cols = payload[rng[:, r, None] + j, :, lidx]  # [nt, S2, 72]
        sel = sel + torch.where(on[..., None], cols, 0.0)
    return sel


def probe_floor_plain(mode: str, ranges, payload, tiles_per_chunk: int = 256):
    """Plain PyTorch version of P1 → out f32[n_tiles, 256, 72], in chunks
    of tiles."""
    if mode not in MODES:
        raise ValueError(f"P1 mode must be one of {MODES}, not {mode!r}")
    parts = [_chunk_plain(mode, ranges[s:s + tiles_per_chunk], payload)
             for s in range(0, ranges.shape[0], tiles_per_chunk)]
    return torch.cat(parts)


def _check(ranges, payload):
    if ranges.dtype != torch.int32 or ranges.ndim != 2 or ranges.shape[1] != 4:
        raise ValueError(f"P1 ranges must be int32 [n_tiles, 4], got {ranges.dtype} "
                         f"{tuple(ranges.shape)}")
    if payload.dtype != torch.float32 or payload.shape[1:] != (ROWS, LANES):
        raise ValueError(f"P1 payload must be float32 [P, {ROWS}, {LANES}], got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    if ranges.device != payload.device:
        raise ValueError("P1 ranges and payload on different devices")
    if payload.shape[0] < NB:
        raise ValueError(f"P1 payload must hold a window of {NB} blocks")


def probe_floor(mode: str, ranges, payload):
    """P1 in ``mode``: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors → out f32[n_tiles, 256, 72]."""
    if mode not in MODES:
        raise ValueError(f"P1 mode must be one of {MODES}, not {mode!r}")
    _check(ranges, payload)
    if payload.device.type == "cpu":
        return probe_floor_plain(mode, ranges, payload)
    if payload.device.type != "cuda":
        raise ValueError(f"P1 runs on cuda or cpu tensors, not {payload.device}")
    from .. import _build

    lib = _build.load()
    n_tiles = ranges.shape[0]
    out = torch.empty((n_tiles, S2, ROWS), dtype=torch.float32, device=payload.device)
    ranges, payload = ranges.contiguous(), payload.contiguous()
    rc = lib.p1_probe_floor(MODES.index(mode), ranges.data_ptr(), payload.data_ptr(),
                            payload.shape[0], out.data_ptr(), n_tiles,
                            torch.cuda.current_stream(payload.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"p1_probe_floor ({mode}) launch failed: cudaError {rc}")
    LAUNCHES[f"p1_floor_{mode}"] += 1
    return out


def bound_ms(mode: str, ranges, peak_bytes_per_s=3.35e12, peak_flops=67e12,
             flops_per_eval=14):
    """Least time (ms) an H100 could take for one P1 launch in ``mode`` on
    these ranges, the larger of two times:
      bytes: the output (n_tiles × 256 × 72 × 4 B) written once, plus (from
        dma on) every payload block a window references read once and the
        ranges;
      operations: (from eval on) 14 FP32 operations per (pixel, evaluated
        candidate) — every candidate in eval, those of the blocks that pass
        the count test in cond and select — plus, in select, one add per
        output row of every (pixel, window) whose block passes, at the FP32
        non-tensor rate. A block's skip depends on the ranges only, so this
        counts what these inputs need.
    Returns (ms, "bytes" | "operations")."""
    n_tiles = ranges.shape[0]
    n_bytes = n_tiles * S2 * ROWS * 4
    ops = 0
    if mode != "empty":
        blocks = torch.unique(torch.cat([ranges[:, r].long()[:, None]
                                         + torch.arange(NB, device=ranges.device)
                                         for r in range(2)]))
        n_bytes += blocks.numel() * ROWS * LANES * 4 + ranges.numel() * 4
    if mode in ("eval", "cond", "select"):
        j = torch.arange(NB, device=ranges.device)
        if mode == "eval":
            n_blocks = n_tiles * 2 * NB
        else:
            n_blocks = int((ranges[:, 2:4].long()[:, :, None] > LANES * j).sum())
        ops = n_blocks * LANES * S2 * flops_per_eval
        if mode == "select":
            ops += 2 * n_tiles * S2 * ROWS
    t_bytes = n_bytes / peak_bytes_per_s
    t_ops = ops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def run_ladder(ranges, payload, reps: int = 10, log=print):
    """Every mode on CUDA inputs (``reference_inputs``): one line per mode
    with ms, µs per tile and the bound. Returns {mode: (ms, bound_ms,
    bound_by)}."""
    rows = {}
    for mode in MODES:
        ms = cuda_time_ms(lambda m=mode: probe_floor(m, ranges, payload), reps=reps)
        bnd, by = bound_ms(mode, ranges)
        rows[mode] = (ms, bnd, by)
        log(f"P1 {mode:6s}: {ms:.4f} ms ({ms / ranges.shape[0] * 1e3:.4f} us/tile); bound "
            f"{bnd:.4f} ms ({by})")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_kernel_floor: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    ranges, payload = reference_inputs(torch.device("cuda"), args.seed)
    rows = run_ladder(ranges, payload, log=lambda s: print(s, flush=True))
    print(json.dumps({m: {"ms": v[0], "bound_ms": v[1], "bound_by": v[2]}
                      for m, v in rows.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
