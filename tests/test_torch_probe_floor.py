"""P1's plain version against the reference's TPU probe on the CPU.

``devtools/probe_kernel_floor.py`` runs its TPU ladder when it is imported,
so its ``make`` and constants are loaded through ``ast`` without the
module-level statements that build inputs and run the ladder, its sizes are
cut to 2×2 tiles, and the Pallas kernel runs in TPU interpret mode. Both
packages get the same numpy payload. Bars: best index equal on at least
0.99 of the pixels, z within the repo's raster atol of 2e-3 where the
indices agree; select rows within 1e-5; empty and dma exactly equal."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from impact_tpu_torch.devtools import probe_kernel_floor as p1

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_TILES = 4
P_BLOCKS = 920


def load_reference():
    """``make`` and the constants of the reference probe, with the ladder
    (the module-level ``key``/``payload``/``ranges`` assignments and the
    ``for`` loop) left out and the grid cut to ``N_TILES`` tiles."""
    src = (ROOT / "devtools" / "probe_kernel_floor.py").read_text()
    tree = ast.parse(src)
    skip = {"key", "payload", "ranges"}
    body = [n for n in tree.body
            if not isinstance(n, ast.For)
            and not (isinstance(n, ast.Assign)
                     and any(isinstance(t, ast.Name) and t.id in skip for t in n.targets))]
    ns = {"__name__": "probe_kernel_floor_reference"}
    exec(compile(ast.Module(body=body, type_ignores=[]), "probe_kernel_floor", "exec"), ns)
    ns.update(H=2 * ns["TILE"], W=2 * ns["TILE"], TH=2, TW=2, N_TILES=N_TILES)
    return ns


@pytest.fixture(scope="module")
def reference():
    return load_reference()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    payload = rng.normal(size=(P_BLOCKS, p1.ROWS, p1.LANES)).astype(np.float32)
    # the reference's ranges on three tiles, other counts on the fourth so
    # the count test skips blocks
    ranges = np.tile(np.array(p1.REFERENCE_RANGES, np.int32), (N_TILES, 1))
    ranges[3] = [5, 400, 130, 100]
    return ranges, payload


def run_reference(ns, mode, ranges, payload):
    with pltpu.force_tpu_interpret_mode():
        out = ns["make"](mode)(jnp.asarray(ranges.reshape(-1)), jnp.asarray(payload))
        return np.asarray(jax.block_until_ready(out))


@pytest.mark.parametrize("mode", p1.MODES)
def test_plain_matches_reference(reference, inputs, mode):
    ranges, payload = inputs
    ref = run_reference(reference, mode, ranges, payload)
    got = p1.probe_floor(mode, torch.from_numpy(ranges), torch.from_numpy(payload)).numpy()
    assert got.shape == ref.shape == (N_TILES, p1.S2, p1.ROWS)
    if mode in ("empty", "dma"):
        np.testing.assert_array_equal(got, ref)
        return
    if mode == "select":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        assert np.abs(got).sum() > 0
        return
    same = got[..., 1] == ref[..., 1]
    assert same.mean() >= 0.99
    covered = got[..., 1] >= 0
    assert covered.sum() >= 50  # standard normal planes cover the pixels near (0, 0)
    np.testing.assert_allclose(got[..., 0][same], ref[..., 0][same], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(got[..., 2:], np.repeat(got[..., :1], p1.ROWS - 2, axis=-1))


def test_cond_skips_blocks_past_the_count(inputs):
    """With 256 candidates a window's block 2 is skipped, so cond never picks
    an index of 256 and up where eval does; cond's z is never nearer."""
    ranges, payload = inputs
    r, p = torch.from_numpy(ranges), torch.from_numpy(payload)
    cond = p1.probe_floor("cond", r, p)
    ev = p1.probe_floor("eval", r, p)
    assert int(cond[..., 1].max()) < 256 <= int(ev[..., 1].max())
    assert bool((cond[..., 0] >= ev[..., 0]).all())


def test_bounds():
    ranges = torch.tensor(p1.REFERENCE_RANGES, dtype=torch.int32).repeat(p1.N_TILES, 1)
    ms, by = p1.bound_ms("empty", ranges)
    assert by == "bytes" and abs(ms - p1.N_TILES * 256 * 72 * 4 / 3.35e12 * 1e3) < 1e-9
    ms_e, by_e = p1.bound_ms("eval", ranges)
    assert by_e == "operations" and abs(ms_e - 2088960 * 768 * 14 / 67e12 * 1e3) < 1e-9
    ms_c, by_c = p1.bound_ms("cond", ranges)
    assert by_c == "operations" and abs(ms_c - 2088960 * 512 * 14 / 67e12 * 1e3) < 1e-9


def test_wrapper_checks_inputs(inputs):
    ranges, payload = inputs
    r, p = torch.from_numpy(ranges), torch.from_numpy(payload)
    with pytest.raises(ValueError):
        p1.probe_floor("nope", r, p)
    with pytest.raises(ValueError):
        p1.probe_floor("eval", r.long(), p)
    with pytest.raises(ValueError):
        p1.probe_floor("eval", r, p[:2])  # not even one window


def test_window_start_past_the_payload_is_clamped(inputs):
    """A window that would run past the payload reads its last 3 blocks."""
    ranges, payload = inputs
    r, p = torch.from_numpy(ranges), torch.from_numpy(payload[:912])
    shifted = r.clone()
    shifted[:3, 1] = 909
    for mode in ("dma", "select"):
        assert torch.equal(p1.probe_floor(mode, r, p), p1.probe_floor(mode, shifted, p))


ABOVE_ONE = np.float32(1.00000012)
NO_POS = 0x7FFFFFFF


def covers(b0, b1, b2):
    """The kernels' coverage test: no sign bit set in b0 | b1 | b2."""
    return (b0.view(np.int32) | b1.view(np.int32) | b2.view(np.int32)) >= 0


def emulate_kernel(mode, ranges, payload, order="pos"):
    """numpy emulation of ``csrc/probe_floor.cu``'s evaluating modes: the
    evaluated blocks staged candidate-major with their visit positions (each
    plane's c as c + 0), the coverage and nearer tests on the bits, 16
    thread groups taking every 16th candidate (a thread keeps the first
    strictly nearer one), the group pairs of a warp merged, then the 8 warps,
    by (z, visit position), or by (z, index) with ``order="index"``."""
    nt, p_blocks = ranges.shape[0], payload.shape[0]
    start = np.clip(ranges[:, :2], 0, p_blocks - p1.NB)
    cnt = ranges[:, 2:]
    f32 = np.float32
    pc = np.arange(p1.S2)
    px, py = (pc % p1.TILE).astype(f32), (pc // p1.TILE).astype(f32)
    out = np.zeros((nt, p1.S2, p1.ROWS), f32)
    for t in range(nt):
        visit = [v for v in range(2 * p1.NB)
                 if mode == "eval" or cnt[t, v // p1.NB] > p1.LANES * (v % p1.NB)]
        geo = np.concatenate([payload[start[t, v // p1.NB] + v % p1.NB, :9].T for v in visit]
                             or [np.zeros((0, 9), f32)])
        geo[:, 2::3] += f32(0)  # each plane's c staged as c + 0: -0.0 becomes +0.0
        pos = np.concatenate([v * p1.LANES + np.arange(p1.LANES) for v in visit] or [[]])
        parts = []
        for g in range(16):
            m = np.full(p1.S2, ABOVE_ONE)
            mp = np.full(p1.S2, NO_POS)
            for c in range(g, len(geo), 16):
                a = geo[c]
                b0 = (a[0] * px + a[1] * py) + a[2]
                b1 = (a[3] * px + a[4] * py) + a[5]
                z = (a[6] * px + a[7] * py) + a[8]
                b2 = (f32(1) - b0) - b1
                take = covers(b0, b1, b2) & (z.view(np.uint32) < m.view(np.uint32))
                m = np.where(take, z, m)
                mp = np.where(take, pos[c], mp)
            parts.append((m, mp))

        def key(p):
            return p % (p1.NB * p1.LANES) if order == "index" else p

        def merge(a, b):
            (za, pa), (zb, pb) = a, b
            take = (zb < za) | ((zb == za) & (key(pb) < key(pa)))
            return np.where(take, zb, za), np.where(take, pb, pa)

        warps = [merge(parts[2 * w], parts[2 * w + 1]) for w in range(8)]
        bz, bp = warps[0]
        for w in warps[1:]:
            bz, bp = merge((bz, bp), w)
        hit = bz <= 1
        win_i = np.where(hit, bp % (p1.NB * p1.LANES), -1)
        if mode != "select":
            out[t] = np.where(hit, bz, f32(3e38))[:, None]
            out[t, :, 1] = win_i
            continue
        for p in np.nonzero(win_i >= 0)[0]:
            j, lane = divmod(int(win_i[p]), p1.LANES)
            for r in range(2):
                if cnt[t, r] > p1.LANES * j:
                    out[t, p] = out[t, p] + payload[start[t, r] + j, :, lane]
    return out


def tied_pixels(mode, ranges, payload):
    """[n_tiles, 256]: pixels whose nearest covered z is reached by two or
    more of the candidates the mode evaluates."""
    rng = ranges.long().clone()
    rng[:, :2] = rng[:, :2].clamp(0, payload.shape[0] - p1.NB)
    pc = torch.arange(p1.S2)
    px, py = (pc % p1.TILE).float(), (pc // p1.TILE).float()
    zs = []
    for r in range(2):
        for j in range(p1.NB):
            geo = payload[rng[:, r] + j]
            b0, b1, z = (p1._plane(geo, k, px, py) for k in range(3))
            b2 = (1.0 - b0) - b1
            cov = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (z >= 0) & (z <= 1)
            if mode != "eval":
                cov &= (rng[:, 2 + r] > p1.LANES * j)[:, None, None]
            zs.append(torch.where(cov, z, 3e38))
    zm = torch.cat(zs, dim=-1)
    m = zm.amin(dim=-1, keepdim=True)
    return ((zm == m).sum(dim=-1) >= 2) & (m[..., 0] <= 1)


@pytest.mark.parametrize("mode", ("eval", "cond", "select"))
def test_plain_matches_reference_on_planted_ties(reference, mode):
    """Twins evaluate to the same bits in both packages, so where a twin ties
    for the nearest the tie rules alone pick the winner: the same index, and
    the same selected column."""
    ranges, payload = p1.tie_inputs("cpu", seed=1, n_tiles=N_TILES)
    tied = tied_pixels(mode, ranges, payload).numpy()
    assert tied.sum() >= 10 and tied[1].sum() >= 5  # tile 1: both windows on block 0
    ref = run_reference(reference, mode, ranges.numpy(), payload.numpy())
    got = p1.probe_floor(mode, ranges, payload).numpy()
    if mode == "select":
        close = np.abs(got - ref).max(axis=-1) <= 1e-5
        assert close.mean() >= 0.99 and close[tied].all()
        return
    same = got[..., 1] == ref[..., 1]
    assert same.mean() >= 0.99 and same[tied].all()
    np.testing.assert_allclose(got[..., 0][same], ref[..., 0][same], atol=2e-3, rtol=0)


@pytest.mark.parametrize("past_end", [False, True], ids=["in_range", "past_end"])
@pytest.mark.parametrize("mode", ("eval", "cond", "select"))
def test_kernel_split_and_merge_match_plain(mode, past_end):
    """The kernel's split of a tile's candidates over 16 thread groups and
    its (z, visit position) merge equal the plain version bit for bit on
    planted ties, counts 0-256 off and on the 128 boundary, and window
    starts at, past and below the payload's ends."""
    ranges, payload = p1.tie_inputs("cpu", seed=2, n_tiles=14, past_end=past_end)
    assert tied_pixels(mode, ranges, payload).sum() >= 10
    got = emulate_kernel(mode, ranges.numpy(), payload.numpy())
    np.testing.assert_array_equal(got, p1.probe_floor_plain(mode, ranges, payload).numpy())


def test_merge_by_index_would_break_the_tie_rule():
    """A merge by (z, index) picks window 1's twin of the small triangle in
    window 0's block 2 (a smaller index, visited later): the planted ties
    tell the two orders apart."""
    ranges, payload = p1.tie_inputs("cpu", seed=2, n_tiles=14)
    got = emulate_kernel("eval", ranges.numpy(), payload.numpy(), order="index")
    ref = p1.probe_floor_plain("eval", ranges, payload).numpy()
    assert (got[..., 1] != ref[..., 1]).any()
