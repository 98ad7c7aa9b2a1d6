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
