"""P2's plain version against the reference's TPU probe on the CPU.

Both packages get the same numpy triangles (drawn as the reference's
``main()`` draws them, 60× larger so they cover pixels at 64²), clip and bin
them with their own prologues, and run each of the six variants; the
reference's ``run_variant`` runs in TPU interpret mode. The probe as written
projects every triangle behind the near plane (an empty frame); the cases
with clip z negated compare a frame that is 94 % covered. Bars (the repo's
raster bars, tests/test_raster_pallas.py): coverage equal on at least 0.99
of the pixels, z within 2e-3 where both cover. The TF32 variants are held to
the reference run on the payload rounded to TF32, the precision their plane
products take on the tensor cores; the reference's own dot on the CPU is
float32."""

import copy
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from impact_tpu.render import raster_pallas as jrp
from impact_tpu.render.raster import clip_triangles_near
from impact_tpu_torch.devtools import probe_kernel_ablate as p2

ROOT = pathlib.Path(__file__).resolve().parents[1]
S, T, SCALE = 64, 512, 60.0


def load_reference():
    spec = importlib.util.spec_from_file_location(
        "probe_kernel_ablate_reference", ROOT / "devtools" / "probe_kernel_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # main() is guarded: nothing runs
    return mod


@pytest.fixture(scope="module")
def reference():
    return load_reference()


@pytest.fixture(scope="module")
def triangles():
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, (T, 3)).astype(np.float32),
            rng.normal(size=(T, 3, 3)).astype(np.float32))


def jax_inputs(centers, normals, flip):
    """The reference's main() prologue on the given draws."""
    c = jnp.asarray(centers)
    c = c.at[:, 2].set(c[:, 2] * 20 - 25)
    size = 0.004 * SCALE * (-c[:, 2:3])
    verts = c[:, None, :] + jnp.asarray(normals) * size[:, None]
    f = 1.0 / np.tan(0.5)
    a = 100.0 / (100.0 - 0.1)
    x, y, z = verts[..., 0], verts[..., 1], verts[..., 2]
    cz = a * z + a * 0.1
    clip = jnp.stack([f * x, f * y, -cz if flip else cz, -z], axis=-1)
    clip2, _, act2 = clip_triangles_near(clip, jnp.ones((T,), bool))
    pro = jrp._bin(clip2, act2, S, S, 16, 128, 128, False, None, T)
    return clip, pro[0], pro[1], pro[2], pro[3]


def tf32(x):
    u = np.array(x, np.float32)
    b = u.view(np.int32)
    b[:] = (b + 0x1000) & -0x2000
    return u


@pytest.mark.parametrize("flip", [False, True], ids=["as_written", "clip_z_negated"])
@pytest.mark.parametrize("name,kw", p2.VARIANTS, ids=[n for n, _ in p2.VARIANTS])
def test_plain_matches_reference(reference, triangles, flip, name, kw):
    centers, normals = triangles
    clip, ranges, payload, big_rows, big_mask = jax_inputs(centers, normals, flip)
    clip_t = p2.probe_clip(torch.from_numpy(centers), torch.from_numpy(normals), SCALE, flip)
    np.testing.assert_array_equal(clip_t.numpy(), np.asarray(clip))
    inp = p2.bin_probe(clip_t, S, S)
    np.testing.assert_array_equal(inp.ranges.numpy(), np.asarray(ranges).reshape(-1, 8))
    if kw["mxu"]:
        payload = jnp.asarray(tf32(payload))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(reference.run_variant(ranges, payload, big_rows, big_mask,
                                               S // 16, S // 16, **kw))
    got = p2.probe_ablate(inp, **kw).numpy()
    assert got.shape == ref.shape == (16, 1, 256)
    assert np.mean((got < 1.0) == (ref < 1.0)) >= 0.99
    both = (got < 1.0) & (ref < 1.0)
    np.testing.assert_allclose(got[both], ref[both], atol=2e-3, rtol=0)
    if flip:
        assert both.mean() > (0.5 if kw["windows"] == 4 else 0.3)
    else:
        assert (got == 1.0).all() and (ref == 1.0).all()


def test_probe_as_written_is_an_empty_frame(reference, triangles):
    """Reference fault, reproduced: clip z = a·z + a·0.1 with w = −z is
    negative for every z in [-45, -5], so the near clip drops every triangle,
    every window is empty and every variant writes 1.0. The probe also never
    reads its big block: garbage there changes nothing."""
    centers, normals = triangles
    clip, ranges, payload, big_rows, big_mask = jax_inputs(centers, normals, False)
    assert float(clip[..., 2].max()) < 0
    assert int(np.asarray(ranges).reshape(-1, 8)[:, 4:].sum()) == 0
    inp = p2.bin_probe(p2.probe_clip(torch.from_numpy(centers), torch.from_numpy(normals),
                                     SCALE), S, S)
    assert int(inp.ranges[:, 4:].sum()) == 0
    _, ranges_f, payload_f, big_f, mask_f = jax_inputs(centers, normals, True)
    kw = dict(conds=True, mxu=False, dbuf=True, windows=4)
    with pltpu.force_tpu_interpret_mode():
        a = np.asarray(reference.run_variant(ranges_f, payload_f, big_f, mask_f, 4, 4, **kw))
        b = np.asarray(reference.run_variant(ranges_f, payload_f, jnp.full_like(big_f, 0.25),
                                             jnp.ones_like(mask_f), 4, 4, **kw))
    np.testing.assert_array_equal(a, b)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 3.0e-3])
    got = p2.tf32_round(x)
    # ties go away from zero; the low 13 mantissa bits are cleared
    assert got[:5].tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0]
    assert int(got[5:].view(torch.int32)) & 0x1FFF == 0
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2 ** -11


def test_bounds_count_what_the_windows_hold(triangles):
    centers, normals = triangles
    inp = p2.bin_probe(p2.probe_clip(torch.from_numpy(centers), torch.from_numpy(normals),
                                     SCALE, True), S, S)
    n4 = int(inp.ranges[:, 4:].sum())
    ms, by = p2.bound_ms(inp, 4, mxu=False)
    assert by == "operations" and abs(ms - n4 * 256 * 14 / 67e12 * 1e3) < 1e-12
    ms_t, _ = p2.bound_ms(inp, 4, mxu=True)
    assert ms_t < ms
    empty = p2.bin_probe(p2.probe_clip(torch.from_numpy(centers), torch.from_numpy(normals),
                                       SCALE), S, S)
    ms_e, by_e = p2.bound_ms(empty, 4, mxu=False)
    assert by_e == "bytes" and abs(ms_e - (16 * 8 * 4 + 16 * 256 * 4) / 3.35e12 * 1e3) < 1e-15
    assert abs(p2.dense_bound_ms(empty, 4) - 16 * 256 * 1024 * 14 / 67e12 * 1e3) < 1e-12


def test_wrapper_checks_inputs(triangles):
    centers, normals = triangles
    inp = p2.bin_probe(p2.probe_clip(torch.from_numpy(centers), torch.from_numpy(normals),
                                     SCALE, True), S, S)
    with pytest.raises(ValueError, match="six variants"):
        p2.probe_ablate(inp, conds=False, mxu=False, dbuf=False, windows=4)
    with pytest.raises(ValueError):
        p2.probe_ablate(inp, conds=True, mxu=True, dbuf=True, windows=3)
    short = copy.copy(inp)
    short.payload = inp.payload[:8].contiguous()
    with pytest.raises(ValueError, match="window"):
        p2.probe_ablate(short, conds=True, mxu=True, dbuf=True, windows=4)


ABOVE_ONE = np.float32(1.00000012)
DEAD = np.array([0, 0, 0, 0, 0, 0, 0, 0, -1], np.float32)  # the z plane of a masked slot


def emulate_kernel(inp, *, conds, mxu, windows, groups=16):
    """numpy emulation of ``csrc/probe_ablate.cu``'s tiles: the blocks the
    variant evaluates staged (with ``conds`` only those whose first slot is
    inside the count; each plane's c as c + 0), a slot outside [s, s + c)
    given a z plane of -1, a depth key of z's bits with the sign bits of b0,
    b1 and b2 OR'd in, the
    slots split over ``groups`` thread groups (every ``groups``-th slot),
    each keeping the least key from the float after 1.0, and the groups met
    in a z-min. The tensor cores' sums are not emulated: with
    ``mxu`` the TF32 coefficients are summed in float32, as the plain
    version sums them."""
    ranges, payload = inp.ranges.numpy(), inp.payload.numpy()[:, :9]
    if mxu:
        payload = p2.tf32_round(torch.from_numpy(payload)).numpy()
    f32 = np.float32
    pc = np.arange(256)
    out = np.empty((ranges.shape[0], 1, 256), f32)
    for t in range(ranges.shape[0]):
        slots = []
        for r in range(windows):
            s, c = int(ranges[t, r]), int(ranges[t, 4 + r])
            a = s - s % 128
            load = min(max(a, 0), payload.shape[0] - 256)
            for j in range(2):
                if conds and not a + 128 * j < s + c:
                    continue
                idx = a + 128 * j + np.arange(128)
                rows = payload[load + 128 * j:load + 128 * j + 128]
                rows = rows.copy()
                rows[:, 2::3] += f32(0)  # each plane's c staged as c + 0: -0.0 becomes +0.0
                slots.append(np.where(((idx >= s) & (idx < s + c))[:, None], rows, DEAD))
        px = (f32((t % inp.tw) * 16) + (pc % 16).astype(f32)) + f32(0.5)
        py = (f32((t // inp.tw) * 16) + (pc // 16).astype(f32)) + f32(0.5)
        best = np.full(256, ABOVE_ONE)
        geo = np.concatenate(slots) if slots else np.zeros((0, 9), f32)
        for g in range(groups):
            m = np.full(256, ABOVE_ONE)
            for a in geo[g::groups]:
                b0 = (a[0] * px + a[1] * py) + a[2]
                b1 = (a[3] * px + a[4] * py) + a[5]
                z = (a[6] * px + a[7] * py) + a[8]
                b2 = (f32(1) - b0) - b1
                sign = (b0.view(np.uint32) | b1.view(np.uint32) | b2.view(np.uint32)) & 0x80000000
                m = np.minimum(m.view(np.uint32), sign | z.view(np.uint32)).view(f32)
            best = np.minimum(best, m)
        out[t, 0] = np.minimum(best, f32(1))
    return out


@pytest.mark.parametrize("name,kw", p2.VARIANTS, ids=[n for n, _ in p2.VARIANTS])
def test_kernel_split_and_masks_match_plain(name, kw):
    """The kernel's staging (blocks skipped by ``conds``, masked slots as a z
    plane of -1) and its split over 16 thread groups equal the plain version
    bit for bit on empty tiles beside crowded ones and on starts and counts
    off the 128 boundary."""
    inp = p2.edge_inputs("cpu", seed=3, height=64, width=80, n=T, size_scale=SCALE)
    r = inp.ranges
    assert bool((r[:, 4:] == 0).all(dim=1).any()) and bool((r[:, :4] % 128 != 0).any())
    ref = p2.probe_ablate_plain(inp, **kw).numpy()
    assert 0.2 < (ref < 1.0).mean() < 0.9
    np.testing.assert_array_equal(emulate_kernel(inp, **{k: kw[k] for k in ("conds", "mxu",
                                                                             "windows")}), ref)


def test_dense_bound_counts_mxu_at_the_tf32_split(triangles):
    """The all-slot bound of the TF32 variants takes ``bound_ms``'s split:
    12 plane operations at the tensor rate, b2's 2 at the FP32 rate."""
    centers, normals = triangles
    inp = p2.bin_probe(p2.probe_clip(torch.from_numpy(centers), torch.from_numpy(normals),
                                     SCALE), S, S)
    evals = 16 * 256 * 4 * 256
    want = (evals * 12 / 495e12 + evals * 2 / 67e12) * 1e3
    assert abs(p2.dense_bound_ms(inp, 4, mxu=True) - want) < 1e-15
    assert abs(p2.dense_bound_ms(inp, 2, mxu=True) - want / 2) < 1e-15
    assert p2.dense_bound_ms(inp, 4, mxu=True) < p2.dense_bound_ms(inp, 4, mxu=False) / 3
