"""K1, the tile rasterizer: the port's plain version (what the wrappers run on
CPU tensors) against the reference Pallas kernel in interpret mode, and
against the reference and port XLA-style tile rasters.

Bars (from tests/test_raster_pallas.py): coverage agreement > 0.99, depth
atol 2e-3 where both cover, attributes within 5e-2 (abs or rel) on 99% of the
pixels both cover; the drop counts of K1's window/big-block overflow must be
equal. The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_k1_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.render import raster as jraster
from impact_tpu.render import raster_pallas as jrp
from impact_tpu_torch.render import raster as traster
from impact_tpu_torch.render import raster_pallas as trp
from impact_tpu_torch.render.pipeline import project_corners

H, W = 64, 96
K, BIG = 32, 16


def _vp():
    f = 1.0 / np.tan(0.5)
    near, far = 0.1, 100.0
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1] = f / (W / H), f
    m[2, 2] = -far / (far - near)
    m[2, 3] = m[2, 2] * near
    m[3, 2] = -1.0
    return m


def _soup(seed, n_tris=300, n_attr=5, near_crossing=True):
    """Random triangles in front of the camera (a few straddle the near
    plane), corner-major positions [T,9], attributes [T,3A], active mask."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-2.5, -1.5, -6.0], [2.5, 1.5, -2.0], size=(n_tris, 1, 3))
    size = rng.uniform(0.05, 0.6, size=(n_tris, 1, 1))
    corners = centers + size * rng.normal(size=(n_tris, 3, 3))
    if near_crossing:
        corners[:4, 2, 2] = 1.0  # behind the camera: near-plane clip path
    pos9 = corners.reshape(n_tris, 9).astype(np.float32)
    attrs = rng.normal(size=(n_tris, 3 * n_attr)).astype(np.float32)
    active = rng.uniform(size=n_tris) < 0.9
    return pos9, attrs, active


def _cov_depth_check(got, ref):
    cg, cr = got < 1.0, ref < 1.0
    assert np.mean(cg == cr) > 0.99
    both = cg & cr
    np.testing.assert_allclose(got[both], ref[both], atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tile", [16, 32])
def test_depth_plain_matches_pallas_interpret(seed, tile):
    pos9, _, active = _soup(seed)
    vp = _vp()
    dj, nj = jrp.rasterize_depth_pos(
        jnp.asarray(pos9), jnp.asarray(active), jnp.asarray(vp), H, W, tile=tile,
        k_per_range=K, big_budget=BIG, cull_backfaces=False, interpret=True,
        return_drops=True)
    dt, nt = trp.rasterize_depth_pos(
        torch.from_numpy(pos9), torch.from_numpy(active), torch.from_numpy(vp), H, W,
        tile=tile, k_per_range=K, big_budget=BIG, cull_backfaces=False, return_drops=True)
    _cov_depth_check(dt.numpy(), np.asarray(dj))
    assert int(nt) == int(nj)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tile", [16, 32])
def test_attributes_plain_matches_pallas_interpret(seed, tile):
    pos9, attrs, active = _soup(seed)
    vp = _vp()
    ij, nrj, vj, nj = jrp.rasterize_attributes_pos(
        jnp.asarray(pos9), jnp.asarray(active), jnp.asarray(attrs), jnp.asarray(vp), H, W,
        tile=tile, k_per_range=K, big_budget=BIG, cull_backfaces=False, interpret=True,
        return_drops=True)
    it, nrt, vt, nt = trp.rasterize_attributes_pos(
        torch.from_numpy(pos9), torch.from_numpy(active), torch.from_numpy(attrs),
        torch.from_numpy(vp), H, W, tile=tile, k_per_range=K, big_budget=BIG,
        cull_backfaces=False, return_drops=True)
    vj, vt = np.asarray(vj), vt.numpy()
    assert vt.sum() > 0.2 * vt.size
    assert np.mean(vj == vt) > 0.99
    both = vj & vt
    for a, b in ((it.numpy(), np.asarray(ij)), (nrt.numpy(), np.asarray(nrj))):
        close = np.all(np.isclose(a[both], b[both], atol=5e-2, rtol=5e-2), axis=-1)
        assert np.mean(close) > 0.99
    assert int(nt) == int(nj)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_tile_rasters(seed):
    """Coverage and depth against the reference XLA raster and the port's
    plain tile raster (neither truncates at this size: k_per_tile 512)."""
    pos9, attrs, active = _soup(seed)
    vp = _vp()
    dt = trp.rasterize_depth_pos(torch.from_numpy(pos9), torch.from_numpy(active),
                                 torch.from_numpy(vp), H, W, tile=32, k_per_range=256,
                                 big_budget=128, cull_backfaces=False).numpy()
    clip = project_corners(torch.from_numpy(pos9), torch.from_numpy(vp))
    ref_j, _, _ = jraster.rasterize(jnp.asarray(clip.numpy()), jnp.asarray(active), H, W,
                                    cull_backfaces=False, k_per_tile=512, big_budget=128)
    ref_t, _, _ = traster.rasterize(clip, torch.from_numpy(active), H, W,
                                    cull_backfaces=False, k_per_tile=512, big_budget=128)
    _cov_depth_check(dt, np.asarray(ref_j.depth))
    _cov_depth_check(ref_t.depth.numpy(), np.asarray(ref_j.depth))
    np.testing.assert_array_equal(ref_t.tri_id.numpy(), np.asarray(ref_j.tri_id))

    t = pos9.shape[0]
    idx = np.arange(3 * t, dtype=np.int32).reshape(t, 3)
    a_flat = attrs.reshape(3 * t, -1)
    ij, nj, vj = jraster.rasterize_attributes(
        jnp.asarray(clip.numpy()), jnp.asarray(active), jnp.asarray(idx), jnp.asarray(a_flat),
        H, W, k_per_tile=512, big_budget=128, cull_backfaces=False)
    it, nt, vt = traster.rasterize_attributes(
        clip, torch.from_numpy(active), torch.from_numpy(idx).long(), torch.from_numpy(a_flat),
        H, W, k_per_tile=512, big_budget=128, cull_backfaces=False)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=1e-4)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_clip_space_wrappers_match_pallas_interpret(seed):
    """rasterize_depth / rasterize_attributes (clip positions [T,3,4] and
    indexed vertex attributes) against the reference in interpret mode."""
    pos9, _, active = _soup(seed, n_tris=200)
    clip = project_corners(torch.from_numpy(pos9), torch.from_numpy(_vp()))
    rng = np.random.default_rng(seed + 10)
    tri = rng.integers(0, 400, size=(200, 3)).astype(np.int32)
    vattr = rng.normal(size=(400, 4)).astype(np.float32)
    cj, aj = jnp.asarray(clip.numpy()), jnp.asarray(active)
    dj, nj = jrp.rasterize_depth(cj, aj, H, W, k_per_range=K, big_budget=BIG, interpret=True,
                                 return_drops=True)
    dt, nt = trp.rasterize_depth(clip, torch.from_numpy(active), H, W, k_per_range=K,
                                 big_budget=BIG, return_drops=True)
    _cov_depth_check(dt.numpy(), np.asarray(dj))
    assert int(nt) == int(nj)
    ij, _, vj = jrp.rasterize_attributes(cj, aj, jnp.asarray(tri), jnp.asarray(vattr), H, W,
                                         k_per_range=K, big_budget=BIG, interpret=True)
    it, _, vt = trp.rasterize_attributes(clip, torch.from_numpy(active),
                                         torch.from_numpy(tri).long(), torch.from_numpy(vattr),
                                         H, W, k_per_range=K, big_budget=BIG)
    vj, vt = np.asarray(vj), vt.numpy()
    assert np.mean(vj == vt) > 0.99
    both = vj & vt
    close = np.all(np.isclose(it.numpy()[both], np.asarray(ij)[both], atol=5e-2, rtol=5e-2), -1)
    assert np.mean(close) > 0.99


def test_wrapper_takes_plain_version_only_on_cpu():
    pos9, attrs, active = _soup(3, n_tris=40)
    args = (torch.from_numpy(pos9), torch.from_numpy(active), torch.from_numpy(_vp()), H, W)
    trp.LAUNCHES.reset()
    d = trp.rasterize_depth_pos(*args)
    assert d.device.type == "cpu" and trp.LAUNCHES["k1_raster_depth"] == 0
    b = trp.bin_depth_pos(*args)
    b.payload = b.payload.to("meta")
    with pytest.raises(ValueError):
        trp.raster_depth(b)


def test_window_overflow_fault_is_reproduced():
    """Reference fault kept by the port (ROADMAP Queue 3): under
    ``k_per_range`` overflow K1 keeps each window's first candidates in
    (bin, quantized z) order, so a window spanning two bins evicts the second
    bin's NEAR candidates and leaves holes. Port and reference agree exactly;
    both cover far less than the untruncated tile raster."""
    pos9, _, active = _soup(0, n_tris=600)
    vp = _vp()
    dt, nt = trp.rasterize_depth_pos(
        torch.from_numpy(pos9), torch.from_numpy(active), torch.from_numpy(vp), H, W, tile=32,
        k_per_range=16, big_budget=128, cull_backfaces=False, return_drops=True)
    dj, nj = jrp.rasterize_depth_pos(
        jnp.asarray(pos9), jnp.asarray(active), jnp.asarray(vp), H, W, tile=32,
        k_per_range=16, big_budget=128, cull_backfaces=False, interpret=True,
        return_drops=True)
    assert int(nt) == int(nj) > 1000
    np.testing.assert_array_equal(dt.numpy() < 1.0, np.asarray(dj) < 1.0)
    clip = project_corners(torch.from_numpy(pos9), torch.from_numpy(vp))
    full, _, _ = traster.rasterize(clip, torch.from_numpy(active), H, W, cull_backfaces=False,
                                   k_per_tile=2048, big_budget=128)
    assert (dt.numpy() < 1.0).mean() < (full.depth.numpy() < 1.0).mean() - 0.3


@pytest.mark.parametrize("variant", ["depth", "attributes"])
def test_fitted_windows_drop_nothing(variant):
    """``k_per_range=None`` (the port's render passes) fits the windows to
    the view's longest: nothing drops, and the output matches the reference
    kernel's (interpret mode) at that window size, which is the longest
    window rounded up to 128 positions, within the bars above; coverage
    agrees with the untruncated tile raster's on 99% of the pixels."""
    pos9, attrs, active = _soup(0, n_tris=600)
    vp = _vp()
    args = (torch.from_numpy(pos9), torch.from_numpy(active), torch.from_numpy(vp), H, W)
    b = trp.bin_depth_pos(*args, tile=32, k_per_range=None, big_budget=128,
                          cull_backfaces=False)
    longest = int(trp.bin_depth_pos(*args, tile=32, k_per_range=1 << 20, big_budget=128,
                                    cull_backfaces=False).ranges[:, 4:].max())
    assert longest > 128 and b.k_per_range == -(-longest // 128) * 128
    assert int(b.n_drop) == 0 and int(b.ranges[:, 4:].max()) == longest
    jargs = (jnp.asarray(pos9), jnp.asarray(active), jnp.asarray(vp), H, W)
    kw = dict(tile=32, big_budget=128, cull_backfaces=False, return_drops=True)
    if variant == "depth":
        dt, nt = trp.rasterize_depth_pos(*args, k_per_range=None, **kw)
        dj, nj = jrp.rasterize_depth_pos(*jargs, k_per_range=b.k_per_range, interpret=True,
                                         **kw)
        _cov_depth_check(dt.numpy(), np.asarray(dj))
        covered = dt.numpy() < 1.0
    else:
        ta = torch.from_numpy(attrs)
        it, nrt, vt, nt = trp.rasterize_attributes_pos(*args[:2], ta, *args[2:],
                                                       k_per_range=None, **kw)
        ij, nrj, vj, nj = jrp.rasterize_attributes_pos(
            *jargs[:2], jnp.asarray(attrs), *jargs[2:], k_per_range=b.k_per_range,
            interpret=True, **kw)
        vj, vt = np.asarray(vj), vt.numpy()
        assert np.mean(vj == vt) > 0.99
        both = vj & vt
        for a, r in ((it.numpy(), np.asarray(ij)), (nrt.numpy(), np.asarray(nrj))):
            close = np.all(np.isclose(a[both], r[both], atol=5e-2, rtol=5e-2), axis=-1)
            assert np.mean(close) > 0.99
        covered = vt
    assert int(nt) == int(nj) == 0
    clip = project_corners(torch.from_numpy(pos9), torch.from_numpy(vp))
    full, _, _ = traster.rasterize(clip, torch.from_numpy(active), H, W, cull_backfaces=False,
                                   k_per_tile=2048, big_budget=128)
    assert np.mean(covered == (full.depth.numpy() < 1.0)) > 0.99


def test_fitted_tile_raster_drops_nothing():
    """The plain tile raster with ``fit_k`` (the port's render passes) keeps
    every candidate of every tile (here up to 857, past the reference's
    256): it matches the reference XLA raster at a k_per_tile past the most
    crowded tile (depth within the bars above, winners and coverage equal,
    attributes as test_plain_matches_tile_rasters holds them)."""
    pos9, attrs, active = _soup(0, n_tris=3000)
    clip = project_corners(torch.from_numpy(pos9), torch.from_numpy(_vp()))
    act = torch.from_numpy(active)
    clip2, _, act2 = traster.clip_triangles_near(clip, act)
    crowd = int(traster._bin_small_and_big(clip2, act2, H, W, 32, 128, False).counts.max())
    assert 256 < crowd <= 4096
    fit, _, _ = traster.rasterize(clip, act, H, W, cull_backfaces=False, big_budget=128,
                                  fit_k=True)
    cj, aj = jnp.asarray(clip.numpy()), jnp.asarray(active)
    ref, _, _ = jraster.rasterize(cj, aj, H, W, cull_backfaces=False, k_per_tile=4096,
                                  big_budget=128)
    _cov_depth_check(fit.depth.numpy(), np.asarray(ref.depth))
    np.testing.assert_array_equal(fit.tri_id.numpy(), np.asarray(ref.tri_id))

    t = pos9.shape[0]
    idx = np.arange(3 * t, dtype=np.int32).reshape(t, 3)
    a_flat = attrs.reshape(3 * t, -1)
    it, nt, vt = traster.rasterize_attributes(
        clip, act, torch.from_numpy(idx).long(), torch.from_numpy(a_flat), H, W,
        big_budget=128, cull_backfaces=False, fit_k=True)
    ij, nj, vj = jraster.rasterize_attributes(
        cj, aj, jnp.asarray(idx), jnp.asarray(a_flat), H, W, k_per_tile=4096, big_budget=128,
        cull_backfaces=False)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=1e-4)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-6)


def test_bound_counts_each_referenced_row_once():
    """bound_ms reads each referenced payload row once however many windows
    hold it, and evaluates only in-image pixels."""
    pos9, attrs, active = _soup(0)
    b, a = trp.bin_attributes_pos(torch.from_numpy(pos9), torch.from_numpy(active),
                                  torch.from_numpy(attrs), torch.from_numpy(_vp()), H, W,
                                  tile=32, k_per_range=K, big_budget=BIG)
    ms, by = trp.bound_ms(b, a, peak_bytes_per_s=1e3, peak_flops=1e30)
    assert by == "bytes"
    rows = set()
    for s, c in zip(b.ranges[:, :4].reshape(-1).tolist(), b.ranges[:, 4:].reshape(-1).tolist()):
        rows.update(range(s, s + c))
    n_read = (len(rows) + int(b.big_have.sum())) * b.rows * 4 + b.ranges.numel() * 4
    assert ms == pytest.approx((n_read + H * W * (8 * a + 5)) / 1e3 * 1e3)
    ms, by = trp.bound_ms(b, a, peak_bytes_per_s=1e30, peak_flops=1.0)
    cand = b.ranges[:, 4:].sum(dim=1).numpy() + int(b.big_have.sum())
    px = np.array([min(32, W - (t % b.tw) * 32) * min(32, H - (t // b.tw) * 32)
                   for t in range(b.th * b.tw)])
    assert by == "operations" and ms == pytest.approx(14 * float((cand * px).sum()) * 1e3)


def test_kernel_inputs_need_no_conversion():
    """The prologue hands K1 its big-block mask as contiguous bool (one byte
    of 0 or 1 a slot, read by the kernel as it is); the launch checks refuse
    a mask of another type, and A past the kernel's exact run division."""
    pos9, attrs, active = _soup(0)
    b, a = trp.bin_attributes_pos(torch.from_numpy(pos9), torch.from_numpy(active),
                                  torch.from_numpy(attrs), torch.from_numpy(_vp()), H, W,
                                  tile=32, k_per_range=K, big_budget=BIG)
    assert b.big_have.dtype == torch.bool and b.big_have.is_contiguous()
    assert b.big_have.untyped_storage().nbytes() == b.big_have.numel()
    trp._check_binned(b)
    b.big_have = b.big_have.to(torch.uint8)
    with pytest.raises(ValueError, match="big_have"):
        trp._check_binned(b)
    a = trp._MAX_ATTR + 1
    rows = trp.GEOM_ROWS + 3 * a
    meta = dict(device="meta")
    wide = trp.Binned(torch.empty((1, rows), **meta),
                      torch.empty((b.th * b.tw, 8), dtype=torch.int32, **meta),
                      torch.empty((0, rows), **meta), torch.empty((0,), dtype=torch.bool, **meta),
                      None, b.th, b.tw, b.tile, K, H, W)
    with pytest.raises(ValueError, match="attributes"):
        trp.raster_attributes(wide, a)
