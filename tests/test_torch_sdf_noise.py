"""The port's SDF noise (``voxel/sdf.py``) and the asteroid it shapes,
against impact_tpu on the CPU.

* The u32 lattice hash on int32 coordinates that include negative cells and
  the int32 extremes: equal.
* ``gradient_noise``, ``multifractal_noise`` and a ``noise_modifier`` graph
  on seeded points in [-20, 20)³ (negative lattice cells included): within
  1e-6 absolute (the same float32 operations in the same order).
* The chunked bench's asteroid compiled by both packages at 64³ i8, as the
  bench writes it (radius (64/2 − 4)·0.3 = 8.4 voxels) and filled (28
  voxels): SDF codes and voxel types equal, except where a float32 ulp of
  the evaluation flips a code: at most 1e-4 of the voxels, each by ±1. The
  as-written asteroid has 2,423 active voxels in both packages (the bench's
  radius fault, ROADMAP Queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.voxel import sdf as jsdf
from impact_tpu_torch.models.bench import (
    bench_chunked_config,
    bench_chunked_fill_scene,
    bench_chunked_scene,
)
from impact_tpu_torch.runtime import compile_scene as tcompile
from impact_tpu_torch.voxel import sdf as tsdf
from test_torch_chunked_engine import (  # noqa: F401  (an autouse fixture)
    few_torch_threads,
    jax_asteroid,
    jax_compile_chunked,
    jax_config,
)

G = 64
AS_WRITTEN_VOXELS = 2423
FLIP_SHARE = 1e-4


def _points(n=4000, seed=0):
    return np.random.default_rng(seed).uniform(-20.0, 20.0, size=(n, 3)).astype(np.float32)


def test_hash_on_negative_and_extreme_cells():
    rng = np.random.default_rng(1)
    ext = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 1], np.int32)
    ijk = np.concatenate([np.stack(np.meshgrid(ext, ext, ext, indexing="ij"), -1).reshape(-1, 3),
                          rng.integers(-5000, 5000, size=(500, 3)).astype(np.int32)])
    for seed in (0, 7, 2 ** 32 - 1):
        want = np.asarray(jsdf._hash3(*(jnp.asarray(ijk[:, a]) for a in range(3)), seed))
        t = torch.from_numpy(ijk).to(torch.int64)
        got = tsdf._hash3(t[:, 0], t[:, 1], t[:, 2], seed)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7])
def test_noise_matches_reference(seed):
    p = _points(seed=seed)
    assert (np.floor(p) < 0).any()
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    np.testing.assert_allclose(tsdf.gradient_noise(tp, seed).numpy(),
                               np.asarray(jsdf.gradient_noise(jp, seed)), atol=1e-6)
    args = (4, 0.22, 2.0, 0.55)
    np.testing.assert_allclose(tsdf.multifractal_noise(tp, *args, seed=seed).numpy(),
                               np.asarray(jsdf.multifractal_noise(jp, *args, seed=seed)),
                               atol=1e-6)
    graph = jsdf.noise_modifier(jsdf.sphere(8.4), 4, 0.22, 2.0, 0.55, 1.6, seed)
    np.testing.assert_allclose(tsdf.evaluate(graph, tp).numpy(),
                               np.asarray(jsdf.evaluate(graph, jp)), atol=1e-6)


@pytest.mark.parametrize("which", ["as written", "filled"])
def test_chunked_asteroid_compiles_as_reference(which):
    radius = (G / 2 - 4) * 0.3 if which == "as written" else G / 2 - 4
    scene = bench_chunked_scene(G) if which == "as written" else bench_chunked_fill_scene(G)
    ref = jax_compile_chunked(jax_asteroid(radius), jax_config(G, 4)).sim.voxels
    got = tcompile(scene, bench_chunked_config(G), device="cpu").sim.voxels
    want_sdf = np.asarray(ref.sdf).astype(np.int32)
    diff = got.sdf.numpy().astype(np.int32) - want_sdf
    n_flips = int((diff != 0).sum())
    print(f"{which}: {n_flips} of {diff.size} i8 codes differ")
    assert n_flips <= FLIP_SHARE * diff.size and np.abs(diff).max(initial=0) <= 1
    np.testing.assert_array_equal(got.vtype.numpy(), np.asarray(ref.vtype))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    n_active = int((got.sdf < 0).sum())
    assert n_active == int((want_sdf < 0).sum())
    if which == "as written":
        assert n_active == AS_WRITTEN_VOXELS
    else:
        assert n_active > 30 * AS_WRITTEN_VOXELS
