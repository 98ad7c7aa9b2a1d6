"""K2's plain version and the port's connected-component labels against
impact_tpu on the CPU.

The reference has two labelling paths: the XLA path of
``interaction.connected_component_labels`` (6-neighbour Jacobi sweeps to a
fixpoint; ``max_iters`` caps the sweeps) and the Pallas kernel
``ccl_pallas.connected_component_labels_pallas``, which composes its three
axis passes through the intermediate minimum and so also joins voxels that
touch only along an edge or a corner. The port keeps the 6-connected
labels. Bars: labels and sweep counts exactly equal — integer minima have
no rounding. Against the Pallas function the fixpoints are compared on
grids whose components never touch diagonally (where both reference paths
agree, which the test checks first); the diagonal case is pinned apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.ops.ccl_pallas import ccl_propagate_sweeps, connected_component_labels_pallas
from impact_tpu.voxel.interaction import connected_component_labels as jax_labels
from impact_tpu_torch.ops import ccl_pallas as k2
from impact_tpu_torch.voxel.interaction import connected_component_labels


def serpentine(g):
    """One 6-connected path snaking through the k = 0 plane."""
    occ = np.zeros((g, g, g), bool)
    occ[0::2, :, 0] = True
    for i in range(1, g, 2):
        occ[i, g - 1 if (i // 2) % 2 == 0 else 0, 0] = True
    return occ


def lattice_blobs(g, seed):
    """Random blocks on a lattice with 1-voxel gaps, joined by random
    face-wide bridges: every diagonal contact lies inside one component."""
    rng = np.random.default_rng(seed)
    s = 3 if g >= 16 else 2
    n = g // (s + 1)
    keep = rng.uniform(size=(n, n, n)) < 0.6
    occ = np.zeros((g, g, g), bool)
    for idx in np.argwhere(keep):
        lo = idx * (s + 1)
        occ[lo[0]:lo[0] + s, lo[1]:lo[1] + s, lo[2]:lo[2] + s] = True
        for ax in range(3):
            nb = idx.copy()
            nb[ax] += 1
            if nb[ax] < n and keep[tuple(nb)] and rng.uniform() < 0.5:
                sl = [slice(lo[a], lo[a] + s) for a in range(3)]
                sl[ax] = slice(lo[ax] + s, lo[ax] + s + 1)
                occ[tuple(sl)] = True
    return occ


def random_fill(g, seed, fill):
    return np.random.default_rng(seed).uniform(size=(g, g, g)) < fill


def _plain_labels(occ_np, n_sweeps):
    occ = torch.from_numpy(occ_np)[None]
    lab, sweeps = k2.ccl_sweeps_plain(occ, k2.initial_labels(occ), n_sweeps)
    return torch.where(occ, lab, -1)[0].numpy(), int(sweeps[0])


@pytest.mark.parametrize("g", [8, 16, 32])
@pytest.mark.parametrize("n_sweeps", [1, 16])
def test_plain_sweeps_match_reference_sweeps(g, n_sweeps):
    """After exactly n sweeps (the XLA path stopped by ``max_iters``)."""
    for fill in (0.3, 0.6):
        occ = random_fill(g, g + n_sweeps, fill)
        got, sweeps = _plain_labels(occ, n_sweeps)
        ref = np.asarray(jax_labels(jnp.asarray(occ), max_iters=n_sweeps))
        np.testing.assert_array_equal(got, ref)
        assert sweeps == n_sweeps


@pytest.mark.parametrize("g", [8, 16, 32])
def test_fixpoint_matches_both_reference_paths(g):
    grids = [lattice_blobs(g, seed) for seed in (0, 1)] + [serpentine(g)]
    for occ in grids:
        ref_xla = np.asarray(jax_labels(jnp.asarray(occ)))
        ref_pallas = np.asarray(connected_component_labels_pallas(
            jnp.asarray(occ), n_sweeps=16, interpret=True))
        np.testing.assert_array_equal(ref_xla, ref_pallas)  # the two reference paths agree here
        got = connected_component_labels(torch.from_numpy(occ)).numpy()
        np.testing.assert_array_equal(got, ref_xla)
    assert len(np.unique(got[got >= 0])) == 1  # the serpentine is one component


@pytest.mark.parametrize("g", [8, 16, 32])
def test_fixpoint_matches_xla_path_on_random_fills(g):
    """Random fills touch diagonally everywhere: exact against the XLA path,
    batched (one call for every grid, as the split detection launches K2)."""
    occ = np.stack([random_fill(g, s, f) for s, f in ((0, 0.2), (1, 0.35), (2, 0.5))])
    got = connected_component_labels(torch.from_numpy(occ)).numpy()
    for b in range(occ.shape[0]):
        np.testing.assert_array_equal(got[b], np.asarray(jax_labels(jnp.asarray(occ[b]))))


def test_serpentine_needs_hundreds_of_sweeps():
    occ = torch.from_numpy(serpentine(32))[None]
    _, sweeps = k2.ccl_sweeps_plain(occ, k2.initial_labels(occ), 32 ** 3)
    assert int(sweeps[0]) > 500  # ~g²/2 sweeps, +1 for the no-change sweep


def test_empty_and_full_grids():
    occ = torch.stack([torch.zeros((16, 16, 16), dtype=torch.bool),
                       torch.ones((16, 16, 16), dtype=torch.bool)])
    lab, sweeps = k2.ccl_sweeps_plain(occ, k2.initial_labels(occ), 16 ** 3)
    assert bool((lab[0] == 16 ** 3).all()) and bool((lab[1] == 0).all())
    assert sweeps.tolist() == [1, 3 * 15 + 1]


def test_pallas_kernel_joins_diagonal_neighbours():
    """Reference fault, not reproduced: two voxels that share only an edge
    are one component for the Pallas kernel after one sweep (and at its
    fixpoint) but two for the XLA path and the port."""
    occ = np.zeros((8, 8, 8), bool)
    occ[1, 1, 1] = occ[2, 2, 1] = True
    lin = jnp.where(jnp.asarray(occ), jnp.arange(512, dtype=jnp.int32).reshape(8, 8, 8), 512)
    one = np.asarray(ccl_propagate_sweeps(jnp.asarray(occ), lin, n_sweeps=1, interpret=True))
    assert one[2, 2, 1] == one[1, 1, 1] == 73
    pallas = np.asarray(connected_component_labels_pallas(jnp.asarray(occ), interpret=True))
    assert pallas[2, 2, 1] == pallas[1, 1, 1]
    xla = np.asarray(jax_labels(jnp.asarray(occ)))
    got = connected_component_labels(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(got, xla)
    assert got[1, 1, 1] == 73 and got[2, 2, 1] == 145


def test_wrapper_checks_inputs():
    occ = torch.zeros((1, 8, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        k2.ccl_sweeps(occ, k2.initial_labels(occ).long(), 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k2.ccl_sweeps(occ.to("meta"), k2.initial_labels(occ).to("meta"), 4)
    # the u16 limit guards only the shared-memory launch: past it the CPU
    # takes the plain sweep, and 64³ the two-level labelling
    big = torch.zeros((1, 41, 41, 41), dtype=torch.bool)
    lab, sweeps = k2.ccl_sweeps(big, k2.initial_labels(big), 4)
    assert bool((lab == 41 ** 3).all()) and sweeps.tolist() == [1]
    assert bool((connected_component_labels(torch.zeros((64, 64, 64), dtype=torch.bool))
                 == -1).all())
