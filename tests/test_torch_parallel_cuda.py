"""The engine step sharded over the voxel-object pool on the card, as
``chip_smoke.py``'s parallel phase drives it (checks (a)-(e) of its item 15).

Needs an NVIDIA GPU, so these tests skip elsewhere; they import no JAX, so
they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_parallel_cuda.py``.

* (a) The quick start's tumbler under ``scan`` on a 1-rank ``nccl`` mesh,
  10 steps, within ``tests/test_parallel.py:88-103``'s bars of
  ``HeadlessRuntime``'s run, every scan launch of the path equal to the
  plain loop on its active slots.
* (b) Fracturing and the filled 64³ asteroid on 4 ranks sharing the card
  over host-staged gloo, across their events, within the same bars of a
  single-process run; every labelled grid equal to the plain labelling.
* (c) The 1024-slot pod step: local dims, device peak, collective sizes.
* (d) The halo min filter on a 2×2 mesh, closed boundary.
* (e) The jacobi solve at 1024 bodies × 4096 slots under C·N·4 bytes.
* (f) The space axis: the labels kernel on slabs [B,gx,G,G] (gx < G, and
  gx = G unchanged) against its plain version, and the 1024-slot pod on a
  4×2 mesh of 8 ranks sharing the card.
* (g) The contact solve with the bodies split over the objects axis of a
  4×2 mesh on those 8 ranks, against the single-process solve on the card;
  every scan launch of the ranks equal to the plain loop.
"""

import pytest
import torch
from chip_smoke import (
    PARALLEL_RANKS,
    SPACE_RANKS,
    labels_plain,
    parallel_events,
    parallel_halo,
    parallel_pod,
    parallel_quick_start,
    parallel_sharded_solve,
    parallel_solver_memory,
    parallel_space_pod,
)

from impact_tpu_torch import _build
from impact_tpu_torch.parallel.world import World


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded step's kernels and NCCL run there")
    _build.load()  # built once here, before any rank is spawned
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def world(card, tmp_path_factory):
    w = World(PARALLEL_RANKS, device=card, backend="gloo",
              store_dir=tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world8(card, tmp_path_factory):
    w = World(SPACE_RANKS, device=card, backend="gloo",
              store_dir=tmp_path_factory.mktemp("world8"))
    yield w
    w.close()


@pytest.mark.cuda
def test_quick_start_sharded_on_one_nccl_rank(card, tmp_path):
    row, launches, scan_err = parallel_quick_start(card, str(tmp_path))
    assert row["scan_calls"] > 0 and scan_err == 0.0
    assert launches["scan_velocity_iterations"] == row["scan_calls"]


@pytest.mark.cuda
def test_events_on_ranks_sharing_the_card(card, world, tmp_path):
    rows, launches, labels_err = parallel_events(card, world, str(tmp_path))
    assert labels_err == 0.0 and launches["k2_labels"] > 0
    assert rows["asteroid"]["receivers"] and rows["fracturing"]["receivers"]


@pytest.mark.cuda
def test_pod_step_on_ranks_sharing_the_card(world):
    rows = parallel_pod(world)
    assert len(rows) == PARALLEL_RANKS


@pytest.mark.cuda
def test_halo_min_filter_on_the_card(card, world):
    assert parallel_halo(card, world)["halos"] == [1] * PARALLEL_RANKS


@pytest.mark.cuda
def test_jacobi_solve_allocates_no_incidence(card):
    row = parallel_solver_memory(card)
    assert row["peak_bytes"] < row["bar_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("gx,g", [(8, 16), (4, 16), (16, 64), (13, 40), (1, 9), (16, 16)])
def test_slab_labels_kernel_equals_plain_version(card, gx, g):
    """The labels kernel's slab entry (``k2_ccl_labels_slab``) on [3,gx,G,G]
    slabs (random fills, a slab full, a slab empty) equals the plain sweep
    of the same slabs; gx = G takes the cubic entry, as before."""
    import numpy as np

    from impact_tpu_torch.ops import ccl_pallas as k2

    rng = np.random.default_rng(gx * 100 + g)
    occ = np.stack([rng.uniform(size=(gx, g, g)) < 0.45, np.ones((gx, g, g), bool),
                    np.zeros((gx, g, g), bool)])
    occ = torch.tensor(occ, device=card)
    k2.LAUNCHES.reset()
    got = k2.connected_component_labels_batched(occ)
    torch.cuda.synchronize()
    assert torch.equal(got, labels_plain(occ))
    want = dict(k2_labels=1, k2_labels_slab=0) if gx == g else dict(k2_labels=0,
                                                                    k2_labels_slab=1)
    assert {k: k2.LAUNCHES[k] for k in want} == want


@pytest.mark.cuda
def test_pod_step_on_4x2(world8):
    rows = parallel_space_pod(world8)
    assert len(rows) == SPACE_RANKS and any(r["halos"] for r in rows)


@pytest.mark.cuda
def test_body_sharded_solve_on_4x2(card, world8):
    rows, scan_launches = parallel_sharded_solve(card, world8)
    assert scan_launches > 0
    assert all(r["ranks"] == SPACE_RANKS for r in rows)
    assert all(r["bitwise_equal"] for r in rows if not r["warm"])
