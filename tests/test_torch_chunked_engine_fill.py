"""The filled chunked bench scene at full width, bridged and stepped in both
packages on the CPU: the asteroid with a radius of 64/2 − 4 = 28 voxels (as
``bench.py:bench_chunked``'s comment intends) in 4 slots of 64³ i8 grids,
under the bench's absorber, stepped 2 steps. The carve splits the asteroid
into 3 live objects on step 1 in both packages; the bars are those of
``test_torch_chunked_engine.py`` (alive, split_pending, chunk slots and dirt,
deferred carves and mesh drops equal; i8 codes equal but for ±1 on at most
1e-4 of the voxels; body state within 8× the reference's mass-sum spread
plus 1e-6 of the magnitude; three host reads per step)."""

import numpy as np
import pytest

from test_torch_chunked_engine import (  # noqa: F401  (an autouse fixture)
    check_steps,
    few_torch_threads,
    run_both,
)

G = 64


@pytest.fixture(scope="module")
def filled_run():
    mp = pytest.MonkeyPatch()
    try:
        return run_both(G, 4, G / 2 - 4, 2, mp)
    finally:
        mp.undo()


def test_filled_bench_scene_splits_as_reference(filled_run):
    check_steps(filled_run)
    first = filled_run["steps"][0]
    assert int(first["port"].voxels.alive.sum()) == 3
    assert first["port_deferred"] > 0  # more overlapped chunks than the carve budget
    assert int((first["port"].voxels.sdf < 0).sum()) < filled_run["n_active0"]
