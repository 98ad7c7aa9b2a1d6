"""The reference's public API on the card: the quick start, the resume and a
command.

Needs an NVIDIA GPU (K1 and the scan kernels run there), so these tests
skip elsewhere; they import no JAX, so they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_api_cuda.py``.

* The quick start of README.md:41-57 with ``impact_tpu_torch``: an
  ``EngineConfig`` equal to the one its RON text gives,
  ``voxel_box_tumbler(n_boxes=4)``, ``compile_scene`` with no device (the
  state lands on the card), 100 steps, a render through K1, a checkpoint.
* The resume: save, 10 steps, load, 10 steps. On the card the scan solve's
  warm start sums with ``index_add`` (atomics in no fixed order, ROADMAP.md
  Queue 3), so the two runs are held to the scan tests' rtol 1e-5 and an
  atol of 1e-6 of each field's magnitude, not to equality.
* ``pause`` makes ``step`` a no-op, every tensor ``torch.equal``.
"""

import pytest
import torch
from chip_smoke import QUICK_START_RON, SCAN_ATOL_OF_MAGNITUDE, SCAN_RTOL, sim_states_equal

from impact_tpu_torch.models import voxel_box_tumbler
from impact_tpu_torch.render import raster_pallas as rp
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.utils.config import EngineConfig


@pytest.fixture
def quick_start():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 and the scan kernels have no CPU mode here")
    cfg = EngineConfig()
    cfg.tpu.max_voxel_objects = 8
    cfg.tpu.max_bodies = 24
    assert EngineConfig.from_ron_str(QUICK_START_RON) == cfg
    rt = HeadlessRuntime(compile_scene(voxel_box_tumbler(n_boxes=4), cfg), cfg)
    rt.step(100)
    return rt


@pytest.mark.cuda
def test_quick_start_on_the_card(quick_start, tmp_path):
    rt = quick_start
    assert rt.sim.phys.bodies.position.is_cuda
    b = rt.sim.phys.bodies
    assert all(bool(torch.isfinite(getattr(b, f)).all())
               for f in ("position", "orientation", "momentum", "angular_momentum"))
    rp.LAUNCHES.reset()
    img = rt.render()
    assert tuple(img.shape) == (192, 256, 3) and img.float().std().item() > 1.0
    assert rp.LAUNCHES["k1_raster_attributes"] > 0
    assert (tmp_path / "sim.npz") == rt.save_checkpoint(tmp_path / "sim.npz")


@pytest.mark.cuda
def test_resume_on_the_card(quick_start, tmp_path):
    rt = quick_start
    path = rt.save_checkpoint(tmp_path / "sim.npz")
    rt.step(10)
    first = rt.sim.phys.bodies
    rt.load_checkpoint(path)
    assert rt.sim.phys.bodies.position.is_cuda
    rt.step(10)
    for f in ("position", "orientation", "velocity", "angular_velocity", "momentum",
              "angular_momentum"):
        got, want = getattr(rt.sim.phys.bodies, f), getattr(first, f)
        atol = SCAN_ATOL_OF_MAGNITUDE * max(float(want.abs().max()), 1.0)
        torch.testing.assert_close(got, want, rtol=SCAN_RTOL, atol=atol)


@pytest.mark.cuda
def test_pause_on_the_card(quick_start):
    rt = quick_start
    before = rt.sim
    rt.enqueue_command("game_loop", "pause")
    rt.step(5)
    assert rt.paused and sim_states_equal(rt.sim, before)
    rt.enqueue_command("game_loop", "resume")
    rt.step(1)
    assert not torch.equal(rt.sim.phys.bodies.position, before.phys.bodies.position)
