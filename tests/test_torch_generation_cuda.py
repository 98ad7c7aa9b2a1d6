"""The procedural SDF generation path on the card, as ``chip_smoke.py``'s
generation phase drives it.

Needs an NVIDIA GPU (K1 runs there), so these tests skip elsewhere; they
import no JAX, so they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_generation_cuda.py``.

* The generation world (``impact_tpu_torch/models/generation.py``) compiled
  at the default pools with its ``sdf_generators``, stepped 30 steps and
  rendered: every K1 launch of the frame equal to K1's plain version
  (depth, z and valid equal, attributes within 1e-5), the bodies finite,
  and the frame at least 0.95 against the plain tile raster's.
* The voxel generator's preview of its example graph through K1 at least
  0.95 against the plain tile raster's frame, and its ``stats`` on the
  card equal to the CPU's.
"""

import pytest
import torch
from chip_smoke import PARITY_BAR, body_state_finite, held_k1

from impact_tpu_torch.apps import voxel_generator as vg
from impact_tpu_torch.apps.snapshot_tester import render_again
from impact_tpu_torch.models.generation import generation_world
from impact_tpu_torch.render import raster_pallas as rp
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.utils.config import EngineConfig
from impact_tpu_torch.utils.image import rgb_hybrid_compare

STEPS = 30


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 has no CPU mode here")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_generation_world_k1_launches_equal_the_plain_version(card, tmp_path):
    cfg = EngineConfig()
    world, gens = generation_world(tmp_path)
    rt = HeadlessRuntime(compile_scene(world, cfg, sdf_generators=gens), cfg)
    rt.step(STEPS)
    assert body_state_finite(rt.sim)
    held = dict(depth=0, attributes=0, max_abs_err=0.0)
    run_depth, run_attr = rp.raster_depth, rp.raster_attributes
    rp.raster_depth, rp.raster_attributes = held_k1(held)
    rp.LAUNCHES.reset()
    try:
        img = rt.render().cpu().numpy()
    finally:
        rp.raster_depth, rp.raster_attributes = run_depth, run_attr
    assert held["attributes"] == rp.LAUNCHES["k1_raster_attributes"] == 1
    assert held["depth"] == rp.LAUNCHES["k1_raster_depth"] > 0
    assert rgb_hybrid_compare(img, render_again(rt, "raster")) >= PARITY_BAR


@pytest.mark.cuda
def test_preview_through_k1_matches_the_plain_tile_raster(card):
    graph = vg.example_graph()
    rp.LAUNCHES.reset()
    img = vg.preview_frame(graph, card).cpu().numpy()
    assert rp.LAUNCHES["k1_raster_attributes"] == 1
    plain = vg.preview_frame(graph, card, raster_backend="raster").cpu().numpy()
    assert rgb_hybrid_compare(img, plain) >= PARITY_BAR
    assert vg.stats(graph, card)["line"] == vg.stats(graph, "cpu")["line"]
