"""The slice of the reference tester's scenes, the gizmos and the chunked
registry rebake on the card, as ``chip_smoke.py``'s parity phase drives
them.

Needs an NVIDIA GPU (K1 and the labels kernel run there), so these tests
skip elsewhere; they import no JAX, so they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_parity_cuda.py``.

* One parity scene (ShadowCubeMapping, 768x512, six 1024² cube faces)
  through ``apps/parity_snapshots.py``: no raster drops, every K1 launch
  equal to K1's plain version, the frame at least 0.95 against the plain
  tile raster's.
* The gizmos of all 21 kinds and ``colliders`` on the snapshot
  configuration's VoxelBoxTumbler: the card's overlay equal to the port's
  overlay on the CPU on at least 99.9 % of the written pixels, and hiding
  them gives the base frame back.
* The filled 64³ chunked scene rebaked with a registry of other colours:
  the baked corners within 1e-6 of a CPU rebake of the same pool, and a
  K1 frame after 3 steps at least 0.95 against the plain tile raster's.
"""

import numpy as np
import pytest
import torch
from chip_smoke import OVERLAY_SHARE, PARITY_BAR, held_k1, overlay_card_vs_cpu, parity_frame

from impact_tpu_torch.apps import snapshot_tester as st
from impact_tpu_torch.apps.snapshot_tester import render_again
from impact_tpu_torch.models.bench import bench_chunked_config, bench_chunked_fill_scene
from impact_tpu_torch.render import raster_pallas as rp
from impact_tpu_torch.render.gizmos import ALL_GIZMO_TYPES, GIZMO_COLLIDERS
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.scene.materials import make_voxel_type_registry, material_corner_table
from impact_tpu_torch.utils.image import rgb_hybrid_compare
from impact_tpu_torch.voxel.mesh import bake_mesh_materials


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 and the labels kernel have no CPU mode here")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_parity_scene_on_the_card(card):
    held = dict(depth=0, attributes=0, max_abs_err=0.0)
    run_depth, run_attr = rp.raster_depth, rp.raster_attributes
    rp.raster_depth, rp.raster_attributes = held_k1(held)
    rp.LAUNCHES.reset()
    try:
        row, img, rt = parity_frame("ShadowCubeMapping", card)
    finally:
        rp.raster_depth, rp.raster_attributes = run_depth, run_attr
    assert img.shape == (512, 768, 3) and row["drops"] == 0
    assert held["attributes"] == rp.LAUNCHES["k1_raster_attributes"] == 1
    assert held["depth"] == rp.LAUNCHES["k1_raster_depth"] >= 6  # the six cube faces and more
    assert row["vs_tile_raster"] >= PARITY_BAR


@pytest.mark.cuda
def test_gizmo_overlay_card_matches_cpu(card):
    rt = st.build_runtime("VoxelBoxTumbler", card)
    rt.step(5)
    start = rt.sim
    base = rt.render()
    kinds = ALL_GIZMO_TYPES + (GIZMO_COLLIDERS,)
    rt.sim = start
    frame, differ, written = overlay_card_vs_cpu(rt, base, kinds)
    assert written > 0 and differ <= OVERLAY_SHARE * written
    assert (frame != base.cpu().numpy()).any()
    rt.visible_gizmos = tuple(kinds)
    rt.sim = start
    np.testing.assert_array_equal(rt.render().cpu().numpy(), frame)
    rt.visible_gizmos = ()
    rt.sim = start
    np.testing.assert_array_equal(rt.render().cpu().numpy(), base.cpu().numpy())


@pytest.mark.cuda
def test_chunked_registry_rebake_on_the_card(card):
    cfg = bench_chunked_config(64)
    build = compile_scene(bench_chunked_fill_scene(64), cfg, device=card)
    registry = make_voxel_type_registry([
        {"name": "Basalt", "color": (0.9, 0.1, 0.2), "roughness": 0.3},
        {"name": "Copper", "color": (0.2, 0.8, 0.4), "metalness": 1.0},
        {"name": "Glass", "color": (0.1, 0.3, 0.9), "emissive_luminance": 2.0}], device="cpu")
    pool_cpu = type(build.sim.meshes)(*(x.cpu() for x in build.sim.meshes))
    rt = HeadlessRuntime(build, cfg, registry=registry, enable_fracturing=False)
    cpu = bake_mesh_materials(pool_cpu, material_corner_table(registry))
    for f in ("tri_albedo", "tri_f0", "tri_rough", "tri_emissive"):
        np.testing.assert_allclose(getattr(rt.sim.meshes, f).cpu().numpy(),
                                   getattr(cpu, f).numpy(), rtol=0, atol=1e-6, err_msg=f)
    rt.step(3)
    img = rt.render().cpu().numpy()
    assert rt.last_drops == (0, 0)
    assert rgb_hybrid_compare(img, render_again(rt, "raster")) >= PARITY_BAR
