"""Frames of the reference snapshot tester's scenes in the port against
impact_tpu's on the CPU (the frame part of
``tests/test_torch_parity_scenes.py``; the cascaded scene is in
``tests/test_torch_parity_scenes_csm.py`` so that ``--dist loadfile``
spreads the frames).

Each scene is compiled by both packages with their harnesses' overrides
(the reference's captured on ``EngineConfig()``), cut to 128x96 with 64²
shadow maps to fit the CPU, and rendered once: the reference with its XLA
tile raster, the port through K1's plain version (its windows fit to each
view). The port's frame must have no raster drops and score at least 0.95
(the repo's parity bar, apps/parity_snapshots.py:41) against the
reference's.
"""

import functools

import numpy as np
import pytest
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_parity_scenes import (  # noqa: F401  (an autouse fixture)
    cache_small_compiles, jcompile, reference_config)

from impact_tpu.models.parity_scenes import PARITY_SCENES as JPARITY
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu_torch.apps import parity_snapshots as ps
from impact_tpu_torch.utils.config import EngineConfig
from impact_tpu_torch.utils.image import rgb_hybrid_compare

W, H, SHADOW = 128, 96, 64


def cut(cfg, bf16=False):
    """The harness's configuration cut to the CPU's size."""
    cfg.tpu.render_width, cfg.tpu.render_height = W, H
    cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = SHADOW
    cfg.tpu.bf16_shading = bf16
    return cfg


@functools.lru_cache(maxsize=None)
def reference_frame(name, bf16=False):
    cfg = cut(reference_config(name), bf16)
    rt = JRuntime(jcompile(JPARITY[name][0](), cfg), cfg, enable_fracturing=False,
                  enable_absorption=False, enable_splitting=False)
    return np.asarray(rt.render())


def port_runtime(name, bf16=False, monkeypatch=None):
    """The port's harness runtime of ``name`` at the cut size on the CPU."""
    monkeypatch.setattr(ps, "WIDTH", W)
    monkeypatch.setattr(ps, "HEIGHT", H)
    return ps.build_runtime(name, cut(EngineConfig(), bf16), device="cpu")


def check_frame(name, monkeypatch, bf16=False):
    rt = port_runtime(name, bf16, monkeypatch)
    img = rt.render().numpy()
    assert img.shape == (H, W, 3)
    assert rt.last_drops == (0, 0) and rt.dropped_raster_candidates() == 0
    score = rgb_hybrid_compare(img, reference_frame(name, bf16))
    print(f"{name} (bf16 {bf16}): {score:.4f} against impact_tpu's frame")
    assert score >= ps.MIN_SCORE, (name, score)
    assert img.std() > 1.0
    return img


@pytest.mark.parametrize("name", ["SoftShadowCubeMapping", "Bloom"])
def test_frame_matches_reference(name, monkeypatch):
    check_frame(name, monkeypatch)
