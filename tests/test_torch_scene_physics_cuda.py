"""The textured frames and the scene-driven physics on the card.

Needs an NVIDIA GPU (K1 and the scan kernels run there), so these tests
skip elsewhere; they import no JAX, so they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_scene_physics_cuda.py``.

* TexturedMaterials through the runner, K1's frame against its golden at
  the harness's 0.93; a textured box entity (colour, normal and parallax
  maps) through K1 against the CPU's frame of the same scene at 0.95.
* HarmonicOscillation, FreeRotation and DragDrop at the snapshot
  configuration: the oscillator at center + dir·A·sin(2πt/T) within 1e-3
  (tests/test_physics.py:232-247), FreeRotation's angular momentum and unit
  quaternion within 1e-5 relative and its state after 20 steps at 8
  contact slots against the port's on the CPU (rtol 1e-5), DragDrop's
  spheres falling alike as written and the drag sphere slower in a medium
  of density 10, every body state finite and the scan kernels launched
  once DragDrop's spheres touch the floor.
"""

import math

import numpy as np
import pytest
import torch
from chip_smoke import (
    ROT_CPU_CONTACTS,
    ROT_CPU_STEPS,
    SCAN_ATOL_OF_MAGNITUDE,
    SCAN_RTOL,
    textured_box_config,
    textured_box_scene,
)

from impact_tpu_torch.apps import snapshot_tester as st
from impact_tpu_torch.models import SCENES
from impact_tpu_torch.physics import scan_solver
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.utils.config import EngineConfig
from impact_tpu_torch.utils.image import rgb_hybrid_compare


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 and the scan kernels have no CPU mode here")
    return torch.device("cuda")


@pytest.mark.cuda
def test_textured_frames_on_the_card(cuda_device):
    img, rt = st.render_scene("TexturedMaterials", cuda_device)
    assert st.score("TexturedMaterials", img) >= st.MIN_SCORE_TO_PASS
    frames = []
    for dev in (cuda_device, "cpu"):
        cfg = textured_box_config(EngineConfig())
        rt = HeadlessRuntime(compile_scene(textured_box_scene(), cfg, device=dev), cfg)
        frames.append(rt.render().cpu().numpy())
    assert rgb_hybrid_compare(*frames) >= 0.95


def physics_config(medium=0.0):
    cfg = st.snapshot_config()
    cfg.physics.medium.mass_density = medium
    cfg.physics.rigid_body_force.drag_load_map_config.directory = None
    return cfg


def finite(rt):
    b = rt.sim.phys.bodies
    return all(bool(torch.isfinite(getattr(b, f)).all())
               for f in ("position", "orientation", "momentum", "angular_momentum"))


@pytest.mark.cuda
def test_harmonic_oscillation_on_the_card(cuda_device):
    cfg = physics_config()
    rt = HeadlessRuntime(compile_scene(SCENES["HarmonicOscillation"](), cfg, device=cuda_device),
                         cfg)
    rt.step(50)
    t = float(rt.sim.phys.time)
    want = 2.0 + 2.0 * math.sin(2 * math.pi * t / 2.0)
    np.testing.assert_allclose(rt.sim.phys.bodies.position[0].cpu().numpy(), [0.0, want, 0.0],
                               atol=1e-3)
    assert finite(rt)


@pytest.mark.cuda
def test_free_rotation_on_the_card(cuda_device):
    cfg = physics_config()
    rt = HeadlessRuntime(compile_scene(SCENES["FreeRotation"](), cfg, device=cuda_device), cfg)
    l0 = rt.sim.phys.bodies.angular_momentum[0].clone()
    rt.step(100)
    b = rt.sim.phys.bodies
    torch.testing.assert_close(b.angular_momentum[0], l0, rtol=1e-5, atol=1e-5 * float(l0.norm()))
    assert abs(float(b.orientation[0].norm()) - 1.0) < 1e-5
    assert finite(rt)
    # what the card computes for it, against the port on the CPU
    runs = []
    cfg.tpu.max_contacts = ROT_CPU_CONTACTS
    for dev in (cuda_device, "cpu"):
        r = HeadlessRuntime(compile_scene(SCENES["FreeRotation"](), cfg, device=dev), cfg)
        r.step(ROT_CPU_STEPS)
        runs.append(r.sim.phys.bodies)
    for f in ("orientation", "angular_velocity"):
        got, want = (getattr(b, f)[0].cpu() for b in runs)
        atol = SCAN_ATOL_OF_MAGNITUDE * max(float(want.abs().max()), 1.0)
        torch.testing.assert_close(got, want, rtol=SCAN_RTOL, atol=atol)


@pytest.mark.cuda
def test_drag_drop_on_the_card(cuda_device):
    fall = {}
    for medium in (0.0, 10.0):
        cfg = physics_config(medium)
        rt = HeadlessRuntime(compile_scene(SCENES["DragDrop"](), cfg, device=cuda_device), cfg)
        rt.step(100)
        fall[medium] = rt.sim.phys.bodies.velocity[1:3, 1].cpu()
        assert finite(rt)
    assert torch.equal(fall[0.0][0], fall[0.0][1])  # as written: no drag
    assert float(fall[10.0][1]) > float(fall[10.0][0])  # the drag sphere falls slower
    scan_solver.LAUNCHES.reset()
    rt.step(30)
    assert sum(scan_solver.LAUNCHES.values()) > 0 and finite(rt)
