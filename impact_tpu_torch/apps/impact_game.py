"""Voxel Range, the game app, on the port (port of ``apps/impact_game.py``;
ref: apps/impact_game).

A headless shooting range composed from the engine's systems: voxel
spheres are launched at fracturable voxel targets on a floor; the game loop
scores the fragments spawned (the growth of the live voxel objects),
renders optional frames, and is won when any target shatters. The world,
the configuration and the scoring are the reference app's; it runs on the
card unless ``--device cpu`` is given.

    python -m impact_tpu_torch.apps.impact_game                 # play, print the score
    python -m impact_tpu_torch.apps.impact_game --frames 400 --render out --every 20
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_range_world(n_targets: int = 3, n_shots: int = 3, seed: int = 0):
    """The range: lights, a camera, a floor, ``n_targets`` fracturable
    voxel boxes in a row and ``n_shots`` voxel spheres aimed at them."""
    from ..ecs import World
    from ..ecs import components as C
    from ..render.camera import look_at

    rng = np.random.default_rng(seed)
    w = World()
    w.create_entity(C.AmbientEmission(illuminance=(900.0, 950.0, 1100.0)))
    w.create_entity(
        C.ReferenceFrame(position=(18.0, 24.0, 18.0)),
        C.ShadowableOmnidirectionalEmission(luminous_intensity=(4e5, 3.8e5, 3.2e5),
                                            source_extent=0.5),
    )
    w.create_entity(
        C.ShadowableUnidirectionalEmission(perpendicular_illuminance=(30000.0, 28000.0, 24000.0),
                                           direction=(-0.35, -0.8, -0.48),
                                           angular_source_extent=2.0),
    )
    eye = (0.0, 9.0, 30.0)
    w.create_entity(
        C.ReferenceFrame(position=eye, orientation=tuple(look_at(eye, (0.0, 3.0, 0.0)).numpy())),
        C.PerspectiveCamera(vertical_field_of_view=float(np.pi / 3), near_distance=0.05,
                            far_distance=500.0),
    )
    w.create_entity(
        C.ReferenceFrame(),
        C.PlanarCollidable(kind=1, normal=(0.0, 1.0, 0.0), displacement=0.0, restitution=0.2,
                           static_friction=0.8, dynamic_friction=0.6),
    )
    # fracturable targets in a row
    for i in range(n_targets):
        x = (i - (n_targets - 1) / 2.0) * 7.0
        w.create_entity(
            C.ReferenceFrame(position=(x, 3.0, 0.0)),
            C.VoxelBox(voxel_extent=0.25, extent_x=12.0, extent_y=12.0, extent_z=12.0),
            C.SameVoxelType(voxel_type=i % 3),
            C.DynamicVoxels(),
            C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.8, dynamic_friction=0.6),
            C.FracturingProperties(impulse_threshold=25.0, fracture_radius=2.2),
            C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)),
        )
    # staggered projectiles aimed at the targets
    for i in range(n_shots):
        x = (i - (n_shots - 1) / 2.0) * 7.0 + float(rng.uniform(-0.5, 0.5))
        w.create_entity(
            C.ReferenceFrame(position=(x, 4.0, 20.0 + 6.0 * i)),
            C.Motion(linear_velocity=(0.0, 2.5, -22.0)),
            C.VoxelSphere(voxel_extent=0.25, radius=4.0),
            C.SameVoxelType(voxel_type=1),
            C.DynamicVoxels(),
            C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.5, dynamic_friction=0.4),
            C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)),
        )
    return w


def range_config():
    """The range's engine configuration: 24 object slots of 16³ (targets,
    shots and fragments), 40 bodies, 512 contacts, up to 8 fragments an
    event, dt 0.01, 320x240 with 128² omni shadow maps."""
    from ..utils.config import EngineConfig

    cfg = EngineConfig()
    cfg.tpu.max_voxel_objects = 24
    cfg.tpu.max_bodies = 40
    cfg.tpu.max_contacts = 512
    cfg.tpu.voxel_grid_size = 16
    cfg.tpu.render_width = 320
    cfg.tpu.render_height = 240
    cfg.tpu.max_fracture_fragments = 8
    cfg.physics.simulator.initial_time_step_duration = 0.01
    cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = 128
    return cfg


def play(frames: int = 400, render_dir=None, render_every: int = 0, seed: int = 0,
         device="cuda"):
    """Play the range for ``frames`` frames; returns (and prints) the result
    dict: frames, fragments spawned, targets, objects alive, won."""
    from ..runtime import HeadlessRuntime, compile_scene
    from ..utils.image import save_png

    n_targets, n_shots = 3, 3
    cfg = range_config()
    world = build_range_world(n_targets, n_shots, seed)
    rt = HeadlessRuntime(compile_scene(world, cfg, device=device), cfg)
    base_objects = int(rt.sim.voxels.alive.sum())

    if render_dir:
        os.makedirs(render_dir, exist_ok=True)
    score = 0
    for frame in range(frames):
        rt.step(1)
        n_alive = int(rt.sim.voxels.alive.sum())
        score = max(score, n_alive - base_objects)  # fragments spawned
        if render_dir and render_every and frame % render_every == 0:
            save_png(os.path.join(render_dir, f"frame_{frame:05d}.png"),
                     rt.render().cpu().numpy())
    result = {
        "frames": frames,
        "fragments_spawned": score,
        "targets": n_targets,
        "objects_alive": int(rt.sim.voxels.alive.sum()),
        "won": score > 0,
    }
    print(result)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--render", default=None)
    p.add_argument("--every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    r = play(a.frames, a.render, a.every, a.seed, device=a.device)
    return 0 if r["won"] else 2


if __name__ == "__main__":
    sys.exit(main())
