"""Rendering regression harness of the port: the reference's snapshot tester
(``apps/snapshot_tester.py``) driving ``impact_tpu_torch``.

Each scene is compiled at the tester's configuration (320x240, 4 voxel
objects of 32³, the default ``scan`` solver), stepped its warm-up count,
rendered through K1 (``raster_backend="kernel"``, the port's default) and
scored with ``rgb_hybrid_compare`` against the committed golden
``apps/snapshots/reference/<name>.png``; a score below 0.93 fails the
scene. As a side check the same state is rendered again through the plain
tile raster (``"raster"``, the counterpart of the reference's XLA raster,
which made the goldens off the TPU), and K1's frame must agree with it at
0.95. K1's windows and the tile raster's lists are fit to each view, so
neither drops geometry; the reference's fixed 256 do on crowded views,
and the goldens carry the XLA raster's cut. Frames
that fail are written to ``snapshot_failures/`` in the working directory,
never into ``apps/snapshots``.

    python -m impact_tpu_torch.apps.snapshot_tester                  # on the card
    python -m impact_tpu_torch.apps.snapshot_tester --device cpu --scenes Blank

All 20 of the reference's scenes run; ``TexturedMaterials`` turns on
``tpu.textured_voxels``, the triplanar voxel-type textures of
``render/textures.py`` applied in the shade pass.
"""

from __future__ import annotations

import argparse
import copy
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
SNAPSHOT_DIR = REPO / "apps" / "snapshots" / "reference"
MIN_SCORE_TO_PASS = 0.93
# K1's frame against the plain tile raster's (the repo's parity bar,
# apps/parity_snapshots.py)
RASTER_PARITY_BAR = 0.95
FAILED_DIR = pathlib.Path("snapshot_failures")

# simulation scenes: (name, warm-up steps)
TEST_SCENES = [
    ("Blank", 1),
    ("BallPit", 30),
    ("VoxelBoxTumbler", 30),
    ("Asteroid", 5),
    ("Fracturing", 10),
]


def _base_off(cfg):
    cfg.rendering.shadow_mapping.enabled = False
    cfg.rendering.ambient_occlusion.enabled = False
    cfg.rendering.temporal_anti_aliasing.enabled = False
    cfg.rendering.capturing_camera.bloom.enabled = False
    cfg.rendering.capturing_camera.dynamic_range_compression.tone_mapping_method = "None"


def _with(base=_base_off, **sets):
    def mut(cfg):
        base(cfg)
        for path, value in sets.items():
            obj = cfg
            parts = path.split("__")
            for p in parts[:-1]:
                obj = getattr(obj, p)
            setattr(obj, parts[-1], value)
    return mut


# rendering-feature scenes over the RenderingTest arrangement:
# name → (rendering_test kwargs, config mutator), one warm-up step each
FEATURE_SCENES = {
    "AmbientLight": (dict(omni=None, uni=None), _with()),
    "OmnidirectionalLight": (dict(ambient=(0, 0, 0), omni="plain", uni=None), _with()),
    "UnidirectionalLight": (dict(ambient=(0, 0, 0), omni=None, uni="plain"), _with()),
    "ShadowableOmnidirectionalLight": (
        dict(ambient=(0, 0, 0), omni="shadowable", uni=None), _with()
    ),
    "ShadowableUnidirectionalLight": (
        dict(ambient=(0, 0, 0), omni=None, uni="shadowable"), _with()
    ),
    "ShadowCubeMapping": (
        dict(ambient=(100, 100, 120), omni="shadowable", uni=None),
        _with(rendering__shadow_mapping__enabled=True),
    ),
    "SoftShadowCubeMapping": (
        dict(ambient=(100, 100, 120), omni="shadowable", uni=None, omni_extent=2.0),
        _with(rendering__shadow_mapping__enabled=True, tpu__soft_shadows=True),
    ),
    "CascadedShadowMapping": (
        dict(ambient=(100, 100, 120), omni=None, uni="shadowable"),
        _with(rendering__shadow_mapping__enabled=True, tpu__csm_cascades=3),
    ),
    "SoftCascadedShadowMapping": (
        dict(ambient=(100, 100, 120), omni=None, uni="shadowable", uni_extent=4.0),
        _with(rendering__shadow_mapping__enabled=True, tpu__csm_cascades=3,
              tpu__soft_shadows=True),
    ),
    "AmbientOcclusion": (
        dict(omni=None, uni=None),
        _with(rendering__ambient_occlusion__enabled=True),
    ),
    "Bloom": (
        dict(emissive_sphere=True),
        _with(rendering__capturing_camera__bloom__enabled=True),
    ),
    "ACESToneMapping": (
        dict(),
        _with(rendering__capturing_camera__dynamic_range_compression__tone_mapping_method="ACES"),
    ),
    "KhronosPBRNeutralToneMapping": (
        dict(),
        _with(rendering__capturing_camera__dynamic_range_compression__tone_mapping_method=(
            "KhronosPBRNeutral")),
    ),
    "TexturedMaterials": (
        dict(),
        _with(rendering__shadow_mapping__enabled=True, tpu__textured_voxels=True),
    ),
    "Skybox": (
        dict(),
        _with(rendering__shadow_mapping__enabled=True, tpu__procedural_sky=True),
    ),
}

NOT_PORTED = ()
ALL_SCENES = TEST_SCENES + [(name, 1) for name in FEATURE_SCENES]
PORTED_SCENES = [(n, w) for n, w in ALL_SCENES if n not in NOT_PORTED]


def snapshot_config(raster_backend: str | None = None):
    """The tester's configuration (apps/snapshot_tester.py:_snapshot_config);
    ``raster_backend`` None keeps the port's default (K1)."""
    from ..utils.config import EngineConfig

    cfg = EngineConfig()
    cfg.tpu.max_voxel_objects = 4
    cfg.tpu.max_bodies = 24
    cfg.tpu.max_contacts = 128
    cfg.tpu.voxel_grid_size = 32
    cfg.tpu.render_width = 320
    cfg.tpu.render_height = 240
    cfg.physics.simulator.initial_time_step_duration = 0.01
    cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = 256
    if raster_backend is not None:
        cfg.tpu.raster_backend = raster_backend
    return cfg


def build_runtime(scene_name: str, device="cuda", raster_backend: str | None = None):
    """The scene's HeadlessRuntime at the tester's configuration."""
    from ..models import SCENES, rendering_test
    from ..runtime import HeadlessRuntime, compile_scene

    cfg = snapshot_config(raster_backend)
    if scene_name in FEATURE_SCENES:
        kwargs, mutate = FEATURE_SCENES[scene_name]
        mutate(cfg)
        scene = rendering_test(**kwargs)
    else:
        scene = SCENES[scene_name]()
    return HeadlessRuntime(compile_scene(scene, cfg, device=device), cfg)


def warmup_steps(name: str) -> int:
    return dict(ALL_SCENES)[name]


def render_scene(name: str, device="cuda", raster_backend: str | None = None):
    """(u8 frame [H,W,3] as numpy, runtime) after the scene's warm-up steps."""
    rt = build_runtime(name, device, raster_backend)
    rt.step(warmup_steps(name))
    return rt.render().cpu().numpy(), rt


def render_again(rt, raster_backend: str):
    """The runtime's current state rendered once more, from the render state
    it started with (the first frame of a sequence, as the scored frame
    was), with another raster backend → u8 frame as numpy."""
    from ..runtime import HeadlessRuntime
    from ..runtime.setup import SceneBuild

    cfg = copy.deepcopy(rt.config)
    cfg.tpu.raster_backend = raster_backend
    sim = rt.sim._replace(render=rt._initial_sim.render)
    other = HeadlessRuntime(SceneBuild(sim=sim, params=rt.params, info=rt.info), cfg)
    return other.render().cpu().numpy()


def golden(name: str):
    from ..utils.image import load_png

    return load_png(SNAPSHOT_DIR / f"{name}.png")


def score(name: str, img) -> float:
    """rgb_hybrid_compare of a frame against the scene's golden."""
    from ..utils.image import rgb_hybrid_compare

    return rgb_hybrid_compare(img, golden(name))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="scene names (default: every ported scene)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..utils.image import rgb_hybrid_compare, save_png

    names = args.scenes or [n for n, _ in PORTED_SCENES]
    for n in names:
        if n not in dict(ALL_SCENES):
            ap.error(f"unknown scene {n!r}")
    failures = []
    for name in names:
        t0 = time.perf_counter()
        img, rt = render_scene(name, args.device)
        s = score(name, img)
        parity = rgb_hybrid_compare(img, render_again(rt, "raster"))
        ok = s >= MIN_SCORE_TO_PASS and parity >= RASTER_PARITY_BAR
        print(f"[{'PASS' if ok else 'FAIL'}] {name}: score {s:.4f} (min {MIN_SCORE_TO_PASS}), "
              f"vs the plain tile raster {parity:.4f} (min {RASTER_PARITY_BAR}), K1 drops "
              f"(geometry, shadows) {rt.last_drops}, {time.perf_counter() - t0:.1f} s",
              flush=True)
        if not ok:
            FAILED_DIR.mkdir(parents=True, exist_ok=True)
            save_png(FAILED_DIR / f"{name}_failed.png", img)
            failures.append(name)
    if failures:
        print(f"FAILED scenes: {failures}")
        return 1
    print("all snapshot scenes passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
