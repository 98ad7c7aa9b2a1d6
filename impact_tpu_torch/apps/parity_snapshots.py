"""Reference-parity snapshots of the port: the reference snapshot tester's 13
scenes (``models/parity_scenes.py``) rendered by ``impact_tpu_torch`` and
scored against golden PNGs (port of ``apps/parity_snapshots.py``; ref:
apps/snapshot_tester/src/testing.rs:20-108, config/config.ron
min_score_to_pass 0.95).

Each scene is compiled with the reference harness's overrides
(``parity_config``: 768x512, one voxel object of 16³, 8 bodies, 16 mesh
entities, 16384 triangles, the scene's feature switches, a black sky) and
rendered once through K1 on the card. A frame with raster drops fails the
run: its score would measure an incomplete render.

The base configuration is ``--config PATH`` when given, else the reference
checkout's ``engine_config.ron`` where it exists, else ``EngineConfig()``.
The goldens are ``--golden-dir`` when given, else the reference checkout's
goldens where they exist, else the repo's committed JAX renders in
``apps/snapshots/parity/``. The reference checkout's paths are the ones the
reference harness names (``REF_CONFIG``, ``REF_DIR`` in
``apps/parity_snapshots.py``). The run prints which configuration and
which goldens it used. Frames go to ``--out-dir`` (``parity_out/``, which
git ignores), never into ``apps/snapshots``.

    python -m impact_tpu_torch.apps.parity_snapshots                    # on the card
    python -m impact_tpu_torch.apps.parity_snapshots --device cpu --scene Bloom
"""

from __future__ import annotations

import argparse
import ast
import copy
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
REFERENCE_HARNESS = REPO / "apps" / "parity_snapshots.py"
JAX_RENDERS = REPO / "apps" / "snapshots" / "parity"
OUT_DIR = pathlib.Path("parity_out")
MIN_SCORE = 0.95  # ref: config.ron min_score_to_pass
WIDTH, HEIGHT = 768, 512


def reference_paths() -> dict:
    """The reference checkout's config and golden paths as the reference
    harness names them (its ``REF_CONFIG`` and ``REF_DIR``), read from its
    source without running it; empty where the harness is not beside the
    port."""
    if not REFERENCE_HARNESS.exists():
        return {}
    paths = {}
    for node in ast.parse(REFERENCE_HARNESS.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id in ("REF_CONFIG", "REF_DIR"):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                    paths[node.targets[0].id] = pathlib.Path(sub.value)
                    break
    return paths


def load_base_config(path=None):
    """(EngineConfig, where it came from): ``path``, else the reference
    checkout's engine_config.ron where it exists, else the defaults."""
    from ..utils.config import EngineConfig

    if path is None:
        ref = reference_paths().get("REF_CONFIG")
        if ref is not None and ref.exists():
            path = ref
    if path is None:
        return EngineConfig(), "EngineConfig() (no engine_config.ron found)"
    return EngineConfig.from_ron_file(path), str(path)


def golden_dir(path=None):
    """(directory, label) of the goldens to score against."""
    if path is not None:
        return pathlib.Path(path), f"{path} (given)"
    ref = reference_paths().get("REF_DIR")
    if ref is not None and ref.exists():
        return ref, f"{ref} (the reference's goldens)"
    return JAX_RENDERS, f"{JAX_RENDERS} (the repo's committed JAX renders, not the reference's)"


def parity_config(name: str, cfg):
    """``cfg`` with the reference harness's overrides for scene ``name``
    (apps/parity_snapshots.py:50-72), in place; returns it."""
    from ..models.parity_scenes import PARITY_SCENES

    _, feats = PARITY_SCENES[name]
    t = cfg.tpu
    t.render_width, t.render_height = WIDTH, HEIGHT
    t.max_voxel_objects = 1
    t.max_bodies = 8
    t.voxel_grid_size = 16
    t.max_mesh_entities = 16
    t.max_render_triangles = 16384
    # per-scene feature switches (ref: testing.rs prepare_settings)
    r = cfg.rendering
    if feats.get("shadows"):
        r.shadow_mapping.enabled = True
    if feats.get("ao"):
        r.ambient_occlusion.enabled = True
    if feats.get("bloom"):
        r.capturing_camera.bloom.enabled = True
    if "tone" in feats:
        r.capturing_camera.dynamic_range_compression.tone_mapping_method = feats["tone"]
    t.sky_luminance = (0.0, 0.0, 0.0)  # no skybox in these scenes
    t.csm_cascades = feats.get("csm", 1)
    t.soft_shadows = bool(feats.get("soft"))
    return cfg


def build_runtime(name: str, cfg=None, device="cuda"):
    """The scene's HeadlessRuntime with the harness's overrides applied to a
    copy of ``cfg`` (default: ``load_base_config()``'s), fracturing,
    absorption and splitting off as in the reference harness."""
    from ..models.parity_scenes import PARITY_SCENES
    from ..runtime import HeadlessRuntime, compile_scene

    cfg = parity_config(name, copy.deepcopy(cfg) if cfg is not None else load_base_config()[0])
    builder, _ = PARITY_SCENES[name]
    build = compile_scene(builder(), cfg, device=device)
    return HeadlessRuntime(build, cfg, enable_fracturing=False, enable_absorption=False,
                           enable_splitting=False)


def run(names, cfg=None, device="cuda", goldens=JAX_RENDERS, out_dir=OUT_DIR):
    """Render and score each scene → (scores, drops). Raises AssertionError
    when a frame has raster drops."""
    from ..utils.image import load_png, rgb_hybrid_compare, save_png

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    scores, drops = {}, {}
    for name in names:
        t0 = time.perf_counter()
        rt = build_runtime(name, cfg, device)
        img = rt.render().cpu().numpy()
        drops[name] = rt.dropped_raster_candidates()
        if drops[name] != 0:
            raise AssertionError(f"{name}: {drops[name]} raster candidates dropped; the "
                                 f"score would measure an incomplete render")
        ref = load_png(pathlib.Path(goldens) / f"{name}.png")[..., :3]
        scores[name] = rgb_hybrid_compare(img, ref)
        save_png(out_dir / f"{name}.png", img)
        diff = abs(img.astype("int16") - ref.astype("int16")).astype("uint8")
        save_png(out_dir / f"{name}.diff.png", diff)
        print(f"[parity] {name}: {scores[name]:.4f} "
              f"({'PASS' if scores[name] >= MIN_SCORE else 'fail'}) drops={drops[name]} "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return scores, drops


def main(argv=None) -> int:
    from ..models.parity_scenes import PARITY_SCENES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", action="append", default=None,
                    help="a scene name (repeatable; default: all 13)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--config", default=None, help="an engine_config.ron to start from")
    ap.add_argument("--golden-dir", default=None, help="the directory of golden PNGs")
    ap.add_argument("--out-dir", default=str(OUT_DIR),
                    help="where the frames, diffs and PARITY.json go")
    args = ap.parse_args(argv)
    names = args.scene or list(PARITY_SCENES)
    for n in names:
        if n not in PARITY_SCENES:
            ap.error(f"unknown scene {n!r}")
    cfg, cfg_label = load_base_config(args.config)
    goldens, golden_label = golden_dir(args.golden_dir)
    print(f"[parity] config: {cfg_label}", flush=True)
    print(f"[parity] goldens: {golden_label}", flush=True)
    scores, drops = run(names, cfg, args.device, goldens, args.out_dir)
    summary = {
        "scenes": {k: round(v, 4) for k, v in scores.items()},
        "n_pass": sum(1 for s in scores.values() if s >= MIN_SCORE),
        "n_total": len(scores),
        "min_score_to_pass": MIN_SCORE,
        "raster_drops": drops,
        "config": cfg_label,
        "goldens": golden_label,
        "device": args.device,
    }
    with open(pathlib.Path(args.out_dir) / "PARITY.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
