"""The SDF voxel-object generator (port of ``apps/voxel_generator.py``;
ref: apps/voxel_generator, the reference's node-graph editor with live
voxel regeneration, preview, and graph save/load).

A headless CLI over the graph model of ``voxel/sdf.py`` (atomic graphs) and
``voxel/meta_sdf.py`` (meta graphs, lowered at a seed), both stored as
JSON files that the reference package's app reads and writes too. Graphs
are voxelized on a 48³ grid of 0.5-unit voxels and meshed with Surface
Nets; ``preview`` renders the mesh at 320x240 with AO and no shadows or
TAA through ``render_frame``, so on the card through the tile raster
kernel K1. It runs on the card unless ``--device cpu`` is given.

    python -m impact_tpu_torch.apps.voxel_generator example out.json
    python -m impact_tpu_torch.apps.voxel_generator stats graph.json
    python -m impact_tpu_torch.apps.voxel_generator preview graph.json out.png
    python -m impact_tpu_torch.apps.voxel_generator vary graph.json outdir [N]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

GRID, EXTENT = 48, 0.5
WIDTH, HEIGHT = 320, 240


def example_graph():
    """A noisy rock with a capsule spike, smoothly joined."""
    from ..voxel import sdf

    rock = sdf.noise_modifier(sdf.sphere(9.0), octaves=4, frequency=0.25, persistence=0.55,
                              amplitude=1.8, seed=7)
    spike = sdf.translation(sdf.capsule(1.5, 10.0), (0.0, 6.0, 0.0))
    return sdf.union(rock, spike, smoothness=1.5)


def cmd_example(path):
    from ..voxel import sdf

    sdf.save_graph(path, example_graph())
    print(f"wrote {path}")


def lower_any(node, seed: int = 0):
    """An atomic graph as it is (validated), or a meta graph lowered with
    ``seed``."""
    from ..voxel import meta_sdf, sdf

    if isinstance(node, dict) and str(node.get("kind", "")).startswith("meta_"):
        return meta_sdf.lower(node, seed=seed)
    return sdf.validate(node)


def load_any_graph(path, seed: int = 0):
    with open(path, "r", encoding="utf-8") as f:
        return lower_any(json.load(f), seed)


def voxelize(graph, device="cuda", grid_size: int = GRID, extent: float = EXTENT):
    """(f32 SDF grid [G,G,G], origin [3], SurfaceNetsMesh) of a graph."""
    import torch

    from ..voxel.mesh import surface_nets
    from ..voxel.object import generate_sdf_grid

    s, origin = generate_sdf_grid(graph, grid_size, extent, device=device)
    mesh = surface_nets(s, torch.zeros((grid_size,) * 3, dtype=torch.int32, device=device))
    return s, origin, mesh


def stats(graph, device="cuda", grid_size: int = GRID, extent: float = EXTENT) -> dict:
    """The solid voxels, vertices and triangles of a graph's voxelization,
    its ``stats`` line, and the SDF grid they come from."""
    from ..voxel.mesh import mesh_counts

    s, _, mesh = voxelize(graph, device, grid_size, extent)
    nv, nt = mesh_counts(mesh)
    out = dict(solid=int((s < 0).sum()), vertices=int(nv), triangles=int(nt), sdf=s)
    out["line"] = (f"grid {grid_size}³ @ {extent}: {out['solid']} solid voxels, "
                   f"{out['vertices']} vertices, {out['triangles']} triangles")
    return out


def cmd_stats(path, grid_size: int = GRID, extent: float = EXTENT, device="cuda"):
    print(stats(load_any_graph(path), device, grid_size, extent)["line"])


def preview_frame(graph, device="cuda", raster_backend: str = "kernel", grid_size: int = GRID,
                  extent: float = EXTENT):
    """The graph's mesh rendered at WIDTH x HEIGHT → u8 [H,W,3] on
    ``device``: ambient and one directional light, AO, no shadows or TAA;
    ``raster_backend`` "kernel" is K1, "raster" the plain tile raster."""
    import torch

    from ..render.camera import Camera, look_at
    from ..render.lights import empty_light_pools
    from ..render.pipeline import RenderConfig, init_render_state, render_frame
    from ..scene.assembly import render_scene_from_indexed

    dev = torch.device(device)
    _, origin, mesh = voxelize(graph, dev, grid_size, extent)
    verts = mesh.vert_pos * extent + origin
    v = verts.shape[0]
    scene = render_scene_from_indexed(
        verts, mesh.vert_normal,
        torch.tensor([[0.55, 0.45, 0.38]], device=dev).repeat(v, 1),
        torch.full((v, 3), 0.04, device=dev), torch.full((v,), 0.8, device=dev),
        torch.zeros((v, 3), device=dev), torch.full((v,), -1, dtype=torch.int32, device=dev),
        mesh.tri_indices, mesh.tri_active)
    lights = empty_light_pools(1, 1, device=dev)
    sun = torch.tensor([-0.4, -0.75, -0.5], device=dev)
    lights = lights._replace(
        ambient_luminance=torch.tensor([1500.0, 1600.0, 1900.0], device=dev),
        uni_direction=(sun / torch.linalg.vector_norm(sun))[None],
        uni_illuminance=torch.tensor([[35000.0, 33000.0, 30000.0]], device=dev),
        uni_mask=torch.ones(1, dtype=torch.bool, device=dev))
    r = grid_size * extent
    eye = (1.6 * r, 1.0 * r, 1.9 * r)
    cam = Camera(torch.tensor(eye, device=dev), look_at(eye, (0.0, 0.0, 0.0)).to(dev),
                 torch.tensor(math.pi / 3, device=dev), torch.tensor(0.1, device=dev),
                 torch.tensor(20.0 * r, device=dev))
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, shadows_enabled=False, taa_enabled=False,
                       ao_enabled=True, sky_luminance=(2500.0, 3500.0, 7000.0),
                       raster_backend=raster_backend)
    img, _, _ = render_frame(scene, lights, cam, cam, init_render_state(cfg, dev), cfg)
    return img


def cmd_preview(path, out_png, grid_size: int = GRID, extent: float = EXTENT, device="cuda"):
    from ..utils.image import save_png

    img = preview_frame(load_any_graph(path), device, grid_size=grid_size, extent=extent)
    save_png(out_png, img.cpu().numpy())
    print(f"wrote {out_png}")


def cmd_vary(path, out_dir, n: int = 4, device="cuda"):
    """Render ``n`` seed variations of a graph (a meta graph resamples its
    distributions at each seed; an atomic graph renders the same each
    time): the headless analog of the editor's stochastic exploration."""
    from ..utils.image import save_png

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for seed in range(n):
        png = out / f"variant_{seed}.png"
        save_png(png, preview_frame(load_any_graph(path, seed), device).cpu().numpy())
        print(f"wrote {png}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="SDF voxel-object generator.")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("example", help="write the example graph").add_argument("out")
    sub.add_parser("stats", help="voxel and mesh counts of a graph").add_argument("graph")
    p = sub.add_parser("preview", help="render a graph to a PNG")
    p.add_argument("graph")
    p.add_argument("out")
    p = sub.add_parser("vary", help="render N seed variants of a graph")
    p.add_argument("graph")
    p.add_argument("out_dir")
    p.add_argument("n", nargs="?", type=int, default=4)
    args = ap.parse_args(argv)
    if args.cmd == "example":
        cmd_example(args.out)
    elif args.cmd == "stats":
        cmd_stats(args.graph, device=args.device)
    elif args.cmd == "preview":
        cmd_preview(args.graph, args.out, device=args.device)
    else:
        cmd_vary(args.graph, args.out_dir, args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
