#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``impact_tpu_torch/csrc`` (one nvcc
call), checks the tile rasterizer K1 against its plain PyTorch version,
renders the bench scene (62 voxel boxes of 26³ voxels in 64 slots of 32³ i8
grids; 1920x1080, shadow maps 512², AO, TAA, bloom, ACES) through
``HeadlessRuntime.render`` and checks the frames. Every phase prints one
flushed line with its seconds; any failure exits non-zero. The last lines
are a ``{"kernels": [...]}`` record and the ``{"ok": true, ...}`` result.
It needs a CUDA device and the rest of the repository beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
# K1 evaluates its planes with the same float32 rounding as the plain
# version, so on the same inputs depth, valid and z must be equal and the
# interpolated and nearest-corner attributes within ATTR_ATOL
# (tests/test_torch_k1_cuda.py holds the same bars)
ATTR_ATOL = 1e-5
# frame parity between two implementations (the repo's parity bar)
PARITY_BAR = 0.95


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints ``[phase] name ... ok (s)`` around a block; failures propagate."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[phase] {self.name} ...")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        log(f"[phase] {self.name} {'ok' if exc_type is None else 'FAILED'} ({dt:.2f} s)")
        return False


def cuda_time_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_k1(got, ref, n_attr, what):
    """Hold one K1 launch against its plain version; returns the max abs error
    over every output and pixel."""
    import torch

    if n_attr == 0:
        got, ref = (got,), (ref,)
        exact = (0,)
    else:
        exact = (2, 3)  # z, valid; interp (0) and near (1) within ATTR_ATOL
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{what}: output {i} is {tuple(g.shape)} {g.dtype}, "
                                 f"plain {tuple(r.shape)} {r.dtype}")
        d = (g.float() - r.float()).abs()
        e = d.max().item() if d.numel() else 0.0
        err = max(err, e)
        bad = int((d > 0).sum()) if i in exact else int((d > ATTR_ATOL).sum())
        if bad or (i in exact and not torch.equal(g, r)):
            raise AssertionError(f"{what}: output {i} differs from the plain version at "
                                 f"{bad} entries (max abs err {e:.3g})")
    return err


def main() -> int:
    t_all = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs an NVIDIA GPU",
              file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, HERE)
    try:
        import impact_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the impact_tpu_torch package is not beside this script: {e}",
              file=sys.stderr, flush=True)
        return 3
    pkg_dir = os.path.dirname(os.path.abspath(impact_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print(f"chip_smoke: impact_tpu_torch comes from {pkg_dir}, not from {HERE}",
              file=sys.stderr, flush=True)
        return 3

    from impact_tpu_torch import _build
    from impact_tpu_torch.models.bench import HEIGHT, WIDTH, bench_config, bench_scene
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.geometry.projection import perspective_projection_matrix
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.utils.image import rgb_hybrid_compare

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    record = {}

    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        log(f"device: {kind} (count {count}); torch {torch.__version__}, "
            f"cuda {torch.version.cuda}, python {sys.version.split()[0]}")
        log("card (nvidia-smi name, power.limit):")
        log(smi)

    with Phase("kernel build"):
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.load()
        log(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
            f"(nvcc {_build.build_seconds:.2f} s)")

    log(f"K1 vs plain version: depth, z and valid equal; interp and near within atol "
        f"{ATTR_ATOL}; drops equal")
    with Phase("K1 vs plain version, 256x256, 3000 seeded triangles"):
        rng = np.random.default_rng(0)
        n = 3000
        centers = rng.uniform([-2.5, -2.5, -8.0], [2.5, 2.5, -2.0], size=(n, 1, 3))
        corners = centers + rng.uniform(0.05, 0.5, (n, 1, 1)) * rng.normal(size=(n, 3, 3))
        corners[:8, 2, 2] = 1.0  # near-plane crossings
        pos9 = torch.tensor(corners.reshape(n, 9), dtype=torch.float32, device=dev)
        active = torch.tensor(rng.uniform(size=n) < 0.9, device=dev)
        attrs = torch.tensor(rng.normal(size=(n, 60)), dtype=torch.float32, device=dev)
        vp = perspective_projection_matrix(1.0, 1.0, 0.1, 100.0, device=dev)
        bd = rp.bin_depth_pos(pos9, active, vp, 256, 256, tile=32, k_per_range=256,
                              cull_backfaces=False)
        ba, a_dim = rp.bin_attributes_pos(pos9, active, attrs, vp, 256, 256, tile=32,
                                          k_per_range=256, cull_backfaces=False)
        d_k, d_p = rp.raster_depth(bd), rp.raster_depth_plain(bd)
        a_k, a_p = rp.raster_attributes(ba, a_dim), rp.raster_attributes_plain(ba, a_dim)
        torch.cuda.synchronize()
        err_d = compare_k1(d_k, d_p, 0, "depth 256x256")
        err_a = compare_k1(a_k, a_p, a_dim, "attributes 256x256")
        covered = (d_k < 1.0).float().mean().item()
        if covered == 0.0 or not bool(a_k[3].any()):
            raise AssertionError("the 256x256 soup covers no pixel")
        ms_d = cuda_time_ms(lambda: rp.raster_depth(bd))
        ms_dp = cuda_time_ms(lambda: rp.raster_depth_plain(bd), reps=3, warmup=1)
        ms_a = cuda_time_ms(lambda: rp.raster_attributes(ba, a_dim))
        ms_ap = cuda_time_ms(lambda: rp.raster_attributes_plain(ba, a_dim), reps=3, warmup=1)
        log(f"K1 depth 256x256: coverage {covered:.4f}, max abs err {err_d:.3g}, "
            f"drops {int(bd.n_drop)}; kernel {ms_d:.4f} ms, plain {ms_dp:.4f} ms")
        log(f"K1 attributes 256x256: coverage {a_k[3].float().mean().item():.4f}, "
            f"max abs err {err_a:.3g}, "
            f"drops {int(ba.n_drop)}; kernel {ms_a:.4f} ms, plain {ms_ap:.4f} ms")

    with Phase("scene build (bench tumbler: 62 boxes of 26^3 voxels, 64 slots, 32^3 i8)"):
        cfg = bench_config(WIDTH, HEIGHT)
        scene_spec = bench_scene()
        build = compile_scene(scene_spec, cfg, device=dev)
        torch.cuda.synchronize()
        n_tris = int(build.meshes.tri_active.sum())
        log(f"scene: {build.info['n_voxel_objects']} voxel objects, {n_tris} active "
            f"triangles, {int(build.meshes.n_dropped_tris.sum())} dropped by mesh caps")
        if n_tris == 0:
            raise AssertionError("the bench scene meshed to no triangles")

    with Phase("three frames at 1920x1080 through HeadlessRuntime.render"):
        rt = HeadlessRuntime(build, cfg)
        rp.LAUNCHES.reset()
        stage_rows = []
        for i in range(3):
            t0 = time.perf_counter()
            img = rt.render()
            torch.cuda.synchronize()
            stage_rows.append(dict(rt.stage_ms, frame=(time.perf_counter() - t0) * 1e3))
            if i == 0:
                first_frame = img.cpu().numpy()
            log(f"frame {i}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in stage_rows[-1].items())
                + f"; cumulative raster drops {rt.dropped_raster_candidates()}")
        launches = dict(rp.LAUNCHES)
        log(f"K1 launches over the three frames: {launches}")
        for name, cnt in launches.items():
            if cnt <= 0:
                raise AssertionError(f"{name} was not launched on the main path")
        hdr = rt.last_hdr
        if not bool(torch.isfinite(hdr).all()):
            raise AssertionError("non-finite HDR luminance")
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"image {tuple(img.shape)} {img.dtype}")
        mean = img.float().mean().item()
        if not (0.0 < mean < 255.0) or img.float().std().item() < 1.0:
            raise AssertionError(f"image is flat (mean {mean:.2f})")
        coverage = rt.last_gbuffer.valid.float().mean().item()
        log(f"image mean {mean:.2f}, G-buffer coverage {coverage:.4f}")
        record["frames"] = stage_rows
        record["drops_after_3_frames"] = rt.dropped_raster_candidates()

    with Phase("K1 vs plain version on every view of one more 1080p frame"):
        # record the prologue outputs K1 is launched on in a 4th frame (the
        # launches above were already counted), then hold each launch against
        # the plain version on the same inputs and time both
        views = {"k1_raster_attributes": [], "k1_raster_depth": []}
        run_depth, run_attr = rp.raster_depth, rp.raster_attributes

        def rec_depth(b):
            views["k1_raster_depth"].append((b, 0))
            return run_depth(b)

        def rec_attr(b, n_attr):
            views["k1_raster_attributes"].append((b, n_attr))
            return run_attr(b, n_attr)

        rp.raster_depth, rp.raster_attributes = rec_depth, rec_attr
        try:
            rt.render()
        finally:
            rp.raster_depth, rp.raster_attributes = run_depth, run_attr
        kernels = []
        for name, recorded in views.items():
            errs, ms, plain_ms, bounds, bound_by = [], [], [], [], []
            for i, (b, n_attr) in enumerate(recorded):
                if n_attr:
                    def kern(b=b, n=n_attr):
                        return rp.raster_attributes(b, n)

                    def plain(b=b, n=n_attr):
                        return rp.raster_attributes_plain(b, n)

                    got = kern()
                    cover = got[3].float().mean().item()
                else:
                    def kern(b=b):
                        return rp.raster_depth(b)

                    def plain(b=b):
                        return rp.raster_depth_plain(b)

                    got = kern()
                    cover = (got < 1.0).float().mean().item()
                err = compare_k1(got, plain(), n_attr, f"{name} view {i}")
                errs.append(err)
                ms.append(cuda_time_ms(kern))
                plain_ms.append(cuda_time_ms(plain, reps=3, warmup=1))
                bnd, by = rp.bound_ms(b, n_attr)
                bounds.append(bnd)
                bound_by.append(by)
                n_cand = int(b.ranges[:, 4:].sum())
                log(f"{name} view {i} ({b.height}x{b.width}): {n_cand} window candidates, "
                    f"{int(b.big_have.sum())} big, drops {int(b.n_drop)}; coverage {cover:.6f}, "
                    f"max abs err {err:.3g}; kernel {ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f} ms, "
                    f"bound {bnd:.4f} ms ({by})")
            n = len(recorded)
            kernels.append(dict(
                name=name, route="cuda", source="impact_tpu_torch/csrc/raster.cu",
                replaces="impact_tpu/render/raster_pallas.py:495", launches=launches[name],
                max_abs_err=max(errs), ms=sum(ms) / n, plain_ms=sum(plain_ms) / n,
                bound_ms=sum(bounds) / n,
                bound_by=max(set(bound_by), key=bound_by.count), library_ms=None))
            log(f"{name}: {n} launches per frame, mean kernel {sum(ms) / n:.4f} ms, "
                f"plain {sum(plain_ms) / n:.4f} ms, bound {sum(bounds) / n:.4f} ms")

    with Phase("1080p frame 0: K1 path vs the plain tile raster (render/raster.py) on the card"):
        cfg_r = bench_config(WIDTH, HEIGHT, "raster")
        r = HeadlessRuntime(build, cfg_r)
        img_r = r.render().cpu().numpy()
        log("1080p raster: " + ", ".join(f"{k} {v:.2f} ms" for k, v in r.stage_ms.items()))
        score = rgb_hybrid_compare(first_frame, img_r)
        log(f"1080p rgb_hybrid_compare(K1 path, plain tile raster) = {score:.6f} "
            f"(bar {PARITY_BAR})")
        record["parity_1080p_vs_tile_raster"] = score
        if score < PARITY_BAR:
            raise AssertionError(f"1080p parity {score:.4f} < {PARITY_BAR}")

    with Phase("480x270 frame: kernel on the card vs K1's plain version on the CPU"):
        torch.set_num_threads(os.cpu_count() or 8)
        c = bench_config(480, 270)
        small, drops = {}, {}
        for where in ("cuda", "cpu"):
            r = HeadlessRuntime(compile_scene(scene_spec, c, device=where), c)
            small[where] = r.render().cpu().numpy()
            drops[where] = r.dropped_raster_candidates()
            log(f"480x270 on {where}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in r.stage_ms.items())
                + f"; raster drops {drops[where]}")
        score = rgb_hybrid_compare(small["cuda"], small["cpu"])
        log(f"480x270 rgb_hybrid_compare(kernel, plain version) = {score:.6f} (bar {PARITY_BAR})")
        record["parity_480x270_kernel_vs_plain"] = score
        if score < PARITY_BAR:
            raise AssertionError(f"480x270 parity {score:.4f} < {PARITY_BAR}")

    log(f"total wall time {time.perf_counter() - t_all:.1f} s")
    log("record: " + json.dumps(record))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        rc = 1
    sys.exit(rc)
