#!/usr/bin/env python3
"""Profile 1080p bench frames of the PyTorch/CUDA port on one NVIDIA GPU.

    python devtools/torch_profile_frame.py [--frames 3] [--trace frame_trace.json]

Renders the bench configuration (impact_tpu_torch/models/bench.py) through
HeadlessRuntime.render: two warm-up frames, then --frames frames timed per
stage (wall ms after torch.cuda.synchronize), then the same number of frames
under torch.profiler. Prints the card (nvidia-smi name, power.limit), the
median stage times, the device busy share and the CUDA kernels by total
device time. The busy share is the profiled CUDA kernel time per frame over
the median frame time measured without the profiler: the profiler's own
host overhead stretches the profiled frames' wall time (printed beside it),
not the kernels. Kernels run on one stream, so they do not overlap. Imports no
JAX; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the profiled frames")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from impact_tpu_torch.models.bench import bench_config, bench_scene
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    cfg = bench_config()
    rt = HeadlessRuntime(compile_scene(bench_scene(), cfg, device="cuda"), cfg)
    for _ in range(2):
        rt.render()
    rows = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        rt.render()
        torch.cuda.synchronize()
        rows.append(dict(rt.stage_ms, frame=(time.perf_counter() - t0) * 1e3))
    for k in rows[0]:
        vals = [r[k] for r in rows]
        print(f"stage {k}: median {statistics.median(vals):.3f} ms  runs {vals}", flush=True)
    frame_ms = statistics.median(r["frame"] for r in rows)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            rt.render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return getattr(e, name)
        return 0.0

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / args.frames
    n_launch = sum(e.count for e in kernels) / args.frames
    print(f"profiled {args.frames} frames: wall {wall_ms / args.frames:.3f} ms per frame "
          f"under the profiler, CUDA kernel time {busy_ms:.3f} ms per frame, "
          f"{n_launch:.0f} kernel launches per frame", flush=True)
    print(f"device busy share {busy_ms / frame_ms:.4f} of the unprofiled median frame "
          f"({frame_ms:.3f} ms)", flush=True)
    kernels.sort(key=dev_us, reverse=True)
    for e in kernels[: args.top]:
        print(f"  {dev_us(e) / 1e3 / args.frames:10.4f} ms/frame  {e.count // args.frames:6d} "
              f"launches/frame  {e.key[:100]}", flush=True)
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
