"""Profile engine steps of the bench configurations on one NVIDIA GPU.

    python -m impact_tpu_torch.profile_step
        [--what tumbler|fracture|chunked64|chunked128|game] [--steps 5]
        [--trace trace.json] [--top 20]

``tumbler`` steps the bench tumbler (``models/bench.py:bench_step_scene``,
fracturing off); ``fracture`` takes steady steps of the fracture bench
before its event; ``chunked64`` and ``chunked128`` step the filled chunked
bench scene (``bench_chunked_fill_scene``: the asteroid filling its 64³ or
128³ grid under the bench's carving absorber, fracturing off); ``game``
steps the Voxel Range game's world (``apps/impact_game.py``) past its
fracture events (100 warm-up steps: the targets shatter on landing and
their fragments fill the 24 object slots). Two warm-up steps (100 for
``game``), then --steps steps timed one by one
(wall ms after ``torch.cuda.synchronize``), then the same number under
``torch.profiler``. Prints the card (nvidia-smi name, power.limit), the
median step, the host syncs per step, the device memory allocated once
the scene is built and at its peak over the timed steps, the device busy
share and the CUDA kernels by total device time. The busy share is the profiled kernel time
per step over the median step measured without the profiler (the
profiler's host overhead stretches the profiled steps, not the kernels).
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=("tumbler", "fracture", "chunked64", "chunked128", "game"),
                    default="tumbler")
    ap.add_argument("--steps", type=int, default=5, help="steps timed, then profiled")
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the profiled steps")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from .models import bench
    from .runtime import HeadlessRuntime, compile_scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if args.what == "fracture":
        cfg = bench.bench_fracture_config()
        rt = HeadlessRuntime(compile_scene(bench.bench_fracture_scene(), cfg), cfg)
    elif args.what.startswith("chunked"):
        g = int(args.what[len("chunked"):])
        cfg = bench.bench_chunked_config(g)
        rt = HeadlessRuntime(compile_scene(bench.bench_chunked_fill_scene(g), cfg), cfg,
                             enable_fracturing=False)
    elif args.what == "game":
        from .apps import impact_game

        cfg = impact_game.range_config()
        rt = HeadlessRuntime(compile_scene(impact_game.build_range_world(), cfg), cfg)
    else:
        cfg = bench.bench_config()
        rt = HeadlessRuntime(compile_scene(bench.bench_step_scene(), cfg), cfg,
                             enable_fracturing=False)
    rt.step(100 if args.what == "game" else 2)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, syncs = [], rt.host_syncs
    for _ in range(args.steps):
        rt.step(1)
        times.append(rt.step_ms)
    step_ms = statistics.median(times)
    print(f"{args.what} step: median {step_ms:.3f} ms, runs {times}, "
          f"{(rt.host_syncs - syncs) / args.steps:.2f} host syncs per step", flush=True)
    print(f"device memory: {resident} B allocated after the warm-up steps, peak "
          f"{torch.cuda.max_memory_allocated()} B over the timed steps", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.step(args.steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return getattr(e, name)
        return 0.0

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / args.steps
    n_launch = sum(e.count for e in kernels) / args.steps
    print(f"profiled {args.steps} steps: wall {wall_ms / args.steps:.3f} ms per step under the "
          f"profiler, CUDA kernel time {busy_ms:.3f} ms per step, {n_launch:.0f} kernel "
          f"launches per step", flush=True)
    print(f"device busy share {busy_ms / step_ms:.4f} of the unprofiled median step "
          f"({step_ms:.3f} ms)", flush=True)
    kernels.sort(key=dev_us, reverse=True)
    for e in kernels[: args.top]:
        print(f"  {dev_us(e) / 1e3 / args.steps:10.4f} ms/step  {e.count // args.steps:6d} "
              f"launches/step  {e.key[:100]}", flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
