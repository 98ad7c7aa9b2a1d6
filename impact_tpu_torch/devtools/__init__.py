"""Kernel probes of the port: the reference's TPU probes (``devtools/
probe_kernel_floor.py``, ``devtools/probe_kernel_ablate.py``) written again
as Hopper kernels with their plain PyTorch versions and entry points
(``python -m impact_tpu_torch.devtools.probe_kernel_floor`` and
``... .probe_kernel_ablate``, on the card), and ``probe_scan_walk``, the
scan kernels' level walk against a serial walk of the same schedule with
the operation latencies of their chain bound."""

from __future__ import annotations

import subprocess

import torch


def cuda_time_ms(fn, reps=10, warmup=2):
    """Mean ms per call of ``fn`` over ``reps`` calls between two CUDA
    events, after ``warmup`` calls."""
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


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
