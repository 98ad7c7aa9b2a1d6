"""The scan kernels' level walk against a serial walk of the same schedule,
and the operation latencies that their chain bound counts, on the card.

Run on the card from the repository root: ``python -m
impact_tpu_torch.devtools.probe_scan_walk``. Two parts:

1. Latencies (``scan_latency.cu``): one thread runs a chain of dependent
   operations of one kind (add.rn, mul.rn, clamp_min's compare and select,
   a select, sqrt.rn, div.rn through its divisor) between two clock64
   reads, at two lengths; the cycles per operation are the difference of
   the cycles over the difference of the lengths, the least of REPEATS
   runs. ``physics/scan_solver.py:OP_LATENCY_CYCLES`` holds them.
2. Serial walk: ``csrc/scan_solver.cu`` built with ``-DSCAN_SERIAL_WALK``
   walks the same schedule's placed nodes (the active slots and the runs;
   fixed bodies never stored, a tail on two fixed bodies dropped) in slot
   order with one thread and no barrier: the simple design, with only the
   parallel levels taken away. On ``chip_smoke.py``'s four recorded scan
   inputs it is held equal to the package's kernels, and both are timed
   alone (torch.profiler, 20 calls after 2) in turns: levels, serial,
   serial, levels.

Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

from .. import _build
from ..physics import scan_solver
from . import card_line

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
KINDS = ("add", "mul", "clamp", "select", "sqrt", "div")
# (x, y, flag) of each chain: values that stay finite and normal
START = {"add": (1.0, 1e-3, 1.0), "mul": (1.0, 1.0000001, 1.0), "clamp": (1.0, 0.5, 1.0),
         "select": (1.0, 0.5, 1.0), "sqrt": (2.0, 0.0, 1.0), "div": (1.5, 1.0, 1.0)}
ROUNDS = (64, 192)  # rounds of 32 operations
REPEATS = 5
KERNELS = ("scan_velocity_kernel", "scan_correction_kernel")


def build():
    """Compile scan_latency.cu, and csrc/scan_solver.cu with
    -DSCAN_SERIAL_WALK (two nvcc, started together) → (latency library,
    serial library), with argtypes declared."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {"latency": (HERE / "scan_latency.cu", []),
            "serial": (_build.CSRC / "scan_solver.cu", ["-DSCAN_SERIAL_WALK"])}
    outs, procs = {}, []
    for name, (src, flags) in jobs.items():
        out = _build.BUILD_DIR / f"probe_scan_{name}.{os.getpid()}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(out), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        outs[name] = out
    try:
        _build._run(procs)
        libs = {name: ctypes.CDLL(str(path)) for name, path in outs.items()}
    finally:
        for path in outs.values():
            path.unlink(missing_ok=True)
    fn = libs["latency"].scan_op_latency
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("scan_velocity_iterations", "scan_position_correction"):
        fn = getattr(libs["serial"], name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return libs["latency"], libs["serial"]


def op_latencies(lib, dev):
    """SM cycles of one dependent operation of each kind in KINDS."""
    out = torch.empty(1, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for kind, name in enumerate(KINDS):
        inp = torch.tensor(START[name], dtype=torch.float32, device=dev)

        def cycles(rounds):
            rc = lib.scan_op_latency(kind, inp.data_ptr(), out.data_ptr(), cyc.data_ptr(),
                                     rounds, stream)
            if rc != 0:
                raise RuntimeError(f"scan_op_latency({name}) failed: cudaError {rc}")
            torch.cuda.synchronize()
            if not math.isfinite(out.item()):
                raise AssertionError(f"the {name} chain left a value that is not finite")
            return cyc.item()

        cycles(ROUNDS[0])
        res[name] = min((cycles(ROUNDS[1]) - cycles(ROUNDS[0])) / (32 * (ROUNDS[1] - ROUNDS[0]))
                        for _ in range(REPEATS))
    return res


def serial_vs_levels(lib, inputs, kernel_ms):
    """Per input: the serial build held equal to the package's kernels, then
    both timed alone in turns (levels, serial, serial, levels)."""
    rows = {}
    for name, a in inputs.items():
        fns = {"levels": lambda a=a: scan_solver.scan_iterations(*a),
               "serial": lambda a=a: scan_solver._launch(lib, *a, False)}
        got = {who: fn() for who, fn in fns.items()}
        if not all(torch.equal(x, y) for x, y in zip(got["levels"], got["serial"])):
            raise AssertionError(f"scan {name}: the serial walk and the levels differ")
        ms = {"levels": [], "serial": []}
        vel = {"levels": [], "serial": []}
        for who in ("levels", "serial", "serial", "levels"):
            ms[who].append(kernel_ms(fns[who], KERNELS))
            vel[who].append(kernel_ms(fns[who], KERNELS[0]))
        prep = a[6]
        sch = scan_solver.scan_schedule(prep.body_a, prep.body_b, prep.active, a[4], a[5], a[3])
        rows[name] = dict(
            active=int(prep.active.sum()), slots=prep.active.shape[0],
            correction_nodes=int(prep.active.sum()) + sch.runs.shape[0],
            velocity_levels=sch.velocity_depth, correction_levels=sch.correction_depth,
            levels_ms=ms["levels"], serial_ms=ms["serial"],
            levels_velocity_ms=vel["levels"], serial_velocity_ms=vel["serial"])
        print(f"scan {name}: serial walk equal to the levels; kernels alone ms in turns: "
              f"levels {ms['levels']}, serial {ms['serial']} (velocity sweeps: levels "
              f"{vel['levels']}, serial {vel['serial']}); {rows[name]['active']} active "
              f"slots, {sch.velocity_depth} and {sch.correction_depth} levels", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_scan_walk: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    clock_hz = float(chip_smoke.card_query("clocks.max.sm").split()[0]) * 1e6
    lat_lib, serial_lib = build()
    lat = op_latencies(lat_lib, dev)
    chains = {loop: sum(k * lat[op] for op, k in ops.items()) for loop, ops in (
        ("velocity", scan_solver.VELOCITY_CHAIN_OPS),
        ("correction", scan_solver.CORRECTION_CHAIN_OPS))}
    print(f"dependent-operation latencies, SM cycles: {lat}; one slot's chain: {chains}",
          flush=True)
    inputs = chip_smoke.record_scan_phase_inputs(dev)
    rows = serial_vs_levels(serial_lib, inputs, chip_smoke.kernel_ms)
    for name, r in rows.items():
        a = inputs[name]
        r["chain_bound_ms"] = (a[8] * r["velocity_levels"] * chains["velocity"]
                               + a[9] * r["correction_levels"] * chains["correction"]
                               ) / clock_hz * 1e3
    print(json.dumps(dict(card=card, sm_clock_hz=clock_hz, op_latency_cycles=lat,
                          chain_cycles=chains, inputs=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
