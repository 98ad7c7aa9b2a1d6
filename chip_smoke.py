#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``impact_tpu_torch/csrc`` (one nvcc
per source, all started together), checks the connected-component sweep
kernel K2 and the tile rasterizer K1 against their plain PyTorch versions,
then drives these paths through the port's entry points:

1. the bench scene's render (62 voxel boxes of 26³ voxels in 64 slots of
   32³ i8 grids; 1920x1080, shadow maps 512², AO, TAA, bloom, ACES) through
   ``HeadlessRuntime.render``, with frame checks;
2. the same bench scene stepped (``HeadlessRuntime.step``, jacobi at dt
   0.005) and rendered at 1080p (``step_and_render``);
3. the reference's fracture bench (a radius-5 voxel sphere at 18 m/s into a
   fracturable 14-voxel box; 208 slots, up to 192 fragments) stepped through
   its fracture event and the split detection after it, which runs the
   labels kernel (``connected_component_labels_batched``);
4. the labels kernel against its plain version and timed on the grids the
   fracture bench labelled and on batches at G = 39, 40, 48, 63 and 72
   (``connected_component_labels``), and the two-level labelling at 64³;
5. the sweep function ``ccl_sweeps`` (the port of ``ccl_propagate_sweeps``)
   on the fracture grids (K2) and at G = 39, 40, 48 and 63 (K2-wide);
6. the P1 probe ladder (``devtools.probe_kernel_floor.run_ladder``: five
   modes over the 8160 tiles of 1080p), each mode held against its plain
   version on the full output;
7. the P2 probe ablation (``devtools.probe_kernel_ablate.run_ablation``:
   six variants at 512² over 262,144 triangles), on the probe's own input
   (an empty frame) and with its clip z negated, each variant held against
   its plain version.

Kernel launch counts are zeroed just before each path and read just after
it. Every phase prints one flushed line with its seconds; any failure exits
non-zero. The last lines are a ``{"kernels": [...]}`` record and the
``{"ok": true, ...}`` result. It needs a CUDA device and the rest of the
repository beside it.

K1 is timed two ways on every view of a bench frame: the kernel's own device
time (``kernel_ms``: torch.profiler's device time of the kernel's launches,
which the ``kernels`` record reports as ``ms``; where the profiler records
none of the launches, CUDA events behind a busy stream, ``busy_events_ms``)
and the wrapper call between two CUDA events (``wrapper``), which also holds
the wrapper's host work.
``--k1-only`` stops after the K1 phases (the K1 parts of the record, then the
same last line), so two trees' K1 kernels can be timed in turns in one call.
``--ccl-only`` runs only the labelling: the fracture bench to record its
grids, then the two labels phases (CUDA events around the labels call, 20
calls after 2). It also runs on trees from before the labels kernel, to time
them in turns with this one; there the bound is not printed, and the labels
at G = 39 and 40 fail. ``--probes-only`` runs only the P1 and P2 phases,
so two trees' probe kernels can be timed in turns in one call; the
``kernels`` record gives their device time alone (``busy_events_ms``; P2's
empty frame is shorter than the wrapper's host work) and the wrapper's.
"""

from __future__ import annotations

import argparse
import json
import os
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
# K2 sweeps integer labels exactly as its plain version does: labels and
# sweep counts must be equal, after 16 sweeps and at the fixpoint
K2_SWEEPS = 16
# P2's TF32 variants against their plain version, which rounds the plane
# coefficients to TF32 as the tensor cores take them but sums in float32 in
# its own order: the repo's raster bars (tests/test_raster_pallas.py),
# coverage equal on this share of the pixels and z within RASTER_ATOL where
# both cover; the float32 variants must be equal
RASTER_COVER_SHARE = 0.99
RASTER_ATOL = 2e-3
TUMBLER_STEPS = 80
FRACTURE_MAX_STEPS = 400
STEPS_AFTER_EVENT = 8
# card vs CPU at reduced depth: the same uniforms go to both runs, but the
# card's sin/cos/pow round differently in the last bit, which can move a
# Voronoi near-tie voxel to its other seed; at most this share of the
# fractured voxels may sit in another slot
SMALL_FRAGMENTS = 12
MOVED_VOXEL_SHARE = 1e-3


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


def kernel_ms(fn, kernel, reps=20, warmup=2, events=True):
    """Mean device ms of one launch of the CUDA kernel whose name contains
    ``kernel``, from torch.profiler over ``reps`` calls of ``fn``, each of
    which launches it once: the kernel alone, without the wrapper's host
    work or any other launch.

    The profiler now and then loses launch records (1 of 20; in some runs
    all of them, in every profile of one kernel): the mean is taken over the
    recorded launches, and the profile is taken again when fewer than half
    were recorded. After three such profiles the time comes from
    ``busy_events_ms`` (device time of the whole call, which also holds any
    other launch of ``fn``) when ``events`` is true, else it is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel in e.key
                and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in hits)
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in hits)
        if reps // 2 <= n <= reps and us > 0.0:
            return us / n / 1e3
    if not events:
        log(f"kernel_ms: the profiler saw {n} launches of {kernel} ({us} us) in {reps} calls, "
            f"three times; not timed alone")
        return None
    ms = busy_events_ms(fn, reps)
    log(f"kernel_ms: the profiler saw {n} launches of {kernel} ({us} us) in {reps} calls, "
        f"three times; timed by CUDA events behind a busy stream instead: {ms:.4f} ms")
    return ms


def busy_events_ms(fn, reps=20, sleep_cycles=200_000_000):
    """Mean device ms per call of ``fn`` between two CUDA events, with the
    stream held busy (``torch.cuda._sleep``, about 0.1 s) while the host
    issues the start event and the ``reps`` calls, so that the calls run
    back to back and the events see device work only, not the wrapper's
    host work. Fails if the host took longer to issue than 20 ms, when
    the sleep may have ended before the calls were queued."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if issue_s > 0.02:
        raise AssertionError(f"busy_events_ms: the host took {issue_s * 1e3:.1f} ms to issue "
                             f"{reps} calls; the stream may have idled between them")
    return start.elapsed_time(end) / reps


def serpentine(g):
    """One 6-connected path snaking through the k = 0 plane: rows i = 0, 2, 4,
    ... joined at alternate ends; the labels need ~g²/2 sweeps to settle."""
    import numpy as np

    occ = np.zeros((g, g, g), bool)
    occ[0::2, :, 0] = True
    for i in range(1, g, 2):
        occ[i, g - 1 if (i // 2) % 2 == 0 else 0, 0] = True
    return occ


def check_k2(occ, what):
    """Hold K2 against its plain version after K2_SWEEPS sweeps and at the
    fixpoint on a bool batch [B,G,G,G]; returns (fixpoint sweep counts, max
    abs label error)."""
    import torch

    from impact_tpu_torch.ops import ccl_pallas as k2

    g = occ.shape[-1]
    lab0 = k2.initial_labels(occ)
    err = 0
    for n in (K2_SWEEPS, g ** 3):
        got, got_sw = k2.ccl_sweeps(occ, lab0, n)
        ref, ref_sw = k2.ccl_sweeps_plain(occ, lab0, n)
        torch.cuda.synchronize()
        err = max(err, int((got - ref).abs().max()))
        if not (torch.equal(got, ref) and torch.equal(got_sw, ref_sw)):
            bad = int((got != ref).sum())
            raise AssertionError(f"K2 {what}, {n} sweeps: {bad} labels differ from the plain "
                                 f"version (sweeps {got_sw.tolist()} vs {ref_sw.tolist()})")
    return got_sw, float(err)


def time_k2(occ, reps=20):
    """(kernel ms, plain ms, bound ms, bound_by, sweeps) of one fixpoint call."""
    from impact_tpu_torch.devtools import cuda_time_ms
    from impact_tpu_torch.ops import ccl_pallas as k2

    g = occ.shape[-1]
    lab0 = k2.initial_labels(occ)
    _, sweeps = k2.ccl_sweeps(occ, lab0, g ** 3)
    ms = cuda_time_ms(lambda: k2.ccl_sweeps(occ, lab0, g ** 3), reps=reps)
    plain = cuda_time_ms(lambda: k2.ccl_sweeps_plain(occ, lab0, g ** 3), reps=2, warmup=1)
    bound, by = k2.bound_ms(occ, sweeps)
    return ms, plain, bound, by, sweeps.tolist()


def labels_plain(occ):
    """The labels' plain version (``connected_component_labels_plain``): the
    fixpoint sweep, −1 where empty, spelled with the sweep function so that
    ``--ccl-only`` runs on trees without the labels kernel too."""
    import torch

    from impact_tpu_torch.ops import ccl_pallas as k2

    labels, _ = k2.ccl_sweeps_plain(occ, k2.initial_labels(occ), occ.shape[-1] ** 3)
    return torch.where(occ, labels, -1)


def checkerboard(g):
    """Every voxel with i + j + k even: each its own component."""
    import numpy as np

    i, j, k = np.indices((g, g, g))
    return (i + j + k) % 2 == 0


def wide_batch(g, dev):
    """Random fills 0.2/0.35/0.5 and the serpentine: bool [4,G,G,G]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(g)
    grids = [rng.uniform(size=(g, g, g)) < f for f in (0.2, 0.35, 0.5)]
    return torch.tensor(np.stack(grids + [serpentine(g)]), device=dev)


def edge_batch(g, dev):
    """Random fills 0.2/0.35/0.5/0.7, the serpentine, empty, full, the
    checkerboard and one voxel at each corner: bool [9,G,G,G]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(g)
    corners = np.zeros((g, g, g), bool)
    corners[::g - 1, ::g - 1, ::g - 1] = True
    grids = [rng.uniform(size=(g, g, g)) < f for f in (0.2, 0.35, 0.5, 0.7)]
    grids += [serpentine(g), np.zeros((g, g, g), bool), np.ones((g, g, g), bool),
              checkerboard(g), corners]
    return torch.tensor(np.stack(grids), device=dev)


def fracture_phase(dev, record, full=True):
    """Step the fracture bench through its fracture event and
    STEPS_AFTER_EVENT steps after it, recording every batch its split
    detection labels (at ``connected_component_labels_batched``, where
    ``voxel/interaction.py`` calls it). With ``full``, also render a frame
    and hold the launch counts: the labels kernel after the event, no sweep
    kernel. Returns (the non-empty recorded batches, labels launches)."""
    import torch

    from impact_tpu_torch.models.bench import bench_fracture_config, bench_fracture_scene
    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.voxel import interaction
    from impact_tpu_torch.voxel.object import nonempty_counts

    with Phase("fracture bench: step through the fracture event and the splits after it"):
        fcfg = bench_fracture_config()
        frt = HeadlessRuntime(compile_scene(bench_fracture_scene(), fcfg, device=dev), fcfg)
        grids = []
        run_labels = interaction.connected_component_labels_batched

        def rec_labels(occ):
            grids.append(occ.clone())
            return run_labels(occ)

        alive0 = int(frt.sim.voxels.alive.sum())
        log(f"fracture: {int(nonempty_counts(frt.sim.voxels).sum())} active voxels in "
            f"{alive0} objects")
        step_ms, event_step, peak = [], None, 0
        rp.LAUNCHES.reset()
        k2.LAUNCHES.reset()
        syncs0 = frt.host_syncs
        interaction.connected_component_labels_batched = rec_labels
        try:
            for i in range(1, FRACTURE_MAX_STEPS + 1):
                torch.cuda.reset_peak_memory_stats(dev)
                frt.step(1)
                step_ms.append(frt.step_ms)
                if int(frt.sim.voxels.alive.sum()) > alive0:
                    event_step = i
                    peak = torch.cuda.max_memory_allocated(dev)
                    break
            if event_step is None:
                raise AssertionError(f"no fracture event within {FRACTURE_MAX_STEPS} steps")
            n_fragments = int(frt.sim.voxels.alive.sum()) - alive0
            at_event = dict(k2.LAUNCHES)
            frt.step(STEPS_AFTER_EVENT)
            after_ms = frt.step_ms / STEPS_AFTER_EVENT
        finally:
            interaction.connected_component_labels_batched = run_labels
        torch.cuda.synchronize()
        fracture_launches = {**dict(rp.LAUNCHES), **dict(k2.LAUNCHES)}
        n_steps = event_step + STEPS_AFTER_EVENT
        syncs = (frt.host_syncs - syncs0) / n_steps
        steady = sorted(step_ms[-6:-1])[2] if len(step_ms) >= 6 else min(step_ms[:-1] or [0.0])
        pending = int(frt.sim.voxels.split_pending.sum())
        batches = [x for x in grids if x.shape[0] > 0]
        log(f"fracture: event at step {event_step}, {n_fragments} fragments "
            f"(alive {alive0} -> {alive0 + n_fragments}); event step {step_ms[-1]:.2f} ms, "
            f"steady step {steady:.2f} ms (median of the 5 before), event - steady "
            f"{step_ms[-1] - steady:.2f} ms; peak memory of the event step "
            f"{peak / 2**30:.3f} GiB; {STEPS_AFTER_EVENT} steps after it {after_ms:.2f} ms each, "
            f"{pending} objects still split-pending")
        log(f"fracture: {(event_step - 1) / (sum(step_ms[:-1]) / 1e3 or 1):.2f} steps/s before the "
            f"event; {syncs:.2f} host syncs per step; {len(grids)} labelling calls on "
            f"{sum(x.shape[0] for x in grids)} grids (batches {[x.shape[0] for x in grids]}); "
            f"launches at the event {at_event}, after {STEPS_AFTER_EVENT} more steps "
            f"{fracture_launches}")
        if n_fragments < 2:
            raise AssertionError(f"the event made {n_fragments} fragments")
        if not batches:
            raise AssertionError("the split detection labelled no grid")
        if not full:
            return batches, None
        labels_launches = k2.LAUNCHES["k2_labels"]
        if labels_launches - at_event["k2_labels"] <= 0:
            raise AssertionError("the labels kernel was not launched on the steps after the "
                                 "fracture event")
        if k2.LAUNCHES["k2_ccl"] or k2.LAUNCHES["k2_ccl_wide"]:
            raise AssertionError(f"the split detection launched a sweep kernel: "
                                 f"{fracture_launches}")
        if not body_state_finite(frt.sim):
            raise AssertionError("non-finite body state in the fracture bench")
        frt.render()
        torch.cuda.synchronize()
        geo_drops, shadow_drops = frt.last_drops
        log(f"fracture: 320x200 frame drops geometry {geo_drops} shadows {shadow_drops}; "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in frt.stage_ms.items()))
        record["fracture"] = dict(event_step=event_step, fragments=n_fragments,
                                  event_ms=step_ms[-1], steady_ms=steady,
                                  event_minus_steady_ms=step_ms[-1] - steady,
                                  peak_gib=peak / 2**30, after_event_ms=after_ms,
                                  host_syncs=syncs, launches=fracture_launches)
    return batches, labels_launches


def labels_phases(dev, batches, labels_launches, record, kernels):
    """The labels kernel against its plain version, exactly, and timed
    (``connected_component_labels_batched`` between CUDA events, 20 calls
    after 2; its plain version one call, or 2 after 1 on the timed batches)
    beside ``labels_bound_ms``, each pass's device time alone
    (torch.profiler) and the host's issue time per call: on the fracture
    grids, 48³ × 4 and 63³ × 4, 63³ × 4 full and checkerboard (the most and
    the fewest unions), then on nine edge grids each at G = 39, 40 and 72.
    Then the routed entry point at every flat G goes through the labels
    kernel alone, and no labelling call reads from the card."""
    import numpy as np
    import torch

    from impact_tpu_torch.devtools import cuda_time_ms
    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.voxel.interaction import connected_component_labels

    # trees from before the labels kernel have neither its bound nor its passes
    new_tree = hasattr(k2, "labels_bound_ms")
    rows, err = {}, 0

    def hold(name, occ, plain_reps):
        nonlocal err
        got = k2.connected_component_labels_batched(occ)
        again = k2.connected_component_labels_batched(occ)
        ref = labels_plain(occ)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != torch.int32:
            raise AssertionError(f"labels {name}: {tuple(got.shape)} {got.dtype}")
        if ref.numel():
            err = max(err, int((got.long() - ref.long()).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"labels {name}: {int((got != ref).sum())} labels differ from "
                                 f"the plain version")
        if not torch.equal(again, got):
            raise AssertionError(f"labels {name}: two calls on the same grids differ")

        def call():
            return k2.connected_component_labels_batched(occ)

        ms = cuda_time_ms(call, reps=20)
        plain = cuda_time_ms(lambda: labels_plain(occ), reps=plain_reps, warmup=plain_reps - 1)
        n_comp = [len(torch.unique(x[x >= 0])) for x in got]
        log(f"labels {name}, batch of {occ.shape[0]} (components {n_comp}): equal to the plain "
            f"version in two calls; {ms:.4f} ms per call, plain {plain:.4f} ms")
        rows[name] = dict(ms=ms, plain_ms=plain)
        if new_tree:
            bound, by = k2.labels_bound_ms(occ)
            host = host_us(call)
            # one call launches all three passes, so a pass the profiler missed
            # cannot be timed alone by events: it stays None
            passes = {p: kernel_ms(call, f"k2_labels_{p}", events=False)
                      for p in ("tile", "faces", "compress")}
            timed = [v for v in passes.values() if v is not None]
            log(f"labels {name}: bound {bound:.6f} ms ({by}); passes alone "
                + ", ".join(f"{p} {v:.4f} ms" if v is not None else f"{p} not timed"
                            for p, v in passes.items())
                + f" (sum of the timed {sum(timed):.4f}); host issue {host:.1f} us per call")
            rows[name].update(bound_ms=bound, bound_by=by, passes_ms=passes, host_us=host)

    with Phase("labels kernel vs plain version, timed: the fracture grids, 48^3 x 4 and "
               "63^3 x 4 (fills 0.2/0.35/0.5, serpentine), 63^3 x 4 full and checkerboard"):
        four = next((x for x in batches if x.shape[0] == 4), batches[0])
        hold("fracture grids", four, 2)
        for g in (48, 63):
            hold(f"{g}^3", wide_batch(g, dev), 2)
        hold("63^3 full", torch.ones((4, 63, 63, 63), dtype=torch.bool, device=dev), 2)
        hold("63^3 checkerboard", torch.tensor(np.stack([checkerboard(63)] * 4), device=dev), 2)

    with Phase("labels kernel vs plain version at G=39, 40 and 72 (fills, serpentine, empty, "
               "full, checkerboard, corners); routing; no host read"):
        edges = {g: edge_batch(g, dev) for g in (39, 40, 72)}
        for g, occ in edges.items():
            hold(f"{g}^3 edge grids", occ, 1)
        k2.LAUNCHES.reset()
        flat = [four] + [wide_batch(g, dev) for g in (48, 63)] + list(edges.values())
        for occ in flat:
            connected_component_labels(occ)
        torch.cuda.synchronize()
        log(f"connected_component_labels at G=32, 48, 63, 39, 40, 72: launches "
            f"{dict(k2.LAUNCHES)}")
        if dict(k2.LAUNCHES) != dict(k2_ccl=0, k2_ccl_wide=0, k2_labels=len(flat)):
            raise AssertionError(f"the flat labelling did not go through the labels kernel alone: "
                                 f"{dict(k2.LAUNCHES)}")
        torch.cuda.set_sync_debug_mode("error")
        try:
            for occ in flat:
                k2.connected_component_labels_batched(occ)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log("no labelling call synchronised with the host (torch.cuda sync debug mode 'error')")

    r = rows["fracture grids"]
    kernels.append(dict(
        name="k2_labels", route="cuda", source="impact_tpu_torch/csrc/ccl.cu",
        replaces="impact_tpu/ops/ccl_pallas.py:45", launches=labels_launches,
        max_abs_err=float(err), ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r.get("bound_ms"),
        bound_by=r.get("bound_by"), library_ms=None))
    record["k2_labels"] = rows


def probe_phases(dev, record, kernels):
    """The P1 ladder and the P2 ablation: every mode and variant against its
    plain version and timed beside its bounds, alone (``busy_events_ms``)
    and through its wrapper (the module's ladder and ablation, CUDA events
    around back-to-back calls); P1 ``empty`` also beside ``torch.zeros`` of
    its output, the one PyTorch call that computes it."""
    import torch

    from impact_tpu_torch.devtools import cuda_time_ms
    from impact_tpu_torch.devtools import probe_kernel_ablate as p2
    from impact_tpu_torch.devtools import probe_kernel_floor as p1

    with Phase("P1 probe ladder at 1080p (8160 tiles): five modes, each against its plain "
               "version on every tile"):
        ranges, payload = p1.reference_inputs(dev)
        p1.LAUNCHES.reset()
        ladder = p1.run_ladder(ranges, payload, log=log)
        p1_launches = dict(p1.LAUNCHES)
        for mode in p1.MODES:
            key = f"p1_floor_{mode}"
            if p1_launches[key] <= 0:
                raise AssertionError(f"{key} was not launched by the ladder")
            got = p1.probe_floor(mode, ranges, payload)
            ref = p1.probe_floor_plain(mode, ranges, payload)
            torch.cuda.synchronize()
            if got.shape != (p1.N_TILES, p1.S2, p1.ROWS) or not torch.equal(got, ref):
                bad = int((got != ref).sum()) if got.shape == ref.shape else -1
                raise AssertionError(f"P1 {mode}: {bad} outputs differ from the plain version")
            covered = (got[..., 1] >= 0).float().mean().item() if mode in ("eval", "cond") \
                else None
            del got, ref
            plain = cuda_time_ms(lambda m=mode: p1.probe_floor_plain(m, ranges, payload),
                                 reps=2, warmup=1)
            # empty's function is torch.zeros of the output; the others are
            # no single PyTorch call
            library = cuda_time_ms(lambda: torch.zeros((p1.N_TILES, p1.S2, p1.ROWS),
                                                       device=dev)) if mode == "empty" else None
            wrapper, bnd, by = ladder[mode]
            ms = busy_events_ms(lambda m=mode: p1.probe_floor(m, ranges, payload), reps=10)
            log(f"P1 {mode}: equal to the plain version on all {p1.N_TILES} tiles"
                + (f" (covered share {covered:.4f})" if covered is not None else "")
                + f"; kernel alone {ms:.4f} ms (wrapper {wrapper:.4f}), plain {plain:.4f} ms, "
                f"bound {bnd:.4f} ms ({by}), {bnd / ms:.3f} of it"
                + (f", torch.zeros {library:.4f} ms" if library is not None else ""))
            kernels.append(dict(
                name=key, route="cuda", source="impact_tpu_torch/csrc/probe_floor.cu",
                replaces="devtools/probe_kernel_floor.py:33", launches=p1_launches[key],
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=library, wrapper_ms=wrapper))
            record.setdefault("p1", {})[mode] = dict(ms=ms, wrapper_ms=wrapper, bound_ms=bnd,
                                                     library_ms=library)
        del ranges, payload

    with Phase("P2 probe ablation at 512^2 (262,144 triangles): six variants on the probe's "
               "input and two frames with clip z negated, each against its plain version"):
        # the probe's own triangles (an empty frame), the same with clip z
        # negated (about 1 px each: a sparse frame), and those 8x larger (a
        # dense frame, where the evaluations dominate)
        inputs = {"as written": p2.reference_inputs(dev, 0),
                  "clip z negated": p2.reference_inputs(dev, 0, flip_clip_z=True),
                  "clip z negated, 8x triangles": p2.reference_inputs(
                      dev, 0, flip_clip_z=True, size_scale=8.0)}
        p2.LAUNCHES.reset()
        runs = {}
        for tag, inp in inputs.items():
            log(f"P2 input {tag}: {int(inp.ranges[:, 4:].sum())} window candidates")
            runs[tag] = p2.run_ablation(inp, log=log, tag=f" [{tag}]")
        p2_launches = dict(p2.LAUNCHES)
        for name, kw in p2.VARIANTS:
            key = p2.variant_key(**kw)
            if p2_launches[key] <= 0:
                raise AssertionError(f"{key} was not launched by the ablation")
            errs, plain_ms = [], {}
            for tag, inp in inputs.items():
                got = p2.probe_ablate(inp, **kw)
                ref = p2.probe_ablate_plain(inp, **kw)
                torch.cuda.synchronize()
                cov_g, cov_r = got < 1.0, ref < 1.0
                both = cov_g & cov_r
                err = (got[both] - ref[both]).abs().max().item() if bool(both.any()) else 0.0
                agree = (cov_g == cov_r).float().mean().item()
                errs.append(err)
                if not kw["mxu"] and not torch.equal(got, ref):
                    raise AssertionError(f"P2 {name} [{tag}]: {int((got != ref).sum())} pixels "
                                         f"differ from the plain version")
                if kw["mxu"] and (agree < RASTER_COVER_SHARE or err > RASTER_ATOL):
                    raise AssertionError(f"P2 {name} [{tag}]: coverage agrees on {agree:.5f} of "
                                         f"the pixels, max z error {err:.3g}")
                if tag == "as written" and not bool((got == 1.0).all()):
                    raise AssertionError(f"P2 {name}: the probe's own frame is not empty")
                if tag != "as written" and not bool(cov_g.any()):
                    raise AssertionError(f"P2 {name} [{tag}]: the frame is empty")
                plain_ms[tag] = cuda_time_ms(lambda i=inp, k=kw: p2.probe_ablate_plain(i, **k),
                                             reps=2, warmup=1)
                row = runs[tag][name]
                row.update(plain_ms=plain_ms[tag], alone_ms=busy_events_ms(
                    lambda i=inp, k=kw: p2.probe_ablate(i, **k)))
                log(f"P2 {name} [{tag}]: coverage agrees with the plain version on {agree:.6f} "
                    f"of the pixels, max abs z error {err:.3g}; kernel alone "
                    f"{row['alone_ms']:.4f} ms (wrapper {row['ms']:.4f}), plain "
                    f"{plain_ms[tag]:.4f} ms, bound {row['bound_ms']:.6f} ms, all-slot bound "
                    f"{row['dense_bound_ms']:.4f} ms")
            a = runs["as written"][name]
            kernels.append(dict(
                name=key, route="cuda", source="impact_tpu_torch/csrc/probe_ablate.cu",
                replaces="devtools/probe_kernel_ablate.py:38", launches=p2_launches[key],
                max_abs_err=max(errs), ms=a["alone_ms"], plain_ms=plain_ms["as written"],
                bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=None,
                wrapper_ms=a["ms"], inputs={tag: runs[tag][name] for tag in inputs}))
        record["p2"] = runs


def host_us(fn, reps=50):
    """Host microseconds per call of ``fn`` to issue its work (no sync in
    the timed loop; the card drains the queue afterwards)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def body_state_finite(sim):
    import torch

    b = sim.phys.bodies
    return all(bool(torch.isfinite(getattr(b, f)).all()) for f in
               ("position", "orientation", "momentum", "angular_momentum"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--k1-only", action="store_true",
                    help="stop after the K1 phases (kernel vs plain version, timings)")
    ap.add_argument("--ccl-only", action="store_true",
                    help="run only the labelling phases (fracture grids, labels timings)")
    ap.add_argument("--probes-only", action="store_true",
                    help="run only the P1 and P2 probe phases")
    args = ap.parse_args(argv)
    k1_only, ccl_only = args.k1_only, args.ccl_only
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
    from impact_tpu_torch.devtools import card_line, cuda_time_ms
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
        smi = card_line()
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

    from impact_tpu_torch.ops import ccl_pallas as k2

    if ccl_only:
        kernels = []
        batches, labels_launches = fracture_phase(dev, record, full=False)
        labels_phases(dev, batches, labels_launches, record, kernels)
        return finish(t_all, record, kernels, kind, count)
    if args.probes_only:
        kernels = []
        probe_phases(dev, record, kernels)
        return finish(t_all, record, kernels, kind, count)

    with Phase("K2 vs plain version, G=32: random fills, serpentine, empty, full"):
        rng = np.random.default_rng(0)
        g = 32
        grids = [rng.uniform(size=(g, g, g)) < f for f in (0.2, 0.35, 0.5, 0.7)]
        grids += [serpentine(g), np.zeros((g, g, g), bool), np.ones((g, g, g), bool)]
        occ = torch.tensor(np.stack(grids), device=dev)
        sweeps, _ = check_k2(occ, "synthetic grids")
        log(f"K2 labels and sweep counts equal the plain version after {K2_SWEEPS} sweeps and "
            f"at the fixpoint; fixpoint sweeps (fill 0.2/0.35/0.5/0.7, serpentine, empty, "
            f"full): {sweeps.tolist()}")
        if sweeps[4] < 256:
            raise AssertionError(f"the serpentine settled in {int(sweeps[4])} sweeps")
        for name, sel in (("batch of 4 random fills", slice(0, 4)), ("1 grid, serpentine",
                                                                     slice(4, 5))):
            ms, plain, bound, by, sw = time_k2(occ[sel])
            log(f"K2 {name}: {ms:.4f} ms per launch (sweeps {sw}), plain {plain:.4f} ms, "
                f"bound {bound:.6f} ms ({by})")

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
        ms_d = kernel_ms(lambda: rp.raster_depth(bd), "k1_depth_kernel")
        wr_d = cuda_time_ms(lambda: rp.raster_depth(bd))
        ms_dp = cuda_time_ms(lambda: rp.raster_depth_plain(bd), reps=3, warmup=1)
        ms_a = kernel_ms(lambda: rp.raster_attributes(ba, a_dim), "k1_attr_kernel")
        wr_a = cuda_time_ms(lambda: rp.raster_attributes(ba, a_dim))
        ms_ap = cuda_time_ms(lambda: rp.raster_attributes_plain(ba, a_dim), reps=3, warmup=1)
        log(f"K1 depth 256x256: coverage {covered:.4f}, max abs err {err_d:.3g}, "
            f"drops {int(bd.n_drop)}; kernel alone {ms_d:.4f} ms, wrapper {wr_d:.4f} ms, "
            f"plain {ms_dp:.4f} ms")
        log(f"K1 attributes 256x256: coverage {a_k[3].float().mean().item():.4f}, "
            f"max abs err {err_a:.3g}, drops {int(ba.n_drop)}; kernel alone {ms_a:.4f} ms, "
            f"wrapper {wr_a:.4f} ms, plain {ms_ap:.4f} ms")

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
        kernel_names = {"k1_raster_attributes": "k1_attr_kernel",
                        "k1_raster_depth": "k1_depth_kernel"}
        for name, recorded in views.items():
            errs, ms, wrapper_ms, plain_ms, bounds, bound_by = [], [], [], [], [], []
            per_view = []
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
                ms.append(kernel_ms(kern, kernel_names[name]))
                wrapper_ms.append(cuda_time_ms(kern))
                plain_ms.append(cuda_time_ms(plain, reps=3, warmup=1))
                bnd, by = rp.bound_ms(b, n_attr)
                bounds.append(bnd)
                bound_by.append(by)
                n_cand = int(b.ranges[:, 4:].sum())
                per_tile = b.ranges[:, 4:].sum(dim=1) + b.big_have.sum()
                tile_max, crowded = int(per_tile.max()), int((per_tile >= 256).sum())
                per_view.append(dict(view=i, window_candidates=n_cand,
                                     big=int(b.big_have.sum()), drops=int(b.n_drop),
                                     tile_max=tile_max, tiles_256_up=crowded,
                                     coverage=cover, max_abs_err=err, ms=ms[-1],
                                     wrapper_ms=wrapper_ms[-1], plain_ms=plain_ms[-1],
                                     bound_ms=bnd, bound_by=by))
                log(f"{name} view {i} ({b.height}x{b.width}): {n_cand} window candidates, "
                    f"{int(b.big_have.sum())} big, drops {int(b.n_drop)}, at most {tile_max} "
                    f"a tile, {crowded} of {per_tile.numel()} tiles with 256 or more; "
                    f"coverage {cover:.6f}, "
                    f"max abs err {err:.3g}; kernel alone {ms[-1]:.4f} ms, wrapper "
                    f"{wrapper_ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f} ms, bound {bnd:.4f} ms "
                    f"({by}), {bnd / ms[-1]:.3f} of it")
            n = len(recorded)
            kernels.append(dict(
                name=name, route="cuda", source="impact_tpu_torch/csrc/raster.cu",
                replaces="impact_tpu/render/raster_pallas.py:781", launches=launches[name],
                max_abs_err=max(errs), ms=sum(ms) / n, plain_ms=sum(plain_ms) / n,
                bound_ms=sum(bounds) / n,
                bound_by=max(set(bound_by), key=bound_by.count), library_ms=None,
                wrapper_ms=sum(wrapper_ms) / n))
            record[name] = per_view
            log(f"{name}: {n} launches per frame, mean kernel alone {sum(ms) / n:.4f} ms, "
                f"wrapper {sum(wrapper_ms) / n:.4f} ms, plain {sum(plain_ms) / n:.4f} ms, "
                f"bound {sum(bounds) / n:.4f} ms")

    if k1_only:
        return finish(t_all, record, kernels, kind, count)

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

    from impact_tpu_torch.models.bench import (
        bench_fracture_config,
        bench_fracture_scene,
        bench_step_scene,
    )
    from impact_tpu_torch.voxel.object import nonempty_counts

    with Phase(f"tumbler bench stepped (boxes spaced 11.5 m): {TUMBLER_STEPS} steps, then "
               f"step_and_render at 1080p"):
        cfg = bench_config(WIDTH, HEIGHT)
        rt = HeadlessRuntime(compile_scene(bench_step_scene(), cfg, device=dev), cfg,
                             enable_fracturing=False)
        n_active = int(nonempty_counts(rt.sim.voxels).sum())
        rt.step(2)  # warm-up: the first steps build cuBLAS/cuSOLVER handles
        rp.LAUNCHES.reset()
        k2.LAUNCHES.reset()
        syncs0 = rt.host_syncs
        rt.step(TUMBLER_STEPS)
        steps_ms = rt.step_ms
        steps_per_s = TUMBLER_STEPS / (steps_ms / 1e3)
        t0 = time.perf_counter()
        img = rt.step_and_render()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        tumbler_launches = {**dict(rp.LAUNCHES), **dict(k2.LAUNCHES)}
        syncs = (rt.host_syncs - syncs0) / (TUMBLER_STEPS + 1)
        if not body_state_finite(rt.sim):
            raise AssertionError("non-finite body state after stepping the tumbler")
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or img.float().std().item() < 1.0:
            raise AssertionError(f"stepped 1080p image {tuple(img.shape)} is flat")
        if rp.LAUNCHES["k1_raster_attributes"] == 0 or rp.LAUNCHES["k1_raster_depth"] == 0:
            raise AssertionError(f"K1 was not launched on the stepped frame: {tumbler_launches}")
        geo_drops, shadow_drops = rt.last_drops
        drop_v, drop_t = rt.dropped_mesh_elements()
        ys = rt.sim.phys.bodies.position[rt.sim.voxels.body_index][:62, 1]
        log(f"tumbler: {n_active} active voxels; {TUMBLER_STEPS} steps in {steps_ms:.1f} ms = {steps_per_s:.2f} steps/s "
            f"({steps_ms / TUMBLER_STEPS:.3f} ms per step), {syncs:.2f} host syncs per step; "
            f"box heights {ys.min().item():.3f}..{ys.max().item():.3f}")
        log(f"tumbler step_and_render at 1080p: {frame_ms:.2f} ms (step {rt.step_ms:.2f} ms; "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in rt.stage_ms.items()) + ")")
        log(f"tumbler stepped state: broad_phase_overflow {rt.broad_phase_overflow()}, "
            f"dropped_mesh_elements ({drop_v}, {drop_t}), raster drops geometry {geo_drops} "
            f"shadows {shadow_drops}; launches {tumbler_launches}")
        record["tumbler"] = dict(steps_per_s=steps_per_s, step_ms=steps_ms / TUMBLER_STEPS,
                                 frame_ms=frame_ms, stage_ms=rt.stage_ms, host_syncs=syncs,
                                 broad_phase_overflow=rt.broad_phase_overflow(),
                                 geometry_drops=geo_drops, shadow_drops=shadow_drops)

    batches, labels_launches = fracture_phase(dev, record)

    with Phase(f"fracture scene at reduced depth ({SMALL_FRAGMENTS} fragment slots): the card "
               f"vs the port on the CPU, same uniforms"):
        from impact_tpu_torch.voxel.interaction import draw_fracture_uniforms

        scfg = bench_fracture_config(SMALL_FRAGMENTS)
        uniforms = draw_fracture_uniforms(torch.Generator().manual_seed(0), SMALL_FRAGMENTS)
        runs = {}
        for where in ("cuda", "cpu"):
            r = HeadlessRuntime(
                compile_scene(bench_fracture_scene(), scfg, device=where), scfg,
                fracture_uniforms=lambda gen, n, w=where: tuple(u.to(w) for u in uniforms))
            a0, event = int(r.sim.voxels.alive.sum()), None
            for i in range(1, FRACTURE_MAX_STEPS + 1):
                r.step(1)
                if event is None and int(r.sim.voxels.alive.sum()) > a0:
                    event = i
                if event is not None and i >= event + 4:
                    break
            v = r.sim.voxels
            runs[where] = dict(event=event, alive=v.alive.cpu(),
                               counts=(v.sdf < 0).sum(dim=(1, 2, 3)).cpu(),
                               pos=r.sim.phys.bodies.position.cpu())
        c, p = runs["cuda"], runs["cpu"]
        moved = int((c["counts"] - p["counts"]).abs().sum()) // 2
        total = int(p["counts"].sum())
        dpos = (c["pos"] - p["pos"]).abs().max().item()
        log(f"reduced fracture: event at step {c['event']} on the card, {p['event']} on the CPU; "
            f"alive {int(c['alive'].sum())} / {int(p['alive'].sum())}; {moved} of {total} "
            f"voxels in another slot (bar {MOVED_VOXEL_SHARE:g} of them); body positions "
            f"differ by at most {dpos:.3g} m")
        if c["event"] is None or c["event"] != p["event"]:
            raise AssertionError(f"event step {c['event']} on the card, {p['event']} on the CPU")
        if not torch.equal(c["alive"], p["alive"]):
            raise AssertionError("the card and the CPU keep different object slots alive")
        if moved > MOVED_VOXEL_SHARE * total:
            raise AssertionError(f"{moved} voxels sit in another slot on the card")
        record["reduced_fracture_card_vs_cpu"] = dict(event=c["event"], moved_voxels=moved,
                                                      max_position_diff=dpos)

    with Phase("ccl_sweeps (K2) on the grids the fracture bench labelled, against its plain "
               "version"):
        k2.LAUNCHES.reset()
        for x in batches:
            k2.ccl_sweeps(x, k2.initial_labels(x), x.shape[-1] ** 3)
        torch.cuda.synchronize()
        sweeps_launches = k2.LAUNCHES["k2_ccl"]
        if sweeps_launches <= 0 or k2.LAUNCHES["k2_ccl_wide"] != 0:
            raise AssertionError(f"the fracture grids did not go through K2: {dict(k2.LAUNCHES)}")
        occ = torch.cat(batches)
        sweeps, k2_err = check_k2(occ, "fracture-bench grids")
        log(f"K2 equal to its plain version on {occ.shape[0]} labelled grids in "
            f"{len(batches)} launches; fixpoint sweeps min {int(sweeps.min())} max "
            f"{int(sweeps.max())}")
        four = next((x for x in batches if x.shape[0] == 4), batches[0])
        ms4, plain4, bound4, by4, sw4 = time_k2(four)
        ms1, plain1, bound1, by1, sw1 = time_k2(four[:1])
        log(f"K2 on fracture grids, batch of {four.shape[0]}: {ms4:.4f} ms per launch (sweeps "
            f"{sw4}), plain {plain4:.4f} ms, bound {bound4:.6f} ms ({by4}); 1 grid: "
            f"{ms1:.4f} ms (sweeps {sw1}), plain {plain1:.4f} ms, bound {bound1:.6f} ms ({by1})")
        kernels.append(dict(
            name="k2_ccl", route="cuda", source="impact_tpu_torch/csrc/ccl.cu",
            replaces="impact_tpu/ops/ccl_pallas.py:45", launches=sweeps_launches,
            max_abs_err=k2_err, ms=ms4, plain_ms=plain4, bound_ms=bound4, bound_by=by4,
            library_ms=None))

    labels_phases(dev, batches, labels_launches, record, kernels)

    from impact_tpu_torch.voxel.interaction import connected_component_labels

    with Phase("K2-wide vs plain version, G=39, 40, 48 and 63: random fills, serpentine; "
               "the two-level labels at 64^3"):
        wide = {g: wide_batch(g, dev) for g in (39, 40, 48, 63)}
        k2.LAUNCHES.reset()
        for g, occ in wide.items():
            k2.ccl_sweeps(occ, k2.initial_labels(occ), g ** 3)
        torch.cuda.synchronize()
        wide_launches = k2.LAUNCHES["k2_ccl_wide"]
        log(f"ccl_sweeps at G=39, 40, 48 and 63: launches {dict(k2.LAUNCHES)}")
        if wide_launches <= 0 or k2.LAUNCHES["k2_ccl"] != 0:
            raise AssertionError(f"the wide grids did not go through K2-wide: {dict(k2.LAUNCHES)}")
        wide_err, wide_rows = 0.0, {}
        for g, occ in wide.items():
            sweeps, err = check_k2(occ, f"wide G={g}")
            wide_err = max(wide_err, err)
            if sweeps[3] < g * g // 2:
                raise AssertionError(f"the G={g} serpentine settled in {int(sweeps[3])} sweeps")
            if g in (39, 40):
                log(f"K2-wide G={g}: labels and sweeps equal the plain version (sweeps "
                    f"{sweeps.tolist()})")
                continue
            ms, plain, bound, by, sw = time_k2(occ, reps=5)
            wide_rows[g] = (ms, plain, bound, by)
            log(f"K2-wide G={g}, batch of 4 (fills 0.2/0.35/0.5, serpentine): labels and sweeps "
                f"equal the plain version; {ms:.4f} ms per fixpoint call (sweeps {sw}), plain "
                f"{plain:.4f} ms, bound {bound:.6f} ms ({by})")
        rng = np.random.default_rng(64)
        occ64 = torch.tensor(np.stack([rng.uniform(size=(64, 64, 64)) < f for f in (0.3, 0.45)]
                                      + [serpentine(64)]), device=dev)
        two = connected_component_labels(occ64)
        if not torch.equal(two, labels_plain(occ64)):
            raise AssertionError("the two-level labels at 64^3 differ from the flat plain sweep")
        log("two-level labels at 64^3 (fills 0.3/0.45, serpentine) equal the flat plain sweep's")
        ms, plain, bound, by = wide_rows[63]
        kernels.append(dict(
            name="k2_ccl_wide", route="cuda", source="impact_tpu_torch/csrc/ccl.cu",
            replaces="impact_tpu/ops/ccl_pallas.py:45", launches=wide_launches,
            max_abs_err=wide_err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=None))
        record["k2_wide"] = {str(g): dict(ms=v[0], plain_ms=v[1], bound_ms=v[2])
                             for g, v in wide_rows.items()}

    probe_phases(dev, record, kernels)
    return finish(t_all, record, kernels, kind, count)


def finish(t_all, record, kernels, kind, count) -> int:
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
