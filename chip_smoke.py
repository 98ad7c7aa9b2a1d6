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
   its plain version;
8. the chunked bench phases (``bench.py:bench_chunked``: the asteroid in 4
   slots of 64³ or 2 of 128³ i8 grids, chunked meshing with 512 submesh
   slots and a remesh budget of 16, under the bench's carving absorber),
   each as the bench writes it (radius (G/2 − 4)·0.3 voxels) and filled
   (radius G/2 − 4): 50 steps through ``HeadlessRuntime.step`` timed after
   a warm-up, with ``bench_chunked``'s keys, the labels kernel (every split
   check's grids, routed there by ``connected_component_labels``) held
   against the two-level plain labelling on the grids it labelled, and one
   320x200 frame of the filled 64³ phase through K1, held against K1's
   plain version and scored against the plain tile raster;
9. the scan solver (the default ``scan`` mode, ``csrc/scan_solver.cu``):
   its two kernels held equal to ``scan_iterations_plain``, and the
   schedule they walk equal to ``scan_schedule``'s, on the solver inputs
   of one substep of the snapshot tester's VoxelBoxTumbler and Bloom (24
   bodies, 128 slots), of the bench tumbler stepped under ``scan`` (80
   bodies, 1024 slots), each with at least 20 active slots, and of the
   bench tumbler's widened to the default config (1024 bodies, 4096
   slots); timed (CUDA events, 20 calls after 2; device time alone through
   torch.profiler) beside the bytes bound and the chain bound (levels ×
   one slot's dependent latency), and the bench tumbler's step under
   ``scan`` and ``jacobi`` in turns in one process, with launches per step;
10. the snapshot tester's 20 scenes
   (``impact_tpu_torch.apps.snapshot_tester``: 320x240, 4 objects of 32³,
   the ``scan`` solver; TexturedMaterials through the textured shade path)
   stepped their warm-up counts and rendered through
   K1 (windows fit to each view, so nothing drops), each frame scored
   against its golden (``apps/snapshots/reference``) at 0.93, every K1
   launch of the path (the G-buffers, cubemap faces, directional maps and
   cascades) held against K1's plain version on the same inputs, and the
   same state rendered again with the plain tile raster, held to K1's
   frame at 0.95;
11. the scene-driven physics: HarmonicOscillation, FreeRotation and
   DragDrop (as written, and in a medium of density 10) at the snapshot
   configuration, 150 steps each and a K1 frame of each with every launch
   held against K1's plain version; the oscillator on its driver's path
   within 1e-3, FreeRotation's angular momentum and unit quaternion within
   1e-5 and its orientation and angular velocity after 20 steps (at 8
   contact slots) held to the port's run on the CPU (rtol 1e-5), DragDrop's spheres falling alike as written and the drag sphere
   slower in the medium, every body state finite; one DragDrop substep
   with floor contacts through the scan kernels, held equal to their plain
   loop; and a textured box mesh entity (colour, normal and parallax maps)
   through K1, held to the plain tile raster's frame at 0.95;
12. the reference's public API (``api_phase``): the quick start of
   README.md:41-57 with ``impact_tpu_torch`` (an ``EngineConfig`` equal to
   the one its RON text gives, ``voxel_box_tumbler(n_boxes=4)``,
   ``compile_scene`` with no device, 100 steps, a render, a checkpoint),
   the resume (save, 10 steps, load, 10 steps, within the scan tests'
   bar), the commands (pause, resume, set_n_iterations,
   set_bloom_enabled, reset_world, an unknown one), ``run(20,
   render_every=5)``, a ``profile`` trace that names K1 and the scan
   kernels, and the Voxel Range game at its defaults
   (``impact_tpu_torch.apps.impact_game.play``, 400 frames), which must be
   won; every K1 launch of the phase is held against K1's plain version,
   the game's busiest substep through the scan kernels against their plain
   loop, and every grid the game labelled against the plain labelling;
13. the procedural SDF generation path (``generation_phase``): the
   generation world of ``impact_tpu_torch/models/generation.py`` (a sphere
   union, the voxel generator's example graph and a meta graph lowered at
   seed 7 as generated voxel objects, the rectangle, hemisphere, cylinder
   and cone meshes, an OBJ and a PLY file) compiled with its
   ``sdf_generators`` at the default pools (64 slots of 32³, 1024 bodies,
   4096 contact slots, ``scan``, 256x192), 200 steps with a K1 frame every
   50th; the meta cluster fractures into at least 2 fragments; the last
   state's K1 frame, and one frame of the world under an
   OrthographicCamera, each at least 0.95 against the plain tile raster's;
   and the voxel generator app (``example``, ``stats`` equal to the CPU's,
   ``preview``, ``vary`` 2), each preview (K1) at least 0.95 against the
   plain tile raster's; every K1 launch of the phase, its busiest substep's
   scan kernels and every grid it labelled held against their plain
   versions;
14. the slice of gizmos, the scene graph and the parity scenes
   (``parity_phase``): the reference tester's 13 scenes through
   ``impact_tpu_torch.apps.parity_snapshots`` at 768x512 on
   ``EngineConfig()`` (no drops, each K1 frame at least 0.95 against the
   plain tile raster's, its score against the committed JAX render
   printed; each frame rendered again from the same state for its time);
   ShadowableOmnidirectionalLight with ``tpu.bf16_shading`` (not equal to
   the float32 frame, its bfloat16 shade within 2⁻⁶ of the CPU's); all 21
   gizmo kinds and ``colliders`` over the snapshot VoxelBoxTumbler through
   ``render`` and ``step_and_render`` (the card's overlay against the
   CPU's; hidden, the base frame); the filled 64³ chunked scene rebaked
   with another voxel-type registry (against a CPU rebake), stepped and
   rendered; the quick start's world with a three-deep Parent chain
   flattened and compiled, and an EntityController driving a kinematic
   body; every K1 and labels launch held against its plain version;
15. the engine step sharded over the voxel-object pool
   (``parallel_phase``, ``impact_tpu_torch/parallel``): (a) the quick
   start's tumbler under ``scan``, from ``HeadlessRuntime``'s state at step
   90 on a 1-rank ``nccl`` mesh in this process, 10 steps against
   ``HeadlessRuntime``'s next 10 on the card within
   ``tests/test_parallel.py:88-103``'s bars, every scan launch of the path
   held against the plain loop on its active slots; with 4 ranks sharing
   the card over host-staged ``gloo``: (b) Fracturing at the dry run's
   config across its fracture and the filled 64³ asteroid (dense remesh)
   across its carve and split, each from a state of a single-process run
   on the card a few steps before the event, gathered and held to that
   run to the same bars, every grid a rank labelled held against the
   plain labelling; (c) the 1024-slot pod step (local dims, memory over
   the state, the largest collective, no grid-shaped collective); (d) the
   halo min filter on a 2×2 mesh against the plain 3-point min; and (e)
   the jacobi solve at 1024 bodies and 4096 contact slots under
   C·N·4 bytes of peak memory; (f) the ``space`` axis, on 8 ranks sharing
   the card: the tumbler on 2×2 and 4×2 against a single-process run,
   Fracturing on 2×2 and the filled 64³ asteroid on 1×4 across their
   events against a single-process run whose inertia sums slab by slab
   (the divergence from the plain run reported), every slab labels launch
   held against its plain version and timed, the merged slab labels
   against the whole grid's, the 1024-slot pod on 4×2 (local dims, halo
   transfers, no grid- or slab-shaped collective, the largest collective,
   memory over the state) and the dry run on 2×2; (g) the contact solve
   with the bodies split over the ``objects`` axis of a 4×2 mesh and the
   contacts replicated (``parallel.solver.sharded_solve_contacts``) on
   the same 8 ranks: jacobi at 1024 bodies × 2048 slots (one velocity and
   one correction iteration, cold and warm-started) and × 4096 (the
   default iterations), ``scan`` at 128 × 256, each against the
   single-process solve on the card within 1e-5 (bitwise equality
   reported), every scan launch of the ranks held against the plain
   loop, the device peak per rank under C·N·4 bytes, the collectives
   body-row gathers only. Ranks sharing a card say nothing about a
   multi-card speed;
16. the reference's public surface that the port gained last
   (``surface_phase``): the committed image fixtures
   (``tests/data/surface_images``: a baseline 4:2:0 and a progressive
   4:4:4 JPEG at 256², an 8-bit and a 16-bit greyscale PNG) decoded by the
   port (the card has no PIL) equal to PIL's decodes committed beside
   them, each decode timed; the textured box with the JPEG as its colour
   texture through K1, every launch held against K1's plain version, at
   0.95 against the plain tile raster's frame; ``split_off_disconnected_region``
   on a 32³ two-component grid, its labels launch held against the plain
   version and the pool equal to the CPU's; and ``rasterize(method="chunk")``
   against ``method="tiled"`` at 480x270 on the bench scene's triangles
   (depth within 2e-3, coverage equal on more than 0.99 of the pixels),
   both timed.

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
``--chunked-only`` runs only the four chunked phases (and the labels entry
of the record), so two trees can be timed in turns in one call.
``--snapshots-only`` runs only the scan solver, snapshot and scene physics
phases; ``--scene-physics-only`` only the scene physics phase; ``--api-only``
only the API phase; ``--generation-only`` only the generation phase;
``--parity-only`` only the parity phase; ``--parallel-only`` only the
parallel phase; ``--surface-only`` only the surface phase.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings

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
# the chunked phases: warm-up steps, then steps timed as one run (the
# bench's 50)
CHUNKED_WARMUP = 3
CHUNKED_STEPS = 50
# the scan solver: steps before recording, then the steps whose substeps are
# recorded (the one with the most active slots is kept), and the fewest
# active slots a recorded substep may hold. On an H100 80GB HBM3: the
# snapshot tumbler's boxes pile up from ~step 200 and hold 20-36 active
# slots of 128 from ~step 290; Bloom's first step holds 89 (its spheres
# start overlapping), later ones 5-6; BallPit never more than 5 in 400
# steps, so it is not recorded here (its substeps run on the snapshot path);
# the bench tumbler holds 60-71 of 1024 from ~step 500 of 0.005 s
SCAN_RECORD_STEPS = {"VoxelBoxTumbler": (340, 60), "Bloom": (0, 1)}
BENCH_SCAN_RECORD_STEPS = (600, 100)
SCAN_MIN_ACTIVE = 20
# the bench tumbler's steps per turn when timing scan against jacobi (turns
# jacobi, scan, scan, jacobi)
SCAN_TURN_STEPS = 20
# the kernels against their plain version: equal is required (every float
# operation rounded the same way, each body's slots in slot order); a field
# that is not is also reported against the CPU parity bar against
# impact_tpu (tests/test_torch_scan_solver.py): rtol 1e-5 and an atol of
# 1e-6 of each field's largest magnitude
SCAN_RTOL, SCAN_ATOL_OF_MAGNITUDE = 1e-5, 1e-6
# the scene physics phase: steps of each scene and the step of the DragDrop
# fall check (its spheres reach the floor at ~step 124 of 0.01 s), the
# oscillator's bar (tests/test_physics.py:232-247), FreeRotation's
# (tests/test_physics.py:140-151), and the DragDrop steps before recording
# and recorded for the scan hold (floor contacts at steps 125-127 on the CPU)
SCENE_PHYSICS_STEPS = 150
FALL_STEPS = 100
OSC_ATOL = 1e-3
CONSERVED_RTOL = 1e-5
# FreeRotation's steps on the card and on the CPU, held to each other at the
# scan tests' bar: it spins near its intermediate axis, where a difference
# grows as e^(7.1 t), so 0.2 s (×4) keeps the bar meaningful; at 8 contact
# slots, where the CPU's plain scan loop takes ~0.1 s a step (~0.65 s at the
# snapshot configuration's 128)
ROT_CPU_STEPS, ROT_CPU_CONTACTS = 20, 8
DRAG_DROP_SCAN_STEPS = (118, 20)
# the API phase: the reference's quick start (README.md:41-57) steps the
# tumbler QUICK_START_STEPS frames; the resume steps RESUME_STEPS after a
# save and after its load; run(RUN_FRAMES, render_every=RUN_EVERY); the
# Voxel Range game at its defaults, rendering every GAME_RENDER_EVERY-th frame
QUICK_START_STEPS, RESUME_STEPS = 100, 10
RUN_FRAMES, RUN_EVERY = 20, 5
GAME_RENDER_EVERY = 100
QUICK_START_RON = "(tpu: (max_voxel_objects: 8, max_bodies: 24))"
# the generation phase: the generation world's steps and its K1 frame every
# GENERATION_RENDER_EVERY-th; the voxel generator's vary count; the largest
# |SDF| at which a voxel's sign may differ between the card's stats grid and
# the CPU's (a float32 ulp of the evaluation)
GENERATION_STEPS, GENERATION_RENDER_EVERY = 200, 50
VARY_N = 2
SIGN_FLIP_ATOL = 1e-5
# the parity phase: the gizmo scene's steps before its frames, the rebaked
# chunked scene's steps (the filled 64³ asteroid splits on step 1), the
# EntityController's steps, and the share of the pixels either overlay
# writes on which the card's overlay may differ from the CPU's (a sample on
# a pixel edge may round the other way)
PARITY_GIZMO_STEPS, PARITY_CHUNKED_STEPS, CONTROLLER_STEPS = 5, 3, 10
CONTROLLED_AT = (0.0, 12.0, 0.0)
OVERLAY_SHARE = 1e-3
# the card's bfloat16 shade against the CPU's on one G-buffer: at most this
# share of the covered pixels beyond 2⁻⁶ of their magnitude + 1e-6 (the CPU
# test's bar against impact_tpu; a float32 function that rounds the last bit
# another way on the card can move a bfloat16 value by one step)
BF16_SHARE = 1e-3
# the parallel phase: (a)'s single-process steps before it shards the state
# (the boxes land) and its sharded steps; the ranks sharing the card in (b)-(d);
# (b)'s checkpoint, this many steps before its event, and the steps a
# single-process run may take to reach the event; tests/test_parallel.py:
# 88-103's bars (positions, momenta, grids) for a sharded state against a
# single-process one on the card
PARALLEL_WARMUP, PARALLEL_STEPS, PARALLEL_RANKS = 90, 10, 4
PARALLEL_BEFORE_EVENT, PARALLEL_EVENT_STEPS = 3, 200
PARALLEL_POS_ATOL, PARALLEL_MOMENTUM_ATOL, PARALLEL_SDF_ATOL = 1e-5, 1e-4, 1e-6
# (f), the space axis: its ranks sharing the card and the tumbler's steps
SPACE_RANKS, SPACE_STEPS = 8, 5
# (g), the body-sharded contact solve on (f)'s ranks, on a 4x2 mesh: (mode,
# bodies, contact slots, (velocity, correction) iterations or None for the
# default 8 and 3, warm-started) of tests/test_parallel.py:205-242 (seed 5),
# check (e)'s size at the default iterations, the scan at 128 x 256, and the
# first warm-started; each solve timed this many times after a warm-up; the
# bar against the single-process solve on the card
SOLVE_CELLS = (("jacobi", 1024, 2048, (1, 1), False), ("jacobi", 1024, 4096, None, False),
               ("scan", 128, 256, None, False), ("jacobi", 1024, 2048, (1, 1), True))
SOLVE_SEED, SOLVE_REPS, SOLVE_TOL = 5, 3, 1e-5
API_KERNELS = {"k1_raster_attributes": "k1_attr_kernel", "k1_raster_depth": "k1_depth_kernel",
               "scan_velocity_iterations": "scan_velocity_kernel",
               "scan_position_correction": "scan_correction_kernel"}


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
    work or any other launch. ``kernel`` may be a tuple of names of kernels
    that each call launches once each: the ms is then their sum per call.

    The profiler now and then loses launch records (1 of 20; in some runs
    all of them, in every profile of one kernel): the mean is taken over the
    recorded launches, and the profile is taken again when fewer than half
    were recorded. After three such profiles the time comes from
    ``busy_events_ms`` (device time of the whole call, which also holds any
    other launch of ``fn``) when ``events`` is true, else it is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    per_call = len(names)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if any(k in e.key for k in names)
                and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in hits)
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in hits)
        if reps // 2 * per_call <= n <= reps * per_call and us > 0.0:
            return us / n * per_call / 1e3
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
        if dict(k2.LAUNCHES) != dict(k2_ccl=0, k2_ccl_wide=0, k2_labels=len(flat),
                                     k2_labels_slab=0):
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


def chunked_phase(dev, g, fill, record):
    """One chunked bench phase: compile the scene on the card, step
    CHUNKED_WARMUP steps, then CHUNKED_STEPS steps timed as one run with
    the launch counts zeroed just before and read just after, recording
    every batch the split checks label at ``connected_component_labels``.
    Then holds the labels kernel against the two-level plain labelling on
    each recorded batch and times both on the largest. Returns (the phase's
    runtime, its row)."""
    import torch

    from impact_tpu_torch.devtools import card_line, cuda_time_ms
    from impact_tpu_torch.models.bench import (
        bench_chunked_config,
        bench_chunked_fill_scene,
        bench_chunked_scene,
    )
    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.voxel import interaction
    from impact_tpu_torch.voxel.object import nonempty_counts, surface_chunk_counts

    tag = f"chunked{g}" + ("_fill" if fill else "")
    what = "filled, radius G/2-4" if fill else "as written, radius (G/2-4)*0.3"
    with Phase(f"{tag}: the chunked bench at {g}^3 ({what}), {CHUNKED_STEPS} steps"):
        cfg = bench_chunked_config(g)
        scene = bench_chunked_fill_scene(g) if fill else bench_chunked_scene(g)
        t0 = time.perf_counter()
        build = compile_scene(scene, cfg, device=dev)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        meshes = build.sim.meshes
        if int(meshes.n_dropped_chunks) != 0:
            raise AssertionError(f"{tag}: the setup pool was exhausted")
        rt = HeadlessRuntime(build, cfg, enable_fracturing=False)
        n_obj = cfg.tpu.max_voxel_objects
        sdf0 = rt.sim.voxels.sdf.clone()
        active0 = int(nonempty_counts(rt.sim.voxels).sum())
        rt.step(CHUNKED_WARMUP)
        grids, two_level_calls = [], [0]
        run_labels = interaction.connected_component_labels_batched
        run_two_level = interaction.connected_component_labels_two_level

        def rec_labels(occ):
            grids.append(occ.clone())
            return run_labels(occ)

        def rec_two_level(occ):
            two_level_calls[0] += 1
            return run_two_level(occ)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        interaction.connected_component_labels_batched = rec_labels
        interaction.connected_component_labels_two_level = rec_two_level
        try:
            k2.LAUNCHES.reset()
            rp.LAUNCHES.reset()
            syncs0 = rt.host_syncs
            rt.step(CHUNKED_STEPS)
            torch.cuda.synchronize()
            launches = {**dict(k2.LAUNCHES), **dict(rp.LAUNCHES)}
        finally:
            interaction.connected_component_labels_batched = run_labels
            interaction.connected_component_labels_two_level = run_two_level
        step_ms = rt.step_ms / CHUNKED_STEPS
        syncs = (rt.host_syncs - syncs0) / CHUNKED_STEPS
        peak = torch.cuda.max_memory_allocated(dev)
        v = rt.sim.voxels
        n_vox = int(nonempty_counts(v).sum())
        n_surf = int(surface_chunk_counts(v).sum())
        dv, dt_drop = rt.dropped_mesh_elements()
        row = {
            f"{tag}_step_ms": step_ms,
            f"{tag}_active_voxels": n_vox,
            f"{tag}_surface_chunks": n_surf,
            f"{tag}_total_chunks": n_obj * (g // 16) ** 3,
            f"{tag}_remesh_budget": cfg.tpu.chunk_remesh_budget,
            f"{tag}_deferred_chunk_carves": rt.deferred_absorptions(),
            f"{tag}_dropped_mesh_elements": [dv, dt_drop],
        }
        carved = int((v.sdf != sdf0).sum())
        live = int(v.alive.sum())
        # every synchronizing operation of one more step, as torch sees them
        # (the step's counter holds only its branch reads)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rt.step(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch_syncs = sum("synchronizing" in str(w.message) for w in caught)
        log(f"{tag}: compile {compile_s:.2f} s; {active0} active voxels at setup, {n_vox} after "
            f"{CHUNKED_WARMUP} + {CHUNKED_STEPS} steps; {carved} SDF entries changed; "
            f"{live} live objects; {step_ms:.3f} ms per step, {syncs:.2f} host syncs per step "
            f"({torch_syncs} synchronizing operations in one more step, torch's sync debug "
            f"mode); "
            f"peak device memory {peak / 2**30:.3f} GiB; launches {launches}")
        log(f"{tag}: {card_line()}")
        log(json.dumps(row))
        if not body_state_finite(rt.sim):
            raise AssertionError(f"{tag}: non-finite body state")
        if not fill and carved == 0:
            raise AssertionError(f"{tag}: the absorber changed no SDF entry")
        # counted from setup: the filled 64³ asteroid loses its voxels on step
        # 1, in the warm-up, and its split leaves the main part without spin
        # (ROADMAP Queue 3), so nothing more enters the absorber
        if fill and n_vox >= active0:
            raise AssertionError(f"{tag}: active voxels did not fall ({active0} -> {n_vox})")
        if launches["k2_labels"] <= 0 or len(grids) == 0:
            raise AssertionError(f"{tag}: the split checks never reached the labels kernel")
        if two_level_calls[0] or launches["k2_ccl"] or launches["k2_ccl_wide"]:
            raise AssertionError(f"{tag}: the labelling left the labels kernel "
                                 f"(two-level calls {two_level_calls[0]}, launches {launches})")

        # the labels kernel against the two-level plain labelling on every
        # batch the split checks labelled (consecutive equal batches once)
        err, n_checked, prev = 0, 0, None
        for occ in grids:
            if prev is not None and occ.shape == prev.shape and torch.equal(occ, prev):
                continue
            prev = occ
            got = k2.connected_component_labels_batched(occ)
            ref = run_two_level(occ)
            if not torch.equal(got, ref):
                raise AssertionError(f"{tag}: {int((got != ref).sum())} labels differ from the "
                                     f"two-level plain labelling")
            err = max(err, int((got.long() - ref.long()).abs().max()))
            n_checked += 1
        big = max(grids, key=lambda x: x.shape[0])
        ms = cuda_time_ms(lambda: k2.connected_component_labels_batched(big), reps=20)
        plain = cuda_time_ms(lambda: run_two_level(big), reps=2, warmup=1)
        bound, by = k2.labels_bound_ms(big)
        n_comp = [len(torch.unique(x[x >= 0])) for x in k2.connected_component_labels_batched(big)]
        log(f"{tag}: labels kernel equal to the two-level plain labelling on {n_checked} "
            f"distinct batches of the {len(grids)} labelled; on {big.shape[0]} x {g}^3 "
            f"(components {n_comp}): {ms:.4f} ms per call, two-level plain {plain:.4f} ms, "
            f"labels_bound_ms {bound:.6f} ({by}); {launches['k2_labels'] / CHUNKED_STEPS:.2f} "
            f"labels launches per step")
        row.update(live_objects=live, host_syncs_per_step=syncs,
                   torch_syncs_one_step=torch_syncs, peak_gib=peak / 2**30,
                   compile_s=compile_s, setup_active_voxels=active0, sdf_entries_changed=carved,
                   launches=launches, labels_batches=len(grids), labels_checked=n_checked,
                   labels_ms=ms, labels_plain_ms=plain, labels_bound_ms=bound,
                   labels_bound_by=by, labels_batch=big.shape[0], labels_max_abs_err=err,
                   card=card_line())
        record[tag] = row
    return rt, row


def chunked_phases(dev, record, kernels):
    """The four chunked phases (64³ and 128³, as written and filled), then a
    320x200 frame of the filled 64³ phase through K1, against K1's plain
    version and the plain tile raster. Adds the chunked call sites to the
    labels kernel's entry."""
    import torch

    from impact_tpu_torch.models.bench import bench_chunked_config
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.runtime import HeadlessRuntime
    from impact_tpu_torch.runtime.setup import SceneBuild
    from impact_tpu_torch.utils.image import rgb_hybrid_compare

    rows, fill64 = {}, None
    for g in (64, 128):
        for fill in (False, True):
            rt, row = chunked_phase(dev, g, fill, record)
            rows[f"chunked{g}" + ("_fill" if fill else "")] = row
            if g == 64 and fill:
                fill64 = rt
            del rt
            torch.cuda.empty_cache()

    with Phase("chunked64_fill: a 320x200 frame through K1, vs K1's plain version and vs the "
               "plain tile raster"):
        build = SceneBuild(sim=fill64.sim, params=fill64.params, info=fill64.info)

        def frame(backend="kernel"):
            c = bench_chunked_config(64)
            c.tpu.raster_backend = backend
            r = HeadlessRuntime(build, c, enable_fracturing=False)
            img = r.render()
            torch.cuda.synchronize()
            return img.cpu().numpy(), r.last_drops

        rp.LAUNCHES.reset()
        img, drops = frame()
        k1_launches = dict(rp.LAUNCHES)
        run_depth, run_attr = rp.raster_depth, rp.raster_attributes
        rp.raster_depth, rp.raster_attributes = rp.raster_depth_plain, rp.raster_attributes_plain
        try:
            img_p, drops_p = frame()
        finally:
            rp.raster_depth, rp.raster_attributes = run_depth, run_attr
        img_t, _ = frame("raster")
        score_p = rgb_hybrid_compare(img, img_p)
        score_t = rgb_hybrid_compare(img, img_t)
        log(f"chunked64_fill frame: K1 launches {k1_launches}; raster drops (geometry, shadows) "
            f"{drops}, K1's plain version {drops_p}; rgb_hybrid_compare(K1 path, K1's plain "
            f"version) = {score_p:.6f}, (K1 path, plain tile raster) = {score_t:.6f} "
            f"(bar {PARITY_BAR})")
        if min(k1_launches.values()) <= 0:
            raise AssertionError(f"K1 was not launched on the chunked frame: {k1_launches}")
        if img.shape != (200, 320, 3) or img.std() < 1.0:
            raise AssertionError(f"chunked frame {img.shape} is flat")
        if drops != drops_p or score_p < PARITY_BAR:
            raise AssertionError(f"the chunked frame through K1 differs from K1's plain "
                                 f"version: drops {drops} vs {drops_p}, parity {score_p:.4f}")
        # K1's windows are fit to each view (nothing drops), so the frame
        # must match the untruncated tile raster
        if drops != (0, 0) or score_t < PARITY_BAR:
            raise AssertionError(f"chunked frame: K1 drops {drops}, parity {score_t:.4f} "
                                 f"against the tile raster (bar {PARITY_BAR})")
        record["chunked64_fill_frame"] = dict(parity_vs_k1_plain=score_p,
                                              parity_vs_tile_raster=score_t, drops=drops,
                                              k1_launches=k1_launches)

    sites = {tag: dict(launches=r["launches"]["k2_labels"], steps=CHUNKED_STEPS,
                       ms=r["labels_ms"], plain_ms=r["labels_plain_ms"],
                       bound_ms=r["labels_bound_ms"], bound_by=r["labels_bound_by"],
                       batch=r["labels_batch"], max_abs_err=r["labels_max_abs_err"])
             for tag, r in rows.items()}
    entry = next((k for k in kernels if k["name"] == "k2_labels"), None)
    if entry is None:  # --chunked-only: the chunked phases are the labels' main path
        r = rows["chunked64_fill"]
        entry = dict(name="k2_labels", route="cuda", source="impact_tpu_torch/csrc/ccl.cu",
                     replaces="impact_tpu/ops/ccl_pallas.py:45", launches=0, max_abs_err=0.0,
                     ms=r["labels_ms"], plain_ms=r["labels_plain_ms"],
                     bound_ms=r["labels_bound_ms"], bound_by=r["labels_bound_by"],
                     library_ms=None)
        kernels.append(entry)
    entry["launches"] += sum(v["launches"] for v in sites.values())
    entry["max_abs_err"] = max([entry["max_abs_err"]] + [v["max_abs_err"] for v in sites.values()])
    entry["chunked"] = sites


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


def card_query(field: str) -> str:
    """One ``nvidia-smi --query-gpu`` field of the first card (e.g.
    clocks.max.sm → "1980 MHz")."""
    import subprocess

    return subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


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
    ap.add_argument("--chunked-only", action="store_true",
                    help="run only the four chunked bench phases")
    ap.add_argument("--snapshots-only", action="store_true",
                    help="run only the scan solver, snapshot tester and scene physics phases")
    ap.add_argument("--scene-physics-only", action="store_true",
                    help="run only the scene physics phase and the textured-entity check")
    ap.add_argument("--api-only", action="store_true",
                    help="run only the API phase (quick start, resume, commands, run, "
                         "profile, the Voxel Range game)")
    ap.add_argument("--generation-only", action="store_true",
                    help="run only the generation phase (the generation world, its "
                         "orthographic frame, the voxel generator app)")
    ap.add_argument("--parity-only", action="store_true",
                    help="run only the parity phase (the reference tester's scenes, bf16 "
                         "shading, gizmos, the chunked rebake, the scene graph)")
    ap.add_argument("--surface-only", action="store_true",
                    help="run only the surface phase (image fixtures decoded, the JPEG-textured "
                         "box through K1, a single-region split through the labels kernel, "
                         "the brute-force chunk raster)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run only the parallel phase (the engine step sharded over the "
                         "voxel-object pool, the halo exchange, the pod-scale checks, the "
                         "body-sharded contact solve)")
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
    if args.chunked_only:
        kernels = []
        chunked_phases(dev, record, kernels)
        return finish(t_all, record, kernels, kind, count)
    if args.snapshots_only:
        kernels = []
        scan_phase(dev, record, kernels)
        snapshot_phase(dev, record, kernels)
        scene_physics_phase(dev, record, kernels)
        return finish(t_all, record, kernels, kind, count)
    if args.scene_physics_only:
        kernels = []
        scene_physics_phase(dev, record, kernels)
        return finish(t_all, record, kernels, kind, count)
    if args.api_only:
        kernels = []
        api_phase(dev, record, kernels)
        return finish(t_all, record, kernels, kind, count)
    if args.generation_only:
        kernels = []
        generation_phase(dev, record, kernels)
        return finish(t_all, record, kernels, kind, count)
    if args.parity_only:
        kernels = []
        parity_phase(dev, record, kernels)
        return finish(t_all, record, kernels, kind, count)
    if args.parallel_only:
        kernels = []
        parallel_phase(dev, record, kernels)
        return finish(t_all, record, kernels, kind, count)
    if args.surface_only:
        kernels = []
        surface_phase(dev, record, kernels)
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
        build = compile_scene(bench_scene(), cfg, device=dev)
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
            r = HeadlessRuntime(compile_scene(bench_scene(), c, device=where), c)
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

    from impact_tpu_torch.voxel.interaction import connected_component_labels_two_level

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
        two = connected_component_labels_two_level(occ64)
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
    chunked_phases(dev, record, kernels)
    scan_phase(dev, record, kernels)
    snapshot_phase(dev, record, kernels)
    scene_physics_phase(dev, record, kernels)
    api_phase(dev, record, kernels)
    generation_phase(dev, record, kernels)
    parity_phase(dev, record, kernels)
    parallel_phase(dev, record, kernels)
    surface_phase(dev, record, kernels)
    return finish(t_all, record, kernels, kind, count)


def record_scan_inputs(rt, before, steps, what, min_active=SCAN_MIN_ACTIVE):
    """Step ``rt`` ``before`` steps, then ``steps`` more, keeping the
    arguments of the ``scan_iterations`` call (the engine's solve calls it
    once per substep) with the most active slots. Fails below
    ``min_active`` active slots (SCAN_MIN_ACTIVE: the kernel's point is the
    chain of slots that share bodies, which a nearly empty substep does not
    exercise)."""
    from impact_tpu_torch.physics import solver

    rt.step(before)
    best, real = [None, -1], solver.scan_iterations

    def spy(*args):
        n = int(args[6].active.sum())
        if n > best[1]:
            best[:] = [args, n]
        return real(*args)

    solver.scan_iterations = spy
    try:
        rt.step(steps)
    finally:
        solver.scan_iterations = real
    if best[1] < min_active:
        raise AssertionError(f"scan inputs {what}: at most {best[1]} active slots in steps "
                             f"{before}-{before + steps}, fewer than {min_active}")
    return best[0]


def hold_scan(args, what):
    """The kernels against ``scan_iterations_plain`` on one recorded input:
    v, w, the impulses, positions and orientations must each be equal
    (``torch.equal``); a field past SCAN_RTOL / SCAN_ATOL_OF_MAGNITUDE is
    reported as such. The schedule the kernels wrote must equal
    ``scan_schedule``'s. Returns (max abs err, the plain loop's ms for one
    call, the ScanSchedule)."""
    import torch

    from impact_tpu_torch.physics import scan_solver

    *got, sched = scan_solver.scan_iterations(*args, with_schedule=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = scan_solver.scan_iterations_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, faults = 0.0, []
    for name, g, r in zip(("v", "w", "impulses", "position", "orientation"), got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"scan {what}: {name} is {tuple(g.shape)} or not finite")
        d = (g - r).abs()
        e = d.max().item() if d.numel() else 0.0
        err = max(err, e)
        atol = SCAN_ATOL_OF_MAGNITUDE * max(r.abs().max().item() if r.numel() else 0.0, 1.0)
        if bool((d > atol + SCAN_RTOL * r.abs()).any()):
            faults.append(f"{name} differs by {e:.3g} (rtol {SCAN_RTOL}, atol {atol:.3g})")
        elif not torch.equal(g, r):
            faults.append(f"{name} is not equal: {int((g != r).sum())} elements, max abs err "
                          f"{e:.3g} (within rtol {SCAN_RTOL}, atol {atol:.3g})")
    if faults:
        raise AssertionError(f"scan {what}: against the plain version: {'; '.join(faults)}")
    prep = args[6]
    want = scan_solver.scan_schedule(prep.body_a, prep.body_b, prep.active, args[4], args[5],
                                     args[3])
    if not torch.equal(sched, want.packed()):
        raise AssertionError(f"scan {what}: the kernels' schedule differs from scan_schedule's")
    return err, plain_ms, want


def pad_inputs(args, n_bodies: int, n_slots: int, like_body: int):
    """``scan_iterations``' arguments widened to ``n_bodies`` bodies and
    ``n_slots`` slots as wider pools would hold them: each extra slot a copy
    of the last one (which must be compaction's padding, inactive), each
    extra body at rest (zero v and w) with body ``like_body``'s pose,
    inverse mass and inverse inertia (an unused body slot)."""
    import torch

    v, w, pos, ori, inv_mass, inv_inertia, prep, acc, *rest = args
    if bool(prep.active[-1]):
        raise ValueError("the last slot must be inactive padding")

    def grow(t, size, row):
        return torch.cat([t, t[row][None].expand(size - t.shape[0], *t.shape[1:])])

    def at_rest(t):
        return torch.cat([t, t.new_zeros((n_bodies - t.shape[0], 3))])

    prep = prep._replace(**{f: grow(getattr(prep, f), n_slots, -1) for f in prep._fields})
    return (at_rest(v), at_rest(w), grow(pos, n_bodies, like_body),
            grow(ori, n_bodies, like_body), grow(inv_mass, n_bodies, like_body),
            grow(inv_inertia, n_bodies, like_body), prep, grow(acc, n_slots, -1), *rest)


def default_width_input(args):
    """The bench tumbler's recorded substep widened to the default
    EngineConfig's pools (``max_bodies`` × ``max_contacts``): extra slots
    copies of its padding (inactive on body 0), extra bodies at rest with
    the inverse mass and inertia of an unused body slot of the bench's
    state (the last body no slot points at with zero inverse mass)."""
    from impact_tpu_torch.utils.config import TpuConfig

    tc = TpuConfig()
    prep, im = args[6], args[4]
    used = set(prep.body_a.tolist()) | set(prep.body_b.tolist())
    unused = [i for i in range(im.shape[0]) if i not in used and float(im[i]) == 0.0]
    if not unused:
        raise AssertionError("the bench tumbler's state has no unused body slot")
    return pad_inputs(args, tc.max_bodies, tc.max_contacts, unused[-1]), unused[-1]


def record_scan_phase_inputs(dev):
    """The scan phase's four solver inputs, by name: one substep with at
    least SCAN_MIN_ACTIVE active slots of the snapshot VoxelBoxTumbler and
    of Bloom (128 slots), of the bench tumbler under scan (1024 slots), and
    the bench tumbler's widened to the default config."""
    from impact_tpu_torch.apps import snapshot_tester as st
    from impact_tpu_torch.models.bench import bench_config, bench_step_scene
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

    inputs = {}
    for name, (before, steps) in SCAN_RECORD_STEPS.items():
        inputs[name] = record_scan_inputs(st.build_runtime(name, dev), before, steps, name)
    cfg = bench_config()
    cfg.tpu.solver_mode = "scan"
    rt = HeadlessRuntime(compile_scene(bench_step_scene(), cfg, device=dev), cfg,
                         enable_fracturing=False)
    inputs["bench tumbler"] = record_scan_inputs(rt, *BENCH_SCAN_RECORD_STEPS, "bench tumbler")
    inputs["default width"], like = default_width_input(inputs["bench tumbler"])
    log(f"scan inputs default width: the bench tumbler's padded with copies of its last "
        f"slot and of its unused body {like}")
    for name, a in inputs.items():
        prep = a[6]
        log(f"scan inputs {name}: {a[0].shape[0]} bodies, {prep.active.shape[0]} slots, "
            f"{int(prep.active.sum())} active, {a[8]} velocity and {a[9]} correction sweeps")
    return inputs


def scan_phase(dev, record, kernels):
    """The scan solver's kernels on recorded solver inputs and on the bench
    tumbler's widened to the default config, and the bench tumbler stepped
    under scan and jacobi in turns."""
    import torch

    from impact_tpu_torch.devtools import cuda_time_ms
    from impact_tpu_torch.models.bench import bench_config, bench_step_scene
    from impact_tpu_torch.physics import scan_solver
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

    with Phase(f"scan solver: record one substep's solver inputs with at least "
               f"{SCAN_MIN_ACTIVE} active slots (snapshot VoxelBoxTumbler and Bloom, 128 "
               f"slots; bench tumbler under scan, 1024 slots; the bench tumbler's widened to "
               f"the default config)"):
        inputs = record_scan_phase_inputs(dev)

    rows = {}
    with Phase("scan solver kernels vs scan_iterations_plain on the recorded inputs (equal, "
               "and the kernels' schedule equal to scan_schedule's); timed"):
        clock_hz = float(card_query("clocks.max.sm").split()[0]) * 1e6
        for name, a in inputs.items():
            err, plain, sch = hold_scan(a, name)
            ms = kernel_ms(lambda a=a: scan_solver.scan_iterations(*a),
                           ("scan_velocity_kernel", "scan_correction_kernel"))
            vel_ms = kernel_ms(lambda a=a: scan_solver.scan_iterations(*a),
                               "scan_velocity_kernel")
            wrapper = cuda_time_ms(lambda a=a: scan_solver.scan_iterations(*a), reps=20)
            n, c = a[0].shape[0], a[6].active.shape[0]
            bound, by = scan_solver.bound_ms(n, c, a[8], a[9])
            chain = scan_solver.chain_bound_ms(sch.velocity_depth, sch.correction_depth, a[8],
                                               a[9], clock_hz)
            runs = sch.runs[:, 1].tolist()
            # inactive slots on two fixed bodies: no node, never walked
            dropped = int((sch.correction_level == 0).sum())
            rows[name] = dict(bodies=n, slots=c, active=int(a[6].active.sum()),
                              velocity_fixed=int(sch.velocity_fixed.sum()),
                              correction_fixed=int(sch.correction_fixed.sum()),
                              velocity_levels=sch.velocity_depth,
                              correction_levels=sch.correction_depth, runs=runs,
                              slots_on_fixed_bodies=dropped,
                              max_abs_err=err, ms=ms, velocity_ms=vel_ms,
                              wrapper_ms=wrapper, plain_ms=plain, bound_ms=bound, bound_by=by,
                              chain_bound_ms=chain, sm_clock_hz=clock_hz,
                              us_per_level=ms * 1e3 / max(a[8] * sch.velocity_depth
                                                          + a[9] * sch.correction_depth, 1))
            log(f"scan {name}: equal to the plain version, schedule equal to scan_schedule's; "
                f"{rows[name]['active']} active of {c} slots, fixed bodies "
                f"{rows[name]['velocity_fixed']} (velocity) and "
                f"{rows[name]['correction_fixed']} (correction), {sch.velocity_depth} levels "
                f"a velocity sweep, "
                f"{sch.correction_depth} a correction sweep, runs collapsed {runs}, "
                f"{dropped} inactive slots on two fixed bodies not walked; kernels "
                f"alone {ms:.4f} ms (velocity sweeps {vel_ms:.4f} ms), wrapper {wrapper:.4f} "
                f"ms, plain {plain:.1f} ms (1 call); bound {bound:.7f} ms ({by}), chain bound "
                f"{chain:.5f} ms at {clock_hz / 1e6:.0f} MHz")
        record["scan_kernels"] = rows

    with Phase(f"bench tumbler step (80 bodies, 1024 slots): jacobi and scan in turns "
               f"(jacobi, scan, scan, jacobi), {SCAN_TURN_STEPS} steps a turn"):
        rts = {}
        for mode in ("jacobi", "scan"):
            c = bench_config()
            c.tpu.solver_mode = mode
            rts[mode] = HeadlessRuntime(compile_scene(bench_step_scene(), c, device=dev), c,
                                        enable_fracturing=False)
            rts[mode].step(2)
        turns = {"jacobi": [], "scan": []}
        launches = {}
        for mode in ("jacobi", "scan", "scan", "jacobi"):
            scan_solver.LAUNCHES.reset()
            rts[mode].step(SCAN_TURN_STEPS)
            turns[mode].append(rts[mode].step_ms / SCAN_TURN_STEPS)
            launches[mode] = sum(scan_solver.LAUNCHES.values()) / SCAN_TURN_STEPS
        total = {}
        for mode, r in rts.items():
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                r.step(2)
            total[mode] = sum(e.count for e in prof.key_averages()
                              if getattr(e, "device_type", None)
                              == torch.autograd.DeviceType.CUDA) / 2
            if not body_state_finite(r.sim):
                raise AssertionError(f"non-finite bodies stepping the bench tumbler under {mode}")
        if launches["scan"] != 2 or launches["jacobi"] != 0:
            raise AssertionError(f"scan kernel launches per step: {launches}")
        log(f"bench tumbler step ms, turns jacobi/scan/scan/jacobi: jacobi {turns['jacobi']}, "
            f"scan {turns['scan']}; scan kernel launches per step {launches}; CUDA kernels "
            f"launched per step (torch.profiler, 2 steps): {total}")
        record["bench_tumbler_scan_vs_jacobi"] = dict(step_ms=turns, scan_launches=launches,
                                                      kernels_per_step=total)
    bench = rows["bench tumbler"]
    kernels.append(dict(
        name="scan_solver", route="cuda", source="impact_tpu_torch/csrc/scan_solver.cu",
        replaces="impact_tpu/physics/solver.py:258 (lax.scan, no pallas_call)", launches=None,
        max_abs_err=max(r["max_abs_err"] for r in rows.values()),
        ms=bench["ms"], plain_ms=bench["plain_ms"], bound_ms=bench["bound_ms"],
        bound_by=bench["bound_by"], library_ms=None, chain_bound_ms=bench["chain_bound_ms"],
        wrapper_ms=bench["wrapper_ms"], snapshot_ms=rows["VoxelBoxTumbler"]["ms"],
        default_width_ms=rows["default width"]["ms"]))


def held_k1(held):
    """K1's two wrappers, each holding every launch it makes against K1's
    plain version on the same inputs (``compare_k1``: depth, z and valid
    equal, attributes within ATTR_ATOL); ``held`` gathers the count and the
    largest error. Returns (depth, attributes) to put in place of
    ``raster_pallas.raster_depth`` and ``raster_attributes``."""
    from impact_tpu_torch.render import raster_pallas as rp

    run_depth, run_attr = rp.raster_depth, rp.raster_attributes

    def depth(b):
        out = run_depth(b)
        err = compare_k1(out, rp.raster_depth_plain(b), 0,
                         f"K1 depth view {b.height}x{b.width}")
        held["depth"] += 1
        held["max_abs_err"] = max(held["max_abs_err"], err)
        return out

    def attributes(b, n_attr):
        out = run_attr(b, n_attr)
        err = compare_k1(out, rp.raster_attributes_plain(b, n_attr), n_attr,
                         f"K1 G-buffer {b.height}x{b.width}")
        held["attributes"] += 1
        held["max_abs_err"] = max(held["max_abs_err"], err)
        return out

    return depth, attributes


def snapshot_phase(dev, record, kernels):
    """The snapshot tester's 20 scenes through its runner: K1's frame
    scored against the golden, each K1 launch held against K1's plain
    version, and the plain tile raster's frame of the same state against
    K1's."""
    import torch

    from impact_tpu_torch.apps import snapshot_tester as st
    from impact_tpu_torch.physics import scan_solver
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.utils.image import rgb_hybrid_compare

    rows, failed = {}, []
    held = dict(depth=0, attributes=0, max_abs_err=0.0)
    with Phase(f"snapshot tester: {len(st.PORTED_SCENES)} scenes, K1's frame scored against "
               f"its golden at {st.MIN_SCORE_TO_PASS}, every K1 launch against K1's plain "
               f"version, the plain tile raster's frame against K1's at "
               f"{st.RASTER_PARITY_BAR}"):
        run_depth, run_attr = rp.raster_depth, rp.raster_attributes
        rp.raster_depth, rp.raster_attributes = held_k1(held)
        rp.LAUNCHES.reset()
        scan_solver.LAUNCHES.reset()
        try:
            for name, warmup in st.PORTED_SCENES:
                t0 = time.perf_counter()
                img, rt = st.render_scene(name, dev)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                golden_score = st.score(name, img)
                parity = rgb_hybrid_compare(img, st.render_again(rt, "raster"))
                ok = (golden_score >= st.MIN_SCORE_TO_PASS
                      and parity >= st.RASTER_PARITY_BAR)
                rows[name] = dict(score=golden_score, vs_tile_raster=parity,
                                  drops=list(rt.last_drops), warmup_steps=warmup,
                                  step_ms=rt.step_ms, stage_ms=dict(rt.stage_ms),
                                  frame_ms=sum(rt.stage_ms.values()), seconds=seconds,
                                  finite=body_state_finite(rt.sim))
                log(f"[{'PASS' if ok else 'FAIL'}] {name}: K1 frame golden score "
                    f"{golden_score:.4f} (bar {st.MIN_SCORE_TO_PASS}), vs the plain tile "
                    f"raster's frame {parity:.4f} (bar {st.RASTER_PARITY_BAR}), K1 drops "
                    f"(geometry, shadows) {rt.last_drops}; {warmup} steps in "
                    f"{rt.step_ms:.1f} ms, frame {rows[name]['frame_ms']:.1f} ms (stages "
                    f"{ {k: round(v, 2) for k, v in rt.stage_ms.items()} })")
                if not (ok and rows[name]["finite"]):
                    failed.append(name)
        finally:
            rp.raster_depth, rp.raster_attributes = run_depth, run_attr
        path_launches = {**dict(rp.LAUNCHES), **dict(scan_solver.LAUNCHES)}
        log(f"snapshot path launches: {path_launches}; K1 launches held against K1's plain "
            f"version: {held}")
        record["snapshots"] = rows
        record["snapshot_launches"] = path_launches
        record["snapshot_k1_held"] = held
        if failed:
            raise AssertionError(f"snapshot scenes failed: {failed}")
        for name, cnt in path_launches.items():
            if cnt <= 0:
                raise AssertionError(f"{name} was not launched on the snapshot path")
        if (held["depth"], held["attributes"]) != (path_launches["k1_raster_depth"],
                                                   path_launches["k1_raster_attributes"]):
            raise AssertionError(f"K1 launches {path_launches} but {held} held")
    for k in kernels:
        if k["name"] == "scan_solver":
            k["launches"] = path_launches["scan_velocity_iterations"] + path_launches[
                "scan_position_correction"]


def textured_box_textures():
    """The textured box's three 32² textures by name."""
    from impact_tpu_torch.render.textures import checkerboard, noise_normal_map, value_noise

    return dict(checker=checkerboard(32, tiles=8),
                normal=noise_normal_map(32, cells=6, seed=2, strength=4.0),
                height=value_noise(32, cells=4, seed=9))


def textured_box_scene(colour_source=None):
    """tests/test_textured_materials.py's scene as a port world: a box mesh
    entity with a checkerboard colour, a noise normal map and a parallax
    height map (32² textures, registered with ``register_texture``), lit by
    ambient and a directional light. ``colour_source`` (an image file's
    path) replaces the checkerboard as the colour texture."""
    import math

    from impact_tpu_torch.ecs import World
    from impact_tpu_torch.ecs import components as C
    from impact_tpu_torch.runtime.setup import register_texture

    textures = textured_box_textures()
    if colour_source is not None:
        textures["checker"] = str(colour_source)
    ids = {k: register_texture(f"textured-box-{k}", v) for k, v in textures.items()}
    w = World()
    w.create_entity(C.ReferenceFrame(position=(0.0, 0.0, 0.0), orientation=(0.0, 1.0, 0.0, 0.0)),
                    C.PerspectiveCamera(vertical_field_of_view=math.radians(50),
                                        near_distance=0.01, far_distance=100.0))
    w.create_entity(C.AmbientEmission(illuminance=(3e3, 3e3, 3e3)))
    w.create_entity(C.BoxMesh(), C.ModelTransform(scale=1.4),
                    C.ReferenceFrame(position=(0.0, 0.0, 2.6)),
                    C.UniformColor(color=(0.6, 0.6, 0.6)),
                    C.TexturedColor(texture_id=ids["checker"]),
                    C.NormalMap(texture_id=ids["normal"]),
                    C.ParallaxMap(height_map_texture_id=ids["height"], displacement_scale=0.08))
    w.create_entity(C.UnidirectionalEmission(perpendicular_illuminance=(3e3, 3e3, 3e3),
                                             direction=(0.4, -0.4, 0.8),
                                             angular_source_extent=0.0))
    return w


def textured_box_config(cfg):
    """The textured box's 128x96 configuration (tests/test_textured_materials.py:
    _cfg), set on an engine config of either package."""
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 1, 8, 32, 8
    t.render_width, t.render_height, t.texture_resolution = 128, 96, 32
    cfg.rendering.shadow_mapping.enabled = False
    return cfg


def scene_physics_phase(dev, record, kernels):
    """HarmonicOscillation, FreeRotation and DragDrop (as written, and in a
    medium of density 10) stepped at the snapshot configuration and each
    rendered through K1 with every launch held against K1's plain version;
    the analytic and conservation checks; FreeRotation's short run against
    the CPU's; one DragDrop substep's scan kernels held equal to their
    plain loop; and a textured box entity through K1 against the plain tile
    raster's frame."""
    import math

    import torch

    from impact_tpu_torch.apps import snapshot_tester as st
    from impact_tpu_torch.models import SCENES
    from impact_tpu_torch.physics import scan_solver
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.utils.config import EngineConfig
    from impact_tpu_torch.utils.image import rgb_hybrid_compare

    def runtime(name, medium=0.0, device=dev, max_contacts=None):
        cfg = st.snapshot_config()
        cfg.tpu.max_contacts = max_contacts or cfg.tpu.max_contacts
        cfg.physics.medium.mass_density = medium
        cfg.physics.rigid_body_force.drag_load_map_config.directory = None
        return HeadlessRuntime(compile_scene(SCENES[name](), cfg, device=device), cfg)

    rows = {}
    held = dict(depth=0, attributes=0, max_abs_err=0.0)
    with Phase(f"scene physics: HarmonicOscillation, FreeRotation and DragDrop at the "
               f"snapshot configuration ({SCENE_PHYSICS_STEPS} steps of 0.01 s, scan), a K1 "
               f"frame of each with every launch held against K1's plain version"):
        run_depth, run_attr = rp.raster_depth, rp.raster_attributes
        rp.raster_depth, rp.raster_attributes = held_k1(held)
        rp.LAUNCHES.reset()
        scan_solver.LAUNCHES.reset()
        try:
            rts = {}
            for name, medium in (("HarmonicOscillation", 0.0), ("FreeRotation", 0.0),
                                 ("DragDrop", 0.0), ("DragDrop", 10.0)):
                key = name if medium == 0.0 else f"{name} (medium {medium:g})"
                rt = rts[key] = runtime(name, medium)
                l0 = rt.sim.phys.bodies.angular_momentum[0].clone()
                rt.step(FALL_STEPS)
                fall_ms = rt.step_ms
                fall_vy = rt.sim.phys.bodies.velocity[1:3, 1].tolist()
                rest = SCENE_PHYSICS_STEPS - FALL_STEPS
                if medium > 0.0:
                    # the substep of the floor contacts, for the scan hold below
                    before, steps = DRAG_DROP_SCAN_STEPS
                    scan_args = record_scan_inputs(rt, before - FALL_STEPS, steps, "DragDrop",
                                                   min_active=1)
                    rest -= before - FALL_STEPS + steps
                    fall_ms += rt.step_ms
                rt.step(rest)
                t0 = time.perf_counter()
                img = rt.render()
                torch.cuda.synchronize()
                b = rt.sim.phys.bodies
                rows[key] = dict(step_ms=(fall_ms + rt.step_ms) / SCENE_PHYSICS_STEPS,
                                 steps=SCENE_PHYSICS_STEPS,
                                 fall_vy=fall_vy,
                                 frame_ms=(time.perf_counter() - t0) * 1e3,
                                 finite=body_state_finite(rt.sim), drops=list(rt.last_drops),
                                 frame_mean=float(img.float().mean()),
                                 l0=l0.tolist(), l1=b.angular_momentum[0].tolist())
                if not rows[key]["finite"]:
                    raise AssertionError(f"{key}: non-finite body state")
        finally:
            rp.raster_depth, rp.raster_attributes = run_depth, run_attr
        launches = {**dict(rp.LAUNCHES), **dict(scan_solver.LAUNCHES)}

        osc = rts["HarmonicOscillation"].sim.phys
        t = float(osc.time)
        want = 2.0 + 2.0 * math.sin(2.0 * math.pi * t / 2.0)
        pos = osc.bodies.position[0].tolist()
        osc_err = max(abs(pos[0]), abs(pos[1] - want), abs(pos[2]))
        log(f"HarmonicOscillation at t = {t:.4f} s: position {pos}, center + dir·A·"
            f"sin(2πt/T) = (0, {want:.6f}, 0), max abs err {osc_err:.3g} (bar "
            f"{OSC_ATOL})")
        if osc_err > OSC_ATOL:
            raise AssertionError(f"the oscillator is {osc_err:.3g} off its driver's path")

        rot = rts["FreeRotation"].sim.phys.bodies
        l0 = torch.tensor(rows["FreeRotation"]["l0"], device=dev)
        l_err = float((rot.angular_momentum[0] - l0).norm() / l0.norm())
        q_err = abs(float(rot.orientation[0].norm()) - 1.0)
        log(f"FreeRotation: angular momentum {rot.angular_momentum[0].tolist()} against "
            f"{l0.tolist()} (relative err {l_err:.3g}), |q| - 1 = {q_err:.3g} (bar "
            f"{CONSERVED_RTOL})")
        if l_err > CONSERVED_RTOL or q_err > CONSERVED_RTOL:
            raise AssertionError("FreeRotation does not keep its angular momentum and a unit "
                                 "quaternion")
        # what the card computes for it (the integration, the scan kernels'
        # renormalizing walk of the idle slots), against the port on the CPU
        rot_err = {}
        rot_runs = [runtime("FreeRotation", device=d, max_contacts=ROT_CPU_CONTACTS)
                    for d in (dev, "cpu")]
        for r in rot_runs:
            r.step(ROT_CPU_STEPS)
        for f in ("orientation", "angular_velocity"):
            got, want = (getattr(r.sim.phys.bodies, f)[0].cpu() for r in rot_runs)
            atol = SCAN_ATOL_OF_MAGNITUDE * max(float(want.abs().max()), 1.0)
            rot_err[f] = float((got - want).abs().max())
            log(f"FreeRotation {f} after {ROT_CPU_STEPS} steps at {ROT_CPU_CONTACTS} contact "
                f"slots: card {got.tolist()}, CPU "
                f"{want.tolist()} (rtol {SCAN_RTOL}, atol {atol:.3g})")
            if not torch.allclose(got, want, rtol=SCAN_RTOL, atol=atol):
                raise AssertionError(f"FreeRotation {f}: the card is off the CPU port's run")

        fall = {k: rows[k]["fall_vy"] for k in ("DragDrop", "DragDrop (medium 10)")}
        log(f"DragDrop vertical velocities (drag-free, drag 4) after {FALL_STEPS} steps: as "
            f"written {fall['DragDrop']}, in a medium of density 10 "
            f"{fall['DragDrop (medium 10)']}")
        if fall["DragDrop"][0] != fall["DragDrop"][1]:
            raise AssertionError("DragDrop as written: the spheres fall differently, but the "
                                 "default medium (density 0) gives no drag")
        drag_free, drag = fall["DragDrop (medium 10)"]
        if not drag > drag_free:
            raise AssertionError("DragDrop in a medium: the drag sphere does not fall slower")
        log(f"scene physics launches {launches}; K1 launches held against K1's plain version: "
            f"{held}; per scene {rows}")
        for name, cnt in launches.items():
            if cnt <= 0:
                raise AssertionError(f"{name} was not launched on the scene physics path")
        if (held["depth"], held["attributes"]) != (launches["k1_raster_depth"],
                                                   launches["k1_raster_attributes"]):
            raise AssertionError(f"K1 launches {launches} but {held} held")
        record["scene_physics"] = dict(rows=rows, launches=launches, k1_held=held,
                                       oscillator_err=osc_err, angular_momentum_err=l_err,
                                       quaternion_err=q_err, rotation_vs_cpu=rot_err, fall=fall)

    with Phase("scene physics: the DragDrop substep with floor contacts recorded above, the "
               "scan kernels against scan_iterations_plain"):
        err, plain_ms, _ = hold_scan(scan_args, "DragDrop")
        prep = scan_args[6]
        log(f"scan DragDrop: {int(prep.active.sum())} active of {prep.active.shape[0]} "
            f"slots, equal to the plain version (plain loop {plain_ms:.1f} ms)")
        record["scene_physics"]["scan_held"] = dict(max_abs_err=err, plain_ms=plain_ms)

    with Phase("textured box entity (colour, normal and parallax maps) through K1, against "
               "the plain tile raster's frame"):
        scene, cfg = textured_box_scene(), textured_box_config(EngineConfig())
        rp.LAUNCHES.reset()
        rt = HeadlessRuntime(compile_scene(scene, cfg, device=dev), cfg, enable_fracturing=False)
        img = rt.render().cpu().numpy()
        if rp.LAUNCHES["k1_raster_attributes"] <= 0:
            raise AssertionError("the textured box frame did not go through K1")
        parity = rgb_hybrid_compare(img, st.render_again(rt, "raster"))
        face_std = float(img[28:68, 44:84].astype("float32").std(axis=(0, 1)).max())
        log(f"textured box: K1 frame vs the plain tile raster's {parity:.4f} (bar "
            f"{PARITY_BAR}), face colour spread {face_std:.1f}")
        if parity < PARITY_BAR or face_std <= 8.0:
            raise AssertionError(f"textured box: parity {parity:.4f}, face spread {face_std}")
        record["scene_physics"]["textured_box"] = dict(parity=parity, face_std=face_std)
    for k in kernels:
        if k["name"] == "scan_solver":
            k["scene_physics_launches"] = (launches["scan_velocity_iterations"]
                                           + launches["scan_position_correction"])


def sim_states_equal(a, b) -> bool:
    """Every tensor of two SimStates equal, and the generators' states."""
    import torch

    for x, y in zip(a, b):
        if isinstance(x, torch.Generator):
            if not torch.equal(x.get_state(), y.get_state()):
                return False
        elif hasattr(x, "_fields"):
            if not sim_states_equal(x, y):
                return False
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def api_phase(dev, record, kernels):
    """The reference's public API on the card, with every K1 launch held
    against K1's plain version: the quick start (README.md:41-57 with
    ``impact_tpu_torch``: an EngineConfig equal to the one RON gives,
    ``voxel_box_tumbler(n_boxes=4)``, ``compile_scene`` with no device,
    100 steps, a render, a checkpoint); the resume (save, 10 steps, load,
    10 steps: the states within SCAN_RTOL and SCAN_ATOL_OF_MAGNITUDE, the
    scan's warm start summing with atomics in no fixed order); the commands
    (pause, resume, set_n_iterations, set_bloom_enabled, reset_world, an
    unknown one); ``run(20, render_every=5)``; a ``profile`` trace naming K1
    and the scan kernels; and the Voxel Range game at its defaults
    (``impact_tpu_torch.apps.impact_game.play``), won, with one substep's
    scan kernels held equal to their plain loop and every grid its split
    checks labelled held equal to the plain labelling."""
    import tempfile

    import torch

    from impact_tpu_torch.apps import impact_game
    from impact_tpu_torch.models import voxel_box_tumbler
    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.physics import scan_solver, solver
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.utils.config import EngineConfig
    from impact_tpu_torch.voxel import interaction

    rows = {}
    held = dict(depth=0, attributes=0, max_abs_err=0.0)
    launches = dict.fromkeys(("k1_raster_attributes", "k1_raster_depth",
                              "scan_velocity_iterations", "scan_position_correction",
                              "k2_labels", "k2_ccl", "k2_ccl_wide"), 0)
    counters = (rp.LAUNCHES, scan_solver.LAUNCHES, k2.LAUNCHES)

    def reset():
        for c in counters:
            c.reset()

    def add():
        for c in counters:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_api_")
    run_depth, run_attr = rp.raster_depth, rp.raster_attributes
    rp.raster_depth, rp.raster_attributes = held_k1(held)
    try:
        with Phase(f"API: the reference's quick start (voxel_box_tumbler(n_boxes=4), "
                   f"{QUICK_START_STEPS} steps, a render, a checkpoint) through "
                   f"impact_tpu_torch"):
            cfg = EngineConfig()
            cfg.tpu.max_voxel_objects = 8
            cfg.tpu.max_bodies = 24
            if EngineConfig.from_ron_str(QUICK_START_RON) != cfg:
                raise AssertionError(f"EngineConfig.from_ron_str({QUICK_START_RON!r}) differs "
                                     "from the quick start's config")
            world = voxel_box_tumbler(n_boxes=4)
            reset()
            rt = HeadlessRuntime(compile_scene(world, cfg), cfg)
            rt.step(QUICK_START_STEPS)
            quick_ms = rt.step_ms / QUICK_START_STEPS
            img = rt.render()
            ckpt = rt.save_checkpoint(os.path.join(tmp.name, "sim.npz"))
            torch.cuda.synchronize()
            add()
            pos = rt.sim.phys.bodies.position
            log(f"quick start: state on {pos.device}, {QUICK_START_STEPS} steps at "
                f"{quick_ms:.2f} ms each, frame {tuple(img.shape)} in "
                f"{sum(rt.stage_ms.values()):.1f} ms, checkpoint {os.path.getsize(ckpt)} B, "
                f"launches {launches}")
            if pos.device != dev or img.device != dev:
                raise AssertionError(f"compile_scene with no device put the state on "
                                     f"{pos.device}, not on {dev}")
            if not body_state_finite(rt.sim):
                raise AssertionError("quick start: non-finite body state")
            if tuple(img.shape) != (192, 256, 3) or img.float().std().item() < 1.0:
                raise AssertionError(f"quick start: frame {tuple(img.shape)} is flat")
            if launches["k1_raster_attributes"] <= 0:
                raise AssertionError("the quick start's frame did not go through K1")
            rows["quick_start"] = dict(step_ms=quick_ms, frame_ms=sum(rt.stage_ms.values()),
                                       checkpoint_bytes=os.path.getsize(ckpt))

        with Phase(f"API: resume (save, {RESUME_STEPS} steps, load, {RESUME_STEPS} steps)"):
            reset()
            rt.step(RESUME_STEPS)
            first = rt.sim
            rt.load_checkpoint(ckpt)
            rt.step(RESUME_STEPS)
            add()
            diffs = {}
            for f in ("position", "orientation", "velocity", "angular_velocity", "momentum",
                      "angular_momentum"):
                got, want = getattr(rt.sim.phys.bodies, f), getattr(first.phys.bodies, f)
                atol = SCAN_ATOL_OF_MAGNITUDE * max(float(want.abs().max()), 1.0)
                diffs[f] = float((got - want).abs().max())
                if not torch.allclose(got, want, rtol=SCAN_RTOL, atol=atol):
                    raise AssertionError(f"resume: {f} differs by {diffs[f]:.3g} (rtol "
                                         f"{SCAN_RTOL}, atol {atol:.3g})")
            log(f"resume: largest difference per field {diffs} (rtol {SCAN_RTOL}, atol "
                f"{SCAN_ATOL_OF_MAGNITUDE} of each field's magnitude); bitwise equal: "
                f"{sim_states_equal(rt.sim.phys.bodies, first.phys.bodies)}")
            rows["resume"] = dict(max_abs_diff=diffs)

        with Phase("API: commands (pause, resume, set_n_iterations, set_bloom_enabled, "
                   "reset_world, an unknown one)"):
            reset()
            before = rt.sim
            rt.enqueue_command("game_loop", "pause")
            rt.step(5)
            if not (rt.paused and sim_states_equal(rt.sim, before)):
                raise AssertionError("pause: step changed the state")
            rt.enqueue_command("game_loop", "resume")
            rt.step(1)
            if torch.equal(rt.sim.phys.bodies.position, before.phys.bodies.position):
                raise AssertionError("resume: step did not advance the state")
            old_step = rt._step
            rt.enqueue_command("physics", "set_n_iterations", 4)
            rt.step(1)
            if rt._step is old_step or rt.config.physics.constraint_solver.n_iterations != 4:
                raise AssertionError("set_n_iterations did not rebuild the step")
            rt.enqueue_command("rendering", "set_bloom_enabled", False)
            rt.apply_commands()
            if rt.render_config.bloom_enabled:
                raise AssertionError("set_bloom_enabled did not rebuild the render config")
            rt.render()
            rt.enqueue_command("system", "reset_world")
            rt.apply_commands()
            if not sim_states_equal(rt.sim.phys, rt._initial_sim.phys):
                raise AssertionError("reset_world did not give back the compiled state")
            rt.enqueue_command("rendering", "no_such_command", 1)
            try:
                rt.apply_commands()
            except ValueError as e:
                log(f"commands: the unknown command raised ValueError({e})")
            else:
                raise AssertionError("an unknown command did not raise")
            torch.cuda.synchronize()
            add()

        with Phase(f"API: run({RUN_FRAMES}, render_every={RUN_EVERY})"):
            reset()
            frames = rt.run(RUN_FRAMES, render_every=RUN_EVERY)
            torch.cuda.synchronize()
            add()
            fps = rt.metrics.fps
            log(f"run: {len(frames)} frames, smoothed frame {1e3 / fps if fps else 0:.2f} ms "
                f"({fps:.1f} fps), timer {rt.metrics.last_task_execution_times}")
            if len(frames) != RUN_FRAMES // RUN_EVERY or not fps > 0:
                raise AssertionError(f"run returned {len(frames)} frames at {fps} fps")
            rows["run"] = dict(frames=len(frames), fps=fps)

        with Phase("API: profile of one step and one render (torch.profiler, CUDA activity)"):
            # torch.profiler on the card now and then loses every record of a
            # kernel (kernel_ms): profile again, up to three times. K1's
            # launches are held against its plain version after the trace,
            # so that the trace holds the frame's own work
            reset()
            recorded = []

            def rec_depth(b):
                out = run_depth(b)
                recorded.append((b, 0, out))
                return out

            def rec_attr(b, n_attr):
                out = run_attr(b, n_attr)
                recorded.append((b, n_attr, out))
                return out

            hold_depth, hold_attr = rp.raster_depth, rp.raster_attributes
            rp.raster_depth, rp.raster_attributes = rec_depth, rec_attr
            for attempt in range(1, 4):
                trace_dir = os.path.join(tmp.name, f"trace{attempt}")
                t0 = time.perf_counter()
                with rt.profile(trace_dir) as prof:
                    rt.step(1)
                    rt.render()
                traced_s = time.perf_counter() - t0
                names = {e.key for e in prof.key_averages()}
                with open(os.path.join(trace_dir, "trace.json")) as f:
                    trace = f.read()
                # device events carry the kernels' signatures: match by name
                missing = [k for k in API_KERNELS.values()
                           if not any(k in n for n in names) or k not in trace]
                log(f"profile {attempt}: {len(names)} event names, trace {len(trace)} B "
                    f"(traced and written in {traced_s:.2f} s); the K1 and scan kernels "
                    f"{'all named' if not missing else f'missing {missing}'}")
                if not missing:
                    break
            rp.raster_depth, rp.raster_attributes = hold_depth, hold_attr
            for b, n_attr, out in recorded:
                plain = (rp.raster_attributes_plain(b, n_attr) if n_attr
                         else rp.raster_depth_plain(b))
                err = compare_k1(out, plain, n_attr, f"K1 profiled view {b.height}x{b.width}")
                held["attributes" if n_attr else "depth"] += 1
                held["max_abs_err"] = max(held["max_abs_err"], err)
            add()
            if missing:
                raise AssertionError(f"the profile trace does not name {missing}")
            rows["profile"] = dict(attempts=attempt, trace_bytes=len(trace))

        with Phase("API: the Voxel Range game at its defaults (impact_game.play: 3 targets, "
                   "3 shots, 400 frames, 16^3 grids, 24 object slots) on the card"):
            reset()
            grids, best = [], [None, -1]
            run_labels, run_scan = interaction.connected_component_labels_batched, \
                solver.scan_iterations

            def rec_labels(occ):
                grids.append(occ.clone())
                return run_labels(occ)

            def rec_scan(*args):
                n = int(args[6].active.sum())
                if n > best[1]:
                    best[:] = [args, n]
                return run_scan(*args)

            step_ms, run_step = [], HeadlessRuntime.step

            def rec_step(self, n=1):
                out = run_step(self, n)
                step_ms.append(self.step_ms)
                return out

            interaction.connected_component_labels_batched = rec_labels
            solver.scan_iterations = rec_scan
            HeadlessRuntime.step = rec_step
            try:
                t0 = time.perf_counter()
                result = impact_game.play(render_dir=os.path.join(tmp.name, "game"),
                                          render_every=GAME_RENDER_EVERY)
                torch.cuda.synchronize()
                game_s = time.perf_counter() - t0
            finally:
                interaction.connected_component_labels_batched = run_labels
                solver.scan_iterations = run_scan
                HeadlessRuntime.step = run_step
            steps = sorted(step_ms)
            step_stats = dict(median=steps[len(steps) // 2], p90=steps[int(len(steps) * 0.9)],
                              max=steps[-1], mean=sum(steps) / len(steps),
                              first_100_mean=sum(step_ms[:100]) / 100,
                              last_100_mean=sum(step_ms[-100:]) / 100)
            game_launches = {k: v for c in counters for k, v in c.items()}
            add()
            frame_ms = game_s / result["frames"] * 1e3
            log(f"game: {result}; {game_s:.2f} s for {result['frames']} frames, "
                f"{frame_ms:.2f} ms a frame (a step and the score's host read, and a "
                f"render every {GAME_RENDER_EVERY}); step ms "
                f"{ {k: round(v, 2) for k, v in step_stats.items()} }; launches {game_launches}; "
                f"{len(grids)} labelling calls on {sum(x.shape[0] for x in grids)} grids; "
                f"the busiest substep held {best[1]} active contact slots")
            rows["game"] = dict(result=result, seconds=game_s, frame_ms=frame_ms,
                                step_ms=step_stats,
                                launches=game_launches, labelled_grids=sum(x.shape[0]
                                                                           for x in grids))
            if not result["won"]:
                raise AssertionError(f"the game was not won: {result}")
            for name in ("k1_raster_attributes", "k1_raster_depth", "scan_velocity_iterations",
                         "scan_position_correction", "k2_labels"):
                if game_launches[name] <= 0:
                    raise AssertionError(f"{name} was not launched in the game")
    finally:
        rp.raster_depth, rp.raster_attributes = run_depth, run_attr

    with Phase("API: the game's busiest substep through the scan kernels against their plain "
               "loop, and every grid the game labelled against the plain labelling"):
        scan_err, plain_ms, _ = hold_scan(best[0], "game")
        batches = [x for x in grids if x.shape[0] > 0]
        if not batches:
            raise AssertionError("the game's split checks labelled no grid")
        # each grid is labelled on its own, so one batch of all of them holds
        # every grid the game labelled in one kernel call and one plain call
        occ = torch.cat(batches)
        got, ref = k2.connected_component_labels_batched(occ), labels_plain(occ)
        if not torch.equal(got, ref):
            raise AssertionError(f"labels of the game's grids: {int((got != ref).sum())} "
                                 f"differ from the plain version")
        labels_err = int((got.long() - ref.long()).abs().max())
        log(f"game: scan kernels equal to the plain loop on {best[1]} active slots (plain loop "
            f"{plain_ms:.1f} ms); labels equal to the plain labelling on the {occ.shape[0]} "
            f"grids of its {len(batches)} labelling calls")
        rows["game"].update(scan_held=dict(active=best[1], max_abs_err=scan_err),
                            labels_held=dict(grids=occ.shape[0], max_abs_err=labels_err))
    tmp.cleanup()
    held_total = held["depth"] + held["attributes"]
    k1_total = launches["k1_raster_depth"] + launches["k1_raster_attributes"]
    log(f"API phase launches {launches}; K1 launches held against K1's plain version {held}")
    if (held["depth"], held["attributes"]) != (launches["k1_raster_depth"],
                                               launches["k1_raster_attributes"]):
        raise AssertionError(f"K1 launches {launches} but {held} held ({held_total} of "
                             f"{k1_total})")
    record["api"] = dict(rows, launches=launches, k1_held=held)
    api_launches = {"k1_raster_attributes": launches["k1_raster_attributes"],
                    "k1_raster_depth": launches["k1_raster_depth"],
                    "k2_labels": launches["k2_labels"],
                    "scan_solver": launches["scan_velocity_iterations"]
                    + launches["scan_position_correction"]}
    errs = {"k1_raster_attributes": held["max_abs_err"], "k1_raster_depth": held["max_abs_err"],
            "k2_labels": float(labels_err), "scan_solver": scan_err}
    for name, n in api_launches.items():
        entry = next((k for k in kernels if k["name"] == name), None)
        if entry is None:  # --api-only: the phase's own record
            entry = dict(name=name, route="cuda", max_abs_err=errs[name])
            kernels.append(entry)
        entry["api_launches"] = n


def sign_flips(got, ref):
    """Voxels whose SDF sign differs between two grids → list of (index,
    card value, CPU value)."""
    import torch

    g, r = got.cpu(), ref.cpu()
    idx = torch.nonzero((g < 0) != (r < 0))
    return [(tuple(i.tolist()), float(g[tuple(i)]), float(r[tuple(i)])) for i in idx]


def generation_phase(dev, record, kernels):
    """The procedural SDF path on the card (``models/generation.py``), with
    every K1 launch held against K1's plain version: the generation world
    compiled through ``compile_scene(world, EngineConfig(),
    sdf_generators=...)`` at the default pools (64 slots of 32³, 1024
    bodies, 4096 contact slots, the ``scan`` solver, 256x192 with the
    default shadow maps), stepped GENERATION_STEPS frames with a frame every
    GENERATION_RENDER_EVERY-th; the meta cluster must fracture into at
    least 2 fragments, the bodies stay finite, the last state's K1 frame
    scores at least PARITY_BAR against the plain tile raster's, the busiest
    substep's scan kernels equal their plain loop and every grid the split
    checks labelled equals the plain labelling. Then the world with an
    OrthographicCamera, one K1 frame scored against the plain tile raster;
    and the voxel generator (``apps/voxel_generator.py``): ``example``,
    ``stats`` (the card's counts equal the CPU's, a sign flip within
    SIGN_FLIP_ATOL of the surface excepted and printed), ``preview`` and
    ``vary`` with N = VARY_N on the meta graph, each preview frame (K1)
    scored against the plain tile raster's."""
    import json as _json
    import tempfile

    import torch

    from impact_tpu_torch.apps import voxel_generator as vg
    from impact_tpu_torch.apps.snapshot_tester import render_again
    from impact_tpu_torch.models.generation import cluster_meta_graph, generation_world
    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.physics import scan_solver, solver
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.utils.config import EngineConfig
    from impact_tpu_torch.utils.image import load_png, rgb_hybrid_compare
    from impact_tpu_torch.voxel import interaction

    rows = {}
    held = dict(depth=0, attributes=0, max_abs_err=0.0)
    names = ("k1_raster_attributes", "k1_raster_depth", "scan_velocity_iterations",
             "scan_position_correction", "k2_labels", "k2_ccl", "k2_ccl_wide")
    launches = dict.fromkeys(names, 0)
    counters = (rp.LAUNCHES, scan_solver.LAUNCHES, k2.LAUNCHES)

    def reset():
        for c in counters:
            c.reset()

    def add():
        for c in counters:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_generation_")
    t_phase = time.perf_counter()
    run_depth, run_attr = rp.raster_depth, rp.raster_attributes
    rp.raster_depth, rp.raster_attributes = held_k1(held)
    try:
        with Phase(f"generation: the generation world (a sphere union, the voxel generator's "
                   f"example graph, a meta graph lowered at seed 7 that fractures, the rectangle, "
                   f"hemisphere, cylinder and cone meshes, an OBJ and a PLY) at the default "
                   f"pools, {GENERATION_STEPS} steps, a K1 frame every "
                   f"{GENERATION_RENDER_EVERY}th"):
            cfg = EngineConfig()
            world, gens = generation_world(os.path.join(tmp.name, "meshes"))
            reset()
            t0 = time.perf_counter()
            rt = HeadlessRuntime(compile_scene(world, cfg, sdf_generators=gens), cfg)
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            alive0 = int(rt.sim.voxels.alive.sum())
            grids, best = [], [None, -1]
            run_labels, run_scan = interaction.connected_component_labels_batched, \
                solver.scan_iterations

            def rec_labels(occ):
                grids.append(occ.clone())
                return run_labels(occ)

            def rec_scan(*args):
                n = int(args[6].active.sum())
                if n > best[1]:
                    best[:] = [args, n]
                return run_scan(*args)

            interaction.connected_component_labels_batched = rec_labels
            solver.scan_iterations = rec_scan
            step_ms, frame_ms, drops, fragments, fracture_step = [], [], [], 0, None
            syncs0 = rt.host_syncs
            try:
                for i in range(1, GENERATION_STEPS + 1):
                    rt.step(1)
                    step_ms.append(rt.step_ms)
                    spawned = int(rt.sim.voxels.alive.sum()) - alive0
                    if spawned > 0 and fracture_step is None:
                        fracture_step = i
                    fragments = max(fragments, spawned)
                    if i % GENERATION_RENDER_EVERY == 0:
                        rt.render()
                        torch.cuda.synchronize()
                        frame_ms.append(sum(rt.stage_ms.values()))
                        drops.append(tuple(int(d) for d in rt.last_drops))
            finally:
                interaction.connected_component_labels_batched = run_labels
                solver.scan_iterations = run_scan
            syncs = (rt.host_syncs - syncs0) / GENERATION_STEPS
            mesh_drops = (int(rt.sim.meshes.n_dropped_verts.sum()),
                          int(rt.sim.meshes.n_dropped_tris.sum()))
            k1_frame = render_again(rt, "kernel")
            plain_frame = render_again(rt, "raster")
            parity = rgb_hybrid_compare(k1_frame, plain_frame)
            torch.cuda.synchronize()
            add()
            median = sorted(step_ms)[len(step_ms) // 2]
            first50, last50 = sum(step_ms[:50]) / 50, sum(step_ms[-50:]) / 50
            log(f"generation: compile {compile_s:.2f} s ({alive0} voxel objects, "
                f"{rt.info['n_unique_shapes']} distinct shapes, "
                f"{rt.params.mesh_instances.alive.shape[0]} mesh entities); step ms median "
                f"{median:.2f}, first 50 {first50:.2f}, last 50 {last50:.2f}; frame ms "
                f"{[round(f, 2) for f in frame_ms]}; fracture at step {fracture_step}, "
                f"{fragments} fragments; {syncs:.2f} host syncs per step; raster drops "
                f"(geometry, shadows) per frame {drops}; mesh drops (vertices, triangles) "
                f"{mesh_drops}; the last state's K1 frame vs the plain tile raster's "
                f"{parity:.4f} (bar {PARITY_BAR}); busiest substep {best[1]} active slots; "
                f"{len(grids)} labelling calls on {sum(x.shape[0] for x in grids)} grids")
            rows["world"] = dict(compile_s=compile_s, step_ms_median=median,
                                 step_ms_first50=first50, step_ms_last50=last50,
                                 frame_ms=frame_ms, fracture_step=fracture_step,
                                 fragments=fragments, host_syncs=syncs, raster_drops=drops,
                                 mesh_drops=mesh_drops, vs_tile_raster=parity)
            if not body_state_finite(rt.sim):
                raise AssertionError("generation: non-finite body state")
            if fragments < 2:
                raise AssertionError(f"generation: the cluster made {fragments} fragments")
            if parity < PARITY_BAR:
                raise AssertionError(f"generation: the K1 frame scores {parity:.4f} against "
                                     f"the plain tile raster's")
            if k1_frame.std() < 1.0:
                raise AssertionError("generation: the frame is flat")

        with Phase("generation: the busiest substep through the scan kernels against their "
                   "plain loop, and every grid the split checks labelled against the plain "
                   "labelling"):
            scan_err, plain_ms, _ = hold_scan(best[0], "generation")
            batches = [x for x in grids if x.shape[0] > 0]
            if not batches:
                raise AssertionError("generation: the split checks labelled no grid")
            occ = torch.cat(batches)
            got, ref = k2.connected_component_labels_batched(occ), labels_plain(occ)
            if not torch.equal(got, ref):
                raise AssertionError(f"generation: labels of {int((got != ref).sum())} voxels "
                                     f"differ from the plain labelling")
            labels_err = int((got.long() - ref.long()).abs().max())
            log(f"generation: scan kernels equal to the plain loop on {best[1]} active slots "
                f"(plain loop {plain_ms:.1f} ms); labels equal to the plain labelling on the "
                f"{occ.shape[0]} grids of {len(batches)} labelling calls")
            rows["world"].update(scan_held=dict(active=best[1], max_abs_err=scan_err,
                                                plain_ms=plain_ms),
                                 labels_held=dict(grids=occ.shape[0]))

        with Phase("generation: the world with an OrthographicCamera, one K1 frame against the "
                   "plain tile raster"):
            reset()
            ocfg = EngineConfig()
            oworld, ogens = generation_world(os.path.join(tmp.name, "ortho"), orthographic=True)
            ort = HeadlessRuntime(compile_scene(oworld, ocfg, sdf_generators=ogens), ocfg)
            if not (ocfg.tpu.orthographic_camera and ort.render_config.orthographic):
                raise AssertionError("the OrthographicCamera did not set the orthographic "
                                     "projection")
            ortho = ort.render().cpu().numpy()
            ortho_plain = render_again(ort, "raster")
            torch.cuda.synchronize()
            add()
            ortho_score = rgb_hybrid_compare(ortho, ortho_plain)
            log(f"ortho: K1 frame vs the plain tile raster's {ortho_score:.4f} (bar "
                f"{PARITY_BAR}), drops {tuple(int(d) for d in ort.last_drops)}, frame "
                f"{sum(ort.stage_ms.values()):.2f} ms")
            rows["ortho"] = dict(vs_tile_raster=ortho_score)
            if ortho_score < PARITY_BAR or ortho.std() < 1.0:
                raise AssertionError(f"ortho: the K1 frame scores {ortho_score:.4f}")

        with Phase(f"generation: the voxel generator (example, stats on the card and on the "
                   f"CPU, preview, vary {VARY_N}) with K1"):
            reset()
            t0 = time.perf_counter()
            example = os.path.join(tmp.name, "example.json")
            meta = os.path.join(tmp.name, "meta.json")
            vg.main(["--device", "cuda", "example", example])
            with open(meta, "w") as f:
                _json.dump(cluster_meta_graph(), f)
            stats_rows = {}
            for path in (example, meta):
                graph = vg.load_any_graph(path)
                card, cpu = vg.stats(graph, dev), vg.stats(graph, "cpu")
                flips = sign_flips(card["sdf"], cpu["sdf"])
                far = [f for f in flips if abs(f[2]) >= SIGN_FLIP_ATOL]
                log(f"stats {os.path.basename(path)}: card '{card['line']}', CPU "
                    f"'{cpu['line']}'; sign flips {flips}")
                if far or (card["line"] != cpu["line"] and not flips):
                    raise AssertionError(f"stats: the card's counts differ from the CPU's "
                                         f"({card['line']} vs {cpu['line']}; flips {far})")
                stats_rows[os.path.basename(path)] = dict(line=card["line"],
                                                          cpu_line=cpu["line"],
                                                          sign_flips=len(flips))
            previews = {}
            png = os.path.join(tmp.name, "preview.png")
            vg.main(["--device", "cuda", "preview", example, png])
            previews["example"] = (load_png(png), vg.load_any_graph(example))
            vary_dir = os.path.join(tmp.name, "vary")
            vg.main(["--device", "cuda", "vary", meta, vary_dir, str(VARY_N)])
            for seed in range(VARY_N):
                previews[f"meta seed {seed}"] = (
                    load_png(os.path.join(vary_dir, f"variant_{seed}.png")),
                    vg.load_any_graph(meta, seed))
            torch.cuda.synchronize()
            app_s = time.perf_counter() - t0
            scores = {}
            for name, (img, graph) in previews.items():
                plain = vg.preview_frame(graph, dev, raster_backend="raster").cpu().numpy()
                scores[name] = rgb_hybrid_compare(img, plain)
                if scores[name] < PARITY_BAR or img.std() < 1.0:
                    raise AssertionError(f"preview {name}: K1 frame scores {scores[name]:.4f} "
                                         f"against the plain tile raster's")
            add()
            log(f"voxel generator: {app_s:.2f} s for example, stats and the previews; preview "
                f"frames (K1) vs the plain tile raster's {scores} (bar {PARITY_BAR})")
            rows["voxel_generator"] = dict(seconds=app_s, stats=stats_rows, previews=scores)
    finally:
        rp.raster_depth, rp.raster_attributes = run_depth, run_attr
        tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    log(f"generation phase: {phase_s:.2f} s; launches {launches}; K1 launches held against "
        f"K1's plain version {held}")
    if (held["depth"], held["attributes"]) != (launches["k1_raster_depth"],
                                               launches["k1_raster_attributes"]):
        raise AssertionError(f"generation: K1 launches {launches} but {held} held")
    gen_launches = {"k1_raster_attributes": launches["k1_raster_attributes"],
                    "k1_raster_depth": launches["k1_raster_depth"],
                    "k2_labels": launches["k2_labels"],
                    "scan_solver": launches["scan_velocity_iterations"]
                    + launches["scan_position_correction"]}
    for name, n in gen_launches.items():
        if n <= 0:
            raise AssertionError(f"generation: {name} was not launched")
    record["generation"] = dict(rows, seconds=phase_s, launches=launches, k1_held=held)
    errs = {"k1_raster_attributes": held["max_abs_err"], "k1_raster_depth": held["max_abs_err"],
            "k2_labels": float(labels_err), "scan_solver": scan_err}
    for name, n in gen_launches.items():
        entry = next((k for k in kernels if k["name"] == name), None)
        if entry is None:  # --generation-only: the phase's own record
            entry = dict(name=name, route="cuda", max_abs_err=errs[name])
            kernels.append(entry)
        entry["generation_launches"] = n



# --- the parity phase: the reference tester's scenes, bf16 shading, gizmos,
# the chunked registry rebake, the scene graph and controllers ---------------------


def parity_frame(name, dev, cfg=None):
    """One of the reference tester's 13 scenes through the port's parity
    harness (768x512, ``apps/parity_snapshots.py:build_runtime`` on ``cfg``,
    default ``EngineConfig()``), rendered once → (row, K1 frame as numpy,
    runtime). The row holds the frame's raster drops, its score against the
    plain tile raster's frame of the same state (``render_again``), its
    score against the committed JAX render of the scene, and its stage ms
    (with whatever K1 wrappers are installed: the held ones add K1's plain
    version to every view)."""
    import torch

    from impact_tpu_torch.apps import parity_snapshots as ps
    from impact_tpu_torch.apps.snapshot_tester import render_again
    from impact_tpu_torch.utils.config import EngineConfig
    from impact_tpu_torch.utils.image import load_png, rgb_hybrid_compare

    t0 = time.perf_counter()
    rt = ps.build_runtime(name, cfg=cfg if cfg is not None else EngineConfig(), device=dev)
    img = rt.render()
    torch.cuda.synchronize()
    img = img.cpu().numpy()
    plain = render_again(rt, "raster")
    jax_render = load_png(ps.JAX_RENDERS / f"{name}.png")[..., :3]
    row = dict(drops=rt.dropped_raster_candidates(),
               vs_tile_raster=rgb_hybrid_compare(img, plain),
               vs_committed_jax_render=rgb_hybrid_compare(img, jax_render),
               frame_ms_held=sum(rt.stage_ms.values()),
               seconds=time.perf_counter() - t0)
    return row, img, rt


def timed_again(rt, img):
    """The runtime's frame rendered again from the same state through a
    fresh runtime, with K1's wrappers as they are (the caller installs the
    unheld ones) → (frame ms, stage ms); fails unless the frame equals
    ``img``, the held render's, so these launches repeat held ones."""
    import numpy as np
    import torch

    from impact_tpu_torch.runtime import HeadlessRuntime
    from impact_tpu_torch.runtime.setup import SceneBuild

    sim = rt.sim._replace(render=rt._initial_sim.render)
    again = HeadlessRuntime(SceneBuild(sim=sim, params=rt.params, info=rt.info), rt.config,
                            enable_fracturing=False, enable_absorption=False,
                            enable_splitting=False)
    frame = again.render()
    torch.cuda.synchronize()
    if not np.array_equal(frame.cpu().numpy(), img):
        raise AssertionError("the frame rendered again from the same state differs")
    return sum(again.stage_ms.values()), {k: round(v, 3) for k, v in again.stage_ms.items()}


def bf16_shade_card_vs_cpu(rt):
    """The bfloat16 ``shade`` of the runtime's last G-buffer (no shadow maps,
    occlusion 1) on the card against the same call on the CPU → (covered
    pixels beyond 2⁻⁶ of the pixel's magnitude + 1e-6, covered pixels, the
    largest error over the magnitude)."""
    import torch

    from impact_tpu_torch.render.lights import shade

    gb, p = rt.last_gbuffer, rt.params
    args = (gb.world_pos, gb.normal, gb.albedo, gb.f0, gb.roughness, gb.emissive,
            torch.ones_like(gb.roughness), p.camera.position, gb.valid)
    card = shade(p.lights, *args, bf16=True).cpu()
    lights = type(p.lights)(*(x.cpu() for x in p.lights))
    cpu = shade(lights, *(x.cpu() for x in args), bf16=True)
    mag = cpu.abs().amax(dim=-1)
    err = (card - cpu).abs().amax(dim=-1)
    valid = gb.valid.cpu()
    beyond = int(((err > 2.0 ** -6 * mag + 1e-6) & valid).sum())
    worst = float((err / (mag + 1e-6))[valid].max())
    return beyond, int(valid.sum()), worst


def overlay_card_vs_cpu(rt, base, kinds):
    """The gizmo lines of ``kinds`` at the runtime's state overlaid on the
    card over the u8 frame ``base`` (a tensor on the card) against the
    port's overlay on the CPU of the same frame, lines and view-projection
    → (the card's frame, pixels that differ, pixels either one wrote)."""
    from impact_tpu_torch.render.gizmos import GizmoLines, overlay_lines

    lines, vp = rt.gizmo_lines(kinds)
    card = overlay_lines(base, lines, vp).cpu().numpy()
    cpu = overlay_lines(base.cpu(), GizmoLines(*(x.cpu() for x in lines)), vp.cpu()).numpy()
    b = base.cpu().numpy()
    written = int(((card != b) | (cpu != b)).any(axis=-1).sum())
    differ = int((card != cpu).any(axis=-1).sum())
    return card, differ, written


def parity_world():
    """The quick start's world (``voxel_box_tumbler(n_boxes=4)``) with a
    kinematic phantom sphere for an EntityController and a three-deep
    Parent chain of kinematic phantom spheres → (world, chain entities).
    The controlled sphere starts at CONTROLLED_AT."""
    from impact_tpu_torch.ecs import components as C
    from impact_tpu_torch.models import voxel_box_tumbler

    w = voxel_box_tumbler(n_boxes=4)
    w.create_entity(C.ReferenceFrame(position=CONTROLLED_AT), C.KinematicRigidBodyMarker(),
                    C.SphericalCollidable(kind=2, radius=0.5))
    chain, parent = [], None
    for i, (pos, q) in enumerate((((3.0, 9.0, -2.0), (0.0, 0.3826834, 0.0, 0.9238795)),
                                  ((1.5, 0.0, 0.0), (0.0, 0.0, 0.258819, 0.9659258)),
                                  ((0.0, 1.0, 0.5), (0.2588190, 0.0, 0.0, 0.9659258)))):
        comps = [C.ReferenceFrame(position=pos, orientation=q), C.KinematicRigidBodyMarker(),
                 C.SphericalCollidable(kind=2, radius=0.3)]
        if parent is not None:
            comps.append(C.Parent(entity_id=parent))
        parent = w.create_entity(*comps)
        chain.append(parent)
    return w, chain


def body_at(rt, position):
    """The body slot whose position is ``position`` (within 1e-5)."""
    import torch

    p = torch.tensor(position, dtype=torch.float32, device=rt.device)
    hit = torch.nonzero(torch.linalg.vector_norm(rt.sim.phys.bodies.position - p, dim=-1)
                        < 1e-5).flatten()
    if hit.numel() != 1:
        raise AssertionError(f"{hit.numel()} bodies at {position}")
    return int(hit[0])


def parity_phase(dev, record, kernels):
    """The slice's paths on the card, every K1 launch held against K1's
    plain version and every grid the split checks label against the
    two-level plain labelling: the reference tester's 13 scenes through
    ``apps/parity_snapshots.py`` at 768x512 on ``EngineConfig()`` (no
    drops, each K1 frame at least PARITY_BAR against the plain tile
    raster's, the score against the committed JAX render printed);
    ShadowableOmnidirectionalLight with ``tpu.bf16_shading`` (not equal to
    the float32 frame, at least PARITY_BAR against the plain tile raster's
    bf16 frame, and its bfloat16 shade within 2⁻⁶ of the CPU's on all but
    BF16_SHARE of the pixels; its score against the float32 frame is
    printed, not gated: the reference's own bfloat16 frame scores alike,
    tests/bf16_frame_parity.py); the gizmos
    of all 21 kinds and ``colliders`` on the snapshot configuration's
    VoxelBoxTumbler after PARITY_GIZMO_STEPS steps, through ``render`` and
    ``step_and_render`` (the overlaid frame differs from the base frame,
    the card's overlay equals the CPU's on at least 1 − OVERLAY_SHARE of the
    written pixels, hiding them gives the base frame back); the filled 64³
    chunked scene rebaked with a registry of other colours (the baked
    corners within 1e-6 of a CPU rebake of the same pool), stepped
    PARITY_CHUNKED_STEPS steps and rendered (at least PARITY_BAR against the
    plain tile raster); and the quick start's world with a three-deep
    Parent chain flattened and compiled (the chain's bodies at the composed
    world poses) and an EntityController driving a kinematic body through
    CONTROLLER_STEPS steps (its velocity and orientation the controller's)."""
    import numpy as np
    import torch

    from impact_tpu_torch.apps import parity_snapshots as ps
    from impact_tpu_torch.apps import snapshot_tester as st
    from impact_tpu_torch.apps.snapshot_tester import render_again
    from impact_tpu_torch.models.bench import bench_chunked_config, bench_chunked_fill_scene
    from impact_tpu_torch.models.parity_scenes import PARITY_SCENES
    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.render.gizmos import ALL_GIZMO_TYPES, GIZMO_COLLIDERS
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.scene.controller import EntityController
    from impact_tpu_torch.scene.graph import flatten_to_world_frames, world_transforms
    from impact_tpu_torch.scene.materials import make_voxel_type_registry, material_corner_table
    from impact_tpu_torch.utils.config import EngineConfig
    from impact_tpu_torch.utils.image import rgb_hybrid_compare
    from impact_tpu_torch.voxel import interaction
    from impact_tpu_torch.voxel.mesh import bake_mesh_materials

    rows = {}
    held = dict(depth=0, attributes=0, max_abs_err=0.0)
    launches = dict.fromkeys(("k1_raster_attributes", "k1_raster_depth", "k2_labels", "k2_ccl",
                              "k2_ccl_wide"), 0)
    counters = (rp.LAUNCHES, k2.LAUNCHES)

    def reset():
        for c in counters:
            c.reset()

    def add():
        for c in counters:
            for k, v in c.items():
                if k in launches:
                    launches[k] += v

    t_phase = time.perf_counter()
    run_depth, run_attr = rp.raster_depth, rp.raster_attributes
    rp.raster_depth, rp.raster_attributes = held_k1(held)
    run_labels = interaction.connected_component_labels_batched
    grids = []
    try:
        with Phase(f"parity: the reference tester's {len(PARITY_SCENES)} scenes at "
                   f"{ps.WIDTH}x{ps.HEIGHT} through apps/parity_snapshots.py on EngineConfig(), "
                   f"each K1 frame against the plain tile raster's at {PARITY_BAR}"):
            scenes, failed, f32_omni = {}, [], None
            for name in PARITY_SCENES:
                reset()
                row, img, rt = parity_frame(name, dev)
                add()
                # the frame's time without the holding, its launches not counted
                rp.raster_depth, rp.raster_attributes = run_depth, run_attr
                try:
                    row["frame_ms"], row["stage_ms"] = timed_again(rt, img)
                finally:
                    rp.raster_depth, rp.raster_attributes = held_k1(held)
                scenes[name] = row
                if name == "ShadowableOmnidirectionalLight":
                    f32_omni = img
                ok = row["drops"] == 0 and row["vs_tile_raster"] >= PARITY_BAR and img.std() > 1.0
                log(f"[{'PASS' if ok else 'FAIL'}] {name}: K1 frame vs the plain tile raster's "
                    f"{row['vs_tile_raster']:.4f} (bar {PARITY_BAR}); vs the committed JAX "
                    f"render {row['vs_committed_jax_render']:.4f} (not gated); drops "
                    f"{row['drops']}; frame {row['frame_ms']:.2f} ms again from the same state "
                    f"(stages {row['stage_ms']}; {row['frame_ms_held']:.2f} ms held); "
                    f"{row['seconds']:.2f} s")
                if not ok:
                    failed.append(name)
                del rt
            rows["scenes"] = scenes
            if failed:
                raise AssertionError(f"parity scenes failed: {failed}")

        with Phase("parity: ShadowableOmnidirectionalLight with tpu.bf16_shading against its "
                   "float32 frame"):
            cfg = EngineConfig()
            cfg.tpu.bf16_shading = True
            reset()
            row, bf16, rt = parity_frame("ShadowableOmnidirectionalLight", dev, cfg)
            add()
            rp.raster_depth, rp.raster_attributes = run_depth, run_attr
            try:
                row["frame_ms"], row["stage_ms"] = timed_again(rt, bf16)
            finally:
                rp.raster_depth, rp.raster_attributes = held_k1(held)
            score = rgb_hybrid_compare(bf16, f32_omni)
            differ = int((bf16 != f32_omni).any(axis=-1).sum())
            beyond, covered, worst = bf16_shade_card_vs_cpu(rt)
            log(f"bf16 shading: render config bf16_shading={rt.render_config.bf16_shading}; "
                f"the bf16 frame vs the float32 frame {score:.4f} (not gated: the reference's "
                f"own bf16 frame scores alike against its float32 one, "
                f"tests/bf16_frame_parity.py), {differ} pixels differ; vs the plain tile "
                f"raster's bf16 frame {row['vs_tile_raster']:.4f} (bar {PARITY_BAR}); the card's "
                f"bf16 shade vs the CPU's on the frame's G-buffer: {beyond} of {covered} covered "
                f"pixels beyond 2^-6 of their magnitude + 1e-6 (at most {BF16_SHARE:g}), "
                f"largest error {worst:.3g} of the magnitude; frame {row['frame_ms']:.2f} ms")
            rows["bf16"] = dict(vs_float32=score, pixels_differ=differ, shade_beyond=beyond,
                                shade_covered=covered, shade_worst=worst, **row)
            if not rt.render_config.bf16_shading or differ == 0:
                raise AssertionError("bf16 shading: the bf16 frame equals the float32 frame")
            if row["vs_tile_raster"] < PARITY_BAR or beyond > BF16_SHARE * covered:
                raise AssertionError(f"bf16 shading: {row['vs_tile_raster']:.4f} against the "
                                     f"plain tile raster, {beyond} pixels beyond the bar")

        with Phase(f"parity: the gizmos ({len(ALL_GIZMO_TYPES)} kinds and colliders) on "
                   f"VoxelBoxTumbler after {PARITY_GIZMO_STEPS} steps, through render and "
                   f"step_and_render, the card's overlay against the CPU's"):
            reset()
            rt = st.build_runtime("VoxelBoxTumbler", dev)
            rt.step(PARITY_GIZMO_STEPS)
            start = rt.sim
            base = rt.render()
            kinds = ALL_GIZMO_TYPES + (GIZMO_COLLIDERS,)
            rt.enqueue_command("gizmo", "set_visible", kinds)
            rt.apply_commands()
            rt.sim = start
            over = rt.render()
            gizmo_ms = rt.stage_ms.get("gizmos", 0.0)
            rt.sim = start
            card, differ, written = overlay_card_vs_cpu(rt, base, kinds)
            rt.sim = start
            stepped_over = rt.step_and_render().cpu().numpy()
            for kind in kinds:
                rt.enqueue_command("gizmo", "hide", kind)
            rt.apply_commands()
            rt.sim = start
            hidden = rt.render().cpu().numpy()
            rt.sim = start
            stepped = rt.step_and_render().cpu().numpy()
            rt.enqueue_command("gizmo", "set_visible", kinds)
            rt.enqueue_command("gizmo", "set_visible", ())
            rt.apply_commands()
            rt.sim = start
            cleared = rt.render().cpu().numpy()
            torch.cuda.synchronize()
            add()
            base, over = base.cpu().numpy(), over.cpu().numpy()
            drawn = int((over != base).any(axis=-1).sum())
            log(f"gizmos: {drawn} pixels drawn over the base frame ({gizmo_ms:.2f} ms for the "
                f"overlay); step_and_render {int((stepped_over != stepped).any(axis=-1).sum())} "
                f"pixels; the card's overlay vs the CPU's: {differ} of {written} written pixels "
                f"differ (at most {OVERLAY_SHARE:g}); hide and set_visible () give the base "
                f"frame back: {np.array_equal(hidden, base)}, {np.array_equal(cleared, base)}")
            rows["gizmos"] = dict(drawn=drawn, overlay_ms=gizmo_ms, card_vs_cpu_differ=differ,
                                  written=written)
            if drawn == 0 or np.array_equal(stepped_over, stepped):
                raise AssertionError("gizmos: the overlay drew nothing")
            if not np.array_equal(card, over) or differ > OVERLAY_SHARE * written:
                raise AssertionError(f"gizmos: the card's overlay differs from the CPU's on "
                                     f"{differ} of {written} pixels")
            if not (np.array_equal(hidden, base) and np.array_equal(cleared, base)):
                raise AssertionError("gizmos: hiding them did not give the base frame back")
            del rt

        with Phase(f"parity: the filled 64^3 chunked scene rebaked with another registry, "
                   f"{PARITY_CHUNKED_STEPS} steps, a K1 frame against the plain tile raster"):
            cfg = bench_chunked_config(64)
            reset()
            build = compile_scene(bench_chunked_fill_scene(64), cfg, device=dev)
            registry = make_voxel_type_registry([
                {"name": "Basalt", "color": (0.9, 0.1, 0.2), "roughness": 0.3},
                {"name": "Copper", "color": (0.2, 0.8, 0.4), "metalness": 1.0},
                {"name": "Glass", "color": (0.1, 0.3, 0.9), "emissive_luminance": 2.0}],
                device="cpu")
            pool_cpu = type(build.sim.meshes)(*(x.cpu() for x in build.sim.meshes))
            rt = HeadlessRuntime(build, cfg, registry=registry, enable_fracturing=False)
            cpu = bake_mesh_materials(pool_cpu, material_corner_table(registry))
            bake_err = max(float((getattr(rt.sim.meshes, f).cpu() - getattr(cpu, f)).abs().max())
                           for f in ("tri_albedo", "tri_f0", "tri_rough", "tri_emissive"))
            recolored = not torch.equal(rt.sim.meshes.tri_albedo.cpu(), pool_cpu.tri_albedo)

            def rec_labels(occ):
                grids.append(occ.clone())
                return run_labels(occ)

            interaction.connected_component_labels_batched = rec_labels
            try:
                rt.step(PARITY_CHUNKED_STEPS)
            finally:
                interaction.connected_component_labels_batched = run_labels
            img = rt.render().cpu().numpy()
            torch.cuda.synchronize()
            add()
            plain = render_again(rt, "raster")
            score = rgb_hybrid_compare(img, plain)
            labels_err, n_grids = 0, 0
            for occ in grids:
                got, ref = k2.connected_component_labels_batched(occ), \
                    interaction.connected_component_labels_two_level(occ)
                if not torch.equal(got, ref):
                    raise AssertionError(f"chunked rebake: {int((got != ref).sum())} labels "
                                         f"differ from the two-level plain labelling")
                labels_err = max(labels_err, int((got.long() - ref.long()).abs().max()))
                n_grids += occ.shape[0]
            log(f"chunked rebake: baked corners vs a CPU rebake of the same pool, largest error "
                f"{bake_err:.3g} (bar 1e-6), recoloured {recolored}; {len(grids)} labelling "
                f"calls on {n_grids} grids, equal to the two-level plain labelling; K1 frame "
                f"vs the plain tile raster's {score:.4f} (bar {PARITY_BAR}), drops "
                f"{rt.last_drops}; steps {rt.step_ms:.2f} ms for {PARITY_CHUNKED_STEPS}")
            rows["chunked_rebake"] = dict(bake_max_abs_err=bake_err, labelled_grids=n_grids,
                                          vs_tile_raster=score, drops=list(rt.last_drops))
            if bake_err > 1e-6 or not recolored:
                raise AssertionError(f"chunked rebake: {bake_err:.3g} from the CPU's rebake")
            if score < PARITY_BAR or rt.last_drops != (0, 0) or not grids:
                raise AssertionError(f"chunked rebake: frame {score:.4f}, drops "
                                     f"{rt.last_drops}, {len(grids)} labelling calls")
            del rt, build

        with Phase(f"parity: the quick start's world with a three-deep Parent chain flattened "
                   f"and compiled, and an EntityController through {CONTROLLER_STEPS} steps"):
            cfg = EngineConfig.from_ron_str(QUICK_START_RON)
            world, chain = parity_world()
            poses = world_transforms(world)
            flatten_to_world_frames(world)
            reset()
            rt = HeadlessRuntime(compile_scene(world, cfg, device=dev), cfg)
            b = rt.sim.phys.bodies
            chain_err = 0.0
            for e in chain:
                i = body_at(rt, tuple(float(x) for x in poses[e][0]))
                q = torch.as_tensor(poses[e][1], device=dev)
                chain_err = max(chain_err, float((b.orientation[i] - q).abs().max()))
            ctl = EntityController(body_index=body_at(rt, CONTROLLED_AT))
            ctl.motion.set_direction("forward", True)
            ctl.motion.set_direction("left", True)
            ctl.orientation.update(0.4, 0.1)
            ctl_err = 0.0
            for _ in range(CONTROLLER_STEPS):
                rt.sim = ctl.apply(rt.sim)
                rt.step(1)
                q = ctl.orientation.orientation()
                v = ctl.motion.world_velocity(q)
                bb = rt.sim.phys.bodies
                ctl_err = max(ctl_err, float((bb.velocity[ctl.body_index].cpu()
                                              - torch.as_tensor(v)).abs().max()),
                              float((bb.orientation[ctl.body_index].cpu()
                                     - torch.as_tensor(q)).abs().max()))
            torch.cuda.synchronize()
            add()
            moved = float(torch.linalg.vector_norm(
                rt.sim.phys.bodies.position[ctl.body_index].cpu() - torch.tensor(CONTROLLED_AT)))
            log(f"scene graph: the chain's bodies at the composed poses (orientation error "
                f"{chain_err:.3g}); controller: velocity and orientation within {ctl_err:.3g} "
                f"of the controller's over {CONTROLLER_STEPS} steps, moved {moved:.4f} m")
            rows["scene_graph"] = dict(chain_max_err=chain_err, controller_max_err=ctl_err,
                                       moved=moved)
            if chain_err > 1e-5 or ctl_err > 1e-6 or moved <= 0.0:
                raise AssertionError(f"scene graph and controller: chain {chain_err:.3g}, "
                                     f"controller {ctl_err:.3g}, moved {moved}")
            if not body_state_finite(rt.sim):
                raise AssertionError("scene graph: non-finite body state")
    finally:
        rp.raster_depth, rp.raster_attributes = run_depth, run_attr
        interaction.connected_component_labels_batched = run_labels
    phase_s = time.perf_counter() - t_phase
    log(f"parity phase: {phase_s:.2f} s; launches {launches}; K1 launches held against K1's "
        f"plain version {held}")
    if (held["depth"], held["attributes"]) != (launches["k1_raster_depth"],
                                               launches["k1_raster_attributes"]):
        raise AssertionError(f"parity: K1 launches {launches} but {held} held")
    parity_launches = {k: launches[k] for k in ("k1_raster_attributes", "k1_raster_depth",
                                                "k2_labels")}
    for name, n in parity_launches.items():
        if n <= 0:
            raise AssertionError(f"parity: {name} was not launched")
    record["parity"] = dict(rows, seconds=phase_s, launches=launches, k1_held=held)
    errs = {"k1_raster_attributes": held["max_abs_err"], "k1_raster_depth": held["max_abs_err"],
            "k2_labels": float(labels_err)}
    for name, n in parity_launches.items():
        entry = next((k for k in kernels if k["name"] == name), None)
        if entry is None:  # --parity-only: the phase's own record
            entry = dict(name=name, route="cuda", max_abs_err=errs[name])
            kernels.append(entry)
        entry["parity_launches"] = n


def hold_scan_active(args, out, what):
    """One recorded scan launch of a path against the plain loop on its
    active slots (the contacts are compacted, so they lead; an inactive slot
    changes nothing): v, w, the positions and orientations, and the active
    slots' impulses must be equal, the others' as the launch received them.
    Returns (max abs err, active slots)."""
    import torch

    from impact_tpu_torch.physics import scan_solver

    v, w, pos, ori, inv_mass, inv_inertia, prep, acc, n_it, n_corr, factor = args
    k = int(prep.active.sum())
    if not bool(prep.active[:k].all()):
        raise AssertionError(f"scan {what}: the active slots do not lead")
    head = type(prep)(*(f[:k] for f in prep))
    ref_v, ref_w, ref_acc, ref_pos, ref_ori = scan_solver.scan_iterations_plain(
        v, w, pos, ori, inv_mass, inv_inertia, head, acc[:k], n_it, n_corr, factor)
    got_v, got_w, got_acc, got_pos, got_ori = out
    err = 0.0
    for name, g, r in (("v", got_v, ref_v), ("w", got_w, ref_w), ("pos", got_pos, ref_pos),
                       ("ori", got_ori, ref_ori), ("impulses", got_acc[:k], ref_acc),
                       ("idle impulses", got_acc[k:], acc[k:])):
        if not torch.equal(g, r):
            raise AssertionError(f"scan {what}: {name} differs from the plain loop by "
                                 f"{(g - r).abs().max().item():.3g}")
        if g.numel():
            err = max(err, (g - r).abs().max().item())
    return err, k


def held_to_bars(got: dict, want: dict, what):
    """A gathered sharded state against a single-process one on the card, to
    ``tests/test_parallel.py:88-103``'s bars (the card's ``index_add_``
    sums make neither run bitwise repeatable). Returns the largest error of
    each barred field."""
    import numpy as np

    errs = {}
    for key, atol in (("phys/bodies/position", PARALLEL_POS_ATOL),
                      ("phys/bodies/momentum", PARALLEL_MOMENTUM_ATOL),
                      ("voxels/sdf", PARALLEL_SDF_ATOL)):
        g, w = got[key].astype(np.float64), want[key].astype(np.float64)
        errs[key] = float(np.abs(g - w).max())
        if not np.isfinite(g).all() or errs[key] > atol:
            raise AssertionError(f"{what}: {key} differs by {errs[key]:.3g} (atol {atol})")
    if not np.array_equal(got["voxels/alive"], want["voxels/alive"]):
        raise AssertionError(f"{what}: alive {got['voxels/alive'].tolist()} vs "
                             f"{want['voxels/alive'].tolist()}")
    return errs


def event_checkpoint(rt, path, before, max_steps):
    """Step ``rt`` until an object slot comes alive (the event), write the
    state ``before`` steps ahead of it (or the first one) to ``path`` and
    step ``before`` past the event. Returns (the event's step, the steps
    from the written state to ``rt``'s)."""
    import collections

    import torch

    from impact_tpu_torch.runtime.checkpoint import save_checkpoint

    ring = collections.deque(maxlen=before)
    for i in range(1, max_steps + 1):
        ring.append((i - 1, rt.sim, rt.sim.rng.get_state()))
        alive = int(rt.sim.voxels.alive.sum())
        rt.step(1)
        if int(rt.sim.voxels.alive.sum()) != alive:
            break
    else:
        raise AssertionError(f"no event in {max_steps} steps")
    k0, sim, rng_state = ring[0]
    gen = torch.Generator(device=rt.device)
    gen.set_state(rng_state)
    save_checkpoint(path, sim._replace(rng=gen))
    rt.step(before)
    return i, i + before - k0


def parallel_quick_start(dev, store_dir):
    """(a) The quick start's tumbler under ``scan``: HeadlessRuntime steps
    it PARALLEL_WARMUP steps on the card (the boxes land), then that state,
    sharded on a 1-rank ``nccl`` mesh in this process, takes PARALLEL_STEPS
    sharded steps, held to HeadlessRuntime's next PARALLEL_STEPS to
    ``held_to_bars``, every scan launch of the sharded path held against the
    plain loop on its active slots. Returns (row, the path's launches, the
    scan's max abs err)."""
    import torch
    import torch.distributed as dist

    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.parallel import jobs
    from impact_tpu_torch.parallel.mesh import gather_sim_state, make_device_mesh, \
        shard_sim_state
    from impact_tpu_torch.parallel.step import make_sharded_engine_step
    from impact_tpu_torch.physics import scan_solver, solver
    from impact_tpu_torch.render.pipeline import fp32_render
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

    world, cfg = jobs.scene("quick_start")
    rt = HeadlessRuntime(compile_scene(world, cfg, device=dev), cfg)
    rt.step(PARALLEL_WARMUP)
    gen = torch.Generator(device=dev)
    gen.set_state(rt.sim.rng.get_state())
    start = rt.sim._replace(rng=gen)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "a"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_device_mesh(1, 1, device=dev)
        step = make_sharded_engine_step(rt.params, cfg, mesh, rt.info["mesh_vert_cap"],
                                        rt.info["mesh_tri_cap"])
        local = shard_sim_state(mesh, start)
        calls, run_scan, sharded_ms = [], solver.scan_iterations, []

        def rec_scan(*args):
            out = run_scan(*args)
            calls.append((args, out))
            return out

        scan_solver.LAUNCHES.reset()
        k2.LAUNCHES.reset()
        solver.scan_iterations = rec_scan
        try:
            with fp32_render():
                for _ in range(PARALLEL_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    local = step(local)
                    torch.cuda.synchronize()
                    sharded_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            solver.scan_iterations = run_scan
        launches = {**scan_solver.LAUNCHES, **k2.LAUNCHES}
        n_records = len(mesh.comm.records)
        got = jobs.state_arrays(gather_sim_state(mesh, local))
    finally:
        dist.destroy_process_group()
    single_ms = []
    for _ in range(PARALLEL_STEPS):
        rt.step(1)
        single_ms.append(rt.step_ms)
    errs = held_to_bars(got, jobs.state_arrays(rt.sim), "parallel (a)")
    scan_err, active = 0.0, []
    for args, out in calls:
        e, k = hold_scan_active(args, out, "parallel (a)")
        scan_err = max(scan_err, e)
        active.append(k)
    n_scan = launches["scan_velocity_iterations"] + launches["scan_position_correction"]
    med = sorted(sharded_ms[1:])[len(sharded_ms[1:]) // 2]
    med_single = sorted(single_ms)[len(single_ms) // 2]
    log(f"parallel (a): from step {PARALLEL_WARMUP}, sharded steps (1 rank, nccl) "
        f"{[round(x, 2) for x in sharded_ms]} ms (the first starts NCCL; median of the rest "
        f"{med:.2f}), single-process {[round(x, 2) for x in single_ms]} ms (median "
        f"{med_single:.2f}); {n_records} collectives; against the single-process run {errs}; "
        f"{len(calls)} scan calls ({n_scan} launches) equal to the plain loop on their active "
        f"slots {active}")
    if not calls or n_scan != 2 * len(calls) or not any(active):
        raise AssertionError(f"parallel (a): {len(calls)} scan calls, active slots {active}, "
                             f"launches {launches}")
    row = dict(sharded_ms=sharded_ms, single_ms=single_ms, collectives=n_records, errors=errs,
               scan_calls=len(calls), scan_active=active)
    return row, launches, scan_err


def parallel_events(dev, world, store_dir):
    """(b) Fracturing at the dry run's config and the filled 64³ asteroid
    (dense remesh) on the world's ranks, each from the state of a
    single-process run on the card a few steps before its event, gathered
    and held to that run to ``held_to_bars``; every grid a rank labelled
    held against the plain labelling. Returns (rows, the ranks' launches
    summed, the labels' max abs err)."""
    import numpy as np
    import torch

    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.parallel import jobs
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

    rows, launches, labelled = {}, {}, []
    for name in ("fracturing", "asteroid"):
        w, cfg = jobs.scene(name)
        rt = HeadlessRuntime(compile_scene(w, cfg, device=dev), cfg)
        ckpt = os.path.join(store_dir, f"{name}.npz")
        event, n = event_checkpoint(rt, ckpt, PARALLEL_BEFORE_EVENT, PARALLEL_EVENT_STEPS)
        res = world.run(jobs.step_job, name, world.n_ranks, n, ckpt, record_labels=True)
        errs = held_to_bars(res[0]["state"], jobs.state_arrays(rt.sim), f"parallel (b) {name}")
        receivers = [r["rank"] for r in res if r["received"]]
        staged = sum(r["staged_bytes"] for r in res)
        ms = np.mean([r["step_ms"] for r in res], axis=0)
        for r in res:
            for key, v in r["launches"].items():
                launches[key] = launches.get(key, 0) + v
            labelled += r["labelled"]
        log(f"parallel (b) {name}: event at step {event} on the card; {n} sharded steps from "
            f"step {event + PARALLEL_BEFORE_EVENT - n}; against the single-process run {errs}; "
            f"ranks that received fragments or regions {receivers}; cross-shard pairs with "
            f"active contacts {res[0]['cross_pairs']}; host staging {staged} B; step ms (mean "
            f"over ranks) {[round(float(x), 2) for x in ms]}")
        if not receivers or 0 in receivers:
            raise AssertionError(f"parallel (b) {name}: receivers {receivers}")
        rows[name] = dict(event_step=event, steps=n, errors=errs, receivers=receivers,
                          cross_pairs=res[0]["cross_pairs"], staged_bytes=staged,
                          step_ms=[float(x) for x in ms])
    labels_err, n_grids = 0, 0
    for occ in labelled:
        occ = torch.as_tensor(occ, device=dev)
        got, ref = k2.connected_component_labels_batched(occ), labels_plain(occ)
        if not torch.equal(got, ref):
            raise AssertionError(f"parallel (b): {int((got != ref).sum())} labels differ from "
                                 f"the plain labelling")
        labels_err = max(labels_err, int((got.long() - ref.long()).abs().max()))
        n_grids += occ.shape[0]
    log(f"parallel (b): {n_grids} grids of the ranks' {len(labelled)} labelling calls equal to "
        f"the plain labelling; launches {launches}")
    if not labelled or launches["k2_labels"] != len(labelled):
        raise AssertionError(f"parallel (b): {len(labelled)} labelling calls, launches "
                             f"{launches}")
    rows["labelled_grids"] = n_grids
    return rows, launches, float(labels_err)


def parallel_pod(world):
    """(c) The pod step of tests/test_parallel.py:245 (1024 slots of 16³
    i8, jacobi, 4096 contact slots) on the world's ranks: local leading dims
    O/4, each rank's device peak over its state under 8× that state, no
    collective above 1.5 object-axis shards of its largest leaf and none of
    a grid's shape, finite bodies and 6 alive. Returns a row per rank."""
    from impact_tpu_torch.parallel import jobs

    res = world.run(jobs.step_job, "pod", world.n_ranks, 1, gather=False, serial_build=True)
    o_loc = jobs.POD_OBJECTS // world.n_ranks
    rows = []
    for r in res:
        dims, nbytes = r["local_dims"], r["local_bytes"]
        shard_leaf = max(nbytes[p] for p, d in dims.items() if d and d[0] == o_loc)
        worst = max(rec["bytes"] for rec in r["records"])
        grids = [rec["parts"] for rec in r["records"]
                 if any(len(s) >= 4 and min(s[-3:]) >= 15 for s, _ in rec["parts"])]
        rows.append(dict(rank=r["rank"], leading=dims["voxels/sdf"][0],
                         peak_over_state=r["peak_extra_bytes"], state_bytes=r["state_bytes"],
                         largest_collective=worst, shard_leaf_bytes=shard_leaf,
                         step_ms=r["step_ms"][0], staged_bytes=r["staged_bytes"]))
        if (dims["voxels/sdf"][0] != o_loc or dims["meshes/tri_pos"][0] != o_loc
                or r["peak_extra_bytes"] >= 8 * r["state_bytes"] or worst > 1.5 * shard_leaf
                or grids or not r["finite"] or r["n_alive"] != 6):
            raise AssertionError(f"parallel (c): rank {r['rank']}: {rows[-1]}, grids {grids}, "
                                 f"finite {r['finite']}, alive {r['n_alive']}")
    log(f"parallel (c): {rows}")
    return rows


def parallel_halo(dev, world):
    """(d) The halo min filter on a 2×2 mesh of the world's ranks: equal to
    the plain 3-point min of the whole grid, boundary closed."""
    import numpy as np
    import torch

    from impact_tpu_torch.parallel import jobs

    grid = np.random.default_rng(0).uniform(size=(4, 16, 16, 16)).astype(np.float32)
    grid[:, 0], grid[:, -1] = -5.0, -7.0
    res = world.run(jobs.halo_job, grid, 2, 2)
    pad = torch.nn.functional.pad(torch.as_tensor(grid, device=dev), (0, 0, 0, 0, 1, 1),
                                  value=float("inf"))
    want = torch.minimum(torch.minimum(pad[:, :-2], pad[:, 1:-1]), pad[:, 2:]).cpu()
    got = torch.as_tensor(res[0]["out"])
    if not torch.equal(got, want) or got[0, 0, 0, 0] != -5.0 or got[0, -1, 0, 0] != -7.0:
        raise AssertionError("parallel (d): the sharded min filter differs from the plain "
                             "3-point min")
    halos = [len(r["halos"]) for r in res]
    staged = sum(r["staged_bytes"] for r in res)
    log(f"parallel (d): equal to the plain 3-point min (closed boundary); halo transfers per "
        f"rank {halos}, host staging {staged} B")
    return dict(halos=halos, staged_bytes=staged)


def parallel_solver_memory(dev):
    """(e) The jacobi solve at N = 1024 bodies, C = 4096 contact slots
    (tests/test_parallel.py:189): device peak over the inputs under C·N·4
    bytes (no [C, N] incidence), finite velocities."""
    import torch

    from impact_tpu_torch.parallel.jobs import solver_scene
    from impact_tpu_torch.physics import solver
    from impact_tpu_torch.render.pipeline import fp32_render

    n, c = 1024, 4096
    b, prep, scfg = solver_scene(n, c, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with fp32_render():
        out, _ = solver.solve_contacts(b, prep, scfg, mode="jacobi")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    log(f"parallel (e): peak {peak} B over the inputs, bar C*N*4 = {c * n * 4} B")
    if peak >= c * n * 4 or not bool(torch.isfinite(out.velocity).all()):
        raise AssertionError(f"parallel (e): peak {peak} B")
    return dict(peak_bytes=peak, bar_bytes=c * n * 4)


def solve_collectives_ok(records, n, n_contacts, mode, cfg):
    """The sharded solve's collectives, as ``parallel/solver.py`` makes
    them: objects-axis gathers of body rows only (every part N rows, none
    with the contact count), in count and width: jacobi, one velocity
    gather [N, 6] a velocity iteration, the inverse masses and inertias
    [N, 10] once and positions and orientations [N, 7] each correction
    iteration, the written-back positions [N, 3] once; scan, one gather
    of [N, 23] words. Returns a reason it is not so, or None."""
    if mode == "scan":
        want = [23]
    else:
        want = ([6] * 4 * max(cfg.n_iterations, 1)
                + ([10] + [7] * cfg.n_positional_correction_iterations
                   if cfg.n_positional_correction_iterations else []) + [3])
    got = []
    for r in records:
        parts = [tuple(shape) for shape, _ in r["parts"]]
        if r["op"] != "all_gather" or r["axis"] != "objects":
            return f"a {r['op']} along {r['axis']}"
        if any(p[0] != n or n_contacts in p for p in parts):
            return f"a gather of {parts}"
        got.append(r["bytes"] // (4 * n))
    return None if got == want else f"gathers of {got} words a body, not {want}"


def parallel_sharded_solve(dev, world):
    """(g) The contact solve with the bodies split over the objects axis and
    the contacts replicated (``parallel.solver.sharded_solve_contacts``) on
    the world's ranks on a 4x2 mesh, each of SOLVE_CELLS against the
    single-process ``solve_contacts`` on the card: gathered bodies and
    every rank's cache within SOLVE_TOL (bitwise equality reported), every
    scan launch of the ranks equal to ``scan_iterations_plain`` on its
    inputs, each rank's device peak over its inputs under C·N·4 B (the
    [C, N] incidence check (e) forbids), the collectives as
    ``solve_collectives_ok`` sets out. Returns (rows, scan launches summed
    over the ranks)."""
    import numpy as np
    import torch

    from impact_tpu_torch.parallel import jobs
    from impact_tpu_torch.physics import scan_solver, solver
    from impact_tpu_torch.render.pipeline import fp32_render

    rows, n_scan = [], 0
    for mode, n, c, iterations, warm in SOLVE_CELLS:
        what = f"parallel (g) {mode} {n} x {c}" + (" warm" if warm else "")
        b, prep, cfg = jobs.solver_scene(n, c, dev, SOLVE_SEED, warm)
        cfg = jobs.solver_config(cfg, iterations)
        world.submit(jobs.solve_job, n, c, mode, iterations, SOLVE_SEED, warm, SOLVE_REPS)
        with fp32_render():
            solver.solve_contacts(b, prep, cfg, mode=mode)
            single_ms = []
            for _ in range(SOLVE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want_b, want_c = solver.solve_contacts(b, prep, cfg, mode=mode)
                torch.cuda.synchronize()
                single_ms.append((time.perf_counter() - t0) * 1e3)
        res = [r for r in world.collect() if r is not None]
        want = {f: getattr(want_b, f).cpu().numpy() for f in want_b._fields}
        cache = {f: getattr(want_c, f).cpu().numpy() for f in want_c._fields}
        got = res[0]["bodies"]
        unequal = [f for f in want if not np.array_equal(got[f], want[f])]
        unequal += sorted({f"cache/{f}" for r in res for f in cache
                           if not np.array_equal(r["cache"][f], cache[f])})
        err = 0.0
        for key, g, w_ in ([(f, got[f], want[f]) for f in want]
                           + [(f"cache/{f}", r["cache"][f], cache[f]) for r in res
                              for f in cache]):
            if g.dtype.kind == "f":
                d = np.abs(g.astype(np.float64) - w_.astype(np.float64))
                err = max(err, float(d.max()))
                if not np.all(d <= SOLVE_TOL + SOLVE_TOL * np.abs(w_)):
                    raise AssertionError(f"{what}: {key} off by {float(d.max()):.3g}, past "
                                         f"atol and rtol {SOLVE_TOL}")
            elif not np.array_equal(g, w_):
                raise AssertionError(f"{what}: {key} differs")
        if not np.isfinite(got["velocity"]).all():
            raise AssertionError(f"{what}: non-finite velocities")
        for r in res:
            why = solve_collectives_ok(r["records"], n, c, mode, cfg)
            if why:
                raise AssertionError(f"{what}: rank {r['rank']}: {why}")
            if n == 1024 and c == 4096 and r["peak_extra_bytes"] >= c * n * 4:
                raise AssertionError(f"{what}: rank {r['rank']} peak {r['peak_extra_bytes']} B "
                                     f"over its inputs, bar C*N*4 = {c * n * 4} B")
        launches = sum(sum(r["launches"].values()) for r in res)
        if mode == "scan":
            if launches != 2 * SOLVE_REPS * len(res):
                raise AssertionError(f"{what}: scan launches {[r['launches'] for r in res]}")
            held = {}
            for r in res:
                ins = r["scan"]["inputs"]
                key = tuple(x.tobytes() for x in ins["tensors"])
                if key not in held:
                    v, w, pos, ori, im, ii, acc = (torch.as_tensor(x, device=dev)
                                                   for x in ins["tensors"])
                    sprep = type(prep)(**{k: torch.as_tensor(x, device=dev)
                                          for k, x in ins["prep"].items()})
                    held[key] = [x.cpu().numpy() for x in scan_solver.scan_iterations_plain(
                        v, w, pos, ori, im, ii, sprep, acc, *ins["scalars"])]
                for name, g, w_ in zip(("v", "w", "impulses", "pos", "ori"),
                                       r["scan"]["outputs"], held[key]):
                    if not np.array_equal(g, w_):
                        raise AssertionError(f"{what}: rank {r['rank']}'s scan launch: {name} "
                                             f"differs from the plain loop")
            n_scan += launches
        elif launches:
            raise AssertionError(f"{what}: scan launches under jacobi")
        ms = [float(np.median(r["ms"])) for r in res]
        recs = res[0]["records"]
        row = dict(mode=mode, bodies=n, contacts=c, warm=warm,
                   iterations=(cfg.n_iterations, cfg.n_positional_correction_iterations),
                   ms_per_rank=ms, single_ms=float(np.median(single_ms)),
                   collectives=len(recs), collective_bytes=sum(x["bytes"] for x in recs),
                   largest_collective=max(x["bytes"] for x in recs),
                   staged_bytes=res[0]["staged_bytes"],
                   peak_extra_bytes=[r["peak_extra_bytes"] for r in res],
                   bitwise_equal=not unequal, unequal=unequal, max_abs_err=err,
                   scan_launches=launches if mode == "scan" else 0, ranks=len(res))
        log(f"{what}: ms per rank (median of {SOLVE_REPS}) {min(ms):.3f}-{max(ms):.3f} against "
            f"{row['single_ms']:.3f} single-process; {row['collectives']} collectives, "
            f"{row['collective_bytes']} B (largest {row['largest_collective']} B), staged "
            f"{row['staged_bytes']} B; peak over inputs per rank {row['peak_extra_bytes']} B; "
            f"bitwise equal {row['bitwise_equal']} "
            f"{unequal}, max abs err {err:.3g}; scan launches {row['scan_launches']}")
        rows.append(row)
    return rows, n_scan


def space_rows(res):
    """Per rank of a sharded run: step ms, halo transfers and their bytes,
    host staging and the events' grid bytes."""
    rows = []
    for r in res:
        if r is None:
            continue
        halos = [x for x in r["records"] if x["op"] == "halo"]
        rows.append(dict(rank=r["rank"], coordinate=tuple(r["coordinate"]),
                         step_ms=[round(x, 2) for x in r["step_ms"]], halos=len(halos),
                         halo_bytes=sum(x["bytes"] for x in halos),
                         staged_bytes=r["staged_bytes"], event_bytes=r["event_bytes"]))
    return rows


def exact_leaves(got: dict, want: dict, what):
    """The leaves a space-sharded state must hold bit for bit (grids, flags,
    meshes, the probes' choice) against a single-process one; raises
    naming the first that differs."""
    import numpy as np

    keys = [k for k in want if k.startswith(("voxels/sdf", "voxels/vtype", "voxels/alive",
                                             "voxels/mesh_dirty", "voxels/split_pending",
                                             "meshes/", "probes/active", "probes/response"))]
    for k in keys:
        if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs from the single-process run")
    return len(keys)


def divergence(got: dict, want: dict):
    """{leaf: max abs difference} of the body and origin leaves that differ
    (a report, not a check)."""
    import numpy as np

    out = {}
    for k in ("phys/bodies/inertia_body", "phys/bodies/mass", "voxels/origin",
              "phys/bodies/orientation", "phys/bodies/position", "phys/bodies/momentum",
              "phys/bodies/angular_momentum"):
        d = np.abs(got[k].astype(np.float64) - want[k].astype(np.float64))
        if d.size and d.max() > 0:
            out[k] = float(d.max())
    return out


def parallel_space_tumbler(dev, world):
    """(f) The tumbler of tests/test_parallel.py:54-63 on 2×2 and 4×2
    meshes, SPACE_STEPS sharded steps, held to a single-process run on the
    card: grids, flags, meshes and probes bit for bit, bodies to
    ``held_to_bars``. Returns (rows, launches summed over the ranks)."""
    from impact_tpu_torch.parallel import jobs
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

    w, cfg = jobs.scene("tumbler")
    rt = HeadlessRuntime(compile_scene(w, cfg, device=dev), cfg)
    rt.step(SPACE_STEPS)
    want = jobs.state_arrays(rt.sim)
    rows, launches = {}, {}
    for shape in ((2, 2), (4, 2)):
        res = world.run(jobs.step_job, "tumbler", shape[0], SPACE_STEPS, n_space_axis=shape[1])
        what = f"parallel (f) tumbler {shape[0]}x{shape[1]}"
        errs = held_to_bars(res[0]["state"], want, what)
        n_exact = exact_leaves(res[0]["state"], want, what)
        per_rank = space_rows(res)
        for r in res:
            for key, v in (r or {}).get("launches", {}).items():
                launches[key] = launches.get(key, 0) + v
        dims = res[0]["local_dims"]["voxels/sdf"]
        log(f"{what}: {SPACE_STEPS} steps; local sdf {dims}; {n_exact} leaves equal to the "
            f"single-process run, bodies {errs}; per rank {per_rank}")
        if tuple(dims) != (8 // shape[0], 8, 16, 16) or not any(r["halos"] for r in per_rank):
            raise AssertionError(f"{what}: local sdf {dims}, ranks {per_rank}")
        rows[f"{shape[0]}x{shape[1]}"] = dict(errors=errs, ranks=per_rank)
    return rows, launches


def parallel_space_events(dev, world, store_dir):
    """(f) Fracturing on 2×2 across its fracture and the filled 64³
    asteroid on 1×4 across its carve and split, from a state of a
    single-process run on the card a few steps before the event: held to
    a single-process run from that state whose inertia sums slab by slab
    as the rows do (``jobs.slab_ordered_inertia``): grids, flags, meshes
    and probes bit for bit, bodies to ``held_to_bars``; the divergence from
    the plain run (the inertia's float32 sums in another order) is
    reported. Every slab labels launch of the ranks is held against its
    plain version and timed, and the merged labels of the asteroid's
    slabs against the whole grid's kernel labels. Returns (rows, the
    ranks' launches summed, the slab launches' max abs err, their timing
    row)."""
    import numpy as np
    import torch

    from impact_tpu_torch.devtools import cuda_time_ms
    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.parallel import jobs
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

    rows, launches, labelled, first_slabs = {}, {}, [], []
    for name, shape in (("fracturing", (2, 2)), ("asteroid", (1, 4))):
        w, cfg = jobs.scene(name)
        rt = HeadlessRuntime(compile_scene(w, cfg, device=dev), cfg)
        ckpt = os.path.join(store_dir, f"space_{name}.npz")
        event, n = event_checkpoint(rt, ckpt, PARALLEL_BEFORE_EVENT, PARALLEL_EVENT_STEPS)
        world.submit(jobs.step_job, name, shape[0], n, ckpt, record_labels=True,
                     n_space_axis=shape[1])
        ref = HeadlessRuntime(compile_scene(jobs.scene(name)[0], cfg, device=dev), cfg)
        ref.load_checkpoint(ckpt)
        with jobs.slab_ordered_inertia(shape[1]):
            ref.step(n)
        res = world.collect()
        what = f"parallel (f) {name} {shape[0]}x{shape[1]}"
        got = res[0]["state"]
        errs = held_to_bars(got, jobs.state_arrays(ref.sim), what)
        n_exact = exact_leaves(got, jobs.state_arrays(ref.sim), what)
        plain = divergence(got, jobs.state_arrays(rt.sim))
        per_rank = space_rows(res)
        for r in res:
            if r is None:
                continue
            for key, v in r["launches"].items():
                launches[key] = launches.get(key, 0) + v
            labelled += r["labelled"]
            if name == "asteroid":
                first_slabs.append(r["labelled"][0])
        log(f"{what}: event at step {event} on the card; {n} sharded steps from step "
            f"{event + PARALLEL_BEFORE_EVENT - n}; {n_exact} leaves equal to the slab-ordered "
            f"single-process run, bodies {errs}; against the plain single-process run "
            f"(report) {plain or 'equal'}; per rank {per_rank}")
        if not any(r["event_bytes"] for r in per_rank):
            raise AssertionError(f"{what}: no event moved a grid")
        rows[name] = dict(event_step=event, steps=n, errors=errs, plain_divergence=plain,
                          ranks=per_rank)
    # each slab labels launch against its plain version, and timed
    err, ms, plain_ms, bounds = 0, [], [], []
    for occ in labelled:
        occ = torch.as_tensor(occ, device=dev)
        got, ref_lab = k2.connected_component_labels_batched(occ), labels_plain(occ)
        if occ.shape[1] == occ.shape[-1] or not torch.equal(got, ref_lab):
            raise AssertionError(f"parallel (f): slab labels {tuple(occ.shape)} differ from the "
                                 f"plain version")
        err = max(err, int((got.long() - ref_lab.long()).abs().max()))
        ms.append(cuda_time_ms(lambda o=occ: k2.connected_component_labels_batched(o), reps=20))
        plain_ms.append(cuda_time_ms(lambda o=occ: labels_plain(o), reps=1, warmup=1))
        bounds.append(k2.labels_bound_ms(occ))
    log(f"parallel (f): {len(labelled)} slab labels launches {[tuple(x.shape) for x in labelled]}"
        f" equal to the plain version; ms per launch {[round(x, 4) for x in ms]}, plain "
        f"{[round(x, 3) for x in plain_ms]}, bound {[round(b[0], 6) for b in bounds]} ms")
    # the merged labels of the asteroid's slabs against the whole grid's kernel labels
    whole = np.concatenate(first_slabs, axis=1)
    res = world.run(jobs.slab_labels_job, whole, 4)
    kernel = k2.connected_component_labels_batched(torch.as_tensor(whole, device=dev))
    if not np.array_equal(res[0]["labels"], kernel.cpu().numpy()):
        raise AssertionError("parallel (f): the merged slab labels differ from the whole grid's")
    log(f"parallel (f): the asteroid's slabs' merged labels equal the whole {whole.shape[1:]} "
        f"grid's kernel labels ({len(np.unique(res[0]['labels'])) - 1} components); halo "
        f"transfers per rank {[len(r['halos']) for r in res[:4]]}")
    by_shape = {}
    for occ, t in zip(labelled, ms):
        by_shape.setdefault(str(list(occ.shape)), []).append(t)
    log("parallel (f): slab labels ms per launch by shape (median): "
        + ", ".join(f"{k} {float(np.median(v)):.4f} ({len(v)})" for k, v in by_shape.items()))
    timing = dict(ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
                  bound_ms=float(np.mean([b[0] for b in bounds])), bound_by=bounds[0][1],
                  launches_ms=ms, shapes=[list(x.shape) for x in labelled])
    return rows, launches, float(err), timing


def parallel_space_pod(world):
    """(f) The pod step of tests/test_parallel.py:245-405 on 4×2: 1024 slots
    of 16³ i8, jacobi; local sdf dims [256, 8, 16, 16], halo transfers, no
    collective of a grid's or a slab's shape, none above 1.5 object-axis
    shards of the largest leaf, device peak under 8× the rank's state."""
    from impact_tpu_torch.parallel import jobs

    res = world.run(jobs.step_job, "pod", 4, 1, gather=False, serial_build=True,
                    n_space_axis=2)
    g, o_loc = 16, jobs.POD_OBJECTS // 4
    rows = space_rows(res)
    for r, row in zip(res, rows):
        dims, nbytes = r["local_dims"], r["local_bytes"]
        shard_leaf = max(nbytes[p] for p, d in dims.items() if d and d[0] == o_loc)
        worst = max(rec["bytes"] for rec in r["records"])
        shaped = [rec["parts"] for rec in r["records"]
                  if any(len(s) >= 4 and s[-1] >= g and s[-2] >= g and s[-3] >= g // 2
                         for s, _ in rec["parts"])]
        row.update(largest_collective=worst, shard_leaf_bytes=shard_leaf,
                   peak_over_state=r["peak_extra_bytes"], state_bytes=r["state_bytes"])
        if (tuple(dims["voxels/sdf"]) != (o_loc, g // 2, g, g) or worst > 1.5 * shard_leaf
                or shaped or r["peak_extra_bytes"] >= 8 * r["state_bytes"]
                or not r["finite"] or r["n_alive"] != 6 or r["event_bytes"]):
            raise AssertionError(f"parallel (f) pod: {row}, shaped {shaped}, "
                                 f"sdf {dims['voxels/sdf']}")
    if not any(r["halos"] for r in rows):
        raise AssertionError("parallel (f) pod: no halo transfer")
    log(f"parallel (f) pod 4x2: {rows}")
    return rows


def parallel_space_dryrun(world):
    """(f) The dry run on 2×2: the full engine step and the halo min
    filter."""
    from impact_tpu_torch.parallel import jobs

    r = world.run(jobs.dryrun_job, 4)[0]
    log(f"parallel (f) dry run: mesh {r['mesh']}, step {r['step_s']:.2f} s with "
        f"{r['step_halos']} halo transfers, min filter equal {r['halo_equal']}")
    if r["mesh"] != (2, 2) or not (r["finite"] and r["halo_equal"] and r["step_halos"]):
        raise AssertionError(f"parallel (f) dry run: {r}")
    return r


def parallel_phase(dev, record, kernels):
    """The engine step sharded over the voxel-object pool
    (``impact_tpu_torch/parallel``): checks (a)-(g) of the docstring's item
    15, (b)-(d) on PARALLEL_RANKS ranks sharing the card over host-staged
    gloo, (f) and (g) on SPACE_RANKS."""
    import tempfile

    from impact_tpu_torch.parallel.world import World

    t_phase = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        with Phase(f"parallel (a): the quick start's tumbler under scan, sharded on a 1-rank "
                   f"nccl mesh, {PARALLEL_STEPS} steps against HeadlessRuntime's"):
            rows["a"], launches_a, scan_err = parallel_quick_start(dev, tmp)
        with World(PARALLEL_RANKS, device=dev, backend="gloo", store_dir=tmp) as world:
            with Phase(f"parallel (b): Fracturing and the filled 64^3 asteroid on "
                       f"{PARALLEL_RANKS} ranks sharing the card over host-staged gloo, across "
                       f"their events, against single-process runs"):
                rows["b"], launches_b, labels_err = parallel_events(dev, world, tmp)
            with Phase(f"parallel (c): the 1024-slot pod step on {PARALLEL_RANKS} ranks"):
                rows["c"] = parallel_pod(world)
            with Phase("parallel (d): the halo min filter on a 2x2 mesh"):
                rows["d"] = parallel_halo(dev, world)
        with Phase("parallel (e): the jacobi solve at 1024 bodies and 4096 contact slots"):
            rows["e"] = parallel_solver_memory(dev)
        t_space = time.perf_counter()
        with World(SPACE_RANKS, device=dev, backend="gloo", store_dir=tmp) as world:
            with Phase(f"parallel (f): the tumbler on 2x2 and 4x2 (space axis), {SPACE_STEPS} "
                       f"steps against a single-process run"):
                rows["f_tumbler"], launches_f = parallel_space_tumbler(dev, world)
            with Phase("parallel (f): Fracturing on 2x2 and the filled 64^3 asteroid on 1x4 "
                       "across their events; every slab labels launch against its plain "
                       "version"):
                rows["f_events"], launches_fe, slab_err, slab_timing = parallel_space_events(
                    dev, world, tmp)
            with Phase("parallel (f): the 1024-slot pod step on 4x2"):
                rows["f_pod"] = parallel_space_pod(world)
            with Phase("parallel (f): the dry run on 2x2"):
                rows["f_dryrun"] = parallel_space_dryrun(world)
            t_solve = time.perf_counter()
            with Phase("parallel (g): the contact solve with the bodies split over the objects "
                       "axis of a 4x2 mesh, the contacts replicated, against the single-process "
                       "solve"):
                rows["g"], launches_g = parallel_sharded_solve(dev, world)
            rows["g_seconds"] = time.perf_counter() - t_solve
        rows["f_seconds"] = time.perf_counter() - t_space - rows["g_seconds"]
        log(f"parallel (f): {rows['f_seconds']:.2f} s on {SPACE_RANKS} ranks sharing the card over "
            f"host-staged gloo (their times say nothing about a multi-card speed); launches "
            f"{launches_f} (tumbler), {launches_fe} (events)")
    phase_s = time.perf_counter() - t_phase
    n_scan = launches_a["scan_velocity_iterations"] + launches_a["scan_position_correction"]
    launches = {"scan_solver": n_scan, "k2_labels": launches_b["k2_labels"]}
    log(f"parallel phase: {phase_s:.2f} s; launches {launches} ((a) in this process, (b) summed "
        f"over the ranks)")
    record["parallel"] = dict(rows, seconds=phase_s, launches=launches)
    log(f"parallel (g): {rows['g_seconds']:.2f} s; scan launches {launches_g} (summed over the "
        f"ranks, each held against the plain loop)")
    if launches_g <= 0:
        raise AssertionError("parallel (g): the scan kernels were not launched")
    record["parallel"]["sharded_solve_scan_launches"] = launches_g
    errs = {"scan_solver": scan_err, "k2_labels": labels_err}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"parallel: {name} was not launched")
        entry = next((k for k in kernels if k["name"] == name), None)
        if entry is None:  # --parallel-only: the phase's own record
            entry = dict(name=name, route="cuda", max_abs_err=errs[name])
            kernels.append(entry)
        entry["parallel_launches"] = n
        if name == "scan_solver":
            entry["sharded_solve_launches"] = launches_g
    # the labels kernel's slab entry: launched only on this phase's (f) path
    n_slab = launches_fe.get("k2_labels_slab", 0)
    if n_slab <= 0 or n_slab != len(slab_timing["launches_ms"]):
        raise AssertionError(f"parallel (f): slab labels launches {launches_fe}, "
                             f"{len(slab_timing['launches_ms'])} held to the plain version")
    kernels.append(dict(
        name="k2_labels_slab", route="cuda", source="impact_tpu_torch/csrc/ccl.cu",
        replaces="impact_tpu/ops/ccl_pallas.py:45", launches=n_slab, max_abs_err=slab_err,
        ms=slab_timing["ms"], plain_ms=slab_timing["plain_ms"],
        bound_ms=slab_timing["bound_ms"], bound_by=slab_timing["bound_by"], library_ms=None))
    record["parallel"]["k2_labels_slab"] = slab_timing


SURFACE_FIXTURES = ("base420.jpg", "prog444.jpg", "grey8.png", "grey16.png")
SURFACE_DECODE_REPS = 3


def surface_phase(dev, record, kernels):
    """The last-ported names of the reference's public surface, on the card:
    (a) the committed image fixtures (tests/data/surface_images; the card
    has no PIL) decoded by the port equal to PIL's decodes committed beside
    them, each decode timed; (b) the textured box with the baseline JPEG as
    its colour texture, compiled and rendered through K1 with every launch
    held against K1's plain version, scored against the plain tile raster's
    frame; (c) ``split_off_disconnected_region`` on a 32^3 two-component
    grid, its labels launch held against the plain version and the pool
    equal to the CPU's; (d) ``rasterize(method="chunk")`` against
    ``method="tiled"`` at 480x270 on the bench scene's triangles, at the
    raster bars (depth within 2e-3, coverage equal on > 0.99 of pixels);
    (e) the class members and record layouts: after a remesh of a tumbler
    at 16^3 with mixed voxel types, ``sim.meshes``' ``vert_type``,
    ``vert_type2`` and ``vert_blend`` equal the card's and the CPU's
    ``compact_mesh`` of the same Surface Nets mesh; ``Isometry.identity``,
    ``Similarity.identity``, ``BodyState.is_kinematic`` and
    ``HeadlessRuntime.registry`` on the card; ``RenderConfig``,
    ``EngineParams``, ``PhysicsConfig`` and ``TpuConfig`` built
    positionally equal to the runtime's own."""
    import numpy as np
    import torch

    from impact_tpu_torch.apps import snapshot_tester as st
    from impact_tpu_torch.devtools import cuda_time_ms
    from impact_tpu_torch.models.bench import bench_config, bench_scene
    from impact_tpu_torch.ops import ccl_pallas as k2
    from impact_tpu_torch.render import raster as rasterlib
    from impact_tpu_torch.render import raster_pallas as rp
    from impact_tpu_torch.render.camera import projection_matrix, view_matrix
    from impact_tpu_torch.render.pipeline import project_corners
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.utils.config import EngineConfig
    from impact_tpu_torch.utils.image import load_image, rgb_hybrid_compare
    from impact_tpu_torch.voxel.interaction import split_off_disconnected_region
    from impact_tpu_torch.voxel.object import empty_voxel_object_pool

    t_phase = time.perf_counter()
    rows = record["surface"] = {}
    fixtures = os.path.join(HERE, "tests", "data", "surface_images")
    with Phase("surface (a): the image fixtures decoded by the port, equal to PIL's decodes"):
        decode_ms = {}
        for name in SURFACE_FIXTURES:
            with open(os.path.join(fixtures, name), "rb") as f:
                data = f.read()
            want = load_image(os.path.join(fixtures, f"{name}.rgb.png"))
            times = []
            for _ in range(SURFACE_DECODE_REPS):
                t0 = time.perf_counter()
                got = load_image(data, mode="RGB")
                times.append((time.perf_counter() - t0) * 1e3)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{name}: the port's decode differs from PIL's at "
                                     f"{int((got != want).sum())} samples")
            decode_ms[name] = min(times)
            log(f"surface decode {name} ({len(data)} B, {got.shape[1]}x{got.shape[0]}): equal to "
                f"PIL's decode; {decode_ms[name]:.2f} ms (fastest of {SURFACE_DECODE_REPS})")
        rows["decode_ms"] = decode_ms

    k1_names = {"k1_raster_attributes": "k1_attr_kernel", "k1_raster_depth": "k1_depth_kernel"}
    with Phase("surface (b): the JPEG-textured box through K1, every launch held, against the "
               "plain tile raster's frame"):
        cfg = textured_box_config(EngineConfig())
        rt = HeadlessRuntime(compile_scene(textured_box_scene(os.path.join(fixtures,
                                                                           "base420.jpg")),
                                           cfg, device=dev), cfg, enable_fracturing=False)
        held = dict(depth=0, attributes=0, max_abs_err=0.0)
        views = []
        run_depth, run_attr = rp.raster_depth, rp.raster_attributes
        hold_depth, hold_attr = held_k1(held)

        def rec_depth(b):
            views.append(("k1_raster_depth", b, 0))
            return hold_depth(b)

        def rec_attr(b, n_attr):
            views.append(("k1_raster_attributes", b, n_attr))
            return hold_attr(b, n_attr)

        rp.raster_depth, rp.raster_attributes = rec_depth, rec_attr
        rp.LAUNCHES.reset()
        try:
            img = rt.render().cpu().numpy()
        finally:
            rp.raster_depth, rp.raster_attributes = run_depth, run_attr
        k1_launches = dict(rp.LAUNCHES)
        if k1_launches["k1_raster_attributes"] <= 0:
            raise AssertionError(f"the JPEG-textured box did not go through K1: {k1_launches}")
        if held["depth"] + held["attributes"] != sum(k1_launches.values()):
            raise AssertionError(f"held {held} of the launches {k1_launches}")
        if not rt.render_config.textured:
            raise AssertionError("the JPEG texture did not turn the textured path on")
        t0 = time.perf_counter()
        rt.render()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        parity = rgb_hybrid_compare(img, st.render_again(rt, "raster"))
        face_std = float(img[28:68, 44:84].astype("float32").std(axis=(0, 1)).max())
        log(f"surface JPEG box: K1 launches {k1_launches}, each equal to the plain version "
            f"(max abs err {held['max_abs_err']:.3g}); frame {frame_ms:.2f} ms; vs the plain "
            f"tile raster's frame {parity:.4f} (bar {PARITY_BAR}); face colour spread "
            f"{face_std:.1f}")
        if parity < PARITY_BAR or face_std <= 8.0:
            raise AssertionError(f"JPEG box: parity {parity:.4f}, face spread {face_std}")
        k1_rows = {}
        for name, b, n_attr in views:
            call = ((lambda b=b, n=n_attr: rp.raster_attributes(b, n)) if n_attr
                    else (lambda b=b: rp.raster_depth(b)))
            plain = ((lambda b=b, n=n_attr: rp.raster_attributes_plain(b, n)) if n_attr
                     else (lambda b=b: rp.raster_depth_plain(b)))
            bnd, by = rp.bound_ms(b, n_attr)
            k1_rows.setdefault(name, []).append(dict(
                ms=kernel_ms(call, k1_names[name]), plain_ms=cuda_time_ms(plain, reps=3),
                bound_ms=bnd, bound_by=by))
        rows["jpeg_box"] = dict(parity=parity, face_std=face_std, frame_ms=frame_ms,
                                launches=k1_launches, k1=k1_rows)

    with Phase("surface (c): split_off_disconnected_region on a 32^3 two-component grid, "
               "through the labels kernel"):
        g = 32
        pool = empty_voxel_object_pool(4, g, device=dev)
        sdf = pool.sdf.clone()
        occ = torch.zeros((g, g, g), dtype=torch.bool, device=dev)
        occ[2:14, 2:14, 2:14] = True
        occ[20:27, 18:30, 19:26] = True
        sdf[0] = torch.where(occ, -0.3, 0.7)
        pool = pool._replace(sdf=sdf, alive=torch.tensor([True, False, False, False], device=dev),
                             voxel_extent=torch.full((4,), 0.25, device=dev))
        k2.LAUNCHES.reset()
        out, did, disc = split_off_disconnected_region(pool, 0, 2)
        torch.cuda.synchronize()
        split_launches = dict(k2.LAUNCHES)
        if split_launches["k2_labels"] < 1:
            raise AssertionError(f"the split did not label through the labels kernel: "
                                 f"{split_launches}")
        cpu = split_off_disconnected_region(type(pool)(*(x.cpu() for x in pool)), 0, 2)
        for name, a, b in zip(pool._fields, out, cpu[0]):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"split on the card: pool.{name} differs from the CPU's")
        if not (bool(did) and bool(disc)) or (bool(did), bool(disc)) != (bool(cpu[1]),
                                                                        bool(cpu[2])):
            raise AssertionError(f"split flags {bool(did)}, {bool(disc)}; CPU {bool(cpu[1])}, "
                                 f"{bool(cpu[2])}")
        batch = occ[None].contiguous()
        got = k2.connected_component_labels_batched(batch)
        if not torch.equal(got, k2.connected_component_labels_plain(batch)):
            raise AssertionError("the split's labels launch differs from the plain version")
        moved = int((out.sdf[2] < 0).sum())
        labels_ms = cuda_time_ms(lambda: k2.connected_component_labels_batched(batch), reps=20)
        labels_plain_ms = cuda_time_ms(lambda: k2.connected_component_labels_plain(batch), reps=3)
        bnd, by = k2.labels_bound_ms(batch)
        log(f"surface split: launches {split_launches}; moved {moved} of {int(occ.sum())} voxels "
            f"to slot 2; pool equal to the CPU's; labels launch equal to the plain version, "
            f"{labels_ms:.4f} ms per call, plain {labels_plain_ms:.4f} ms, bound {bnd:.6f} ms "
            f"({by})")
        rows["split"] = dict(launches=split_launches, moved=moved, labels_ms=labels_ms,
                             labels_plain_ms=labels_plain_ms, bound_ms=bnd, bound_by=by)

    with Phase("surface (d): rasterize(method='chunk') against method='tiled', 480x270, the "
               "bench scene's triangles"):
        c = bench_config(480, 270)
        r = HeadlessRuntime(compile_scene(bench_scene(), c, device=dev), c)
        scene = r.scene()
        cam = r.params.camera
        vp = projection_matrix(cam, 480, 270, None) @ view_matrix(cam)
        clip = project_corners(scene.tri_pos, vp)
        act = scene.tri_active

        def chunk():
            return rasterlib.rasterize(clip, act, 270, 480, method="chunk")[0]

        def tiled():
            return rasterlib.rasterize(clip, act, 270, 480, method="tiled", fit_k=True)[0]

        a, b = chunk(), tiled()
        cover = ((a.depth < 1.0) == (b.depth < 1.0)).float().mean().item()
        both = (a.depth < 1.0) & (b.depth < 1.0)
        derr = (a.depth - b.depth).abs()[both].max().item() if bool(both.any()) else 0.0
        same_id = (a.tri_id == b.tri_id)[both].float().mean().item() if bool(both.any()) else 1.0
        chunk_ms = cuda_time_ms(chunk, reps=2, warmup=1)
        tiled_ms = cuda_time_ms(tiled, reps=5, warmup=1)
        log(f"surface chunk raster at 480x270: {int(act.sum())} active triangles of "
            f"{act.shape[0]}; coverage agrees on {cover:.6f} of pixels, depth within "
            f"{derr:.3g}, same triangle on {same_id:.6f} of covered pixels; chunk "
            f"{chunk_ms:.2f} ms, tiled {tiled_ms:.2f} ms")
        if cover <= 0.99 or derr > 2e-3 or not bool(both.any()):
            raise AssertionError(f"chunk vs tiled raster: coverage {cover}, depth err {derr}")
        rows["chunk_raster"] = dict(coverage_agree=cover, depth_err=derr, same_id=same_id,
                                    chunk_ms=chunk_ms, tiled_ms=tiled_ms,
                                    triangles=int(act.sum()))

    with Phase("surface (e): the vertex materials after a remesh, identity, is_kinematic, "
               "the registry and the records built positionally, on the card"):
        rows["members"] = surface_members_check(dev)

    for name, k1 in k1_rows.items():
        entry = next((k for k in kernels if k["name"] == name), None)
        if entry is not None:
            entry["surface_launches"] = k1_launches[name]
            continue
        n = len(k1)
        kernels.append(dict(
            name=name, route="cuda", source="impact_tpu_torch/csrc/raster.cu",
            replaces="impact_tpu/render/raster_pallas.py:781", launches=k1_launches[name],
            max_abs_err=held["max_abs_err"], ms=sum(x["ms"] for x in k1) / n,
            plain_ms=sum(x["plain_ms"] for x in k1) / n,
            bound_ms=sum(x["bound_ms"] for x in k1) / n, bound_by=k1[0]["bound_by"],
            library_ms=None))
    entry = next((k for k in kernels if k["name"] == "k2_labels"), None)
    if entry is not None:
        entry["surface_launches"] = split_launches["k2_labels"]
    else:
        kernels.append(dict(
            name="k2_labels", route="cuda", source="impact_tpu_torch/csrc/ccl.cu",
            replaces="impact_tpu/ops/ccl_pallas.py:45", launches=split_launches["k2_labels"],
            max_abs_err=0.0, ms=labels_ms, plain_ms=labels_plain_ms, bound_ms=bnd, bound_by=by,
            library_ms=None))
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"surface phase: {rows['phase_s']:.2f} s")


def reference_field_order(path, name):
    """The fields of class ``name`` in the JAX package's ``path``, in their
    declared order, read from its source text (nothing of it is imported)."""
    import ast

    with open(os.path.join(HERE, "impact_tpu", path)) as f:
        tree = ast.parse(f.read())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == name)
    return [s.target.id for s in cls.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]


def surface_members_check(dev):
    """Check (e) of the surface phase; returns its numbers."""
    import dataclasses

    import torch

    from impact_tpu_torch.math.transform import Isometry, Similarity
    from impact_tpu_torch.models import voxel_box_tumbler
    from impact_tpu_torch.physics.state import KIND_KINEMATIC
    from impact_tpu_torch.render.pipeline import RenderConfig
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.runtime.engine import EngineParams, make_engine_step
    from impact_tpu_torch.utils.config import EngineConfig, PhysicsConfig, TpuConfig
    from impact_tpu_torch.voxel.encoding import sdf_world
    from impact_tpu_torch.voxel.mesh import SurfaceNetsMesh, compact_mesh, surface_nets

    cfg = EngineConfig()
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 4, 8, 64, 16
    rt = HeadlessRuntime(compile_scene(voxel_box_tumbler(n_boxes=2, seed=0), cfg, device=dev),
                         cfg)
    v = rt.sim.voxels
    gen = torch.Generator(device="cpu").manual_seed(7)
    vtype = torch.randint(0, 3, tuple(v.vtype.shape), generator=gen, dtype=torch.int32)
    rt.sim = rt.sim._replace(voxels=v._replace(vtype=vtype.to(dev), mesh_dirty=v.alive.clone()))
    rt.step(1)
    v = rt.sim.voxels
    idx = torch.nonzero(v.alive).flatten()
    if idx.numel() != 2 or bool(v.mesh_dirty.any()):
        raise AssertionError(f"the remesh did not run: alive {idx.tolist()}, dirty "
                             f"{v.mesh_dirty.tolist()}")
    caps = rt.info["mesh_vert_cap"], rt.info["mesh_tri_cap"]
    sn = surface_nets(sdf_world(v.sdf[idx], v.voxel_extent[idx]), v.vtype[idx],
                      t.mesh_merge_levels)
    card = compact_mesh(sn, *caps)
    cpu = compact_mesh(SurfaceNetsMesh(*(f.cpu() for f in sn)), *caps)
    for f in ("vert_type", "vert_type2", "vert_blend"):
        got = getattr(rt.sim.meshes, f)[idx]
        if got.device.type != "cuda" or not torch.equal(got, getattr(card, f)) \
                or not torch.equal(got.cpu(), getattr(cpu, f)):
            raise AssertionError(f"sim.meshes.{f} after the remesh differs from compact_mesh's")
    active = rt.sim.meshes.vert_active[idx]
    n_blended = int((rt.sim.meshes.vert_blend[idx][active] > 0).sum())
    if n_blended == 0:
        raise AssertionError("no two-material vertex after the remesh")
    log(f"surface members: sim.meshes.vert_type, vert_type2, vert_blend after the remesh of "
        f"{idx.numel()} objects equal the card's and the CPU's compact_mesh "
        f"({int(active.sum())} active vertices, {n_blended} of them two-material)")

    for cls in (Isometry, Similarity):
        got = cls.identity((3,), device=dev)
        want = cls.identity((3,), device="cpu")
        if any(a.device.type != "cuda" or not torch.equal(a.cpu(), b)
               for a, b in zip(got, want)):
            raise AssertionError(f"{cls.__name__}.identity on the card")
    bodies = rt.sim.phys.bodies._replace(kind=torch.tensor([0, 1, 2, 2, 1, 0, 0, 0],
                                                           dtype=torch.int32, device=dev))
    kin = bodies.is_kinematic
    if kin.device.type != "cuda" or kin.tolist() != [k == KIND_KINEMATIC
                                                      for k in bodies.kind.tolist()]:
        raise AssertionError(f"is_kinematic on the card: {kin.tolist()}")
    reg = rt.registry
    if reg.n_types != 3 or reg.mass_density.device.type != "cuda" \
            or rt.textures is not None:
        raise AssertionError(f"HeadlessRuntime.registry: {reg.n_types} types on "
                             f"{reg.mass_density.device}")
    log(f"surface members: Isometry.identity and Similarity.identity on the card equal the "
        f"CPU's; is_kinematic {kin.tolist()} on the card; HeadlessRuntime.registry the default "
        f"{reg.n_types} types ({', '.join(reg.names)}) on {reg.mass_density.device}")

    # each record built positionally from distinct marks in the field order
    # that the JAX package's source declares: a port field out of that
    # order takes another field's mark
    records = {}
    for cls, src in ((RenderConfig, "render/pipeline.py"), (EngineParams, "runtime/engine.py"),
                     (PhysicsConfig, "utils/config.py"), (TpuConfig, "utils/config.py")):
        order = reference_field_order(src, cls.__name__)
        built = cls(*order)
        records[cls.__name__] = len(order)
        wrong = [n for n in order if getattr(built, n) != n]
        if wrong or len(order) != len(getattr(cls, "_fields", None)
                                        or dataclasses.fields(cls)):
            raise AssertionError(f"{cls.__name__} built positionally in the reference's order "
                                 f"misplaces {wrong}")
    params = EngineParams(*(getattr(rt.params, n)
                            for n in reference_field_order("runtime/engine.py", "EngineParams")))
    step = make_engine_step(params, cfg, *caps)
    stepped = step(rt.sim)
    if not body_state_finite(stepped):
        raise AssertionError("the step of the positionally built EngineParams is not finite")
    log(f"surface members: {', '.join(f'{k} ({n} fields)' for k, n in records.items())} built "
        f"positionally in the JAX package's declared order put every value in its field; "
        f"the engine step of EngineParams so built from the runtime's values stays finite")
    return dict(n_blended=n_blended, active_vertices=int(active.sum()))


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
