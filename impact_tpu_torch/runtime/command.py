"""Engine commands: the port of ``impact_tpu/runtime/command.py`` (ref:
engine/src/command.rs:30-81 — user and admin commands flow through
per-category queues drained each frame; the dev UI and the snapshot tester
drive the engine through them).

Commands are plain records enqueued from the host and drained by the
runtime before a step. A rendering command re-derives the render
configuration (``HeadlessRuntime.invalidate_render``), a physics command
rebuilds the engine step (``invalidate_step``). The gizmo category raises
NotImplementedError until the gizmos are ported (ROADMAP.md Queue 1.2).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

from ..utils.ron import Variant


@dataclass
class Command:
    """A single command: ``category`` routes it, ``action`` names it."""

    category: str  # rendering | physics | game_loop | system | gizmo
    action: str
    value: Any = None


class CommandQueue:
    """Per-category FIFO queues (ref: command.rs per-category queues)."""

    def __init__(self):
        self._queues: dict[str, deque[Command]] = {}

    def enqueue(self, command: Command):
        self._queues.setdefault(command.category, deque()).append(command)

    def drain(self):
        for cat in list(self._queues):
            q = self._queues[cat]
            while q:
                yield q.popleft()


def execute_commands(runtime, queue: CommandQueue):
    """Drain and apply all queued commands to a HeadlessRuntime.

    The actions are the reference's admin command set (command/rendering.rs,
    command/physics.rs, command/game_loop.rs):
      rendering: set_ao_enabled, set_taa_enabled, set_bloom_enabled,
                 set_shadow_mapping_enabled, set_tone_mapping,
                 set_exposure_compensation
      physics:   set_n_iterations, set_positional_correction_iterations,
                 set_old_impulse_weight, set_simulation_speed,
                 set_enabled (solver)
      game_loop: pause, resume
      system:    reset_world
    An unknown action or category raises ValueError, as the reference's do.
    """
    cfg = runtime.config
    render_dirty = False
    step_dirty = False
    for cmd in queue.drain():
        c, a, v = cmd.category, cmd.action, cmd.value
        if c == "rendering":
            r = cfg.rendering
            if a == "set_ao_enabled":
                r.ambient_occlusion.enabled = bool(v)
            elif a == "set_taa_enabled":
                r.temporal_anti_aliasing.enabled = bool(v)
            elif a == "set_bloom_enabled":
                r.capturing_camera.bloom.enabled = bool(v)
            elif a == "set_shadow_mapping_enabled":
                r.shadow_mapping.enabled = bool(v)
            elif a == "set_tone_mapping":
                r.capturing_camera.dynamic_range_compression.tone_mapping_method = str(v)
            elif a == "set_exposure_compensation":
                r.capturing_camera.settings.sensitivity = Variant(
                    "Auto", fields={"ev_compensation": float(v)})
            else:
                raise ValueError(f"unknown rendering command {a!r}")
            render_dirty = True
        elif c == "physics":
            p = cfg.physics
            if a == "set_n_iterations":
                p.constraint_solver.n_iterations = int(v)
            elif a == "set_positional_correction_iterations":
                p.constraint_solver.n_positional_correction_iterations = int(v)
            elif a == "set_old_impulse_weight":
                p.constraint_solver.old_impulse_weight = float(v)
            elif a == "set_enabled":
                p.constraint_solver.enabled = bool(v)
            elif a == "set_simulation_speed":
                p.simulator.initial_time_step_duration = float(v)
            else:
                raise ValueError(f"unknown physics command {a!r}")
            step_dirty = True
        elif c == "game_loop":
            if a == "pause":
                runtime.paused = True
            elif a == "resume":
                runtime.paused = False
            else:
                raise ValueError(f"unknown game_loop command {a!r}")
        elif c == "gizmo":
            raise NotImplementedError(
                "gizmo commands wait for the gizmos (ROADMAP.md Queue 1.2)")
        elif c == "system":
            if a == "reset_world":
                runtime.reset_world()
            else:
                raise ValueError(f"unknown system command {a!r}")
        else:
            raise ValueError(f"unknown command category {c!r}")
    if render_dirty:
        runtime.invalidate_render()
    if step_dirty:
        runtime.invalidate_step()
