"""Motion and orientation controllers (port of
``impact_tpu/scene/controller.py``; ref: impact_controller: the
semi-directional ``MotionController`` of motion.rs, the roll-free camera
``OrientationController`` of orientation.rs, and the systems.rs systems
that write the controlled entity's velocities into its rigid body).

Controller state lives on the host (it consumes input events); its
output, a (velocity, orientation) pair, is written into the controlled
body's slot before a step: one small update of the state on its device.
The quaternion arithmetic runs in float32 on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..math import quaternion as quat

DIRECTIONS = ("forward", "backward", "left", "right", "up", "down")


@dataclass
class MotionController:
    """Semi-directional movement (ref: motion.rs SemiDirectional)."""

    movement_speed: float = 8.0
    vertical_control: bool = True
    _active: set = field(default_factory=set)

    def set_direction(self, direction: str, active: bool):
        if direction not in DIRECTIONS:
            raise ValueError(f"unknown direction {direction!r}")
        if active:
            self._active.add(direction)
        else:
            self._active.discard(direction)

    def stop(self):
        self._active.clear()

    def local_velocity(self) -> np.ndarray:
        """Movement velocity in the controlled entity's local frame (camera
        convention: −z forward, +x right, +y up)."""
        v = np.zeros(3, np.float32)
        if "forward" in self._active:
            v[2] -= 1.0
        if "backward" in self._active:
            v[2] += 1.0
        if "left" in self._active:
            v[0] -= 1.0
        if "right" in self._active:
            v[0] += 1.0
        if self.vertical_control:
            if "up" in self._active:
                v[1] += 1.0
            if "down" in self._active:
                v[1] -= 1.0
        n = np.linalg.norm(v)
        if n > 0:
            v = v / n * self.movement_speed
        return v

    def world_velocity(self, orientation_xyzw) -> np.ndarray:
        q = torch.as_tensor(np.asarray(orientation_xyzw, np.float32))
        return quat.rotate(q, torch.from_numpy(self.local_velocity())).numpy()


@dataclass
class RollFreeCameraOrientationController:
    """Yaw and pitch without roll (ref: orientation.rs RollFreeCamera)."""

    sensitivity: float = 1.0
    yaw: float = 0.0  # radians about world +y
    pitch: float = 0.0  # radians about local +x, clamped

    def update(self, dx: float, dy: float):
        """Apply a mouse delta (radians before the sensitivity)."""
        self.yaw -= dx * self.sensitivity
        self.pitch = float(np.clip(self.pitch - dy * self.sensitivity, -0.49 * np.pi,
                                   0.49 * np.pi))

    def orientation(self) -> np.ndarray:
        def about(axis, angle):
            return quat.from_axis_angle(torch.tensor(axis, dtype=torch.float32),
                                        torch.tensor(angle, dtype=torch.float32))

        return quat.mul(about([0.0, 1.0, 0.0], self.yaw), about([1.0, 0.0, 0.0], self.pitch)).numpy()


@dataclass
class EntityController:
    """Binds the controllers to a body slot and writes their output into the
    state (ref: impact_controller systems.rs writing velocities into rigid
    bodies)."""

    body_index: int
    motion: MotionController = field(default_factory=MotionController)
    orientation: RollFreeCameraOrientationController = field(
        default_factory=RollFreeCameraOrientationController)

    def apply(self, sim):
        """The state with the controlled body's orientation and velocity set
        (for kinematic bodies), written on the state's own device."""
        b = sim.phys.bodies
        q = self.orientation.orientation()
        v = self.motion.world_velocity(q)
        dev = b.orientation.device
        orientation = b.orientation.clone()
        velocity = b.velocity.clone()
        orientation[self.body_index] = torch.as_tensor(q, device=dev)
        velocity[self.body_index] = torch.as_tensor(v, device=dev)
        b = b._replace(orientation=orientation, velocity=velocity)
        return sim._replace(phys=sim.phys._replace(bodies=b))
