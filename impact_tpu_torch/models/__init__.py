from .scenes import (
    SCENES,
    asteroid,
    ball_pit,
    blank,
    drag_drop,
    fracturing,
    free_rotation,
    harmonic_oscillation,
    rendering_test,
    voxel_box_tumbler,
)

__all__ = ["SCENES", "asteroid", "ball_pit", "blank", "drag_drop", "fracturing",
           "free_rotation", "harmonic_oscillation", "rendering_test", "voxel_box_tumbler"]
