from .scenes import (
    SCENES,
    asteroid,
    ball_pit,
    blank,
    fracturing,
    rendering_test,
    voxel_box_tumbler,
)

__all__ = ["SCENES", "asteroid", "ball_pit", "blank", "fracturing", "rendering_test",
           "voxel_box_tumbler"]
