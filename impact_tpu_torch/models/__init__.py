from .scenes import asteroid, fracturing, voxel_box_tumbler

__all__ = ["asteroid", "fracturing", "voxel_box_tumbler"]
