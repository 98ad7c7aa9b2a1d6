from .scenes import fracturing, voxel_box_tumbler

__all__ = ["fracturing", "voxel_box_tumbler"]
