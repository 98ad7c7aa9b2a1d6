from .scenes import voxel_box_tumbler

__all__ = ["voxel_box_tumbler"]
