"""The hand-written kernels' wrappers and their plain PyTorch versions (port
of ``impact_tpu/ops``): ``ccl_pallas`` holds the labels and sweep kernels of
``csrc/ccl.cu`` that replace the reference's Pallas labelling kernel."""

from . import ccl_pallas

__all__ = ["ccl_pallas"]
