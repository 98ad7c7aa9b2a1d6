"""PyTorch/CUDA port of impact_tpu for one NVIDIA H100.

The JAX package ``impact_tpu`` stays the reference; this package mirrors its
module names and is held against it by the tests (same inputs through both,
compared with stated tolerances). It imports ``torch`` and never ``jax`` or
``impact_tpu``: host-side helpers it needs are kept as its own copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. The
one hand-written kernel of this slice, the tile rasterizer K1
(``csrc/raster.cu``), is built with ``nvcc`` at first use (``_build.py``) and
called through ``render/raster_pallas.py``; on CPU tensors its wrappers run
the kernel's plain PyTorch version instead.
"""
