"""PyTorch/CUDA port of impact_tpu for one NVIDIA H100.

The JAX package ``impact_tpu`` stays the reference; this package mirrors its
module names and is held against it by the tests (same inputs through both,
compared with stated tolerances). It imports ``torch`` and never ``jax`` or
``impact_tpu``: host-side helpers it needs are kept as its own copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. The
hand-written kernels — the tile rasterizer K1 (``csrc/raster.cu``, called
through ``render/raster_pallas.py``), the connected-component labeller K2
and K2-wide (``csrc/ccl.cu``, called through ``ops/ccl_pallas.py``), and
K1's two probes P1 and P2 (``csrc/probe_floor.cu``,
``csrc/probe_ablate.cu``, called through ``devtools/``) — are built with
one ``nvcc`` call at first use (``_build.py``); on CPU tensors their
wrappers run the kernels' plain PyTorch versions instead.
"""
