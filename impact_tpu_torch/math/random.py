"""Halton jitter sequence for TAA (port of ``impact_tpu/math/random.py``'s
Halton helpers; pure host-side numpy)."""

from __future__ import annotations

import numpy as np


def halton(index: int, base: int) -> float:
    """Halton radical inverse of ``index`` (1-based) in ``base``."""
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton_sequence_2d(n: int, bases=(2, 3), centered: bool = True) -> np.ndarray:
    pts = np.array(
        [[halton(i + 1, bases[0]), halton(i + 1, bases[1])] for i in range(n)],
        dtype=np.float32,
    )
    return pts - 0.5 if centered else pts


TAA_JITTER_COUNT = 32
taa_jitter_offsets = halton_sequence_2d(TAA_JITTER_COUNT)
