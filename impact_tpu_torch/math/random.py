"""Halton jitter sequence for TAA (port of ``impact_tpu/math/random.py``'s
Halton helpers; pure host-side numpy)."""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


def splitmix64_next(state: int) -> tuple[int, int]:
    """One splitmix64 step → (new_state, output), on the host."""
    state = (state + 0x9E3779B97F4A7C15) & MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return state, (z ^ (z >> 31)) & MASK64


def splitmix64_sequence(seed: int, n: int) -> np.ndarray:
    """n splitmix64 outputs as uint64."""
    out = np.empty(n, dtype=np.uint64)
    state = seed & MASK64
    for i in range(n):
        state, out[i] = splitmix64_next(state)
    return out


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
