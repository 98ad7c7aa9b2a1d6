"""Image comparison (port of ``impact_tpu/utils/image.py:rgb_hybrid_compare``:
per-channel global SSIM blended with mean RGB proximity)."""

from __future__ import annotations

import numpy as np


def _ssim_gray(a, b):
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)
    )


def rgb_hybrid_compare(a_u8, b_u8) -> float:
    """Similarity score in [0,1]; 1 = identical."""
    a = np.asarray(a_u8, np.float32) / 255.0
    b = np.asarray(b_u8, np.float32) / 255.0
    if a.shape != b.shape:
        return 0.0
    ssim = float(np.mean([_ssim_gray(a[..., c], b[..., c]) for c in range(3)]))
    rms = float(np.sqrt(np.mean((a - b) ** 2)))
    return max(0.0, min(1.0, 0.5 * (ssim + (1.0 - rms))))
