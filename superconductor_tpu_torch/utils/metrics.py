"""Image quality metrics (the port's copy of
``superconductor_tpu/utils/metrics.py``; PSNR gate from BASELINE.json:
>= 35 dB)."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_value: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_value * max_value / mse))
