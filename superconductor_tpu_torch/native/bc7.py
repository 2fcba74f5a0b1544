"""BC7 decode through the C++ scnative library (no GL fallback in the port)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import load_native


def decode_bc7(payload: bytes, width: int, height: int) -> np.ndarray:
    """(h, w, 4) uint8."""
    lib = load_native()
    bw = (width + 3) // 4
    bh = (height + 3) // 4
    need = bw * bh * 16
    if len(payload) < need:
        payload = payload + b"\0" * (need - len(payload))
    out = np.zeros((height, width, 4), np.uint8)
    lib.sc_decode_bc7(
        payload,
        ctypes.c_int(width),
        ctypes.c_int(height),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
