"""ASTC LDR decode through the C++ scnative library (no GL fallback in the port).

Also the UASTC decode path: UASTC blocks (KHR_texture_basisu) are valid
ASTC 4x4 blocks, so the same decoder transcodes them to RGBA — the role
basis-universal plays in the reference (textures.rs:1099-1153)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import load_native


def decode_astc(
    payload: bytes,
    width: int,
    height: int,
    block_w: int = 4,
    block_h: int = 4,
    srgb: bool = False,
) -> np.ndarray:
    """(h, w, 4) uint8 (sRGB-encoded bytes when srgb=True)."""
    lib = load_native()
    bx = (width + block_w - 1) // block_w
    by = (height + block_h - 1) // block_h
    need = bx * by * 16
    if len(payload) < need:
        payload = payload + b"\0" * (need - len(payload))
    out = np.zeros((height, width, 4), np.uint8)
    lib.sc_decode_astc(
        payload,
        ctypes.c_int(width),
        ctypes.c_int(height),
        ctypes.c_int(block_w),
        ctypes.c_int(block_h),
        ctypes.c_int(1 if srgb else 0),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def decode_astc_hdr(
    payload: bytes,
    width: int,
    height: int,
    block_w: int = 4,
    block_h: int = 4,
) -> np.ndarray:
    """(h, w, 4) float32 — ASTC HDR profile decode (LNS endpoints).

    Validated against the
    uncompressed RGBA16F twin of the reference's astc lightvol at ~51 dB
    (the codec's own loss)."""
    lib = load_native()
    bx = (width + block_w - 1) // block_w
    by = (height + block_h - 1) // block_h
    need = bx * by * 16
    if len(payload) < need:
        payload = payload + b"\0" * (need - len(payload))
    out = np.zeros((height, width, 4), np.float32)
    lib.sc_decode_astc_hdr(
        payload,
        ctypes.c_int(width),
        ctypes.c_int(height),
        ctypes.c_int(block_w),
        ctypes.c_int(block_h),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
