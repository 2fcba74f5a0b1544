"""EXT_meshopt_compression decode (vertex/index codecs + filters): the
port's copy of ``superconductor_tpu/assets/meshopt.py``, decoding through
the scnative C++ decoder (``native/src/meshopt.cpp``) only. The
reference's numpy decoders and encoders (its test-support round trip) are
not copied: the port always has the library, or raises.

Codec notes (meshopt format):
  * vertex codec v0: byte-plane delta encoding in blocks of up to 256
    vertices, 16-value groups with a 2-bit width selector.
  * index codec v1 (TRIANGLES): edge/vertex FIFO prediction.
  * index sequence codec (INDICES): one vbyte per index against two
    running baselines.
  * filters: octahedral (normals), quaternion, exponential -- applied after
    decode per EXT_meshopt_compression, in numpy below.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load_native


def _filter_octahedral(data: np.ndarray, stride: int) -> np.ndarray:
    comp = data.view(np.int8 if stride == 4 else np.int16).reshape(-1, 4 if stride == 4 else 4)
    maxv = 127.0 if stride == 4 else 32767.0
    x = comp[:, 0].astype(np.float32)
    y = comp[:, 1].astype(np.float32)
    one = np.abs(comp[:, 2]).astype(np.float32)
    x /= one
    y /= one
    z = 1.0 - np.abs(x) - np.abs(y)
    t = np.maximum(-z, 0.0)
    x -= np.sign(x) * t
    y -= np.sign(y) * t
    n = np.stack([x, y, z], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    out = np.round(n * maxv).astype(np.int16 if stride == 8 else np.int8)
    w = comp[:, 3]
    if stride == 4:
        return np.concatenate([out.astype(np.int8), w[:, None].astype(np.int8)], axis=1).view(np.uint8)
    return np.concatenate([out.astype(np.int16), w[:, None].astype(np.int16)], axis=1).view(np.uint8).reshape(-1, 8)


def _filter_quaternion(data: np.ndarray) -> np.ndarray:
    comp = data.view(np.int16).reshape(-1, 4)
    out = np.zeros_like(comp)
    scale = 1.0 / np.sqrt(2.0)
    ifl = (comp[:, 3] & 3).astype(np.int64)
    bits = (comp[:, 3].astype(np.int64) | 3) >> 2  # remaining range
    q = comp[:, :3].astype(np.float32) / (np.maximum(bits, 1)[:, None].astype(np.float32)) * scale
    rest = np.sqrt(np.maximum(0.0, 1.0 - np.sum(q * q, axis=-1)))
    full = np.zeros((len(comp), 4), np.float32)
    for i in range(len(comp)):
        k = ifl[i]
        order = [(k + 1) % 4, (k + 2) % 4, (k + 3) % 4]
        full[i, order[0]] = q[i, 0]
        full[i, order[1]] = q[i, 1]
        full[i, order[2]] = q[i, 2]
        full[i, k] = rest[i]
    out = np.round(full * 32767.0).astype(np.int16)
    return out.view(np.uint8).reshape(-1, 8)


def _filter_exponential(data: np.ndarray) -> np.ndarray:
    comp = data.view(np.uint32).reshape(-1)
    e = (comp >> 24).astype(np.int32)
    e = np.where(e > 127, e - 256, e)
    m = (comp & 0xFFFFFF).astype(np.int32)
    m = np.where(m >= 0x800000, m - 0x1000000, m)
    out = (m.astype(np.float64) * np.exp2(e.astype(np.float64))).astype(np.float32)
    return out.view(np.uint8).reshape(data.shape[0], -1) if data.ndim > 1 else out.view(np.uint8)


def decode_buffer_view(
    data: bytes, mode: int, count: int, stride: int, filter: str = "NONE"
) -> np.ndarray:
    """EXT_meshopt_compression bufferView decode -> flat uint8 array.

    mode: 0/'ATTRIBUTES', 1/'TRIANGLES', 2/'INDICES'.
    """
    lib = load_native()
    mode_names = {0: "ATTRIBUTES", 1: "TRIANGLES", 2: "INDICES"}
    if isinstance(mode, int):
        mode = mode_names[mode]
    if mode == "ATTRIBUTES":
        out = np.zeros((count, stride), np.uint8)
        rc = lib.sc_meshopt_decode_vertex(
            data, len(data), count, stride, out.ctypes.data_as(ctypes.c_void_p)
        )
        if rc != 0:
            raise ValueError(f"meshopt vertex decode failed ({rc})")
        if filter and filter != "NONE":
            if filter == "OCTAHEDRAL":
                out = _filter_octahedral(out, stride).reshape(count, stride)
            elif filter == "QUATERNION":
                out = _filter_quaternion(out).reshape(count, stride)
            elif filter == "EXPONENTIAL":
                out = _filter_exponential(out).reshape(count, stride)
        return out.reshape(-1).copy()
    if mode in ("TRIANGLES", "INDICES"):
        idx = np.zeros(count, np.uint32)
        if mode == "TRIANGLES":
            rc = lib.sc_meshopt_decode_index(
                data, len(data), count, idx.ctypes.data_as(ctypes.c_void_p)
            )
        else:
            rc = lib.sc_meshopt_decode_index_sequence(
                data, ctypes.c_int(len(data)), ctypes.c_int(count),
                idx.ctypes.data_as(ctypes.c_void_p),
            )
        if rc != 0:
            raise ValueError(f"meshopt {mode.lower()} decode failed ({rc})")
        if stride == 2:
            return idx.astype(np.uint16).view(np.uint8)
        return idx.astype(np.uint32).view(np.uint8)
    raise ValueError(f"unknown meshopt mode {mode}")
