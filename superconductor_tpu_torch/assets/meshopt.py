"""EXT_meshopt_compression (vertex/index codecs + filters): the port's
copy of ``superconductor_tpu/assets/meshopt.py``. It decodes through the
scnative C++ decoder (``native/src/meshopt.cpp``) only: the port always
has the library, or raises, so the reference's pure-Python decoders are
not copied. The encoders are, byte for byte: they author fixtures and
round-trip the decoder.

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


VERTEX_HEADER = 0xA0
INDEX_HEADER = 0xE0
BYTE_GROUP_SIZE = 16
BLOCK_SIZE_BYTES = 8192
BLOCK_MAX_VERTICES = 256


def _block_size(stride: int) -> int:
    result = (BLOCK_SIZE_BYTES // stride) & ~(BYTE_GROUP_SIZE - 1)
    return min(max(result, BYTE_GROUP_SIZE), BLOCK_MAX_VERTICES)


def _zigzag8(v):
    v = v & 0xFF
    return ((v << 1) ^ (0xFF if v & 0x80 else 0)) & 0xFF


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


def encode_vertex_buffer(vertices: np.ndarray) -> bytes:
    """Independent encoder for round-trip testing (always uses the widest
    group encoding that fits; not size-optimal, format-conformant)."""
    count, stride = vertices.shape
    v = vertices.astype(np.uint8)
    out = bytearray([VERTEX_HEADER | 0])
    block = _block_size(stride)
    # The tail carries the seed vertex the decoder starts from; encode
    # deltas relative to it (we seed with vertex 0, like meshoptimizer).
    seed = v[0].copy() if count else np.zeros(stride, np.uint8)
    last = seed.astype(np.int32).copy()
    offset = 0
    while offset < count:
        n = min(count - offset, block)
        rounded = (n + 15) & ~15
        for k in range(stride):
            deltas = np.zeros(rounded, np.uint8)
            p = int(last[k])
            for i in range(n):
                cur = int(v[offset + i, k])
                deltas[i] = _zigzag8(cur - p)
                p = cur
            last[k] = int(v[offset + n - 1, k])
            # encode groups
            ngroups = rounded // 16
            header = bytearray((ngroups + 3) // 4)
            payload = bytearray()
            for g in range(ngroups):
                grp = deltas[g * 16 : g * 16 + 16]
                if not grp.any():
                    sel = 0
                elif grp.max() < 15:
                    sel = 2
                    b = bytearray()
                    for j in range(0, 16, 2):
                        b.append((int(grp[j]) << 4) | int(grp[j + 1]))
                    payload += b
                else:
                    sel = 3
                    payload += grp.tobytes()
                header[g // 4] |= sel << ((g % 4) * 2)
            out += header + payload
        offset += n
    out += bytes(max(stride, 32) - stride)  # tail padding to tail_size
    out += seed.tobytes()
    return bytes(out)


def _encode_vbyte(v: int) -> bytes:
    out = bytearray()
    while True:
        if v < 0x80:
            out.append(v)
            return bytes(out)
        out.append((v & 0x7F) | 0x80)
        v >>= 7


SEQUENCE_HEADER = 0xD0


def encode_index_sequence(indices: np.ndarray) -> bytes:
    """Conformant index sequence encoder (baseline picked by smaller
    absolute delta; 4-byte zero tail like meshoptimizer's)."""
    out = bytearray([SEQUENCE_HEADER | 1])
    last = [0, 0]
    for idx in np.asarray(indices, np.uint32).reshape(-1):
        idx = int(idx)
        d0, d1 = idx - last[0], idx - last[1]
        current = 0 if abs(d0) <= abs(d1) else 1
        d = idx - last[current]
        zz = (d << 1) if d >= 0 else ((-d << 1) - 1)
        out += _encode_vbyte((zz << 1) | current)
        last[current] = idx
    out += b"\0" * 4
    return bytes(out)


def encode_index_buffer(indices: np.ndarray) -> bytes:
    """Trivial conformant encoder: every triangle uses the 0xff escape with
    explicit indices (large output, exercises the explicit-decode path)."""
    indices = np.asarray(indices, np.uint32).reshape(-1)
    ntri = len(indices) // 3
    code = bytearray()
    aux = bytearray()
    last = 0
    for t in range(ntri):
        code.append(0xFF)
        aux.append(0xFF)  # feb=15, fec=15: all explicit
        for k in range(3):
            v = int(indices[t * 3 + k])
            d = v - last
            aux += _encode_vbyte(((d << 1) ^ (d >> 63)) & 0xFFFFFFFF if d < 0 else (d << 1))
            last = v
    out = bytearray([INDEX_HEADER | 1])
    out += code
    out += aux
    out += bytes(16)  # codeaux table (unused by this encoder)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


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
