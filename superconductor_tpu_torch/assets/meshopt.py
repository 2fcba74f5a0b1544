"""EXT_meshopt_compression (vertex/index codecs + filters): the port's
copy of ``superconductor_tpu/assets/meshopt.py``. ``decode_buffer_view``
(the glTF loader's path) decodes through the scnative C++ decoder
(``native/src/meshopt.cpp``): the port always has the library, or raises.
The reference's pure-Python decoders (``decode_vertex_buffer``,
``decode_index_buffer``, ``decode_index_sequence``) and its encoders are
copied byte for byte: the encoders author fixtures, and both round-trip
the native decoder.

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
SEQUENCE_HEADER = 0xD0
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
# Pure-Python decoders (the reference's, byte for byte): a reference for the
# native decoder and a decode of a single buffer without the library
# ---------------------------------------------------------------------------


def _unzigzag8(v):
    return ((v >> 1) ^ (-(v & 1))) & 0xFF


def _decode_bytes_group(data: bytes, pos: int, sel: int):
    out = np.zeros(16, np.uint8)
    if sel == 0:
        return out, pos
    if sel == 1:  # 2-bit packed, sentinel 3 -> full byte
        packed = data[pos : pos + 4]
        pos += 4
        for j in range(16):
            v = (packed[j // 4] >> (6 - 2 * (j % 4))) & 3
            if v == 3:
                v = data[pos]
                pos += 1
            out[j] = v
        return out, pos
    if sel == 2:  # 4-bit packed, sentinel 15 -> full byte
        packed = data[pos : pos + 8]
        pos += 8
        for j in range(16):
            v = (packed[j // 2] >> (4 - 4 * (j % 2))) & 15
            if v == 15:
                v = data[pos]
                pos += 1
            out[j] = v
        return out, pos
    out[:] = np.frombuffer(data[pos : pos + 16], np.uint8)
    return out, pos + 16


def _decode_bytes(data: bytes, pos: int, size: int):
    assert size % BYTE_GROUP_SIZE == 0
    ngroups = size // BYTE_GROUP_SIZE
    header_size = (ngroups + 3) // 4
    header = data[pos : pos + header_size]
    pos += header_size
    out = np.zeros(size, np.uint8)
    for g in range(ngroups):
        sel = (header[g // 4] >> ((g % 4) * 2)) & 3
        group, pos = _decode_bytes_group(data, pos, sel)
        out[g * 16 : g * 16 + 16] = group
    return out, pos


def decode_vertex_buffer(data: bytes, count: int, stride: int) -> np.ndarray:
    """-> (count, stride) uint8."""
    if not data or (data[0] & 0xF0) != VERTEX_HEADER:
        raise ValueError("bad vertex codec header")
    version = data[0] & 0x0F
    if version != 0:
        raise ValueError(f"unsupported vertex codec version {version}")
    last = np.frombuffer(data[len(data) - stride :], np.uint8).astype(np.int32).copy()
    out = np.zeros((count, stride), np.uint8)
    pos = 1
    block = _block_size(stride)
    offset = 0
    while offset < count:
        n = min(count - offset, block)
        rounded = (n + 15) & ~15
        for k in range(stride):
            deltas, pos = _decode_bytes(data, pos, rounded)
            vals = np.zeros(n, np.int32)
            p = int(last[k])
            for i in range(n):
                p = (p + _unzigzag8(int(deltas[i]))) & 0xFF
                vals[i] = p
            out[offset : offset + n, k] = vals
            last[k] = vals[-1]
        offset += n
    return out


def _decode_vbyte(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            break
    return result, pos


def decode_index_buffer(data: bytes, index_count: int) -> np.ndarray:
    """-> (index_count,) uint32 (triangle list)."""
    if not data or (data[0] & 0xF0) != INDEX_HEADER:
        raise ValueError("bad index codec header")
    version = data[0] & 0x0F
    if version > 1:
        raise ValueError(f"unsupported index codec version {version}")
    fecmax = 13 if version >= 1 else 15

    ntri = index_count // 3
    code = data[1 : 1 + ntri]
    pos = 1 + ntri  # aux data stream
    codeaux = data[len(data) - 16 :]

    out = np.zeros(index_count, np.uint32)
    edgefifo = [(0, 0)] * 16
    vertexfifo = [0] * 16
    eoff = 0
    voff = 0
    next_v = 0
    last = 0

    def push_edge(a, b):
        nonlocal eoff
        edgefifo[eoff & 15] = (a, b)
        eoff += 1

    def push_vertex(v, cond=True):
        nonlocal voff
        if cond:
            vertexfifo[voff & 15] = v
            voff += 1

    def decode_index(p, last):
        v, p = _decode_vbyte(data, p)
        d = (v >> 1) ^ (-(v & 1))
        return last + d, p

    for t in range(ntri):
        codetri = code[t]
        if codetri < 0xF0:
            fe = codetri >> 4
            a, b = edgefifo[(eoff - 1 - fe) & 15]
            fec = codetri & 15
            if fec < fecmax:
                if fec == 0:
                    c = next_v
                    next_v += 1
                else:
                    c = vertexfifo[(voff - 1 - fec) & 15]
                push_vertex(c, fec == 0)
            else:
                # v1: 13 = last, 14/15 = explicit delta-coded index
                if fec == 13:
                    c = last
                else:
                    c, pos = decode_index(pos, last)
                    last = c
                push_vertex(c)
            push_edge(c, b)
            push_edge(a, c)
        else:
            if codetri < 0xFE:
                cod = codeaux[codetri & 15]
                feb = cod >> 4
                fec = cod & 15
                # a is always a new vertex
                a = next_v
                next_v += 1
                if feb == 0:
                    b = next_v
                    next_v += 1
                else:
                    b = vertexfifo[(voff - feb) & 15]
                if fec == 0:
                    c = next_v
                    next_v += 1
                else:
                    c = vertexfifo[(voff - fec) & 15]
                push_vertex(a)
                push_vertex(b, feb == 0)
                push_vertex(c, fec == 0)
            else:
                # 0xfe / 0xff: explicit codeaux byte from the data stream
                codeaux_b = data[pos]
                pos += 1
                fea = 0 if codetri == 0xFE else 15
                feb = codeaux_b >> 4
                fec = codeaux_b & 15
                if fea == 0:
                    a = next_v
                    next_v += 1
                else:
                    a, pos = decode_index(pos, last)
                    last = a
                if feb == 0:
                    b = next_v
                    next_v += 1
                elif feb < 15:
                    b = vertexfifo[(voff - feb) & 15]
                else:
                    b, pos = decode_index(pos, last)
                    last = b
                if fec == 0:
                    c = next_v
                    next_v += 1
                elif fec < 15:
                    c = vertexfifo[(voff - fec) & 15]
                else:
                    c, pos = decode_index(pos, last)
                    last = c
                push_vertex(a)
                push_vertex(b, feb == 0)
                push_vertex(c, fec == 0)
            push_edge(b, a)
            push_edge(c, b)
            push_edge(a, c)
        out[t * 3 + 0] = a
        out[t * 3 + 1] = b
        out[t * 3 + 2] = c
    return out


def decode_index_sequence(data: bytes, index_count: int) -> np.ndarray:
    """Index SEQUENCE codec (meshopt mode 2, arbitrary topology): per
    index one vbyte v — bit 0 selects one of two running baselines, the
    rest is a zigzag delta applied to (and stored back into) it."""
    if not data or (data[0] & 0xF0) != SEQUENCE_HEADER:
        raise ValueError("bad index sequence header")
    version = data[0] & 0x0F
    if version > 1:
        raise ValueError(f"unsupported index sequence version {version}")
    pos = 1
    last = [0, 0]
    out = np.zeros(index_count, np.uint32)
    for i in range(index_count):
        v, pos = _decode_vbyte(data, pos)
        current = v & 1
        v >>= 1
        d = (v >> 1) ^ (-(v & 1))
        last[current] = (last[current] + d) & 0xFFFFFFFF
        out[i] = last[current]
    return out



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
