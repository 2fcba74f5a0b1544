"""BasisLZ / ETC1S supercompression: the port's copy of
``superconductor_tpu/assets/basislz.py``, decode glue and the ETC1S
encoder (quantizer, codebooks, stream writer and ``write_etc1s_ktx2``),
which authors fixtures and round-trips the decoder.

The reference consumes KHR_texture_basisu textures through the
basis-universal C++ transcoder (renderer-core/Cargo.toml:29,
textures.rs:929-1097, UastcTranscodeTargetFormat textures.rs:1099-1153).
UASTC payloads are handled by the native ASTC decoder (native/astc.py);
this module covers the other basisu mode: ETC1S with BasisLZ
supercompression (KTX2 supercompressionScheme 1).

Split of labor:
  * ``native/src/etc1s.cpp`` decodes the compressed streams (canonical
    Huffman codebooks, delta-coded endpoint/selector palettes, per-slice
    block index streams) into per-block (endpoint, selector) indices.
  * This module parses the KTX2 supercompression global data, drives the
    native decoder, and expands indices to RGBA8 vectorized in numpy.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..native import load_native

# ETC1 intensity modifier tables (Khronos OES_compressed_ETC1_RGB8 spec),
# indexed by basis selector value 0..3 = {-b, -a, +a, +b}.
INTEN_TABLES = np.array(
    [
        [-8, -2, 2, 8],
        [-17, -5, 5, 17],
        [-29, -9, 9, 29],
        [-42, -13, 13, 42],
        [-60, -18, 18, 60],
        [-80, -24, 24, 80],
        [-106, -33, 33, 106],
        [-183, -47, 47, 183],
    ],
    np.int16,
)

# basis selector value -> ETC1 pixel index bits (msb*2 | lsb).
SELECTOR_TO_ETC1 = np.array([3, 2, 0, 1], np.uint8)

SGD_HEADER = struct.Struct("<2H4I")  # endpointCount, selectorCount, 4 lengths
IMAGE_DESC = struct.Struct("<5I")  # flags, rgbOff, rgbLen, alphaOff, alphaLen
IMAGE_FLAG_IFRAME = 0x02  # informational; video (P-frame) decode is n/a here


@dataclass
class BasisLzData:
    """Parsed + palette-decoded supercompression global data."""

    endpoints: np.ndarray  # (N, 4) u8: r5, g5, b5, inten3
    selectors: np.ndarray  # (S, 16) u8 values 0..3, raster y*4+x
    tables: bytes
    image_descs: List[Tuple[int, int, int, int, int]]  # level-major order


class BasisLzError(RuntimeError):
    pass


def parse_global_data(sgd: bytes, num_images: int) -> BasisLzData:
    if len(sgd) < SGD_HEADER.size + num_images * IMAGE_DESC.size:
        raise BasisLzError("BasisLZ global data truncated")
    n_ep, n_sel, ep_len, sel_len, tab_len, ext_len = SGD_HEADER.unpack_from(sgd, 0)
    descs = []
    p = SGD_HEADER.size
    for _ in range(num_images):
        descs.append(IMAGE_DESC.unpack_from(sgd, p))
        p += IMAGE_DESC.size
    ep_data = sgd[p : p + ep_len]
    p += ep_len
    sel_data = sgd[p : p + sel_len]
    p += sel_len
    tables = sgd[p : p + tab_len]
    p += tab_len + ext_len
    if len(ep_data) < ep_len or len(sel_data) < sel_len or len(tables) < tab_len:
        raise BasisLzError("BasisLZ global data blobs truncated")

    lib = load_native()
    endpoints = np.zeros((max(1, n_ep), 4), np.uint8)
    selectors = np.zeros((max(1, n_sel), 16), np.uint8)
    rc = lib.sc_etc1s_decode_palettes(
        ep_data,
        ctypes.c_uint32(len(ep_data)),
        ctypes.c_uint32(n_ep),
        sel_data,
        ctypes.c_uint32(len(sel_data)),
        ctypes.c_uint32(n_sel),
        endpoints.ctypes.data_as(ctypes.c_void_p),
        selectors.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise BasisLzError(f"ETC1S palette decode failed (stage {rc})")
    return BasisLzData(
        endpoints=endpoints[:n_ep],
        selectors=selectors[:n_sel],
        tables=tables,
        image_descs=descs,
    )


def transcode_slice(
    gd: BasisLzData, slice_bytes: bytes, nbx: int, nby: int
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (ep_idx, sel_idx), each (nby, nbx) u32."""
    lib = load_native()
    ep_idx = np.zeros((nby, nbx), np.uint32)
    sel_idx = np.zeros((nby, nbx), np.uint32)
    rc = lib.sc_etc1s_transcode_slice(
        gd.tables,
        ctypes.c_uint32(len(gd.tables)),
        slice_bytes,
        ctypes.c_uint32(len(slice_bytes)),
        ctypes.c_uint32(nbx),
        ctypes.c_uint32(nby),
        ctypes.c_uint32(len(gd.endpoints)),
        ctypes.c_uint32(len(gd.selectors)),
        ep_idx.ctypes.data_as(ctypes.c_void_p),
        sel_idx.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise BasisLzError(f"ETC1S slice transcode failed (stage {rc})")
    return ep_idx, sel_idx


# ----------------------------------------------------------------- expand


def expand_blocks(
    endpoints: np.ndarray,
    selectors: np.ndarray,
    ep_idx: np.ndarray,
    sel_idx: np.ndarray,
) -> np.ndarray:
    """Per-block indices -> (nby*4, nbx*4, 3) u8 pixels, vectorized."""
    nby, nbx = ep_idx.shape
    ep = endpoints[ep_idx.reshape(-1)].astype(np.int16)  # (B, 4)
    base5 = ep[:, :3]
    base8 = (base5 << 3) | (base5 >> 2)
    mods = INTEN_TABLES[ep[:, 3]]  # (B, 4)
    selv = selectors[sel_idx.reshape(-1)]  # (B, 16) values 0..3
    b = np.arange(selv.shape[0])[:, None]
    mod = mods[b, selv]  # (B, 16)
    rgb = np.clip(base8[:, None, :] + mod[:, :, None], 0, 255).astype(np.uint8)
    return (
        rgb.reshape(nby, nbx, 4, 4, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(nby * 4, nbx * 4, 3)
    )


def decode_image_u8(ktx, level: int, image: int = 0) -> np.ndarray:
    """One ETC1S image -> display-encoded (h, w, 4) u8 (alpha slice, when
    present, lands in A via its green channel — basis convention)."""
    gd = _cached_global_data(ktx)
    w, h, _d = ktx.level_dims(level)
    nbx, nby = (w + 3) // 4, (h + 3) // 4
    desc_index = _image_desc_index(ktx, level, image)
    _flags, rgb_off, rgb_len, a_off, a_len = gd.image_descs[desc_index]
    data = ktx.level_bytes(level)
    ep_idx, sel_idx = transcode_slice(gd, data[rgb_off : rgb_off + rgb_len], nbx, nby)
    rgb = expand_blocks(gd.endpoints, gd.selectors, ep_idx, sel_idx)
    out = np.empty((nby * 4, nbx * 4, 4), np.uint8)
    out[..., :3] = rgb
    if a_len:
        aep, asel = transcode_slice(gd, data[a_off : a_off + a_len], nbx, nby)
        out[..., 3] = expand_blocks(gd.endpoints, gd.selectors, aep, asel)[..., 1]
    else:
        out[..., 3] = 255
    return out[:h, :w]


def _cached_global_data(ktx) -> BasisLzData:
    cached = getattr(ktx, "_basislz_cache", None)
    if cached is not None:
        return cached
    if not ktx.sgd:
        raise BasisLzError("ETC1S file has no supercompression global data")
    num_images = 0
    for lvl in range(len(ktx.levels)):
        num_images += _images_in_level(ktx, lvl)
    gd = parse_global_data(ktx.sgd, num_images)
    ktx._basislz_cache = gd
    return gd


def _images_in_level(ktx, level: int) -> int:
    _w, _h, d = ktx.level_dims(level)
    return max(1, ktx.layers) * ktx.faces * d


def _image_desc_index(ktx, level: int, image: int) -> int:
    # imageDescs are level-major, level 0 first (libktx ordering).
    idx = 0
    for lvl in range(level):
        idx += _images_in_level(ktx, lvl)
    return idx + image


# -------------------------------------------------- ETC1 block packing

def pack_etc1_blocks(
    endpoints: np.ndarray,
    selectors: np.ndarray,
    ep_idx: np.ndarray,
    sel_idx: np.ndarray,
) -> bytes:
    """Per-block indices -> raw ETC1 block bytes (differential mode,
    delta 0, flip 0 — the ETC1S restriction). These are valid
    GL_COMPRESSED_RGB8_ETC2 payloads, which is how the block layer is
    validated against Mesa (tests/test_etc1s.py)."""
    B = ep_idx.size
    ep = endpoints[ep_idx.reshape(-1)]
    out = np.zeros((B, 8), np.uint8)
    out[:, 0] = ep[:, 0] << 3
    out[:, 1] = ep[:, 1] << 3
    out[:, 2] = ep[:, 2] << 3
    out[:, 3] = (ep[:, 3] << 5) | (ep[:, 3] << 2) | 0b10  # diff=1, flip=0
    selv = selectors[sel_idx.reshape(-1)]  # (B, 16) raster y*4+x
    etc1_bits = SELECTOR_TO_ETC1[selv]  # msb*2|lsb
    msb = np.zeros(B, np.uint16)
    lsb = np.zeros(B, np.uint16)
    for y in range(4):
        for x in range(4):
            p = x * 4 + y  # ETC1 pixel order is column-major
            v = etc1_bits[:, y * 4 + x].astype(np.uint16)
            msb |= (v >> 1) << p
            lsb |= (v & 1) << p
    out[:, 4] = (msb >> 8).astype(np.uint8)
    out[:, 5] = (msb & 0xFF).astype(np.uint8)
    out[:, 6] = (lsb >> 8).astype(np.uint8)
    out[:, 7] = (lsb & 0xFF).astype(np.uint8)
    return out.tobytes()


# ===================================================================
# Test-support encoder (the counterpart of the decoder above; the same
# role assets/meshopt.py's encode_* functions play for the meshopt codec)
# ===================================================================


class BitWriter:
    def __init__(self):
        self._bits: List[int] = []

    def put_bits(self, v: int, n: int) -> None:
        for i in range(n):
            self._bits.append((v >> i) & 1)

    def put_vlc(self, v: int, chunk_bits: int) -> None:
        while True:
            chunk = v & ((1 << chunk_bits) - 1)
            v >>= chunk_bits
            self.put_bits(chunk | ((1 if v else 0) << chunk_bits), chunk_bits + 1)
            if not v:
                break

    def put_code(self, code: int, length: int) -> None:
        """Huffman code, MSB of the canonical code first."""
        for i in reversed(range(length)):
            self._bits.append((code >> i) & 1)

    def getvalue(self) -> bytes:
        out = bytearray((len(self._bits) + 7) // 8)
        for i, b in enumerate(self._bits):
            if b:
                out[i >> 3] |= 1 << (i & 7)
        return bytes(out)


def _huffman_lengths(freqs: List[int], max_len: int) -> List[int]:
    """Code lengths for the given symbol frequencies, limited to max_len
    (zlib-style overflow adjustment keeps the Kraft sum valid)."""
    import heapq

    syms = [i for i, f in enumerate(freqs) if f > 0]
    lengths = [0] * len(freqs)
    if not syms:
        return lengths
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    heap = [(freqs[s], i, (s,)) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    n = len(heap)
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            lengths[s] += 1
        n += 1
        heapq.heappush(heap, (fa + fb, n, sa + sb))
    over = max(lengths) > max_len
    if over:
        for s in syms:
            lengths[s] = min(lengths[s], max_len)
        # Restore Kraft <= 1 by lengthening the shallowest over-full codes.
        def kraft():
            return sum(2 ** (max_len - lengths[s]) for s in syms)

        budget = 2**max_len
        while kraft() > budget:
            cand = min(
                (s for s in syms if lengths[s] < max_len),
                key=lambda s: lengths[s],
            )
            lengths[cand] += 1
    return lengths


def _canonical_codes(lengths: List[int]) -> List[int]:
    max_l = max(lengths) if lengths else 0
    count = [0] * (max_l + 1)
    for l in lengths:
        if l:
            count[l] += 1
    next_code = [0] * (max_l + 2)
    code = 0
    for l in range(1, max_l + 1):
        next_code[l] = code
        code = (code + count[l]) << 1
    codes = [0] * len(lengths)
    for s, l in enumerate(lengths):
        if l:
            codes[s] = next_code[l]
            next_code[l] += 1
    return codes


_SORTED_CODELENGTH_CODES = [17, 18, 19, 20, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15, 16]


class HuffEncoder:
    def __init__(self, freqs: List[int], max_len: int = 16):
        self.lengths = _huffman_lengths(freqs, max_len)
        self.codes = _canonical_codes(self.lengths)

    def write_table(self, bw: BitWriter) -> None:
        used = [i for i, l in enumerate(self.lengths) if l]
        if not used:
            bw.put_bits(0, 14)
            return
        total = max(used) + 1
        if total > 16383:
            raise BasisLzError(
                f"Huffman alphabet {total} exceeds the 14-bit table header "
                "(cap codebooks first — see ETC1S_MAX_CODEBOOK)"
            )
        bw.put_bits(total, 14)
        # Code-length code: literal sizes only (run codes are optional).
        cl_freqs = [0] * 21
        for l in self.lengths[:total]:
            cl_freqs[l] += 1
        cl = HuffEncoder(cl_freqs, max_len=7)
        bw.put_bits(21, 5)
        for sym in _SORTED_CODELENGTH_CODES:
            bw.put_bits(cl.lengths[sym], 3)
        for l in self.lengths[:total]:
            cl.write(bw, l)

    def write(self, bw: BitWriter, sym: int) -> None:
        assert self.lengths[sym] > 0, f"symbol {sym} has no code"
        bw.put_code(self.codes[sym], self.lengths[sym])


# ----------------------------------------------------------- palettes


def encode_endpoint_palette(endpoints: np.ndarray) -> bytes:
    """(N, 4) u8 (r5, g5, b5, inten3) -> endpoint codebook stream."""
    def model_of(pv: int) -> int:
        return 0 if pv <= 9 else (1 if pv <= 21 else 2)

    biases = [9, 21, 31]
    sym_streams: List[List[int]] = [[], [], [], []]  # m0, m1, m2, inten
    prev = [16, 16, 16]
    prev_inten = 0
    for r, g, b, inten in endpoints.astype(int):
        sym_streams[3].append((inten - prev_inten) & 7)
        prev_inten = inten
        for ch, v in enumerate((r, g, b)):
            m = model_of(prev[ch])
            sym_streams[m].append(v - prev[ch] + biases[m])
            prev[ch] = v

    encoders = [
        HuffEncoder(_freqs(sym_streams[0], 41)),
        HuffEncoder(_freqs(sym_streams[1], 43)),
        HuffEncoder(_freqs(sym_streams[2], 41)),
        HuffEncoder(_freqs(sym_streams[3], 8)),
    ]
    bw = BitWriter()
    for e in encoders:
        e.write_table(bw)
    bw.put_bits(0, 1)  # not grayscale
    prev = [16, 16, 16]
    prev_inten = 0
    for r, g, b, inten in endpoints.astype(int):
        encoders[3].write(bw, (inten - prev_inten) & 7)
        prev_inten = inten
        for ch, v in enumerate((r, g, b)):
            m = model_of(prev[ch])
            encoders[m].write(bw, v - prev[ch] + biases[m])
            prev[ch] = v
    return bw.getvalue()


def encode_selector_palette(selectors: np.ndarray, raw: bool = True) -> bytes:
    """(S, 16) u8 -> selector codebook stream (raw or XOR-delta mode)."""
    rows = np.zeros((len(selectors), 4), np.uint8)
    for j in range(4):
        for k in range(4):
            rows[:, j] |= (selectors[:, j * 4 + k] & 3) << (k * 2)
    bw = BitWriter()
    bw.put_bits(0, 1)  # no global palette
    bw.put_bits(0, 1)  # no hybrid palette
    bw.put_bits(1 if raw else 0, 1)
    if raw:
        for i in range(len(selectors)):
            for j in range(4):
                bw.put_bits(int(rows[i, j]), 8)
        return bw.getvalue()
    deltas = []
    prevb = [0, 0, 0, 0]
    for i in range(len(selectors)):
        for j in range(4):
            if i:
                deltas.append(int(rows[i, j]) ^ prevb[j])
            prevb[j] = int(rows[i, j])
    enc = HuffEncoder(_freqs(deltas, 256))
    enc.write_table(bw)
    prevb = [0, 0, 0, 0]
    for i in range(len(selectors)):
        for j in range(4):
            if not i:
                bw.put_bits(int(rows[i, j]), 8)
            else:
                enc.write(bw, int(rows[i, j]) ^ prevb[j])
            prevb[j] = int(rows[i, j])
    return bw.getvalue()


def _freqs(stream, n) -> List[int]:
    f = [0] * n
    for s in stream:
        f[s] += 1
    return f


# --------------------------------------------------------------- slices


def _slice_tokens(
    ep_idx: np.ndarray,
    sel_idx: np.ndarray,
    num_endpoints: int,
    num_selectors: int,
    history_size: int,
    use_rle: bool,
):
    """Token stream for one slice, mirroring the decoder's state machine.

    Yields ('pred', sym8) / ('delta', sym) / ('sel', sym) /
    ('rle', run_sym, extra_or_None) in exact stream order.
    """
    nby, nbx = ep_idx.shape
    ep = ep_idx.astype(int)
    sel = sel_idx.astype(int)

    # Pred decisions depend only on neighbour equality.
    pred = np.full((nby, nbx), 3, int)
    for by in range(nby):
        for bx in range(nbx):
            if bx and ep[by, bx - 1] == ep[by, bx]:
                pred[by, bx] = 0
            elif by and ep[by - 1, bx] == ep[by, bx]:
                pred[by, bx] = 1
            elif bx and by and ep[by - 1, bx - 1] == ep[by, bx]:
                pred[by, bx] = 2

    history = [0] * history_size
    rover = history_size // 2
    tokens = []
    prev_ep = 0
    rle_left = 0
    for by in range(nby):
        for bx in range(nbx):
            if (bx & 1) == 0 and (by & 1) == 0:
                sym = 0
                for dy in range(2):
                    for dx in range(2):
                        y, x = by + dy, bx + dx
                        if y < nby and x < nbx:
                            sym |= pred[y, x] << ((dy * 2 + dx) * 2)
                tokens.append(("pred", sym))
            if pred[by, bx] == 3:
                tokens.append(("delta", (ep[by, bx] - prev_ep) % num_endpoints))
            prev_ep = ep[by, bx]

            s = sel[by, bx]
            if rle_left:
                rle_left -= 1
                continue
            hidx = history.index(s) if (history_size and s in history) else -1
            if use_rle and hidx == 0:
                run = 0
                y, x = by, bx
                while True:
                    if sel[y, x] != s:
                        break
                    run += 1
                    x += 1
                    if x == nbx:
                        x = 0
                        y += 1
                        if y == nby:
                            break
                if run >= 3:
                    run_sym = run - 3
                    if run_sym >= 63:
                        tokens.append(("rle", 63, run_sym))
                    else:
                        tokens.append(("rle", run_sym, None))
                    rle_left = run - 1
                    continue
            if hidx >= 0:
                tokens.append(("sel", num_selectors + hidx))
                if hidx:  # decoder's approximate-MTF swap
                    history[hidx - 1], history[hidx] = history[hidx], history[hidx - 1]
            else:
                tokens.append(("sel", s))
                if history_size:
                    history[rover] = s
                    rover += 1
                    if rover >= history_size:
                        rover = history_size // 2
    return tokens


def encode_tables_and_slices(
    slices: List[Tuple[np.ndarray, np.ndarray]],
    num_endpoints: int,
    num_selectors: int,
    history_size: int = 0,
    use_rle: bool = False,
) -> Tuple[bytes, List[bytes]]:
    """-> (tables blob, per-slice streams). One shared tables blob for the
    whole file, per the BasisLZ layout."""
    all_tokens = [
        _slice_tokens(e, s, num_endpoints, num_selectors, history_size, use_rle)
        for e, s in slices
    ]
    pred_f = [0] * 257
    delta_f = [0] * max(1, num_endpoints)
    sel_f = [0] * (num_selectors + history_size + 1)
    rle_f = [0] * 64
    for toks in all_tokens:
        for t in toks:
            if t[0] == "pred":
                pred_f[t[1]] += 1
            elif t[0] == "delta":
                delta_f[t[1]] += 1
            elif t[0] == "sel":
                sel_f[t[1]] += 1
            else:
                sel_f[num_selectors + history_size] += 1
                rle_f[t[1]] += 1
    pred_e = HuffEncoder(pred_f)
    delta_e = HuffEncoder(delta_f)
    sel_e = HuffEncoder(sel_f)
    rle_e = HuffEncoder(rle_f)

    tb = BitWriter()
    pred_e.write_table(tb)
    delta_e.write_table(tb)
    sel_e.write_table(tb)
    rle_e.write_table(tb)
    tb.put_bits(history_size, 13)

    out_slices = []
    rle_sym = num_selectors + history_size
    for toks in all_tokens:
        bw = BitWriter()
        for t in toks:
            if t[0] == "pred":
                pred_e.write(bw, t[1])
            elif t[0] == "delta":
                delta_e.write(bw, t[1])
            elif t[0] == "sel":
                sel_e.write(bw, t[1])
            else:
                sel_e.write(bw, rle_sym)
                rle_e.write(bw, t[1])
                if t[2] is not None:
                    bw.put_vlc(t[2], 7)  # decoder: count = vlc + 3
        out_slices.append(bw.getvalue())
    return tb.getvalue(), out_slices


# ------------------------------------------------------------ quantizer


def quantize_etc1s(
    img: np.ndarray, channel: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize (h, w, >=3) u8 to per-block ETC1S params.

    Returns (params (nby, nbx, 4) u8 [r5 g5 b5 inten], selectors
    (nby, nbx, 16) u8). channel=i quantizes a single channel as grayscale
    (the alpha-slice convention)."""
    h, w = img.shape[:2]
    nby, nbx = (h + 3) // 4, (w + 3) // 4
    ph, pw = nby * 4, nbx * 4
    src = img[..., channel : channel + 1] if channel is not None else img[..., :3]
    src = np.pad(src, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    blocks = (
        src.reshape(nby, 4, nbx, 4, src.shape[-1])
        .transpose(0, 2, 1, 3, 4)
        .reshape(nby * nbx, 16, src.shape[-1])
        .astype(np.int16)
    )
    avg = blocks.mean(axis=1)  # (B, C)
    c5 = np.clip(np.rint(avg * (31.0 / 255.0)), 0, 31).astype(np.int16)
    base8 = (c5 << 3) | (c5 >> 2)  # (B, C)
    # candidates: (B, 16, 8, 4, C)
    cand = base8[:, None, None, None, :] + INTEN_TABLES[None, None, :, :, None]
    cand = np.clip(cand, 0, 255)
    diff = blocks[:, :, None, None, :].astype(np.int32) - cand
    err = (diff * diff).sum(-1)  # (B, 16, 8, 4)
    best_sel = err.argmin(-1)  # (B, 16, 8)
    best_err = err.min(-1).sum(1)  # (B, 8)
    table = best_err.argmin(-1)  # (B,)
    b = np.arange(len(table))
    sel = best_sel[b, :, table].astype(np.uint8)  # (B, 16)
    if channel is not None:
        c5 = np.repeat(c5, 3, axis=1)
    params = np.concatenate([c5.astype(np.uint8), table[:, None].astype(np.uint8)], 1)
    return params.reshape(nby, nbx, 4), sel.reshape(nby, nbx, 16)


# Real basis_universal caps codebooks at 16128 clusters (basisu_comp's
# max endpoint/selector cluster limits); our Huffman table header also
# has a 14-bit symbol-count field (16383). Richer-than-toy content (a
# 512^2 noisy texture) overflows a naive dedup, so cap + merge.
ETC1S_MAX_CODEBOOK = 16128


def _cap_codebook(keys: np.ndarray, counts: np.ndarray, cap: int):
    """Keep the `cap` most frequent rows of (N, C) u8 `keys`; return
    (kept (K, C), remap (N,) u32) mapping every original row to its
    kept row — rare rows to the L1-nearest frequent row (greedy
    frequency clustering; adequate rate-distortion for an encoder whose
    role is authoring fixtures, not production compression)."""
    n = len(keys)
    if n <= cap:
        return keys, np.arange(n, dtype=np.uint32)
    order = np.argsort(-counts, kind="stable")
    kept_ids = np.sort(order[:cap])
    rare_ids = np.setdiff1d(np.arange(n), kept_ids, assume_unique=True)
    kept = keys[kept_ids]
    remap = np.zeros(n, np.uint32)
    remap[kept_ids] = np.arange(cap, dtype=np.uint32)
    # chunked L1 nearest (rare x kept x C int16 work)
    rare = keys[rare_ids].astype(np.int16)
    k16 = kept.astype(np.int16)
    step = max(1, (1 << 24) // (len(k16) * keys.shape[1] + 1))
    for i in range(0, len(rare), step):
        d = np.abs(rare[i : i + step, None, :] - k16[None, :, :]).sum(-1)
        remap[rare_ids[i : i + step]] = np.argmin(d, axis=1).astype(np.uint32)
    return kept, remap


def build_codebooks(
    level_params: List[Tuple[np.ndarray, np.ndarray]],
    max_codebook: int = ETC1S_MAX_CODEBOOK,
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[np.ndarray, np.ndarray]]]:
    """Dedupe per-block params across all slices into palettes + indices,
    merging the rarest entries into their nearest neighbours when a
    palette would exceed `max_codebook` (the basisu cluster cap)."""
    ep_map: dict = {}
    sel_map: dict = {}
    ep_counts: List[int] = []
    sel_counts: List[int] = []
    indices = []
    for params, sels in level_params:
        nby, nbx = params.shape[:2]
        ep_idx = np.zeros((nby, nbx), np.uint32)
        sel_idx = np.zeros((nby, nbx), np.uint32)
        for by in range(nby):
            for bx in range(nbx):
                ek = tuple(int(v) for v in params[by, bx])
                sk = tuple(int(v) for v in sels[by, bx])
                e = ep_map.setdefault(ek, len(ep_map))
                s = sel_map.setdefault(sk, len(sel_map))
                if e == len(ep_counts):
                    ep_counts.append(0)
                if s == len(sel_counts):
                    sel_counts.append(0)
                ep_counts[e] += 1
                sel_counts[s] += 1
                ep_idx[by, bx] = e
                sel_idx[by, bx] = s
        indices.append((ep_idx, sel_idx))
    endpoints = np.array(list(ep_map.keys()), np.uint8).reshape(-1, 4)
    selectors = np.array(list(sel_map.keys()), np.uint8).reshape(-1, 16)
    endpoints, ep_remap = _cap_codebook(
        endpoints, np.asarray(ep_counts), max_codebook
    )
    selectors, sel_remap = _cap_codebook(
        selectors, np.asarray(sel_counts), max_codebook
    )
    indices = [(ep_remap[e], sel_remap[s]) for e, s in indices]
    return endpoints, selectors, indices


# ---------------------------------------------------------- ktx2 writer


def write_etc1s_ktx2(
    img: np.ndarray,
    num_levels: int = 1,
    srgb: bool = True,
    with_alpha: bool = False,
    history_size: int = 0,
    use_rle: bool = False,
    raw_selectors: bool = True,
) -> bytes:
    """Encode (h, w, 4) u8 into a BasisLZ/ETC1S KTX2 file (test support)."""
    h, w = img.shape[:2]
    mips = [img]
    for i in range(1, num_levels):
        prev = mips[-1]
        mh, mw = max(1, prev.shape[0] // 2), max(1, prev.shape[1] // 2)
        small = prev[: mh * 2, : mw * 2].reshape(mh, 2, mw, 2, 4).mean((1, 3))
        mips.append(np.clip(np.rint(small), 0, 255).astype(np.uint8))

    level_params = []
    per_level_slices = []  # (rgb_slice_index, alpha_slice_index or -1)
    for m in mips:
        level_params.append(quantize_etc1s(m))
        if with_alpha:
            level_params.append(quantize_etc1s(m, channel=3))
    endpoints, selectors, indices = build_codebooks(level_params)

    tables, slice_streams = encode_tables_and_slices(
        indices,
        len(endpoints),
        len(selectors),
        history_size=history_size,
        use_rle=use_rle,
    )
    ep_stream = encode_endpoint_palette(endpoints)
    sel_stream = encode_selector_palette(selectors, raw=raw_selectors)

    # Per-level data: rgb slice [+ alpha slice], with imageDescs.
    descs = []
    level_blobs = []
    si = 0
    for _ in mips:
        rgb = slice_streams[si]
        si += 1
        alpha = b""
        if with_alpha:
            alpha = slice_streams[si]
            si += 1
        descs.append((0, 0, len(rgb), len(rgb) if alpha else 0, len(alpha)))
        level_blobs.append(rgb + alpha)

    sgd = bytearray()
    sgd += SGD_HEADER.pack(
        len(endpoints), len(selectors), len(ep_stream), len(sel_stream), len(tables), 0
    )
    for d in descs:
        sgd += IMAGE_DESC.pack(*d)
    sgd += ep_stream + sel_stream + tables

    # DFD (basic block: ETC1S color model 163).
    ns = 2 if with_alpha else 1
    block_size = 24 + 16 * ns
    dfd = bytearray()
    dfd += struct.pack("<I", 4 + block_size)
    dfd += struct.pack("<I", 0)  # vendor 0, type 0
    dfd += struct.pack("<2H", 2, block_size)  # version, blockSize
    dfd += bytes([163, 1, 2 if srgb else 1, 0])  # model, primaries, transfer, flags
    dfd += bytes([3, 3, 0, 0])  # texel block 4x4
    dfd += bytes(8)  # bytesPlane: 0 (supercompressed)
    for s in range(ns):
        dfd += struct.pack("<HBB", 0, 63, 0 if s == 0 else 15)  # offset, len, type
        dfd += bytes([0, 0, 0, 0])  # sample positions
        dfd += struct.pack("<2I", 0, 0xFFFFFFFF)

    header_size = 80 + 24 * num_levels
    dfd_off = header_size
    sgd_off = dfd_off + len(dfd)
    sgd_off += (-sgd_off) % 8
    data_off = sgd_off + len(sgd)
    data_off += (-data_off) % 8

    # Levels stored smallest-first physically (KTX2 convention).
    level_offsets = [0] * num_levels
    p = data_off
    for lvl in reversed(range(num_levels)):
        level_offsets[lvl] = p
        p += len(level_blobs[lvl])

    out = bytearray()
    out += b"\xabKTX 20\xbb\r\n\x1a\n"
    out += struct.pack(
        "<9I", 0, 1, w, h, 0, 0, 1, num_levels, 1
    )  # vkFormat UNDEFINED, typeSize, dims, layers 0, faces 1, levels, BasisLZ
    out += struct.pack("<2I", dfd_off, len(dfd))
    out += struct.pack("<2I", 0, 0)  # no KVD
    out += struct.pack("<2Q", sgd_off, len(sgd))
    for lvl in range(num_levels):
        out += struct.pack("<3Q", level_offsets[lvl], len(level_blobs[lvl]), 0)
    out += bytes(dfd_off - len(out))
    out += dfd
    out += bytes(sgd_off - len(out))
    out += sgd
    out += bytes(data_off - len(out))
    for lvl in reversed(range(num_levels)):
        assert len(out) == level_offsets[lvl]
        out += level_blobs[lvl]
    return bytes(out)
