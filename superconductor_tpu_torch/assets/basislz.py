"""BasisLZ / ETC1S supercompression decode: the port's copy of the
decoder half of ``superconductor_tpu/assets/basislz.py`` (its ETC1S
encoder, test support there, is not copied).

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
from typing import List, Tuple

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
