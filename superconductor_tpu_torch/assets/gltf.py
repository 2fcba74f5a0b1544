"""glTF 2.0 / GLB parser (pure Python + numpy, no external gltf library).

Covers what the reference loader consumes (renderer-core/src/assets/
models.rs:159-268, 280-671): GLB chunking, external/embedded buffers,
accessors of all component types (with normalization), sparse accessors,
EXT_meshopt_compression buffer views (decoded via assets.meshopt), and the
extensions the reference reads: KHR_texture_transform,
KHR_materials_emissive_strength, KHR_materials_unlit, MSFT_lod (+
MSFT_screencoverage extras), KHR_texture_basisu.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .fetch import FetchClient, decode_data_uri

GLB_MAGIC = 0x46546C67  # 'glTF'
CHUNK_JSON = 0x4E4F534A  # 'JSON'
CHUNK_BIN = 0x004E4942  # 'BIN\0'

COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


@dataclass
class Gltf:
    """Parsed glTF document: raw JSON dict + resolved binary buffer views."""

    json: dict
    buffer_views: Dict[int, np.ndarray] = field(default_factory=dict)  # uint8 arrays

    # ------------------------------------------------------------------
    def accessor(self, index: int) -> np.ndarray:
        """Decode accessor `index` to an (count, components) float/int array.

        Normalized integer accessors are converted to float per the glTF
        spec. Missing bufferView (zero-filled) and sparse accessors are
        handled.
        """
        acc = self.json["accessors"][index]
        dtype = COMPONENT_DTYPES[acc["componentType"]]
        ncomp = TYPE_COUNTS[acc["type"]]
        count = acc["count"]

        if "bufferView" in acc:
            view_data = self.buffer_views[acc["bufferView"]]
            view = self.json["bufferViews"][acc["bufferView"]]
            stride = view.get("byteStride") or ncomp * np.dtype(dtype).itemsize
            offset = acc.get("byteOffset", 0)
            itemsize = np.dtype(dtype).itemsize
            if stride == ncomp * itemsize:
                flat = view_data[offset : offset + count * ncomp * itemsize]
                out = np.frombuffer(flat.tobytes(), dtype=dtype).reshape(count, ncomp)
            else:
                # Interleaved: gather strided rows.
                rows = np.lib.stride_tricks.as_strided(
                    view_data[offset:],
                    shape=(count, ncomp * itemsize),
                    strides=(stride, 1),
                ).copy()
                out = np.frombuffer(rows.tobytes(), dtype=dtype).reshape(count, ncomp)
        else:
            out = np.zeros((count, ncomp), dtype=dtype)

        sparse = acc.get("sparse")
        if sparse:
            out = out.copy()
            idx_info = sparse["indices"]
            idx_dtype = COMPONENT_DTYPES[idx_info["componentType"]]
            idx_raw = self.buffer_views[idx_info["bufferView"]]
            off = idx_info.get("byteOffset", 0)
            n = sparse["count"]
            indices = np.frombuffer(
                idx_raw[off : off + n * np.dtype(idx_dtype).itemsize].tobytes(),
                dtype=idx_dtype,
            )
            val_info = sparse["values"]
            val_raw = self.buffer_views[val_info["bufferView"]]
            voff = val_info.get("byteOffset", 0)
            values = np.frombuffer(
                val_raw[voff : voff + n * ncomp * np.dtype(dtype).itemsize].tobytes(),
                dtype=dtype,
            ).reshape(n, ncomp)
            out[indices] = values

        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
            if info.min < 0:
                out = np.maximum(out, -1.0)
        return out

    def accessor_index(self, index: int) -> np.ndarray:
        """Decode an index accessor to flat uint32."""
        return self.accessor(index).reshape(-1).astype(np.uint32)


def parse_glb_chunks(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC:
        raise ValueError("not a GLB file")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset = 12
    chunks = {}
    while offset + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunks[ctype] = data[offset : offset + clen]
        offset += clen + (-clen % 4)
    return chunks


def parse_gltf(
    data: bytes, url: str = "", client: Optional[FetchClient] = None
) -> Gltf:
    """Parse .glb or .gltf bytes, fetching external buffers through `client`.

    Equivalent of collect_buffer_view_map (models.rs:159-268): every buffer
    view referenced by the document is materialized as a uint8 numpy array,
    with EXT_meshopt_compression views decoded on the fly.
    """
    if data[:4] == b"glTF":
        chunks = parse_glb_chunks(data)
        doc = json.loads(chunks[CHUNK_JSON])
        bin_chunk = chunks.get(CHUNK_BIN)
    else:
        doc = json.loads(data)
        bin_chunk = None

    buffers: List[Optional[np.ndarray]] = []
    for i, buf in enumerate(doc.get("buffers", ())):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError("buffer with no uri and no BIN chunk")
            raw = bin_chunk
        elif uri.startswith("data:"):
            raw = decode_data_uri(uri)
        else:
            if client is None:
                raise ValueError(f"external buffer {uri!r} requires a fetch client")
            raw = client.fetch_bytes(client.resolve(url, uri))
        buffers.append(np.frombuffer(raw, dtype=np.uint8))

    gltf = Gltf(json=doc)
    for vi, view in enumerate(doc.get("bufferViews", ())):
        meshopt = view.get("extensions", {}).get("EXT_meshopt_compression")
        if meshopt:
            from . import meshopt as meshopt_mod

            src = buffers[meshopt["buffer"]]
            off = meshopt.get("byteOffset", 0)
            comp = src[off : off + meshopt["byteLength"]]
            gltf.buffer_views[vi] = meshopt_mod.decode_buffer_view(
                bytes(comp.tobytes()),
                mode=meshopt["mode"],
                count=meshopt["count"],
                stride=meshopt["byteStride"],
                filter=meshopt.get("filter", "NONE"),
            )
        else:
            src = buffers[view["buffer"]]
            off = view.get("byteOffset", 0)
            gltf.buffer_views[vi] = src[off : off + view["byteLength"]]
    return gltf
