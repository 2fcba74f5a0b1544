"""KTX2 container parsing + supercompression + format decode.

Covers what the reference's texture pipeline consumes
(renderer-core/src/assets/textures.rs:616-1097): KTX2 header/level index,
zstd supercompression, and the texel formats its assets actually use —
RGBA8 (lightvol axis volumes), RGBA16F (lightvol L0), RGBA32F, and
BC6H_UFLOAT (IBL cubemaps — the reference decompresses BC6H on the GPU
with granite-shaders/bc6.frag when the device lacks native support; here
the native scnative C++ decoder does it at load time, with a numpy
fallback), BC7, ASTC 4x4 and UASTC (KHR_texture_basisu). UASTC blocks are
valid ASTC 4x4 blocks, so the in-repo ASTC decoder plays the role
basis-universal plays in the reference (textures.rs:1099-1153); ETC1S/
BasisLZ (the other basisu mode) decodes through native/src/etc1s.cpp +
assets/basislz.py. Unsupported formats degrade to a dummy texture,
mirroring the reference's degrade-don't-fail policy.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

KTX2_MAGIC = b"\xabKTX 20\xbb\r\n\x1a\n"

# vkFormat values we handle
VK_FORMAT_R8G8B8A8_UNORM = 37
VK_FORMAT_R8G8B8A8_SRGB = 43
VK_FORMAT_R16G16B16A16_SFLOAT = 97
VK_FORMAT_R32G32B32A32_SFLOAT = 109
VK_FORMAT_BC6H_UFLOAT = 143
VK_FORMAT_BC7_UNORM = 145
VK_FORMAT_BC7_SRGB = 146
VK_FORMAT_ASTC_4x4_UNORM = 157
VK_FORMAT_ASTC_4x4_SRGB = 158
VK_FORMAT_ASTC_4x4_SFLOAT = 1000066000  # ASTC HDR (astc-tier lightvol L0)
VK_FORMAT_UNDEFINED = 0  # Basis Universal (UASTC / ETC1S)

SUPERCOMPRESSION_NONE = 0
SUPERCOMPRESSION_BASISLZ = 1
SUPERCOMPRESSION_ZSTD = 2
SUPERCOMPRESSION_ZLIB = 3

# Khronos Data Format descriptor color models (for vkFormat == UNDEFINED)
KDF_MODEL_ETC1S = 163
KDF_MODEL_UASTC = 166
KDF_TRANSFER_SRGB = 2


@dataclass
class Ktx2:
    vk_format: int
    width: int
    height: int
    depth: int
    layers: int
    faces: int
    levels: List[Tuple[int, int, int]]  # (offset, byte_len, uncompressed_len)
    scheme: int
    data: bytes
    kvd: dict
    # Supercompression global data (BasisLZ/ETC1S codebooks + image descs).
    sgd: bytes = b""
    # From the Data Format Descriptor: identifies UASTC/ETC1S payloads when
    # vkFormat is UNDEFINED, and the transfer function (sRGB vs linear).
    color_model: int = 0
    transfer: int = 0

    @property
    def is_uastc(self) -> bool:
        return self.vk_format == VK_FORMAT_UNDEFINED and self.color_model == KDF_MODEL_UASTC

    @property
    def is_etc1s(self) -> bool:
        return self.vk_format == VK_FORMAT_UNDEFINED and self.color_model == KDF_MODEL_ETC1S

    @property
    def is_srgb_transfer(self) -> bool:
        return self.transfer == KDF_TRANSFER_SRGB

    @property
    def num_images(self) -> int:
        return max(1, self.layers) * self.faces * max(1, self.depth)

    def level_dims(self, level: int) -> Tuple[int, int, int]:
        return (
            max(1, self.width >> level),
            max(1, self.height >> level),
            max(1, self.depth >> level) if self.depth else 1,
        )

    def level_bytes(self, level: int) -> bytes:
        off, blen, _ulen = self.levels[level]
        raw = self.data[off : off + blen]
        if self.scheme == SUPERCOMPRESSION_ZSTD:
            import zstandard

            return zstandard.ZstdDecompressor().decompress(
                raw, max_output_size=self.levels[level][2]
            )
        if self.scheme == SUPERCOMPRESSION_ZLIB:
            import zlib

            return zlib.decompress(raw)
        return raw


def parse_ktx2(data: bytes) -> Ktx2:
    if data[:12] != KTX2_MAGIC:
        raise ValueError("not a KTX2 file")
    (
        vk_format,
        _type_size,
        width,
        height,
        depth,
        layers,
        faces,
        levels,
        scheme,
    ) = struct.unpack_from("<9I", data, 12)
    dfd_off, dfd_len = struct.unpack_from("<2I", data, 48)
    kvd_off, kvd_len = struct.unpack_from("<2I", data, 56)
    sgd_off, sgd_len = struct.unpack_from("<2Q", data, 64)
    color_model = transfer = 0
    if dfd_off and dfd_len >= 16 and dfd_off + 16 <= len(data):
        # DFD: u32 total size, u32 vendor/type, u32 version/blockSize, then
        # the basic block: colorModel u8, colorPrimaries u8, transfer u8.
        color_model = data[dfd_off + 12]
        transfer = data[dfd_off + 14]
    level_index = []
    for i in range(max(1, levels)):
        off, blen, ulen = struct.unpack_from("<3Q", data, 80 + i * 24)
        level_index.append((off, blen, ulen))
    kvd = {}
    end = kvd_off + kvd_len
    p = kvd_off
    while kvd_off and p + 4 <= end:
        (kv_len,) = struct.unpack_from("<I", data, p)
        kv = data[p + 4 : p + 4 + kv_len]
        if b"\x00" in kv:
            key, _, value = kv.partition(b"\x00")
            kvd[key.decode("utf-8", "replace")] = value
        p += 4 + kv_len + (-kv_len % 4)
    return Ktx2(
        vk_format=vk_format,
        width=width,
        height=height,
        depth=depth,
        layers=layers,
        faces=faces,
        levels=level_index,
        scheme=scheme,
        data=data,
        kvd=kvd,
        sgd=data[sgd_off : sgd_off + sgd_len] if sgd_off else b"",
        color_model=color_model,
        transfer=transfer,
    )


def _srgb_to_linear(arr: np.ndarray) -> np.ndarray:
    rgb = arr[..., :3]
    arr[..., :3] = np.where(
        rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4
    )
    return arr


def _decode_image_payload(
    ktx: Ktx2, payload: bytes, w: int, h: int, linearize: bool = True
) -> np.ndarray:
    """One image (w, h) of a level -> (h, w, 4) float32.

    linearize=True converts sRGB-encoded sources to linear (the HDR/env
    path). linearize=False returns the display-encoded values unchanged —
    the LDR texture-pool path stores encoded u8 texels and lets the
    sampler's TEXFLAG_SRGB do the conversion (one conversion, in-shader,
    exactly like binding an sRGB texture view in the reference)."""
    fmt = ktx.vk_format
    if fmt in (VK_FORMAT_R8G8B8A8_UNORM, VK_FORMAT_R8G8B8A8_SRGB):
        arr = np.frombuffer(payload, np.uint8).reshape(h, w, 4).astype(np.float32)
        arr /= 255.0
        if fmt == VK_FORMAT_R8G8B8A8_SRGB and linearize:
            arr = _srgb_to_linear(arr)
        return arr
    if fmt == VK_FORMAT_R16G16B16A16_SFLOAT:
        return np.frombuffer(payload, np.float16).reshape(h, w, 4).astype(np.float32)
    if fmt == VK_FORMAT_R32G32B32A32_SFLOAT:
        return np.frombuffer(payload, np.float32).reshape(h, w, 4).copy()
    if fmt == VK_FORMAT_BC6H_UFLOAT:
        from ..native import bc6h

        return bc6h.decode_bc6h(payload, w, h)
    if fmt in (VK_FORMAT_BC7_UNORM, VK_FORMAT_BC7_SRGB):
        from ..native import bc7

        arr = bc7.decode_bc7(payload, w, h).astype(np.float32)
        arr *= np.float32(1.0 / 255.0)  # in-place: scalar f32 division is
        # pathologically slow in this numpy build (~200x vs multiply)
        if fmt == VK_FORMAT_BC7_SRGB and linearize:
            arr = _srgb_to_linear(arr)
        return arr
    if fmt in (VK_FORMAT_ASTC_4x4_UNORM, VK_FORMAT_ASTC_4x4_SRGB) or ktx.is_uastc:
        # ASTC LDR via the in-repo C++ decoder (bit-exact vs the Mesa GL
        # oracle, tests/test_native.py). UASTC blocks are valid ASTC 4x4
        # blocks, so the same decoder transcodes KHR_texture_basisu
        # payloads — the reference's basis-universal role
        # (textures.rs:1099-1153).
        from ..native.astc import decode_astc

        srgb = fmt == VK_FORMAT_ASTC_4x4_SRGB or (
            ktx.is_uastc and ktx.is_srgb_transfer
        )
        arr = decode_astc(payload, w, h, srgb=srgb).astype(np.float32)
        arr *= np.float32(1.0 / 255.0)
        if srgb and linearize:
            arr = _srgb_to_linear(arr)
        return arr
    if fmt == VK_FORMAT_ASTC_4x4_SFLOAT:
        from ..native.astc import decode_astc_hdr

        return decode_astc_hdr(payload, w, h)
    raise NotImplementedError(f"vkFormat {fmt}")


def _image_size_bytes(ktx: Ktx2, w: int, h: int) -> int:
    fmt = ktx.vk_format
    if fmt in (VK_FORMAT_R8G8B8A8_UNORM, VK_FORMAT_R8G8B8A8_SRGB):
        return w * h * 4
    if fmt == VK_FORMAT_R16G16B16A16_SFLOAT:
        return w * h * 8
    if fmt == VK_FORMAT_R32G32B32A32_SFLOAT:
        return w * h * 16
    if fmt in (
        VK_FORMAT_BC6H_UFLOAT,
        VK_FORMAT_BC7_UNORM,
        VK_FORMAT_BC7_SRGB,
        VK_FORMAT_ASTC_4x4_UNORM,
        VK_FORMAT_ASTC_4x4_SRGB,
        VK_FORMAT_ASTC_4x4_SFLOAT,
    ) or ktx.is_uastc:
        return ((w + 3) // 4) * ((h + 3) // 4) * 16
    raise NotImplementedError(f"vkFormat {fmt}")


def decode_level_images(
    ktx: Ktx2, level: int, linearize: bool = True
) -> List[np.ndarray]:
    """All images (faces x layers x z-slices, in KTX2 order) of one level,
    each (h, w, 4) float32 (linear unless linearize=False)."""
    w, h, d = ktx.level_dims(level)
    if ktx.is_etc1s:
        from . import basislz

        images = []
        for i in range(max(1, ktx.layers) * ktx.faces * d):
            arr = basislz.decode_image_u8(ktx, level, i).astype(np.float32)
            arr *= np.float32(1.0 / 255.0)
            if ktx.is_srgb_transfer and linearize:
                arr = _srgb_to_linear(arr)
            images.append(arr)
        return images
    raw = ktx.level_bytes(level)
    size = _image_size_bytes(ktx, w, h)
    images = []
    n = max(1, ktx.layers) * ktx.faces * d
    for i in range(n):
        images.append(
            _decode_image_payload(
                ktx, raw[i * size : (i + 1) * size], w, h, linearize=linearize
            )
        )
    return images


def decode_level_u8(ktx: Ktx2, level: int, image: int = 0) -> np.ndarray:
    """Display-encoded (h, w, 4) uint8 decode of one LDR image with NO
    float round trip — host allocations are expensive (first-touch page
    faults run ~50 MB/s in this VM), so the LDR texture-pool path goes
    decoder-output -> pool directly."""
    w, h, _d = ktx.level_dims(level)
    if ktx.is_etc1s:
        from . import basislz

        return basislz.decode_image_u8(ktx, level, image)
    raw = ktx.level_bytes(level)
    size = _image_size_bytes(ktx, w, h)
    payload = raw[image * size : (image + 1) * size]
    fmt = ktx.vk_format
    if fmt in (VK_FORMAT_R8G8B8A8_UNORM, VK_FORMAT_R8G8B8A8_SRGB):
        return np.frombuffer(payload, np.uint8).reshape(h, w, 4).copy()
    if fmt in (VK_FORMAT_BC7_UNORM, VK_FORMAT_BC7_SRGB):
        from ..native import bc7

        return bc7.decode_bc7(payload, w, h)
    if fmt in (VK_FORMAT_ASTC_4x4_UNORM, VK_FORMAT_ASTC_4x4_SRGB) or ktx.is_uastc:
        from ..native.astc import decode_astc

        srgb = fmt == VK_FORMAT_ASTC_4x4_SRGB or (
            ktx.is_uastc and ktx.is_srgb_transfer
        )
        return decode_astc(payload, w, h, srgb=srgb)
    raise NotImplementedError(f"vkFormat {fmt} has no u8 decode")


def decode_ktx2_rgba8(data: bytes) -> np.ndarray:
    """First image of mip 0 as display-encoded (h, w, 4) uint8 — the glTF
    LDR texture-pool path (TEXFLAG_SRGB handles transfer in-shader, so the
    bytes are NOT linearized here; double conversion otherwise)."""
    ktx = parse_ktx2(data)
    try:
        return decode_level_u8(ktx, 0)
    except NotImplementedError:
        img = decode_level_images(ktx, 0, linearize=False)[0]
        out = np.empty(img.shape, np.uint8)
        np.multiply(img, 255.0, out=img)
        np.clip(img, 0, 255, out=img)
        np.rint(img, out=img)
        out[:] = img
        return out
