"""Environment asset loading: IBL cubemaps, SH light volumes, lightmaps,
smoke textures.

Mirrors the reference's resource-update systems:
  * load_ibl_cubemap (textures.rs:23-272) -> 6 HDR pool textures + mips;
  * update_lightvol_textures (systems.rs:593) -> four 3D textures stored as
    stacked 2D layers in the HDR pool (sampled by ops/texture.py's
    sample_3d_from_layers exactly like sample_2d_array_as_3d);
  * lightmaps -> four 2D HDR textures;
  * smoke_a/smoke_b/lut for particles.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..scene.scene import WRAP_CLAMP, Scene
from .ktx2 import decode_level_images, parse_ktx2


def load_ibl_cubemap(scene: Scene, data: bytes) -> int:
    """KTX2 cubemap -> 6 consecutive HDR textures (with mip chains).
    Returns the base texture id; set EnvBindings.ibl_cubemap_base to it.
    Respects scene.max_texture_size (textures.rs:989 applies the device
    limit to the cubemap load the same way)."""
    from ..scene.scene import mip_skip_for_max_size

    ktx = parse_ktx2(data)
    if ktx.faces != 6:
        raise ValueError("not a cubemap")
    scene.textures_hdr.source_bytes += len(data)
    n_levels = len(ktx.levels)
    skip = min(
        mip_skip_for_max_size(ktx.height, ktx.width, scene.max_texture_size),
        n_levels - 1,
    )
    per_face_mips: List[List[np.ndarray]] = [[] for _ in range(6)]
    for level in range(skip, n_levels):
        images = decode_level_images(ktx, level)
        for face in range(6):
            per_face_mips[face].append(images[face].astype(np.float32))
    base = None
    for face in range(6):
        tid = scene.textures_hdr.add_texture(per_face_mips[face], wrap=WRAP_CLAMP)
        if base is None:
            base = tid
    scene.ibl_cubemap_base = base
    return base


def _load_volume_texture(scene: Scene, data: bytes) -> Tuple[int, int]:
    """3D KTX2 -> one HDR pool texture whose 'mip' entries are the z layers.
    Returns (tex_id, z_layers)."""
    ktx = parse_ktx2(data)
    scene.textures_hdr.source_bytes += len(data)
    images = decode_level_images(ktx, 0)  # z slices of mip 0
    tid = scene.textures_hdr.add_texture(
        [img.astype(np.float32) for img in images], wrap=WRAP_CLAMP
    )
    return tid, len(images)


def load_lightvol(
    scene: Scene,
    l0: bytes,
    lx: bytes,
    ly: bytes,
    lz: bytes,
    bottom_left=(0.0, 0.0, 0.0),
    scale=(1.0, 1.0, 1.0),
) -> dict:
    """Four 3D SH textures (L0 + L1 x/y/z); returns the scene.lightvol dict.

    The x/y/z volumes are stored 0..1-encoded (unpacked to [-1, 1] by the
    shading pass with *255/127 - 128/127, matching lib.rs:231-235).
    """
    ids = []
    z_layers = None
    for data in (l0, lx, ly, lz):
        tid, zl = _load_volume_texture(scene, data)
        ids.append(tid)
        z_layers = zl if z_layers is None else z_layers
    scene.lightvol = {
        "tex_ids": ids,
        "z_layers": z_layers,
        "bottom_left": np.asarray(bottom_left, np.float32),
        "scale": np.asarray(scale, np.float32),
    }
    return scene.lightvol


def load_lightmaps(scene: Scene, l0: bytes, lx: bytes, ly: bytes, lz: bytes):
    ids = []
    for data in (l0, lx, ly, lz):
        ktx = parse_ktx2(data)
        scene.textures_hdr.source_bytes += len(data)
        img = decode_level_images(ktx, 0)[0]
        ids.append(
            scene.textures_hdr.add_texture([img.astype(np.float32)], wrap=WRAP_CLAMP)
        )
    scene.lightmap_tex = ids
    return ids


def load_smoke_textures(scene: Scene, smoke_a: bytes, smoke_b: bytes, lut: bytes):
    """Smoke light maps + emissive LUT into the LDR u8 pool.

    The content is LDR (BC7 / RGBA8-sRGB, up to 4096x4096); storing it as
    u8 like the reference's texture bindings keeps the pool 16x smaller
    than float32 and skips a pathologically slow host-side u8->f32
    inflation. The sampler normalizes u8 to [0,1] and TEXFLAG_SRGB handles
    the LUT's transfer function in-shader."""
    from ..scene.scene import TEXFLAG_SRGB
    from .ktx2 import decode_level_u8

    ids = []
    for data in (smoke_a, smoke_b, lut):
        ktx = parse_ktx2(data)
        scene.textures.source_bytes += len(data)
        u8 = decode_level_u8(ktx, 0)
        flags = TEXFLAG_SRGB if ktx.is_srgb_transfer or ktx.vk_format == 43 else 0
        ids.append(
            scene.textures.add_texture([u8], wrap=WRAP_CLAMP, flags=flags)
        )
    scene.smoke_tex = tuple(ids)
    return scene.smoke_tex
