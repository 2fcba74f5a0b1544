"""Texture-gallery scene builder: Sponza-class content without Sponza.bin.

The reference checkout ships the 69 Sponza 1K textures but not the
geometry buffer, so this builds an equivalent-workload scene: a colonnade
of textured boxes/quads, one material per Sponza texture set, ~70
materials and ~380 MB of decoded RGBA mips in the texel pool — the same
many-material, gather-divergent shading the real Sponza frame has.

The port's copy of ``superconductor_tpu/utils/gallery.py``: it reads the
Sponza textures from ``assets.ASSETS_DIR`` (the reference's asset layout)
and raises FileNotFoundError where they are absent, as the reference does.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..assets import ASSETS_DIR
from ..math3d import Similarity
from ..scene.scene import (
    MaterialSettings,
    Model,
    Primitive,
    PrimitiveLod,
    Scene,
    TEXFLAG_SRGB,
    build_mip_chain,
)

SPONZA_TEX_DIR = os.path.join(ASSETS_DIR, "models", "Sponza", "glTF")


def _box_mesh():
    """Unit cube with per-face uvs and outward normals."""
    faces = []
    # (normal, u-axis, v-axis)
    axes = [
        ([0, 0, 1], [1, 0, 0], [0, 1, 0]),
        ([0, 0, -1], [-1, 0, 0], [0, 1, 0]),
        ([1, 0, 0], [0, 0, -1], [0, 1, 0]),
        ([-1, 0, 0], [0, 0, 1], [0, 1, 0]),
        ([0, 1, 0], [1, 0, 0], [0, 0, -1]),
        ([0, -1, 0], [1, 0, 0], [0, 0, 1]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (n, u, v) in enumerate(axes):
        n = np.array(n, np.float32)
        u = np.array(u, np.float32)
        v = np.array(v, np.float32)
        base = len(pos)
        for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            pos.append(0.5 * (n + du * u + dv * v))
            nrm.append(n)
            uv.append([(du + 1) / 2, 1 - (dv + 1) / 2])
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (
        np.array(pos, np.float32),
        np.array(nrm, np.float32),
        np.array(uv, np.float32),
        np.array(idx, np.uint32),
    )


def load_sponza_textures(scene: Scene, limit: Optional[int] = None) -> List[int]:
    """Decode the bundled Sponza JPGs into the LDR pool; returns tex ids."""
    from PIL import Image

    ids = []
    files = sorted(
        f for f in os.listdir(SPONZA_TEX_DIR) if f.endswith((".jpg", ".png"))
    )
    if limit:
        files = files[:limit]
    for f in files:
        img = Image.open(os.path.join(SPONZA_TEX_DIR, f)).convert("RGBA")
        rgba = np.asarray(img, np.uint8)
        ids.append(
            scene.textures.add_texture(build_mip_chain(rgba), flags=TEXFLAG_SRGB)
        )
    return ids


def build_gallery(
    scene: Scene, tex_limit: Optional[int] = None, name: str = "gallery"
) -> Model:
    """A ring colonnade of textured boxes, one material per texture."""
    if not os.path.isdir(SPONZA_TEX_DIR):
        raise FileNotFoundError(SPONZA_TEX_DIR)
    tex_ids = load_sponza_textures(scene, tex_limit)
    pos, nrm, uv, idx = _box_mesh()
    primitives = []
    n = len(tex_ids)
    for i, tid in enumerate(tex_ids):
        mat = scene.add_material(
            MaterialSettings(
                albedo_tex=tid, metallic_factor=0.0, roughness_factor=0.85
            )
        )
        first, count, fv, vc = scene.insert_static_mesh(
            pos, nrm, uv, np.zeros_like(uv), idx, mat
        )
        prim = Primitive(
            material=mat,
            blend_mode=0,
            double_sided=False,
            animated=False,
            lods=[PrimitiveLod(first_index=first, index_count=count, first_vertex=fv, vertex_count=vc)],
            bounding_sphere_radius=float(np.sqrt(0.75)),
            bbox_min=pos.min(0),
            bbox_max=pos.max(0),
        )
        ang = 2 * np.pi * i / max(n, 1)
        radius = 6.0
        from ..math3d import quat_from_axis_angle

        prim.transform = Similarity(
            translation=[radius * np.cos(ang), 0.8 * (i % 3), radius * np.sin(ang)],
            rotation=quat_from_axis_angle([0, 1, 0], -ang),
        )
        primitives.append(prim)
    model = Model(primitives=primitives)
    model.bounding_sphere_radius = 8.0
    scene.models[name] = model
    return model
