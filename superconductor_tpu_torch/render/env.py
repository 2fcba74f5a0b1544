"""Static environment bindings: which HDR textures light the scene.

The reference binds these as the 14-entry global bind group
(allocate_bind_groups, src/systems.rs:409-591): IBL cubemap, 4 lightvol
array textures, 4 lightmap textures, smoke/LUT textures. Texture *ids* are
compile-time constants of the frame function (they change only when the
environment is re-configured, which recompiles — the analog of rebuilding
the bind group), while texel *content* streams freely through the pools.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class EnvBindings:
    ibl_cubemap_base: int = -1  # first of 6 consecutive HDR pool textures
    # (face_mip0_offsets(6), w, h): compile-time placement of the cubemap
    # faces in the HDR pool. When set, the skybox pass samples with fully
    # static addressing — no per-pixel descriptor gathers (ops/texture.py
    # sample_cubemap static path). Filled by from_scene; goes stale only
    # if the cubemap texture is freed/replaced, which re-configures the
    # environment (and recompiles) anyway.
    ibl_cubemap_static: Optional[
        Tuple[Tuple[int, int, int, int, int, int], int, int]
    ] = None
    lightvol_tex_ids: Optional[Tuple[int, int, int, int]] = None
    lightvol_z_layers: int = 0
    # (w, h) of the lightvol layers. When set (and the scene publishes its
    # SH-interleaved "lv_sh" pool), sample_spherical_harmonics uses the
    # packed 2-gather path with fully static addressing.
    lightvol_wh: Optional[Tuple[int, int]] = None
    lightmap_tex_ids: Optional[Tuple[int, int, int, int]] = None
    # (w, h) of the SH lightmaps — same contract as lightvol_wh.
    lightmap_wh: Optional[Tuple[int, int]] = None
    smoke_tex_ids: Optional[Tuple[int, int, int]] = None  # (a, b, lut)
    # Static placement of the interleaved smoke pool (Scene.device_smoke):
    # (w, h, wrap_ab, lut_w, lut_h, lut_wrap, lut_flags). When set and the
    # scene publishes smoke_ab/smoke_lut, the particle shader samples both
    # smoke maps in ONE 32 B row gather from a dedicated pool (and the LUT
    # from its own tiny pool) with zero descriptor gathers.
    smoke_static: Optional[
        Tuple[int, int, int, int, int, int, int]
    ] = None
    clear_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Constant-ambient SH fallback when no lightvol/lightmap is configured
    # (flattened (4,3) row-major: L0.rgb, L1x.rgb, L1y.rgb, L1z.rgb).
    ambient_sh: Tuple[float, ...] = (0.0,) * 12

    @staticmethod
    def from_scene(scene, **extra) -> "EnvBindings":
        """Bindings derived from the scene's configured environment
        textures; `extra` fields (e.g. ambient_sh, clear_color) are
        passed through and win over derived values."""
        kwargs = {}
        if scene.ibl_cubemap_base >= 0:
            kwargs["ibl_cubemap_base"] = scene.ibl_cubemap_base
            pool = scene.textures_hdr
            bases = [
                pool.tex_mip_base[scene.ibl_cubemap_base + f]
                for f in range(6)
            ]
            w = pool.mip_w[bases[0]]
            h = pool.mip_h[bases[0]]
            if all(
                pool.mip_w[b] == w and pool.mip_h[b] == h for b in bases
            ):
                kwargs["ibl_cubemap_static"] = (
                    tuple(int(pool.mip_offset[b]) for b in bases), w, h
                )
        if scene.lightvol is not None:
            kwargs["lightvol_tex_ids"] = tuple(scene.lightvol["tex_ids"])
            kwargs["lightvol_z_layers"] = scene.lightvol["z_layers"]
            w, h, _ = scene.lightvol_dims()
            kwargs["lightvol_wh"] = (w, h)
        if scene.lightmap_tex is not None:
            kwargs["lightmap_tex_ids"] = tuple(scene.lightmap_tex)
            kwargs["lightmap_wh"] = scene.lightmap_dims()
        if scene.smoke_tex[0] >= 0:
            kwargs["smoke_tex_ids"] = tuple(scene.smoke_tex)
            dims = scene.smoke_static_dims()
            if dims is not None:
                kwargs["smoke_static"] = dims
        kwargs.update(extra)
        return EnvBindings(**kwargs)
