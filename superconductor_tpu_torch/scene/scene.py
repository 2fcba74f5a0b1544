"""Scene state on the host: vertex/index mega-buffers, texture pools,
materials, primitives (the port's copy of
``superconductor_tpu/scene/scene.py``, host tables only).

The whole scene is a handful of SoA numpy arrays (``.host`` of each
buffer), the material list, the texture pools with their mip descriptor
tables, and the registries of models and primitives. The reference
uploads them as jax arrays (``Scene.device_arrays()``); the port's
counterpart is ``scene/upload.py`` ``scene_to_torch``, which builds the
same dict of torch tensors from these tables.

  * vertex mega-buffers (positions/normals/uvs/lightmap_uvs), one for
    stationary and one for animated geometry (joints/weights extra);
  * one u32 index mega-buffer per vertex pool, indices rebased at insert;
  * per-triangle material ids (tri_material);
  * a material list mirroring shared_structs::MaterialSettings;
  * texture pools: a u8 RGBA texel pool for LDR material textures and an
    f16 pool for HDR (IBL cubemap, light volumes, lightmaps), each with a
    mip descriptor table, plus the per-texel neighbour table the
    quad-packed pools are gathered with.

Primitives keep the reference's grouping by BlendMode x FaceSides and
MSFT_lod chains.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .buffers import AllocatedArray, GrowableArray

log = logging.getLogger(__name__)


def _identity_similarity():
    from ..math3d import Similarity

    return Similarity()


# Blend modes (pass order: opaque -> alpha_clipped -> ... -> alpha_blended,
# rendering.rs:506-558).
BLEND_OPAQUE = 0
BLEND_ALPHA_CLIPPED = 1
BLEND_ALPHA_BLENDED = 2

# Material flags
MAT_UNLIT = 1 << 0
MAT_DOUBLE_SIDED = 1 << 1

# Texture wrap modes
WRAP_REPEAT = 0
WRAP_CLAMP = 1

# Fixed dummy texture ids in the LDR pool (colors from
# texture_loading.rs:166-189).
TEX_DUMMY_WHITE = 0  # albedo/emissive dummy (sRGB white)
TEX_DUMMY_NORMAL = 1  # flat normal map
TEX_DUMMY_MR = 2  # metallic-roughness dummy

# Texture color-space flags
TEXFLAG_SRGB = 1 << 0


class TexturePool:
    """Flat texel pool + mip descriptor table for gather-based sampling.

    Each texture is a chain of mip levels; level L is a row-major (h, w)
    block of RGBA texels starting at ``mip_offset[base + L]``. The pools are
    deliberately 1-D (N, 4): texel addresses are computed in the shader ops
    as ``offset + ty * w + tx`` and fetched with a single gather, the only
    TPU-friendly random-access primitive.
    """

    def __init__(self, dtype=np.uint8):
        # Range-allocated so freed textures return their texels to the pool
        # (the reference range-allocs its mega-buffers the same way).
        self.texels = AllocatedArray((4,), dtype, initial_capacity=4096)
        # Per-texel [right, down, diag] neighbor indices (wrap baked in at
        # allocate time) — feeds the quad-packed (N, 16) pool
        # (scene/upload.py quad_pool)
        # that makes a bilinear tap ONE gather instead of four
        # (ops/texture.py sample_bilinear_level). Stale rows of freed
        # ranges are harmless: they keep indexing in-bounds pool texels,
        # and reallocation rewrites them.
        self.nbr = GrowableArray((3,), np.int32, initial_capacity=4096)
        # Compressed source bytes behind this pool's content (loaders add
        # the wire size of each texture they decode) — feeds
        # Scene.texture_memory_report()'s expansion factor.
        self.source_bytes: int = 0
        self.mip_offset: List[int] = []
        self.mip_w: List[int] = []
        self.mip_h: List[int] = []
        self.tex_mip_base: List[int] = []
        self.tex_mip_count: List[int] = []
        self.tex_wrap: List[int] = []
        self.tex_flags: List[int] = []
        # Streaming view: while a texture is in its preview phase only some
        # of its mips are visible to the sampler; maps tex_id -> the full
        # (base, count) to restore (see set_mip_view).
        self._full_view: Dict[int, Tuple[int, int]] = {}
        self._freed: set = set()

    @property
    def num_textures(self) -> int:
        return len(self.tex_mip_base)

    def add_texture(
        self,
        levels: List[np.ndarray],
        wrap: int = WRAP_REPEAT,
        flags: int = 0,
    ) -> int:
        """Add a texture from its mip chain (finest first), each (h, w, 4)."""
        tex_id = self.allocate_texture(
            [lvl.shape[:2] for lvl in levels], wrap=wrap, flags=flags
        )
        for i, lvl in enumerate(levels):
            self.write_level(tex_id, i, lvl)
        return tex_id

    def allocate_texture(
        self,
        level_dims: List[Tuple[int, int]],
        wrap: int = WRAP_REPEAT,
        flags: int = 0,
    ) -> int:
        """Allocate a texture's full mip layout (dims finest-first, each
        (h, w)) without content — the streaming path allocates the final
        layout up front so the hot-swap is an in-place write, never a second
        allocation (MutableBindGroup swap semantics)."""
        tex_id = self.num_textures
        self.tex_mip_base.append(len(self.mip_offset))
        self.tex_mip_count.append(len(level_dims))
        self.tex_wrap.append(wrap)
        self.tex_flags.append(flags)
        for h, w in level_dims:
            offset = self.texels.insert_zeros(h * w)
            self.mip_offset.append(offset)
            self.mip_w.append(w)
            self.mip_h.append(h)
            self._write_nbr_level(offset, h, w, wrap)
        return tex_id

    def _write_nbr_level(self, offset: int, h: int, w: int, wrap: int) -> None:
        """Bake one level's [right, down, diag] neighbor indices (with the
        texture's wrap mode applied) into the nbr table."""
        x = np.arange(w, dtype=np.int32)
        y = np.arange(h, dtype=np.int32)
        if wrap == WRAP_REPEAT:
            xr = (x + 1) % w
            yd = (y + 1) % h
        else:
            xr = np.minimum(x + 1, w - 1)
            yd = np.minimum(y + 1, h - 1)
        row = offset + y[:, None] * w  # (h, 1)
        row_d = offset + yd[:, None] * w
        nbr = np.empty((h, w, 3), np.int32)
        nbr[:, :, 0] = row + xr[None, :]  # right
        nbr[:, :, 1] = row_d + x[None, :]  # down
        nbr[:, :, 2] = row_d + xr[None, :]  # diag
        self.nbr.write(offset, nbr.reshape(-1, 3))
        # keep index-alignment with the texel pool across its pow2 growth
        if self.nbr.capacity < self.texels.capacity:
            self.nbr._ensure(self.texels.capacity)

    def write_level(self, tex_id: int, level: int, image: np.ndarray) -> None:
        """Write one mip level's texels ((h, w, 4), dims must match)."""
        assert image.ndim == 3 and image.shape[2] == 4, image.shape
        base = self.tex_mip_base[tex_id]
        if tex_id in self._full_view:
            base = self._full_view[tex_id][0]
        h, w = image.shape[:2]
        assert w == self.mip_w[base + level] and h == self.mip_h[base + level], (
            (h, w), (self.mip_h[base + level], self.mip_w[base + level])
        )
        self.texels.array.write(self.mip_offset[base + level], image.reshape(-1, 4))

    def set_mip_view(self, tex_id: int, first_level: int, count: int) -> None:
        """Restrict sampling to [first_level, first_level+count) of the full
        chain — the preview phase exposes only the smallest mip while the
        rest streams in (create_texture_with_first_mip_data analog,
        textures.rs:526-575)."""
        if tex_id not in self._full_view:
            self._full_view[tex_id] = (
                self.tex_mip_base[tex_id],
                self.tex_mip_count[tex_id],
            )
        base, full_count = self._full_view[tex_id]
        assert 0 <= first_level and first_level + count <= full_count
        self.tex_mip_base[tex_id] = base + first_level
        self.tex_mip_count[tex_id] = count

    def restore_mip_view(self, tex_id: int) -> None:
        """Expose the full mip chain again (streaming finished)."""
        if tex_id in self._full_view:
            base, count = self._full_view.pop(tex_id)
            self.tex_mip_base[tex_id] = base
            self.tex_mip_count[tex_id] = count

    def free_texture(self, tex_id: int) -> None:
        """Return a texture's texel ranges to the pool allocator. The
        descriptor slot stays (ids are stable); sampling it yields the first
        pool texel — callers must rebind materials first."""
        if tex_id in self._freed:
            return
        self.restore_mip_view(tex_id)
        base = self.tex_mip_base[tex_id]
        for i in range(self.tex_mip_count[tex_id]):
            self.texels.remove(
                self.mip_offset[base + i],
                self.mip_w[base + i] * self.mip_h[base + i],
            )
        # Repoint the descriptor at a safe 1x1 view of pool texel 0 (leaving
        # count=0 would make level clamping index the PREVIOUS texture's
        # descriptor rows — a still-bound material would sample a neighbor)
        self._freed.add(tex_id)
        self.mip_offset[base] = 0
        self.mip_w[base] = 1
        self.mip_h[base] = 1
        self.tex_mip_count[tex_id] = 1

    def replace_texture(self, tex_id: int, levels: List[np.ndarray]) -> None:
        """Hot-swap texture content (same mip layout) — the analog of
        MutableBindGroup entry swapping as async loads finish."""
        assert len(levels) == self.tex_mip_count[tex_id]
        for i, lvl in enumerate(levels):
            self.write_level(tex_id, i, lvl)

    def descriptor_arrays(self) -> Dict[str, np.ndarray]:
        n = max(1, len(self.mip_offset))
        t = max(1, self.num_textures)
        d = {
            "mip_offset": np.asarray(self.mip_offset + [0] * (n - len(self.mip_offset)), np.int32),
            "mip_w": np.asarray(self.mip_w + [1] * (n - len(self.mip_w)), np.int32),
            "mip_h": np.asarray(self.mip_h + [1] * (n - len(self.mip_h)), np.int32),
            "tex_mip_base": np.asarray(self.tex_mip_base + [0] * (t - self.num_textures), np.int32),
            "tex_mip_count": np.asarray(self.tex_mip_count + [1] * (t - self.num_textures), np.int32),
            "tex_wrap": np.asarray(self.tex_wrap + [0] * (t - self.num_textures), np.int32),
            "tex_flags": np.asarray(self.tex_flags + [0] * (t - self.num_textures), np.int32),
        }
        # Packed rows: per-SAMPLE descriptor fetches are gather-lane-bound
        # like the texel taps themselves (a trilinear sample was 7 scalar
        # descriptor gathers vs 2 texel gathers on the quad path) — one
        # (T, 4) row and one (L, 4) row replace them (ops/texture.py).
        d["tex_meta"] = np.stack(
            [d["tex_mip_base"], d["tex_mip_count"], d["tex_wrap"],
             d["tex_flags"]], axis=-1,
        )
        d["mip_owh"] = np.stack(
            [d["mip_offset"], d["mip_w"], d["mip_h"],
             np.zeros_like(d["mip_offset"])], axis=-1,
        )
        # Trilinear pair rows: entry E carries its own (offset, w, h) AND
        # the next mip's (within-chain clamped: the last entry pairs with
        # itself), so a trilinear sample fetches ONE descriptor row for
        # both levels (ops/texture.py sample_trilinear fused path).
        # Safe under streaming mip views: views are suffixes of the full
        # chain (smallest-mip-first), so the baked next-entry is always
        # inside the visible view.
        owh2 = np.zeros((n, 8), np.int32)
        owh2[:, 0:4] = d["mip_owh"]
        owh2[:, 4:8] = d["mip_owh"]  # default: pair with self (padding rows)
        for t in range(self.num_textures):
            base, count = self.tex_mip_base[t], self.tex_mip_count[t]
            if t in self._full_view:
                base, count = self._full_view[t]
            if count > 1:
                owh2[base : base + count - 1, 4:8] = d["mip_owh"][
                    base + 1 : base + count
                ]
        d["mip_owh2"] = owh2
        return d

def mip_skip_for_max_size(h: int, w: int, max_size: Optional[int]) -> int:
    """Number of leading mip levels to drop so the finest kept level fits in
    max_size (downscaling_for_max_size, textures.rs:609-614 — log2 of the
    larger axis minus log2 of the limit, saturating at 0). The TPU pool has
    no hardware dimension limit; this caps pool HBM the way the reference
    caps to ``device.limits().max_texture_dimension_2d``.

    Reference-parity looseness (kept bug-for-bug): floor-log2 difference
    means a NON-pow2 texture can keep one level slightly above max_size
    (e.g. 1000px with cap 512 gives skip 0). max_texture_size is a soft
    HBM bound, not a hard limit, so this overshoot (< 2x on one level) is
    accepted for parity with the reference's hardware-limit path."""
    if not max_size:
        return 0
    size = max(h, w)
    return max(0, int(np.floor(np.log2(size))) - int(np.floor(np.log2(max_size))))


def build_mip_chain(image: np.ndarray, max_levels: int = 16) -> List[np.ndarray]:
    """Box-filter mip pyramid down to 1x1 (the reference generates mips via a
    GPU blit chain, textures.rs:357-522; a box filter is equivalent for the
    power-of-two case and close enough otherwise)."""
    levels = [image]
    cur = image.astype(np.float32)
    while (cur.shape[0] > 1 or cur.shape[1] > 1) and len(levels) < max_levels:
        h, w = cur.shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        trimmed = cur[: nh * 2, : nw * 2] if (h > 1 and w > 1) else cur[:nh * 2, :nw * 2]
        if h > 1 and w > 1:
            down = trimmed.reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3))
        elif h > 1:
            down = trimmed.reshape(nh, 2, 1, 1, 4).mean(axis=1).reshape(nh, 1, 4)
        else:
            down = trimmed.reshape(1, 1, nw, 2, 4).mean(axis=3).reshape(1, nw, 4)
        cur = down
        levels.append(
            np.clip(np.round(down), 0, 255).astype(np.uint8)
            if image.dtype == np.uint8
            else down.astype(image.dtype)
        )
    return levels


@dataclass
class MaterialSettings:
    """Host-side mirror of shared_structs::MaterialSettings (lib.rs:238-283)
    plus the texture bindings that the reference keeps in the bind group."""

    base_color_factor: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    emissive_factor: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    normal_map_scale: float = 1.0
    uv_offset: Tuple[float, float] = (0.0, 0.0)
    uv_scale: Tuple[float, float] = (1.0, 1.0)
    uv_rotation: float = 0.0
    flags: int = 0
    alpha_cutoff: float = 0.5
    blend_mode: int = BLEND_OPAQUE
    albedo_tex: int = TEX_DUMMY_WHITE
    normal_tex: int = TEX_DUMMY_NORMAL
    metallic_roughness_tex: int = TEX_DUMMY_MR
    emissive_tex: int = TEX_DUMMY_WHITE


@dataclass
class PrimitiveLod:
    """One LOD of a primitive: index + vertex ranges + lightmap flag (the
    reference's PrimitiveLod, models.rs:694-708; the vertex range feeds the
    shared post-transform vertex stage)."""

    first_index: int
    index_count: int
    lightmapped: bool = False
    first_vertex: int = 0
    vertex_count: int = 0


@dataclass
class Primitive:
    material: int
    blend_mode: int
    double_sided: bool
    animated: bool
    # LOD chains: lods[0] is the highest detail; screen-coverage thresholds
    # select among them (MSFT_lod + MSFT_screencoverage, models.rs:306-338).
    lods: List[PrimitiveLod] = field(default_factory=list)
    lod_coverages: List[float] = field(default_factory=list)
    # bounding sphere radius around the origin of model space, as the
    # reference computes (culling.rs:363-379), and box for SAT culling.
    bounding_sphere_radius: float = 0.0
    bbox_min: np.ndarray = None
    bbox_max: np.ndarray = None
    # node global transform, composed with the instance transform per frame
    # (Similarity; identity unless the loader sets it)
    transform: "Similarity" = field(default_factory=lambda: _identity_similarity())


@dataclass
class Model:
    primitives: List[Primitive]
    animated: bool = False
    # Animation data (animated models only)
    animations: list = None
    depth_first_nodes: object = None
    initial_local_transforms: list = None
    joint_node_indices: np.ndarray = None
    inverse_bind8: np.ndarray = None
    num_joints: int = 0
    bounding_sphere_radius: float = 0.0

    def invalidate_frame_cache(self) -> None:
        """Drop the per-model draw-build SoA cache
        (render/draws._model_frame_arrays). Call after mutating
        ``primitives`` (LODs, materials, radii, transforms) post-load —
        the cache is keyed on identity, so edits are otherwise invisible
        to subsequent frames."""
        self.__dict__.pop("_frame_arrays", None)


class Scene:
    """The whole renderable world as SoA arrays + host-side registries."""

    def __init__(self):
        # Optional texture dimension cap (mip_skip_for_max_size); None =
        # unlimited. Applied by the synchronous texture-load paths; the
        # async TextureStreamer takes its own ctor copy.
        self.max_texture_size: Optional[int] = None
        # Stationary vertex mega-buffers (single allocator: positions,
        # normals, uvs, lightmap_uvs always allocated together, mirroring
        # VertexBuffers, buffers.rs:284-468).
        self.positions = AllocatedArray((3,), np.float32, 4096)
        self.normals = AllocatedArray((3,), np.float32, 4096)
        self.uvs = AllocatedArray((2,), np.float32, 4096)
        self.lightmap_uvs = AllocatedArray((2,), np.float32, 4096)

        # Animated vertex mega-buffers (+ joints, AnimatedVertexBuffers,
        # buffers.rs:510-728).
        self.anim_positions = AllocatedArray((3,), np.float32, 1024)
        self.anim_normals = AllocatedArray((3,), np.float32, 1024)
        self.anim_uvs = AllocatedArray((2,), np.float32, 1024)
        self.anim_joint_indices = AllocatedArray((4,), np.int32, 1024)
        self.anim_joint_weights = AllocatedArray((4,), np.float32, 1024)

        # Index mega-buffers (u32, rebased on insert; one per vertex pool).
        self.indices = AllocatedArray((), np.uint32, 8192)
        self.anim_indices = AllocatedArray((), np.uint32, 2048)

        # Per-triangle material id, parallel to indices/3.
        self.tri_material = AllocatedArray((), np.int32, 4096)
        self.anim_tri_material = AllocatedArray((), np.int32, 1024)

        # Texture pools. HDR is f16: the gather upcasts to f32 before any
        # shading math, and every HDR source here (BC6H, RGBA16F KTX2, SH
        # volumes) has <= f16 precision to begin with.
        self.textures = TexturePool(np.uint8)
        self.textures_hdr = TexturePool(np.float16)
        # Publish quad-packed (N, 16) pools alongside the flat ones so a
        # bilinear tap is one gather instead of four (upload.quad_pool). Costs
        # 4x pool HBM (+ the i32 neighbor table); disable to trade the
        # shade speed back for memory (texture_memory_report shows both).
        self.quad_pools: bool = True
        # Publish the material-interleaved quad pool when the scene
        # qualifies (see matq_plan): the deferred shade's four texture
        # samples collapse to ONE gather per mip level. Costs 64 B per
        # interleaved texel; first rung of the budget degrade ladder.
        # SC_MATQ=0 disables it process-wide (A/B experiments).
        import os as _os

        self.matq_pools: bool = _os.environ.get("SC_MATQ", "1") != "0"
        # Wide interleaved rows (208 B): level-L quad + level-(L+1) 3x3
        # per slot, so a full trilinear sample of all four textures is
        # ONE gather. OFF by default: the standalone gather probe favors
        # wide rows (docs/TIMING.md), but the fused headline frame
        # measured SLOWER with them (90.6 vs 72.1 ms, 2026-08-19 —
        # docs/KERNELS.md "Rejected after measurement"); the in-register
        # 3x3 select ladders and the 3.25x row materialization lose to
        # the second 64 B gather. Kept as a knob (SC_MATQ3=1): it also
        # needs clean halving chains (matq_plan mq3_ok).
        self.matq3x3: bool = _os.environ.get("SC_MATQ3", "0") == "1"
        # Device texture residency budget (bytes) over texel pools +
        # quad pools + SH-interleaved pools. None = unlimited. When a
        # publish would exceed it, enforce_texture_budget() degrades
        # instead of OOMing: first drop the quad/SH speed pools (pure
        # perf trade, shading falls back to flat-pool taps), then shrink
        # max_texture_size so future loads downscale — the reference's
        # downscaling_for_max_size response to device limits
        # (textures.rs:609-614). Already-resident texels are never
        # evicted (matching the reference, which has no eviction either).
        self.texture_budget_bytes: Optional[int] = None
        self._budget_state: dict = {
            "quad_dropped": False, "matq_dropped": False,
            "mq3_dropped": False, "max_size_set": None,
        }
        self._add_dummy_textures()

        # Materials.
        self.materials: List[MaterialSettings] = []

        # Models / primitives registry (host side).
        self.models: Dict[str, Model] = {}

        # Environment: IBL cubemap (6 consecutive HDR textures starting at
        # this id), SH lightvol (4 HDR textures, 3D as stacked layers),
        # lightmaps, smoke textures.
        self.ibl_cubemap_base: int = -1
        self.lightvol: Optional[dict] = None  # {tex_ids: [4], z_layers, bottom_left, scale}
        self.lightmap_tex: Optional[List[int]] = None  # [l0, lx, ly, lz]
        self.smoke_tex: Tuple[int, int, int] = (-1, -1, -1)  # smoke_a, smoke_b, lut

    # ------------------------------------------------------------------
    def _add_dummy_textures(self):
        white = np.full((1, 1, 4), 255, np.uint8)
        normal = np.array([[[127, 127, 255, 255]]], np.uint8)
        mr = np.array([[[0, 255, 255, 255]]], np.uint8)
        assert self.textures.add_texture([white], flags=TEXFLAG_SRGB) == TEX_DUMMY_WHITE
        assert self.textures.add_texture([normal]) == TEX_DUMMY_NORMAL
        assert self.textures.add_texture([mr]) == TEX_DUMMY_MR

    def add_material(self, settings: MaterialSettings) -> int:
        self.materials.append(settings)
        return len(self.materials) - 1

    def material_arrays(self) -> Dict[str, np.ndarray]:
        """Pack materials as SoA numpy arrays for the shading pass."""
        mats = self.materials or [MaterialSettings()]
        return {
            "base_color_factor": np.array([m.base_color_factor for m in mats], np.float32),
            "emissive_factor": np.array([m.emissive_factor for m in mats], np.float32),
            "metallic_factor": np.array([m.metallic_factor for m in mats], np.float32),
            "roughness_factor": np.array([m.roughness_factor for m in mats], np.float32),
            "normal_map_scale": np.array([m.normal_map_scale for m in mats], np.float32),
            "uv_offset": np.array([m.uv_offset for m in mats], np.float32),
            "uv_scale": np.array([m.uv_scale for m in mats], np.float32),
            "uv_rotation": np.array([m.uv_rotation for m in mats], np.float32),
            "flags": np.array([m.flags for m in mats], np.int32),
            "blend_mode": np.array([m.blend_mode for m in mats], np.int32),
            "alpha_cutoff": np.array([m.alpha_cutoff for m in mats], np.float32),
            "albedo_tex": np.array([m.albedo_tex for m in mats], np.int32),
            "normal_tex": np.array([m.normal_tex for m in mats], np.int32),
            "mr_tex": np.array([m.metallic_roughness_tex for m in mats], np.int32),
            "emissive_tex": np.array([m.emissive_tex for m in mats], np.int32),
            # Packed per-pixel shading rows (ops/shade.py): one f32 gather
            # + one i32 gather replace ~12 scalar-field gathers per pixel —
            # per-lane descriptor fetches cost like texel taps on the TPU.
            # Layout: packed_f = [base_color_factor(4), emissive_factor(3),
            # metallic_factor, roughness_factor, normal_map_scale,
            # alpha_cutoff, pad]; packed_i = [albedo_tex, normal_tex,
            # mr_tex, emissive_tex, flags, blend_mode, pad, pad].
            "packed_f": np.concatenate(
                [
                    np.array([m.base_color_factor for m in mats], np.float32),
                    np.array([m.emissive_factor for m in mats], np.float32),
                    np.array(
                        [
                            (
                                m.metallic_factor,
                                m.roughness_factor,
                                m.normal_map_scale,
                                m.alpha_cutoff,
                                0.0,
                            )
                            for m in mats
                        ],
                        np.float32,
                    ),
                ],
                axis=-1,
            ),
            "packed_i": np.array(
                [
                    (
                        m.albedo_tex,
                        m.normal_tex,
                        m.metallic_roughness_tex,
                        m.emissive_tex,
                        m.flags,
                        m.blend_mode,
                        0,
                        0,
                    )
                    for m in mats
                ],
                np.int32,
            ),
        }

    # ------------------------------------------------------------------
    def insert_static_mesh(
        self,
        positions: np.ndarray,
        normals: np.ndarray,
        uvs: np.ndarray,
        lightmap_uvs: np.ndarray,
        indices: np.ndarray,
        material: int,
    ) -> Tuple[int, int, int, int]:
        """Insert one primitive; returns (first_index, index_count,
        first_vertex, vertex_count).

        Indices are rebased by the vertex range start so the frame kernels
        index the mega-buffer directly (models.rs:405-436 does the same).
        """
        n = len(positions)
        vstart = self.positions.insert(positions)
        self.normals.insert(normals)
        self.uvs.insert(uvs)
        self.lightmap_uvs.insert(lightmap_uvs)
        rebased = (np.asarray(indices, np.uint32) + np.uint32(vstart)).astype(np.uint32)
        istart = self.indices.insert(rebased)
        tri_start = istart // 3
        assert istart % 3 == 0
        self.tri_material.array.write(
            tri_start, np.full(len(rebased) // 3, material, np.int32)
        )
        return istart, len(rebased), vstart, n

    def insert_animated_mesh(
        self,
        positions,
        normals,
        uvs,
        joint_indices,
        joint_weights,
        indices,
        material: int,
    ) -> Tuple[int, int, int, int]:
        vstart = self.anim_positions.insert(positions)
        self.anim_normals.insert(normals)
        self.anim_uvs.insert(uvs)
        self.anim_joint_indices.insert(np.asarray(joint_indices, np.int32))
        self.anim_joint_weights.insert(np.asarray(joint_weights, np.float32))
        rebased = (np.asarray(indices, np.uint32) + np.uint32(vstart)).astype(np.uint32)
        istart = self.anim_indices.insert(rebased)
        self.anim_tri_material.array.write(
            istart // 3, np.full(len(rebased) // 3, material, np.int32)
        )
        return istart, len(rebased), vstart, len(positions)

    # ------------------------------------------------------------------
    def texture_memory_report(self) -> dict:
        """Pool residency vs compressed source bytes.

        The reference keeps BC7/ASTC/BC6H compressed in GPU memory
        (passthrough upload + transcode priority, textures.rs:929-1153 —
        chosen precisely to stay near 1 byte/texel). TPUs cannot sample
        block-compressed memory, so this build decodes at load into flat
        pools; this report keeps that expansion measured: u8 LDR = 4 B and
        f16 HDR = 8 B per texel vs the compressed wire size."""

        def pool(p: TexturePool) -> dict:
            arr = p.texels.array
            itemsize = arr.host.dtype.itemsize * 4  # RGBA
            used = p.texels.alloc.used()
            quad_bytes = 0
            if self.quad_pools:
                # quad pool (4x texels) + i32 neighbor table (12 B/texel),
                # both at pool capacity (device-resident derived arrays)
                quad_bytes = arr.capacity * (itemsize * 4 + 12)
            return {
                "texel_bytes_used": used * itemsize,
                "texel_bytes_capacity": arr.capacity * itemsize,
                "quad_pool_bytes": quad_bytes,
                "source_bytes": p.source_bytes,
                "expansion": (used * itemsize / p.source_bytes)
                if p.source_bytes
                else None,
                "num_textures": p.num_textures,
            }

        report = {"ldr": pool(self.textures), "hdr": pool(self.textures_hdr)}
        report["sh_pool_bytes"] = self._sh_pool_bytes()
        report["matq_pool_bytes"] = self.matq_bytes()
        report["total_device_bytes"] = self.projected_texture_bytes()
        report["budget_bytes"] = self.texture_budget_bytes
        if self.texture_budget_bytes:
            report["over_budget"] = (
                report["total_device_bytes"] > self.texture_budget_bytes
            )
            report["degrade"] = dict(self._budget_state)
        return report

    def _sh_pool_bytes(self) -> int:
        """Bytes of the SH-interleaved lightvol/lightmap pools if
        published ((w*h*z, 48) f16 each, device_lightvol_sh)."""
        if not self.quad_pools:
            return 0
        total = 0
        if self.lightvol is not None:
            w, h, z = self.lightvol_dims()
            total += w * h * z * 48 * 2
        if self.lightmap_tex is not None:
            w, h = self.lightmap_dims()
            total += w * h * 48 * 2
        return total

    def projected_texture_bytes(self, quad: Optional[bool] = None) -> int:
        """Device texture residency if published now: texel pools at
        capacity (the device buffer is capacity-sized) + quad pools +
        SH-interleaved pools. `quad` overrides self.quad_pools for
        what-if sizing."""
        use_quad = self.quad_pools if quad is None else quad
        total = 0
        for p in (self.textures, self.textures_hdr):
            itemsize = p.texels.array.host.dtype.itemsize * 4
            cap = p.texels.array.capacity
            total += cap * itemsize
            if use_quad:
                total += cap * (itemsize * 4 + 12)
        if use_quad:
            total += self.matq_bytes()
        if use_quad and self.lightvol is not None:
            w, h, z = self.lightvol_dims()
            total += w * h * z * 48 * 2
        if use_quad and self.lightmap_tex is not None:
            w, h = self.lightmap_dims()
            total += w * h * 48 * 2
        return total

    def enforce_texture_budget(self) -> None:
        """Degrade ladder for texture_budget_bytes (never OOM silently):

        1. Drop the quad-packed + SH-interleaved speed pools (a pure
           perf trade — every sampler falls back to flat-pool taps,
           ops/texture.py:28, ops/shade.py:295).
        2. Still over: shrink max_texture_size to half the largest
           resident texture dimension so FUTURE loads downscale
           (mip_skip_for_max_size — the downscaling_for_max_size analog,
           textures.rs:609-614). Resident texels are not evicted; the
           remaining excess is logged once.

        Idempotent and cheap; called by scene/upload.py scene_to_torch
        when a budget is set."""
        budget = self.texture_budget_bytes
        if not budget:
            return
        if self.projected_texture_bytes() <= budget:
            return
        if self.matq3x3 and self.matq_bytes():
            log.warning(
                "texture budget %.1f MB exceeded (%.1f MB projected): "
                "dropping the wide (208 B) interleaved rows (two-gather "
                "64 B interleaved sampling)",
                budget / 1e6, self.projected_texture_bytes() / 1e6,
            )
            self.matq3x3 = False
            self._budget_state["mq3_dropped"] = True
        if self.projected_texture_bytes() <= budget:
            return
        if self.matq_pools and self.matq_bytes():
            log.warning(
                "texture budget %.1f MB exceeded (%.1f MB projected): "
                "dropping the interleaved material pool (per-slot "
                "quad-pool sampling)",
                budget / 1e6, self.projected_texture_bytes() / 1e6,
            )
            self.matq_pools = False
            self._budget_state["matq_dropped"] = True
        if self.projected_texture_bytes() <= budget:
            return
        if self.quad_pools:
            log.warning(
                "texture budget %.1f MB exceeded (%.1f MB projected): "
                "dropping quad/SH speed pools (flat-pool sampling)",
                budget / 1e6, self.projected_texture_bytes() / 1e6,
            )
            self.quad_pools = False
            self._budget_state["quad_dropped"] = True
        if self.projected_texture_bytes() <= budget:
            return
        largest = 0
        for p in (self.textures, self.textures_hdr):
            for t in range(p.num_textures):
                base = p.tex_mip_base[t]
                largest = max(largest, p.mip_w[base], p.mip_h[base])
        new_max = max(64, largest // 2) if largest else 64
        if self._budget_state["max_size_set"] != new_max:
            log.warning(
                "texture budget still exceeded (%.1f > %.1f MB) with flat "
                "pools; capping future loads at max_texture_size=%d "
                "(resident texels are not evicted)",
                self.projected_texture_bytes() / 1e6, budget / 1e6, new_max,
            )
            self.max_texture_size = new_max
            self._budget_state["max_size_set"] = new_max

    # ------------------------------------------------------------------
    # Interleaved material pool ("matq"): ONE gather fetches the 2x2
    # bilinear footprints of ALL FOUR material textures of a pixel.
    # ------------------------------------------------------------------
    def matq_plan(self) -> Optional[dict]:
        """Plan the material-interleaved quad pool, or None if the scene
        can't use it.

        The deferred shade's four material samples (albedo, normal, mr,
        emissive) always share the SAME uv and, when the four textures
        have identical per-level dimensions, the same footprint and mip
        level — so their texel fetches can ride ONE wide row: pool row i
        carries four quad footprints, 64 u8 channels (the stage is
        gather-ROW-bound and row width is nearly free, docs/TIMING.md).
        Real authored PBR sets ship uniform texture sizes (DamagedHelmet:
        2048^2 across all slots), so the common case qualifies.

        Capability per material: every non-constant slot has the same
        FULL-chain mip dims, count, and wrap mode; 1x1 single-level slots
        (the dummy textures, freed textures) count as constant and are
        broadcast-baked. One incapable material disables the pool for
        the whole scene (per-pixel path divergence would cost both
        paths), falling back to the classic per-slot sampling. Full
        chains (not streaming mip views) size the layout so the row
        width — and therefore the compiled frame program — is stable;
        scene/upload.py matq_tables additionally withholds the pool while any slot is
        mid-stream (set_mip_view active), so streaming scenes shade on
        the classic path and flip to matq once content settles (one
        recompile, same class of event as capacity growth).
        """
        pool = self.textures
        mats = self.materials or [MaterialSettings()]
        chains: Dict[tuple, int] = {}  # slot-id tuple -> chain index
        chain_specs = []  # per chain: (slot_ids, levels [(h, w)], wrap)
        mat_chain = []

        def viewed(t):
            if t in pool._full_view:
                return pool._full_view[t]
            return pool.tex_mip_base[t], pool.tex_mip_count[t]

        def is_const(t):
            base, count = viewed(t)
            return count == 1 and pool.mip_w[base] == 1 and pool.mip_h[base] == 1

        # Per-material capability (round 5): an incapable material no
        # longer disables the pool for the whole scene — its lanes are
        # routed to the classic sampler by the material-path partition
        # (render/frame.py _partition_material_sample) while capable
        # materials' lanes keep the interleaved fast path. mat_chain[i]
        # is -1 for incapable materials; their mat_row_mq rows carry real
        # pf/pi but a count=0 sentinel.
        mat_capable = []
        for m in mats:
            ids = (m.albedo_tex, m.normal_tex,
                   m.metallic_roughness_tex, m.emissive_tex)
            if ids in chains:
                mat_chain.append(chains[ids])
                mat_capable.append(chains[ids] >= 0)
                continue
            real = [t for t in ids if not is_const(t)]
            capable = True
            if real:
                b0, c0 = viewed(real[0])
                dims = [(pool.mip_h[b0 + l], pool.mip_w[b0 + l])
                        for l in range(c0)]
                wrap = pool.tex_wrap[real[0]]
                for t in real[1:]:
                    b, c = viewed(t)
                    if c != c0 or pool.tex_wrap[t] != wrap:
                        capable = False
                        break
                    if any((pool.mip_h[b + l], pool.mip_w[b + l]) != dims[l]
                           for l in range(c)):
                        capable = False
                        break
            else:
                dims = [(1, 1)]
                wrap = WRAP_REPEAT
            if not capable:
                chains[ids] = -1
                mat_chain.append(-1)
                mat_capable.append(False)
                continue
            chains[ids] = len(chain_specs)
            chain_specs.append((ids, dims, wrap))
            mat_chain.append(chains[ids])
            mat_capable.append(True)
        if not chain_specs:
            return None

        # Layout: chains laid out sequentially, finest level first.
        offsets = []  # per chain: [row offset per level]
        total = 0
        for _, dims, _ in chain_specs:
            offs = []
            for h, w in dims:
                offs.append(total)
                total += h * w
            offsets.append(offs)
        L = max(len(dims) for _, dims, _ in chain_specs)

        srgb_masks = []
        for ids, _, _ in chain_specs:
            mask = 0
            for s, t in enumerate(ids):
                if pool.tex_flags[t] & TEXFLAG_SRGB:
                    mask |= 1 << s
            srgb_masks.append(mask)

        # mq3 (single-gather trilinear) additionally requires clean
        # halving chains: level l+1 dims exactly half of EVEN level-l
        # dims (or 1) — the in-register level-(l+1) footprint selection
        # relies on floor(x/2) grid correspondence (ops/texture.py
        # sample_material_interleaved, mq3 path). Pow2 textures qualify.
        def halves(dims):
            for (h, w), (h2, w2) in zip(dims, dims[1:]):
                for a, b in ((h, h2), (w, w2)):
                    if not (a == 1 and b == 1 or a % 2 == 0 and b == a // 2):
                        return False
            return True

        mq3_ok = all(halves(dims) for _, dims, _ in chain_specs)

        # Tail layout: the trilinear SECOND level is always >= 1 (clamped
        # to the chain end), so its rows can live in a dedicated pool a
        # quarter the size of the main one — and gather rate is set by
        # TABLE size, not working set (docs/TIMING.md gather
        # characterization: 1 MB tables gather ~8x faster than 512 MB).
        # Single-level chains duplicate their level 0 into the tail (the
        # clamp lands there); level-0 entries of multi-level chains are -1
        # (never fetched from the tail).
        tail_offsets = []
        tail_total = 0
        for _, dims, _ in chain_specs:
            offs = []
            start = 0 if len(dims) == 1 else 1
            for l, (h, w) in enumerate(dims):
                if l < start:
                    offs.append(-1)
                else:
                    offs.append(tail_total)
                    tail_total += h * w
            tail_offsets.append(offs)

        return {
            "chains": chain_specs, "offsets": offsets, "total_rows": total,
            "L": L, "mat_chain": mat_chain, "srgb_masks": srgb_masks,
            "mq3_ok": mq3_ok,
            "tail_offsets": tail_offsets, "tail_total": tail_total,
            "mat_capable": mat_capable,
            "partial": not all(mat_capable),
        }

    def matq_bytes(self, plan: Optional[dict] = None) -> int:
        """Device bytes of the interleaved material pool if published."""
        if not (self.quad_pools and self.matq_pools):
            return 0
        plan = plan if plan is not None else self.matq_plan()
        if not plan:
            return 0
        if self.matq3x3 and plan["mq3_ok"]:
            return plan["total_rows"] * 208
        return (plan["total_rows"] + plan["tail_total"]) * 64

    def smoke_static_dims(self):
        """(w, h, wrap_ab, lut_w, lut_h, lut_wrap, lut_flags) for
        EnvBindings.smoke_static, or None (host ints — static under
        jit)."""
        ids = getattr(self, "smoke_tex", None)
        if not ids or ids[0] < 0:
            return None
        pool = self.textures
        a, b, lut = ids
        ba, bb, bl = (pool.tex_mip_base[t] for t in (a, b, lut))
        if (pool.mip_w[ba], pool.mip_h[ba]) != (pool.mip_w[bb], pool.mip_h[bb]):
            return None
        if pool.tex_wrap[a] != pool.tex_wrap[b]:
            return None
        return (
            int(pool.mip_w[ba]), int(pool.mip_h[ba]), int(pool.tex_wrap[a]),
            int(pool.mip_w[bl]), int(pool.mip_h[bl]), int(pool.tex_wrap[lut]),
            int(pool.tex_flags[lut]),
        )

    def lightvol_dims(self):
        """(w, h, z_layers) of the SH lightvol, or None. All four volumes
        share the dims (load_lightvol loads them from one matched set)."""
        if self.lightvol is None:
            return None
        pool = self.textures_hdr
        base = pool.tex_mip_base[self.lightvol["tex_ids"][0]]
        return (pool.mip_w[base], pool.mip_h[base], self.lightvol["z_layers"])

    def lightmap_dims(self):
        """(w, h) of the SH lightmaps, or None."""
        if self.lightmap_tex is None:
            return None
        pool = self.textures_hdr
        base = pool.tex_mip_base[self.lightmap_tex[0]]
        return (pool.mip_w[base], pool.mip_h[base])
