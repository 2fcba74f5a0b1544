"""The frame function: scene tables + FrameState -> (V, H, W, 4) u8 image
and the capacity-stats dict (port of ``superconductor_tpu/render/frame.py``).

The ported slice, in the reference's pass order: merged static + animated
geometry (the vertex stage once a frame, the edge setup once a view), then
each view in ``row_chunks`` horizontal bands: the binned tile raster (the
CUDA kernels on a GPU, their plain versions on the CPU) in sorted-pair
mode, or with ``raster="ref"`` the brute-force raster that keeps original
pair ids, the alpha-clip resolve over a
k-buffer of clip fragments, the IBL skybox (full screen or on the sky
worklist), the opaque deferred shade on a compacted granule worklist (or
full screen), the flat-colour lines pass (the raster kernel over the
opaque depth as its init buffer), the particle composite (the k-buffer
kernel over the lines' depth), the alpha-blend composite (the k-buffer
kernel over the same floor), and the tonemap tail. Material textures are
sampled on the interleaved pool, the classic per-slot samplers, or both
through the material-path partition on partial pools; lighting comes from
the SH light volume and lightmaps (ops/shade.py) and particles from the
smoke maps (ops/particles.py). ``shade_row_pad`` pads the per-pair shade
row to a multiple of its columns and every gather slices the pad off, as
in the reference: the same frame, another row layout. PyTorch runs
eagerly, so there is no jit: ``render_frame_impl`` is a plain function,
and on a CUDA device ``render_frame`` and ``render_frame_stats`` replay it
as one CUDA graph a frame (render/frame_graph.py).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..ops.binning import bin_triangles, gather_sorted_setup
from ..ops.geometry import (
    DrawList,
    TriangleSetup,
    VertexList,
    attrs_table,
    geometry_vertex_stage_merged,
    geometry_vertex_stage_merged_plain,
    geometry_view_setup_merged,
    geometry_view_setup_merged_plain,
    setup_table,
)
from ..ops import sample as sample_ops
from ..ops import texture as texture_ops
from ..ops.lines import line_geometry
from ..ops.particles import (
    particle_geometry,
    particle_geometry_plain,
    shade_particles,
    shade_particles_plain,
)
from ..ops.raster import kbuffer_sorted, rasterize_sorted
from ..ops.raster_kbuffer import rasterize_kbuffer_ref
from ..ops.raster_ref import VisibilityBuffer, rasterize_ref
from ..ops.shade import (
    GBuffer,
    albedo_alpha,
    interpolate_gbuffer,
    sample_spherical_harmonics,
    shade,
)
from ..ops.sky import sample_skybox, sample_skybox_at
from ..ops.tonemap import to_u8, tonemap_and_encode
from ..ops.worklist import (
    worklist_compact,
    worklist_compact_plain,
    worklist_compose,
    worklist_compose_clip,
    worklist_compose_clip_plain,
    worklist_compose_plain,
)


@dataclass(frozen=True)
class RenderConfig:
    """Same field names and defaults as the reference's RenderConfig
    (render/frame.py:44-177), so configs and caps caches transfer; see
    the reference for each field's meaning."""

    width: int = 512
    height: int = 512
    t_cap: int = 1 << 14
    t_cap_anim: int = 1 << 10
    v_cap: int = 0
    v_cap_anim: int = 0
    p_cap: int = 1 << 16
    raster: str = "auto"  # 'ref' | 'pallas' | 'auto'
    reverse_z: bool = True
    flip_viewport: bool = False
    inline_tonemapping: bool = True
    inline_srgb: bool = True
    num_views: int = 1
    blend_layers: int = 4
    clip_layers: Optional[int] = None
    particle_layers: Optional[int] = None
    enable_clip: bool = False
    enable_blend: bool = False
    enable_lines: bool = False
    enable_particles: bool = False
    line_width_px: float = 1.5
    aniso_taps: int = 1
    shade_px_cap: int = 1 << 17
    shade_px_caps: Optional[tuple] = None
    clip_px_caps: Optional[tuple] = None
    opaque_px_cap: Optional[int] = None
    sky_px_cap: Optional[int] = None
    matq_classic_cap: Optional[int] = None
    shade_row_pad: int = 0
    worklist_granules: bool = True
    granule_px: int = 128
    row_chunks: int = 1
    tile_h: int = 32
    tile_w: int = 128

    def resolve_raster(self) -> str:
        """'auto' and 'pallas' select the binned tile raster (the kernel on
        CUDA tensors, its plain version on CPU tensors); 'ref' the
        brute-force raster (ops/raster_ref.py), on any device."""
        if self.raster in ("auto", "pallas"):
            return "pallas"
        if self.raster == "ref":
            return "ref"
        raise ValueError(f"unknown raster method {self.raster!r}")

    def resolve_clip_layers(self) -> int:
        return self.clip_layers or self.blend_layers

    def resolve_particle_layers(self) -> int:
        return self.particle_layers or self.blend_layers

    def layer_caps(self, k: Optional[int] = None) -> tuple:
        """Per-layer shading worklist caps, length k (default
        blend_layers): shade_px_caps padded with its last entry, or every
        layer at shade_px_cap."""
        return _per_layer(self.shade_px_caps, self.shade_px_cap, k or self.blend_layers)

    def needed_k_len(self) -> int:
        return max(self.blend_layers, self.resolve_particle_layers())

    def resolve_clip_caps(self) -> tuple:
        """Per-layer clip-resolve worklist caps, length
        resolve_clip_layers(): clip_px_caps padded, or shade_px_cap."""
        return _per_layer(self.clip_px_caps, self.shade_px_cap, self.resolve_clip_layers())


def _per_layer(caps: Optional[tuple], shared: int, k: int) -> tuple:
    cs = tuple(int(c) for c in caps or ())
    if not cs:  # None or empty: every layer at the shared cap
        return (shared,) * k
    return (cs + (cs[-1],) * (k - len(cs)))[:k]


DEFAULT_OPAQUE_PX_CAP = 1 << 17
DEFAULT_SKY_PX_CAP = 1 << 17


def size_worklist_cap(need: int, floor: int = 512) -> int:
    """Worklist capacity from a measured need: 1.125x margin rounded up to
    a sixteenth-pow2 boundary (reference render/frame.py:236)."""
    n = int(need) + (int(need) >> 3)
    if n <= floor:
        return floor
    e = max((n - 1).bit_length() - 5, 0)
    m = -(-n >> e)
    return m << e


class FrameState(NamedTuple):
    """All per-frame device inputs (torch tensors)."""

    uniforms: dict  # tensors with a leading view axis
    draws_static: DrawList
    draws_animated: DrawList
    joint_palette: torch.Tensor  # (J, 8)
    lines: Optional[dict] = None
    particles: Optional[dict] = None


def _rasterize(tri: TriangleSetup, config: RenderConfig, band_height: int,
               y_offset: int, init: Optional[VisibilityBuffer] = None):
    """Visibility raster walked from `init` (None = far, no pair) ->
    (VisibilityBuffer, pairs_needed i32, order). The binned raster works
    in sorted-pair mode: SORTED positions in .pair, and bins.order to
    gather the per-pair tables into that order. raster="ref" leaves
    original row indices in .pair, needs no bin pairs (0) and returns
    order None."""
    if config.resolve_raster() == "ref":
        vis = rasterize_ref(tri, band_height, config.width, reverse_z=config.reverse_z,
                            init=init, y_offset=y_offset)
        return vis, torch.zeros((), dtype=torch.int32, device=tri.setup.device), None
    bins = bin_triangles(
        tri, config.width, band_height, config.p_cap,
        tile_h=config.tile_h, tile_w=config.tile_w, y_offset=y_offset,
    )
    sorted_setup = gather_sorted_setup(tri, bins)
    vis = rasterize_sorted(
        sorted_setup, bins.tile_start, bins.tile_count, band_height,
        config.width, tile_h=config.tile_h, tile_w=config.tile_w,
        reverse_z=config.reverse_z, init=init, y_offset=y_offset,
    )
    return vis, bins.num_pairs, bins.order


def _rasterize_kbuffer(tri: TriangleSetup, config: RenderConfig, band_height: int,
                       y_offset: int, depth_floor: torch.Tensor,
                       want_depth: bool = True, k: Optional[int] = None):
    """K-layer raster -> (KBuffer, pairs_needed i32, layers_needed i32,
    order), in sorted-pair mode as _rasterize (raster="ref": original row
    indices, depth planes always, pairs 0, order None). layers_needed is
    the most accepted fragments any pixel saw; above k the pass dropped a
    surface and the host grows that pass's K."""
    k = k or config.blend_layers
    if config.resolve_raster() == "ref":
        kb, layers = rasterize_kbuffer_ref(
            tri, band_height, config.width, k=k, reverse_z=config.reverse_z,
            depth_floor=depth_floor, y_offset=y_offset,
        )
        return kb, torch.zeros((), dtype=torch.int32, device=tri.setup.device), layers.max(), None
    bins = bin_triangles(
        tri, config.width, band_height, config.p_cap,
        tile_h=config.tile_h, tile_w=config.tile_w, y_offset=y_offset,
    )
    sorted_setup = gather_sorted_setup(tri, bins)
    kb, layers = kbuffer_sorted(
        sorted_setup, bins.tile_start, bins.tile_count, band_height, config.width,
        k=k, tile_h=config.tile_h, tile_w=config.tile_w, reverse_z=config.reverse_z,
        depth_floor=depth_floor, y_offset=y_offset, want_depth=want_depth,
    )
    return kb, bins.num_pairs, layers.max(), bins.order


def _in_order(table: torch.Tensor, order: Optional[torch.Tensor]) -> torch.Tensor:
    """A per-pair table in the order a raster pass's pair planes index it:
    gathered into sorted order by bins.order, or as is (order None)."""
    return table if order is None else table[order]


def _worklist_granule(config: RenderConfig, npx: int) -> int:
    """Lanes per worklist granule (config.granule_px when the band shape
    divides, else 1)."""
    gr = config.granule_px
    if config.worklist_granules and config.width % gr == 0 and npx % gr == 0:
        return gr
    return 1


class _Worklist(NamedTuple):
    """A compacted shading worklist of granules (gr lanes each; gr == 1 is
    per pixel). Lanes past the cap are dropped from shading and keep the
    destination; `need` (granule-dilated pixel count) tells the host what
    cap would have sufficed."""

    idx: torch.Tensor  # (cap_g,) granule indices, sentinel n_granules
    safe: torch.Tensor  # (cap_g,) idx clamped for gathers
    live: torch.Tensor  # (cap_g,) bool
    need: torch.Tensor  # () i32
    gr: int
    npx: int

    def lane_safe(self) -> torch.Tensor:
        if self.gr == 1:
            return self.safe
        off = torch.arange(self.gr, dtype=torch.int32, device=self.safe.device)
        return (self.safe[:, None] * self.gr + off[None, :]).reshape(-1)

    def lane_live(self) -> torch.Tensor:
        if self.gr == 1:
            return self.live
        return self.live[:, None].expand(-1, self.gr).reshape(-1)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """Gather flat per-pixel data (npx,) / (npx, C) to worklist lanes,
        one granule row at a time."""
        if self.gr == 1:
            return x[self.safe]
        if x.ndim == 1:
            return x.reshape(-1, self.gr)[self.safe].reshape(-1)
        c = x.shape[-1]
        return x.reshape(-1, self.gr * c)[self.safe].reshape(-1, c)

    def compose(self, dst, rows: torch.Tensor, where: Optional[torch.Tensor] = None,
                clip: Optional[tuple] = None):
        """Write lane rows into flat per-pixel dst at the live granules, IN
        PLACE, and return dst (worklist_compose: dead lanes never write;
        with a lane mask `where`, neither do the lanes whose mask is false,
        which is composing where(where, rows, take(dst)) bit for bit). It
        consumes dst: no caller in this module reads the old dst after
        the call (the sky on its worklist, the opaque shade over the sky
        and each layer composite's rgb are all rebound to the result, and
        what they read of dst they take() before it).

        With clip=(valid, alpha, cutoff, layer_depth), one alpha-clip
        round (worklist_compose_clip): dst is the round's (found, chosen
        pair, chosen depth) planes and rows its pair lanes; a live lane
        whose pixel has no find yet and whose fragment is valid and passes
        alpha >= cutoff marks found and writes its pair and layer_depth at
        its pixel, every live lane writes found. Returns the three planes,
        written in place (the reference's round, :951-966: the takes of
        found and of the layer's depth, its masks and three composes)."""
        if clip is not None:
            found, pair, depth = dst
            valid, alpha, cutoff, layer_depth = clip
            return worklist_compose_clip(found, pair, depth, self.idx, rows, self.gr, valid,
                                         alpha, cutoff, layer_depth)
        return worklist_compose(dst, self.idx, rows, self.gr, where)


def _compact_worklist(mask: torch.Tensor, cap: int, config: RenderConfig) -> _Worklist:
    """A worklist of at most cap lanes of the flat bool mask's set pixels,
    in granules (worklist_compact: the set granules in ascending order,
    sentinel npx // gr past their count, `safe` clamped for gathers;
    reference render/frame.py:419 and :532)."""
    npx = mask.shape[0]
    gr = _worklist_granule(config, npx)
    cap_g = max(1, min(cap, npx) // gr)
    idx, safe, live, need = worklist_compact(mask, gr, cap_g)
    return _Worklist(idx, safe, live, need, gr, npx)


def _pixel_centers(config: RenderConfig, band_height: int, y_offset: int, device):
    ys = torch.arange(band_height, dtype=torch.float32, device=device) + 0.5 + y_offset
    xs = torch.arange(config.width, dtype=torch.float32, device=device) + 0.5
    px = xs[None, :].expand(band_height, config.width).reshape(-1)
    py = ys[:, None].expand(band_height, config.width).reshape(-1)
    return px, py


def _px_py_at(idx: torch.Tensor, width: int, y_offset: int):
    """Pixel centres of flat band indices, by div/mod."""
    x = torch.remainder(idx, width).to(torch.float32) + 0.5
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32) + 0.5 + y_offset
    return x, y


def _merged_vertex_stage(scene: dict, state: FrameState, config: RenderConfig):
    """View-independent geometry of both draw lists -> ((static, animated)
    VertexStage, merged packed attribute rows). The animated stage runs
    even with no valid draws, as in the reference. One merged call (two
    kernel launches on the card) writes each list's rows into the merged
    table at its own offset (static rows first): the values of the
    reference's concatenation, without a copy."""
    t_s, t_a = config.t_cap, config.t_cap_anim
    merged = attrs_table(t_s + t_a, scene["positions"].device)
    stages = geometry_vertex_stage_merged((
        VertexList(state.draws_static, scene["indices"], scene["positions"], scene["normals"],
                   scene["uvs"], scene["lightmap_uvs"], scene["tri_material"], t_s,
                   v_cap=config.v_cap or t_s),
        VertexList(state.draws_animated, scene["anim_indices"], scene["anim_positions"],
                   scene["anim_normals"], scene["anim_uvs"], None, scene["anim_tri_material"],
                   t_a, v_cap=config.v_cap_anim or t_a, joint_palette=state.joint_palette,
                   joint_indices=scene["anim_joint_indices"],
                   joint_weights=scene["anim_joint_weights"]),
    ), scene["materials"], out=merged)
    return stages, merged


def _merged_setup_for_view(stages, view_proj: torch.Tensor, config: RenderConfig):
    """Per-view clip + edge setup of both stages into one merged table,
    static rows first, num_valid their sum: one merged call (one kernel
    launch on the card)."""
    t = sum(stage.row3.shape[0] for stage in stages)
    return geometry_view_setup_merged(
        stages, view_proj, config.width, config.height, flip_viewport=config.flip_viewport,
        out=setup_table(t, stages[0].w1.device))


# The geometry kernels' wrappers as this module binds them, each with its
# plain version (the layout of bench.PLAIN_VERSIONS): kernel -> ((module,
# name, plain version),)
GEOMETRY_PLAIN_VERSIONS = {
    "vertex_stage": ((sys.modules[__name__], "geometry_vertex_stage_merged",
                      geometry_vertex_stage_merged_plain),),
    "view_setup": ((sys.modules[__name__], "geometry_view_setup_merged",
                    geometry_view_setup_merged_plain),),
}
# the worklist kernels' wrappers as this module binds them, each with its
# plain version (the same layout)
WORKLIST_PLAIN_VERSIONS = {
    "worklist_compact": ((sys.modules[__name__], "worklist_compact", worklist_compact_plain),),
    "worklist_compose": ((sys.modules[__name__], "worklist_compose", worklist_compose_plain),
                         (sys.modules[__name__], "worklist_compose_clip",
                          worklist_compose_clip_plain)),
}

# the particle kernels' wrappers as this module binds them (the same layout)
PARTICLE_PLAIN_VERSIONS = {
    "particle_shade": ((sys.modules[__name__], "shade_particles", shade_particles_plain),),
    "particle_geometry": ((sys.modules[__name__], "particle_geometry", particle_geometry_plain),),
}


def _merged_geometry(scene: dict, state: FrameState, view_proj: torch.Tensor,
                     config: RenderConfig):
    """Static + animated geometry of one view as one pair list -> (merged
    TriangleSetup, merged TriangleAttrs): the vertex stage plus this view's
    setup (reference :763; render_frame_impl runs the two halves itself so
    that views and bands share the vertex stage)."""
    stages, merged_attrs = _merged_vertex_stage(scene, state, config)
    return _merged_setup_for_view(stages, view_proj, config), merged_attrs


def _granule_count(mask: torch.Tensor, gr: int) -> torch.Tensor:
    """Covered pixel count, dilated to whole granules when gr > 1."""
    if gr > 1:
        return mask.reshape(-1, gr).any(dim=1).sum(dtype=torch.int32) * gr
    return mask.sum(dtype=torch.int32)


def _partition_material_sample(g: GBuffer, scene: dict, config: RenderConfig,
                               aniso_taps: int, slots=None):
    """Material sampling on a PARTIAL interleaved pool, each lane on its
    own material's path (reference render/frame.py:565). In the order of
    (incapable, lane) keys, the last cap_c = max(1, min(matq_classic_cap,
    lanes)) lanes form the tail segment, sampled by the classic per-slot
    sampler, and the others the head, which samples the interleaved pool.
    Incapable lanes beyond the tail spill into the head and read the
    count=0 sentinel row -- the grow signal; with fewer incapable lanes
    than cap_c, the last capable lanes by id take the tail. `slots`: the
    material slots to return (None = all four). Returns (s (lanes, 4 *
    len(slots)), classic_needed () i32).

    The reference sorts the keys, permutes the lanes' inputs into that
    order, samples the two segments, concatenates them and permutes the
    result back with a second sort: on the TPU a scatter costs about 80 ns
    a row, so it scatters nothing. On the card a scatter of a row is as
    cheap as a gather, so here each lane's place in that order comes from
    an exclusive prefix count of the incapable lanes before it (a capable
    or invalid lane at lane - before, an incapable one at the capable
    count + before), one scatter lists the lanes in that order, and each
    sampler reads its segment's lanes by id from the g-buffer and writes
    each lane's result to the lane's own row of one result: no sort, no
    permutation and no concatenation. The interleaved sampler is called
    only for a head with lanes (n_h is known from shapes; the tail has
    cap_c >= 1 lanes unless there are none at all), and each sampler's
    result is the next one's `out`."""
    m = scene["materials"]
    lanes = g.material.shape[0]
    dev = g.material.device
    capable = scene["matq_capable"][torch.clamp_min(g.material, 0).long()]
    classic_lane = (~capable) & g.valid
    classic_needed = classic_lane.sum(dtype=torch.int32)
    cap_c = max(1, min(int(config.matq_classic_cap), lanes))
    want = tuple(range(4)) if slots is None else tuple(slots)

    lane_ids = torch.arange(lanes, dtype=torch.int32, device=dev)
    classic = classic_lane.to(torch.int32)
    before = torch.cumsum(classic, 0, dtype=torch.int32) - classic
    pos = torch.where(classic_lane, (lanes - classic_needed) + before, lane_ids - before)
    order = torch.empty_like(lane_ids)
    order[pos] = lane_ids

    n_h = lanes - cap_c
    s = torch.empty((lanes, 4 * len(want)), dtype=torch.float32, device=dev)
    if n_h > 0:
        s = sample_ops.sample_material(
            scene["texels_mq"], m["mat_row_mq"], g.uv, g.duvdx, g.duvdy, aniso_taps,
            mat=g.material, slots=want, texels_tail=scene.get("texels_mq_tail"),
            lane_ids=order[:n_h], out=s,
        )
    s = sample_ops.sample_classic(texture_ops.ldr_pool(scene), m["mat_row"], g.material, g.uv,
                                  g.duvdx, g.duvdy, aniso_taps, slots=want,
                                  lane_ids=order[n_h:], out=s)
    return s, classic_needed


def _composite_layers(rgb, pair_planes, caps, needed_k, shade_fn, config):
    """Back-to-front per-layer compact -> shade -> alpha-blend (reference
    render/frame.py:652). Layer k compacts its own covered pixels into a
    worklist of caps[k] lanes, shade_fn(pair_worklist, safe, live) ->
    (rgb, alpha) shades them, and needed_k[k] takes the max of the
    layer's granule-dilated need. rgb (npx, 3); pair_planes (K, H, W),
    -1 = empty. Returns (rgb, needed_k)."""
    needed_k = needed_k.clone()
    for k in range(len(caps) - 1, -1, -1):
        mask_k = (pair_planes[k] >= 0).reshape(-1)
        wl = _compact_worklist(mask_k, caps[k], config)
        needed_k[k] = torch.maximum(needed_k[k], wl.need)
        live = wl.lane_live()
        pair_w = torch.where(live, wl.take(pair_planes[k].reshape(-1)), -1)
        srgb, sa = shade_fn(pair_w, wl.lane_safe(), live)
        cur = wl.take(rgb)
        rows = srgb * sa[..., None] + cur * (1.0 - sa[..., None])
        rgb = wl.compose(rgb, rows)
    return rgb, needed_k


def _clip_rounds(kb, clip_off: int, clip_px_needed_k: torch.Tensor, npx: int, y_offset: int,
                 config: RenderConfig, scene: dict, tables: tuple, sampled):
    """The alpha-clip resolve's rounds (reference render/frame.py:951-966):
    for each k-buffer layer k, the worklist of the pixels holding a layer-k
    fragment, its lanes' pairs (+ clip_off, -1 where dead), their g-buffer
    and albedo alpha, and one clip-round compose of the full-screen found,
    chosen pair and chosen depth planes, which carry the search from layer
    to layer (the nearest passing fragment wins). tables: (merged
    TriangleSetup, merged TriangleAttrs, the shade rows in raster order,
    row_cols); sampled(g, slots): the material-path partition's albedo or
    None. Raises clip_px_needed_k[k] to each layer's need, in place.
    Returns the (npx,) found (i32), chosen pair (i32) and chosen depth
    (f32) planes."""
    merged_tri, merged_attrs, vis_row, row_cols = tables
    dev = kb.pair.device
    clip_caps = config.resolve_clip_caps()
    found_p = torch.zeros((npx,), dtype=torch.int32, device=dev)
    chosen_pair_p = torch.zeros((npx,), dtype=torch.int32, device=dev)
    chosen_depth_p = torch.zeros((npx,), dtype=torch.float32, device=dev)
    for k in range(config.resolve_clip_layers()):
        wlk = _compact_worklist((kb.pair[k] >= 0).reshape(-1), clip_caps[k], config)
        clip_px_needed_k[k] = torch.maximum(clip_px_needed_k[k], wlk.need)
        livek = wlk.lane_live()
        pxc, pyc = _px_py_at(wlk.lane_safe(), config.width, y_offset)
        raw_k = wlk.take(kb.pair[k].reshape(-1))
        pair_k = torch.where(livek & (raw_k >= 0), raw_k + clip_off, -1)
        g = interpolate_gbuffer(pair_k, pxc, pyc, merged_tri, merged_attrs,
                                shade_row=vis_row, row_cols=row_cols)
        a, cutoff = albedo_alpha(g, scene, aniso_taps=config.aniso_taps,
                                 albedo4=sampled(g, slots=(0,)))
        found_p, chosen_pair_p, chosen_depth_p = wlk.compose(
            (found_p, chosen_pair_p, chosen_depth_p), pair_k,
            clip=(g.valid, a, cutoff, kb.depth[k].reshape(-1)))
    return found_p, chosen_pair_p, chosen_depth_p


def render_view(scene: dict, state: FrameState, view_index: int,
                config: RenderConfig, env, geometry=None, band_height: Optional[int] = None,
                y_offset: int = 0):
    """One view, or its band of rows [y_offset, y_offset + band_height)
    (None = the whole height) -> ((band_height, W, 4) f32 image, stats dict
    of i32 tensors). geometry: (merged TriangleSetup, merged TriangleAttrs)
    of this view; None computes it here, on the scene's device (reference
    :807), as each band of render_frame_sharded does."""
    band_height = band_height or config.height
    u = state.uniforms
    if geometry is None:
        geometry = _merged_geometry(scene, state, u["view_proj"][view_index], config)
    merged_tri, merged_attrs = geometry
    dev = merged_tri.setup.device
    mats = scene["materials"]
    blend_mode = mats["blend_mode"][merged_attrs.material]

    # One row per pair: setup | packed attrs | (matq) material row, so the
    # deferred stages fetch a pixel's whole state in one gather; in
    # sorted-pair mode the table is gathered into the raster's sorted order
    # and indexed by the sorted positions the kernel leaves in vis.pair
    # (raster="ref" leaves original row indices and takes it as is).
    parts = [merged_tri.setup, merged_attrs.packed]
    if "texels_mq" in scene and "mat_row_mq" in mats:
        parts.append(mats["mat_row_mq"][merged_attrs.material])
    shade_row = torch.cat(parts, dim=1)
    row_cols = None
    if config.shade_row_pad > 0:  # reference render/frame.py:826-831
        row_cols = shade_row.shape[1]
        pad = -row_cols % config.shade_row_pad
        if pad:
            shade_row = torch.nn.functional.pad(shade_row, (0, pad))

    # --- pass 1: opaque visibility ---
    opaque_tri = merged_tri._replace(valid=merged_tri.valid & (blend_mode == 0))
    vis, pairs_needed, op_order = _rasterize(opaque_tri, config, band_height, y_offset)
    vis_row = _in_order(shade_row, op_order)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    clip_layers_needed = blend_layers_needed = particle_layers_needed = zero
    shade_px_needed = matq_classic_needed = zero
    shade_px_needed_k = torch.zeros((config.needed_k_len(),), dtype=torch.int32, device=dev)
    clip_px_needed_k = torch.zeros(
        (config.resolve_clip_layers(),), dtype=torch.int32, device=dev
    )
    npx = band_height * config.width

    # Material-path partition on PARTIAL interleaved pools: each lane
    # samples on its own material's path (_partition_material_sample), in
    # the opaque shade, the blend layers and (albedo only) the clip
    # resolve. Without matq_classic_cap every lane takes the classic path,
    # and the incapable-lane count is still reported so a host can size
    # the cap from one stats frame.
    partial_pool = "matq_capable" in scene and "texels_mq" in scene
    use_partition = partial_pool and (config.matq_classic_cap or 0) > 0

    def sampled(g, slots=None):
        nonlocal matq_classic_needed
        if not partial_pool:
            return None
        if not use_partition:
            capable = scene["matq_capable"][torch.clamp_min(g.material, 0).long()]
            need = ((~capable) & g.valid).sum(dtype=torch.int32)
            matq_classic_needed = torch.maximum(matq_classic_needed, need)
            return None
        s16, need = _partition_material_sample(g, scene, config, config.aniso_taps,
                                               slots=slots)
        matq_classic_needed = torch.maximum(matq_classic_needed, need)
        return s16

    # --- alpha-clip resolve: the K nearest clip fragments in front of the
    # opaque depth; per pixel the nearest whose albedo alpha passes the
    # material's cutoff replaces the opaque winner. Alpha is evaluated on
    # per-layer compacted worklists of the pixels holding a layer-k
    # fragment; full-screen found / chosen planes carry the search. ---
    if config.enable_clip:
        clip_tri = merged_tri._replace(valid=merged_tri.valid & (blend_mode == 1))
        kb, clip_pairs, clip_layers_needed, clip_order = _rasterize_kbuffer(
            clip_tri, config, band_height, y_offset, vis.depth,
            k=config.resolve_clip_layers(),
        )
        # sorted-pair mode: one table, opaque rows at [0, p_cap), clip rows
        # at [p_cap, 2 p_cap); raster="ref" indexes shade_row itself
        clip_off = 0
        if clip_order is not None:
            vis_row = torch.cat([vis_row, shade_row[clip_order]])
            clip_off = config.p_cap
        pairs_needed = torch.maximum(pairs_needed, clip_pairs)
        found_p, chosen_pair_p, chosen_depth_p = _clip_rounds(
            kb, clip_off, clip_px_needed_k, npx, y_offset, config, scene,
            (merged_tri, merged_attrs, vis_row, row_cols), sampled)
        if config.clip_px_caps is None:
            shade_px_needed = torch.maximum(shade_px_needed, clip_px_needed_k[0])
        # pixels with no passing layer keep the opaque result
        found_b = (found_p != 0).reshape(vis.pair.shape)
        vis = VisibilityBuffer(
            depth=torch.where(found_b, chosen_depth_p.reshape(vis.depth.shape), vis.depth),
            pair=torch.where(found_b, chosen_pair_p.reshape(vis.pair.shape), vis.pair),
        )

    # --- skybox: the base layer the shaded surfaces overwrite; on the sky
    # worklist only where the post-clip visibility has no winner (covered
    # pixels never read the sky, so zeros under covered granules are
    # unobservable) ---
    gr = _worklist_granule(config, npx)
    hit = (vis.pair >= 0).reshape(-1)
    sky_args = dict(
        projection_inverse=u["projection_inverse"][view_index],
        view_quat=u["view_inverse_quat"][view_index],
        inline_tonemapping=config.inline_tonemapping, inline_srgb=config.inline_srgb,
        y_offset=y_offset, full_height=config.height,
    )
    if 0 < (config.sky_px_cap or 0) < npx:
        swl = _compact_worklist(~hit, config.sky_px_cap, config)
        sky_px_needed = swl.need
        sky_rows = sample_skybox_at(scene, env, swl.lane_safe(), config.width, **sky_args)
        sky = swl.compose(torch.zeros((npx, 3), dtype=torch.float32, device=dev), sky_rows)
    else:
        sky = sample_skybox(scene, env, config.width, band_height, **sky_args)
        sky_px_needed = _granule_count(~hit, gr)

    # --- shade the winning opaque surface ---
    if 0 < (config.opaque_px_cap or 0) < npx:
        wl = _compact_worklist(hit, config.opaque_px_cap, config)
        opaque_px_needed = wl.need
        opx, opy = _px_py_at(wl.lane_safe(), config.width, y_offset)
        pair_w = torch.where(
            wl.lane_live(), wl.take(vis.pair.reshape(-1)),
            torch.full((), -1, dtype=torch.int32, device=dev),
        )
        g = interpolate_gbuffer(pair_w, opx, opy, merged_tri, merged_attrs,
                                shade_row=vis_row, row_cols=row_cols)
        rgb_w, _ = shade(
            g, scene, u, view_index, env=env,
            inline_tonemapping=config.inline_tonemapping,
            inline_srgb=config.inline_srgb, aniso_taps=config.aniso_taps,
            s16=sampled(g),
        )
        rgb = wl.compose(sky, rgb_w, where=g.valid)
    else:
        px, py = _pixel_centers(config, band_height, y_offset, dev)
        gbuf = interpolate_gbuffer(vis.pair.reshape(-1), px, py, merged_tri,
                                   merged_attrs, shade_row=vis_row, row_cols=row_cols)
        opaque_px_needed = _granule_count(gbuf.valid, gr)
        rgb, _ = shade(
            gbuf, scene, u, view_index, env=env,
            inline_tonemapping=config.inline_tonemapping,
            inline_srgb=config.inline_srgb, aniso_taps=config.aniso_taps,
            s16=sampled(gbuf),
        )
        rgb = torch.where(gbuf.valid[..., None], rgb, sky)

    # --- lines: flat-colour quads depth-tested against the post-clip depth
    # (the raster kernel walks from it as its init buffer); their depth is
    # the floor of the particle and blend passes ---
    depth_floor = vis.depth
    if config.enable_lines and state.lines is not None:
        line_tri, line_colors = line_geometry(
            state.lines["pos"], state.lines["color"], state.lines["valid"],
            u["view_proj"][view_index], config.width, config.height,
            line_width_px=config.line_width_px, flip_viewport=config.flip_viewport,
        )
        line_init = VisibilityBuffer(depth=vis.depth, pair=torch.full_like(vis.pair, -1))
        lvis, line_pairs, l_order = _rasterize(line_tri, config, band_height, y_offset,
                                               init=line_init)
        line_colors = _in_order(line_colors, l_order)
        pairs_needed = torch.maximum(pairs_needed, line_pairs)
        lhit = (lvis.pair >= 0).reshape(-1)
        lcol = line_colors[torch.clamp_min(lvis.pair.reshape(-1), 0)]
        rgb = torch.where(lhit[..., None], lcol, rgb)
        depth_floor = lvis.depth

    # --- particles: camera-facing quads, the K nearest in front of the
    # floor per pixel, shaded and blended back to front ---
    if config.enable_particles and state.particles is not None:
        p_tri, p_attrs = particle_geometry(
            state.particles, u["view"][view_index], u["view_inverse"][view_index],
            u["projection"][view_index], config.width, config.height,
            flip_viewport=config.flip_viewport,
        )
        pkb, p_pairs, particle_layers_needed, p_order = _rasterize_kbuffer(
            p_tri, config, band_height, y_offset, depth_floor, want_depth=False,
            k=config.resolve_particle_layers(),
        )
        p_attrs = p_attrs._replace(packed=_in_order(p_attrs.packed, p_order))
        pairs_needed = torch.maximum(pairs_needed, p_pairs)

        def sh_sampler(world_pos):
            # a stand-in g-buffer: the SH lookup reads only the position
            stand_in = GBuffer(
                valid=None, world_pos=world_pos, normal=None, uv=None,
                lm_uv=torch.zeros_like(world_pos[..., :2]), material=None,
                front_facing=None,
                lightmapped=torch.zeros(world_pos.shape[0], dtype=torch.bool, device=dev),
                dpdx=None, dpdy=None, duvdx=None, duvdy=None,
            )
            return sample_spherical_harmonics(stand_in, scene, u, env)

        def shade_particle_layer(pair_w, safe, live):
            spx, spy = _px_py_at(safe, config.width, y_offset)
            return shade_particles(
                pair_w, spx, spy, p_tri, p_attrs, state.particles, scene, u, env,
                view_index, sh_sampler, inline_tonemapping=config.inline_tonemapping,
                inline_srgb=config.inline_srgb,
            )

        rgb, shade_px_needed_k = _composite_layers(
            rgb, pkb.pair, config.layer_caps(config.resolve_particle_layers()),
            shade_px_needed_k, shade_particle_layer, config,
        )

    # --- alpha-blend composite: the K nearest blended fragments in front
    # of the floor (the lines' depth, else the post-clip depth), shaded and
    # blended back to front ---
    if config.enable_blend:
        blend_tri = merged_tri._replace(valid=merged_tri.valid & (blend_mode == 2))
        kb, blend_pairs, blend_layers_needed, blend_order = _rasterize_kbuffer(
            blend_tri, config, band_height, y_offset, depth_floor, want_depth=False,
        )
        blend_row = _in_order(shade_row, blend_order)
        pairs_needed = torch.maximum(pairs_needed, blend_pairs)

        def shade_blend_layer(pair_w, safe, live):
            bpx, bpy = _px_py_at(safe, config.width, y_offset)
            g = interpolate_gbuffer(pair_w, bpx, bpy, merged_tri, merged_attrs,
                                    shade_row=blend_row, row_cols=row_cols)
            lrgb, la = shade(
                g, scene, u, view_index, env=env,
                inline_tonemapping=config.inline_tonemapping,
                inline_srgb=config.inline_srgb, aniso_taps=config.aniso_taps,
                s16=sampled(g),
            )
            return lrgb, torch.where(g.valid, la, 0.0)

        rgb, shade_px_needed_k = _composite_layers(
            rgb, kb.pair, config.layer_caps(), shade_px_needed_k,
            shade_blend_layer, config,
        )

    # the display transform not applied inline in shade / sky
    rgb = tonemap_and_encode(rgb, not config.inline_tonemapping, not config.inline_srgb)

    # shade_px_needed tracks the worklists bounded by shade_px_cap: the
    # clip resolve while clip_px_caps is unset, and the particle / blend
    # layer 0 while shade_px_caps is unset
    if config.shade_px_caps is None:
        shade_px_needed = torch.maximum(shade_px_needed, shade_px_needed_k[0])

    img = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1).reshape(
        band_height, config.width, 4
    )
    stats = {
        "pairs_needed": pairs_needed.to(torch.int32),
        "layers_needed": torch.maximum(
            torch.maximum(clip_layers_needed, blend_layers_needed), particle_layers_needed
        ),
        "clip_layers_needed": clip_layers_needed,
        "blend_layers_needed": blend_layers_needed,
        "particle_layers_needed": particle_layers_needed,
        "shade_px_needed": shade_px_needed,
        "shade_px_needed_k": shade_px_needed_k,
        "opaque_px_needed": opaque_px_needed,
        "sky_px_needed": sky_px_needed,
        "matq_classic_needed": matq_classic_needed,
        "clip_px_needed_k": clip_px_needed_k,
    }
    return img, stats


def render_frame_impl(scene: dict, state: FrameState, config: RenderConfig,
                      env, with_stats: bool = False):
    """Frame body -> (V, H, W, 4) u8 [, stats dict] (reference
    render/frame.py:1293-1366): the vertex stage once, each view's edge
    setup once, and each view in row_chunks bands of height // row_chunks
    rows, a plain loop where the reference maps over the bands. The stats
    are the elementwise max over views and bands."""
    config.resolve_raster()  # raises on an unknown method
    chunks = max(config.row_chunks, 1)
    if config.height % chunks:
        raise ValueError(f"height {config.height} is not a multiple of "
                         f"row_chunks {config.row_chunks}")
    band_h = config.height // chunks
    stages, merged_attrs = _merged_vertex_stage(scene, state, config)
    views, acc = [], None
    for v in range(config.num_views):
        geometry = (
            _merged_setup_for_view(stages, state.uniforms["view_proj"][v], config),
            merged_attrs,
        )
        bands = []
        for b in range(chunks):
            img, stats = render_view(scene, state, v, config, env, geometry,
                                     band_height=band_h, y_offset=b * band_h)
            bands.append(to_u8(img))
            if with_stats:
                acc = stats if acc is None else {
                    k: torch.maximum(acc[k], stats[k]) for k in acc
                }
        views.append(torch.cat(bands))
    image = torch.stack(views)
    if with_stats:
        return image, acc
    return image


def render_frame(scene: dict, state: FrameState, config: RenderConfig, env):
    """render_frame_impl's image; on a CUDA device a replay of the frame's
    CUDA graph (render/frame_graph.py, which says which frames stay
    eager)."""
    if frame_graph.captures(state, config):
        return frame_graph.render(scene, state, config, env)
    return render_frame_impl(scene, state, config, env)


def render_frame_stats(scene: dict, state: FrameState, config: RenderConfig, env):
    """(image, stats) -- the variant the growth loops read; on a CUDA
    device as render_frame."""
    if frame_graph.captures(state, config):
        return frame_graph.render(scene, state, config, env, with_stats=True)
    return render_frame_impl(scene, state, config, env, with_stats=True)


def frame_capacity_stats(scene: dict, state: FrameState, config: RenderConfig):
    """(num_triangles, num_bin_pairs) i32 tensors the frame's first view
    needs, binned at p_cap 1 so the count is the need, not the capacity
    (reference :1404); compare with t_cap / p_cap through
    utils.profiler.frame_capacity_report once a scene or camera change."""
    tri, _attrs = _merged_geometry(scene, state, state.uniforms["view_proj"][0], config)
    bins = bin_triangles(tri, config.width, config.height, 1)
    return tri.num_valid, bins.num_pairs


def stats_to_host(stats: dict) -> dict:
    """Device stats -> plain ints / lists of ints."""
    return {
        k: ([int(x) for x in v.tolist()] if v.ndim else int(v))
        for k, v in stats.items()
    }


# Last: frame_graph records this module's bindings as imported.
from . import frame_graph  # noqa: E402
