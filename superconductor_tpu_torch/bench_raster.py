"""The raster and k-buffer kernels at the frames' own shapes, on the GPU.

    python3 -m superconductor_tpu_torch.bench_raster

Builds the setup rows of the 1920x1080 headline and clip_blend frames,
bins them, and prints for the raster kernel on both frames' opaque setups,
and for the k-buffer kernel at the clip_blend frame's two shapes (clip K=8
with depth planes, blend K=1 without, over the opaque depth) and at blend
K=4: the pairs, the tiles holding rows and the heaviest tile; the kernel's
device time at every cluster size (`graph_ms`: a CUDA graph of 20
launches, median of 20 replays), with every tile's rows, with only the
heaviest tile's, with every tile but that one, and with every tile empty
(where the time goes); and the bound (`raster_bound`).
Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import statistics
import sys

import torch

from .ops.raster import capture_tally, replay_launches

PEAK_FP32_OPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM, published
EDGE_OPS = 12  # FP32 operations of three edge functions at one pixel
CLUSTERS = (1, 2, 4, 8)  # the cluster sizes a sweep times


def graph_ms(fn, launches: int = 20, runs: int = 20) -> float:
    """Median device milliseconds of one fn() call: `launches` calls
    captured in a CUDA graph, CUDA events around each of `runs` replays, so
    the host's work per call (checks, allocation, the ctypes call) is not in
    it. The kernels' launch counters count each replay's launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with capture_tally() as tally, torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    replay_launches(tally)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        replay_launches(tally)
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def raster_bound(bbox: torch.Tensor, bins, width: int, height: int, px_bytes: int,
                 y_offset: int = 0, busy_px_bytes: int = 0, tile_h: int = 32,
                 tile_w: int = 128):
    """(bound_ms, bound_by, pairs) of one binned raster call over the
    band [y_offset, y_offset + height). Bytes: 64 B a setup row its tiles
    hold and 8 B a tile, each read once; `px_bytes` at every pixel (planes
    written, or read where an empty tile still copies them, as an init
    buffer); `busy_px_bytes` only at the pixels of tiles holding a row (a
    k-buffer's depth floor: an empty tile's output does not depend on it).
    Operations: EDGE_OPS at each pixel of a row's tile that the row's
    triangle bounding box (`bbox` (T, 4), inclusive pixels, the binning's)
    covers -- the pixels any raster of this data must test -- not at every
    pixel of the tile."""
    ntx, nty = -(-width // tile_w), -(-height // tile_h)
    busy = (bins.tile_count[:ntx * nty] > 0).reshape(nty, ntx)
    cols = (width - torch.arange(ntx, device=busy.device) * tile_w).clamp(max=tile_w)
    rows = (height - torch.arange(nty, device=busy.device) * tile_h).clamp(max=tile_h)
    busy_px = int((busy * rows[:, None] * cols[None, :]).sum())
    used = bins.tile_of_pair < ntx * nty
    tile = bins.tile_of_pair[used].to(torch.int64)
    box = bbox[bins.order[used].to(torch.int64)].to(torch.int64)
    tx0 = torch.remainder(tile, ntx) * tile_w
    ty0 = torch.div(tile, ntx, rounding_mode="floor") * tile_h + y_offset
    x0 = torch.maximum(box[:, 0], tx0)
    x1 = torch.minimum(box[:, 2], tx0 + tile_w - 1).clamp(max=width - 1)
    y0 = torch.maximum(box[:, 1], ty0)
    y1 = torch.minimum(box[:, 3], ty0 + tile_h - 1).clamp(max=y_offset + height - 1)
    edge_px = int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)).sum())
    pairs = int(tile.numel())
    t_bytes = (pairs * 64 + ntx * nty * 8 + width * height * px_bytes
               + busy_px * busy_px_bytes) / PEAK_BYTES * 1e3
    t_ops = EDGE_OPS * edge_px / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), pairs


def kbuffer_px_bytes(k: int, want_depth: bool, has_floor: bool) -> dict:
    """raster_bound's per-pixel bytes of one k-buffer call: K pair planes
    (and K depth planes) and `layers` written at every pixel, the floor read
    (when given) only in tiles holding a row."""
    return dict(px_bytes=4 * k * (2 if want_depth else 1) + 4,
                busy_px_bytes=4 if has_floor else 0)


@contextlib.contextmanager
def kernel_constants(**values):
    """Set ops.raster's module constants (RASTER_CLUSTER,
    KBUFFER_MIN_PART_ROWS, ...) to `values` inside the block; no result
    depends on them."""
    from .ops import raster

    saved = {name: getattr(raster, name) for name in values}
    try:
        for name, value in values.items():
            setattr(raster, name, value)
        yield
    finally:
        for name, value in saved.items():
            setattr(raster, name, value)


def sweep(run, counts: torch.Tensor, constant: str) -> dict:
    """Device ms of run(tile_count) at each cluster size in CLUSTERS, with
    ops.raster's `constant` set to it, for four tile_counts: every tile's
    rows, only the heaviest tile's, every tile but that one, and every tile
    empty (where the time goes). -> {size: {variant: ms}}."""
    heaviest = int(torch.argmax(counts))
    only = torch.zeros_like(counts)
    only[heaviest] = counts[heaviest]
    rest = counts.clone()
    rest[heaviest] = 0
    variants = {"all tiles": counts, "heaviest tile only": only, "every other tile": rest,
                "every tile empty": torch.zeros_like(counts)}
    times = {}
    for c in CLUSTERS:
        with kernel_constants(**{constant: c}):
            times[c] = {name: run(tile_count) for name, tile_count in variants.items()}
    return times


def format_sweep(times: dict) -> str:
    return "; ".join(f"cluster {c}: " + ", ".join(f"{name} {t:.4f}" for name, t in v.items())
                     for c, v in times.items()) + " (ms)"


def frame_setup(scene: str, width: int, height: int):
    """The merged triangle setup of `scene`'s frame at angle 0 on the card,
    each triangle's blend mode (0 opaque, 1 clip, 2 blend) and the
    scene's RenderConfig."""
    from .render.frame import _merged_setup_for_view, _merged_vertex_stage
    from .scenes import clip_blend_scene, headline_scene

    make = headline_scene if scene == "headline" else clip_blend_scene
    dev, build, config, _env = make(width, height, "cuda")
    state = build(0.0)
    stages, attrs = _merged_vertex_stage(dev, state, config)
    tri = _merged_setup_for_view(stages, state.uniforms["view_proj"][0], config)
    return tri, dev["materials"]["blend_mode"][attrs.material], config


def binned(tri, width: int, height: int, p_cap: int):
    """Bins of `tri` and its tile-sorted setup rows."""
    from .ops.binning import bin_triangles, gather_sorted_setup

    bins = bin_triangles(tri, width, height, p_cap)
    return gather_sorted_setup(tri, bins).contiguous(), bins


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_raster: no CUDA device")

    from .bench import smi_line
    from .ops import raster
    from .ops.raster import kbuffer_sorted, rasterize_sorted

    print(smi_line(), flush=True)
    w, h = 1920, 1080
    for scene in ("headline", "clip_blend"):
        tri, blend, config = frame_setup(scene, w, h)
        opaque = tri._replace(valid=tri.valid & (blend == 0))
        setup, bins = binned(opaque, w, h, config.p_cap)
        counts = bins.tile_count
        bound_ms, bound_by, pairs = raster_bound(opaque.bbox, bins, w, h, 8)
        print(f"{scene} raster: {pairs} pairs in {int((counts > 0).sum())} of {counts.numel()} "
              f"tiles, heaviest tile {int(counts.max())} rows; bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)

        def run(tile_count):
            return graph_ms(lambda: rasterize_sorted(setup, bins.tile_start, tile_count, h, w))

        print("  " + format_sweep(sweep(run, counts, "RASTER_CLUSTER")), flush=True)
    floor = rasterize_sorted(setup, bins.tile_start, bins.tile_count, h, w).depth
    for name, mode, k, want in (("clip", 1, 8, True), ("blend", 2, 1, False),
                                ("blend", 2, 4, False)):
        part = tri._replace(valid=tri.valid & (blend == mode))
        setup, bins = binned(part, w, h, config.p_cap)
        counts = bins.tile_count
        bound_ms, bound_by, pairs = raster_bound(part.bbox, bins, w, h,
                                                 **kbuffer_px_bytes(k, want, True))
        print(f"clip_blend k-buffer {name} K={k} want_depth={want}: {pairs} pairs in "
              f"{int((counts > 0).sum())} of {counts.numel()} tiles, heaviest tile "
              f"{int(counts.max())} rows; bound {bound_ms:.4f} ms ({bound_by})", flush=True)

        def run(tile_count):
            return graph_ms(lambda: kbuffer_sorted(setup, bins.tile_start, tile_count, h, w, k=k,
                                                   depth_floor=floor, want_depth=want))

        print("  " + format_sweep(sweep(run, counts, "KBUFFER_CLUSTER")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
