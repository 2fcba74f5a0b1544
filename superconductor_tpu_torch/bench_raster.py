"""The raster kernel at the frames' own shapes, on the GPU.

    python3 -m superconductor_tpu_torch.bench_raster

Builds the opaque setup rows of the 1920x1080 headline and clip_blend
frames, bins them, and prints for each: the pairs, the tiles holding rows
and the heaviest tile; the kernel's device time at every cluster size
(`graph_ms`: a CUDA graph of 20 launches, median of 20 replays); at the
wrapper's cluster size, the time with only the heaviest tile's rows, with
every tile but that one, and with every tile empty (where the time goes);
and the bound (`raster_bound`). Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys

import torch

PEAK_FP32_OPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM, published
EDGE_OPS = 12  # FP32 operations of three edge functions at one pixel


def graph_ms(fn, launches: int = 20, runs: int = 20) -> float:
    """Median device milliseconds of one fn() call: `launches` calls
    captured in a CUDA graph, CUDA events around each of `runs` replays, so
    the host's work per call (checks, allocation, the ctypes call) is not in
    it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def raster_bound(bbox: torch.Tensor, bins, width: int, height: int, px_bytes: int,
                 y_offset: int = 0, tile_h: int = 32, tile_w: int = 128):
    """(bound_ms, bound_by, pairs) of one binned raster call over the
    band [y_offset, y_offset + height). Bytes: 64 B a setup row its tiles
    hold and 8 B a tile, each read once, and `px_bytes` a pixel of planes
    read or written once. Operations: EDGE_OPS at each pixel of a row's
    tile that the row's triangle bounding box (`bbox` (T, 4), inclusive
    pixels, the binning's) covers -- the pixels any raster of this data
    must test -- not at every pixel of the tile."""
    ntx, nty = -(-width // tile_w), -(-height // tile_h)
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
    t_bytes = (pairs * 64 + ntx * nty * 8 + width * height * px_bytes) / PEAK_BYTES * 1e3
    t_ops = EDGE_OPS * edge_px / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), pairs


@contextlib.contextmanager
def raster_cluster(size: int):
    """Run the raster wrapper at cluster size `size` (1..8) inside the
    block; the result does not depend on it."""
    from .ops import raster

    saved = raster.RASTER_CLUSTER
    raster.RASTER_CLUSTER = size
    try:
        yield
    finally:
        raster.RASTER_CLUSTER = saved


def opaque_setup(scene: str, width: int, height: int):
    """The opaque triangles of `scene`'s frame at angle 0, their
    tile-sorted setup rows and their bins, on the card."""
    from .ops.binning import bin_triangles, gather_sorted_setup
    from .render.frame import _merged_setup_for_view, _merged_vertex_stage
    from .scenes import clip_blend_scene, headline_scene

    make = headline_scene if scene == "headline" else clip_blend_scene
    dev, build, config, _env = make(width, height, "cuda")
    state = build(0.0)
    stages, attrs = _merged_vertex_stage(dev, state, config)
    tri = _merged_setup_for_view(stages, state.uniforms["view_proj"][0], config)
    tri = tri._replace(valid=tri.valid & (dev["materials"]["blend_mode"][attrs.material] == 0))
    bins = bin_triangles(tri, width, height, config.p_cap)
    return tri, gather_sorted_setup(tri, bins).contiguous(), bins


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_raster: no CUDA device")

    from .ops.raster import RASTER_CLUSTER, rasterize_sorted

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(out.stdout.strip().splitlines()[0], flush=True)
    w, h = 1920, 1080
    for scene in ("headline", "clip_blend"):
        tri, setup, bins = opaque_setup(scene, w, h)
        counts = bins.tile_count
        heaviest = int(torch.argmax(counts))
        bound_ms, bound_by, pairs = raster_bound(tri.bbox, bins, w, h, 8)
        print(f"{scene}: {pairs} pairs in {int((counts > 0).sum())} of {counts.numel()} tiles, "
              f"heaviest tile {int(counts[heaviest])} rows; bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)

        def run(tile_count):
            return graph_ms(lambda: rasterize_sorted(setup, bins.tile_start, tile_count, h, w))

        per_cluster = {}
        for c in (1, 2, 4, 8):
            with raster_cluster(c):
                per_cluster[c] = run(counts)
        print(f"  kernel by cluster size (ms): "
              + ", ".join(f"{c}: {t:.4f}" for c, t in per_cluster.items()), flush=True)
        only = torch.zeros_like(counts)
        only[heaviest] = counts[heaviest]
        rest = counts.clone()
        rest[heaviest] = 0
        print(f"  at cluster {RASTER_CLUSTER} (ms): heaviest tile only {run(only):.4f}, every "
              f"other tile {run(rest):.4f}, every tile empty {run(torch.zeros_like(counts)):.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
