"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives superconductor_tpu_torch's two paths at 1920x1080 on the first
CUDA device -- the headline frame (hero_helmet.glb, opaque PBR + IBL
sky) and the clip_blend frame (BASELINE config 3: the helmet plus a ring
of spheres, alpha-clipped and alpha-blended ones among them) -- and
checks them:

1. device: nvidia-smi name and power limit, torch's device name;
2. build: compiles csrc/raster.cu and csrc/kbuffer.cu (nvcc, sm_90a, one
   process each, at once) and prints the seconds, the compiler's
   registers, shared memory and spills of every template variant, and the
   k-buffer kernel's dynamic shared memory per K;
3. raster kernel against its plain torch version on the card, which must
   agree bit for bit in depth and pair: the binned setup of the headline
   frame, a fan of edge-sharing triangles with pixel centres on the
   edges, a mostly empty ragged target, forward z, an init buffer with a
   non-zero y_offset, and one tile of 2,044 rows (every triangle twice,
   the equal-z copies ~1,000 rows apart, so in different parts of the
   split) in both z directions, with and without init, at every cluster
   size; on the headline setup the kernel's device time (CUDA graph of 20
   launches, median of 20 replays) at each cluster size, with all tiles,
   the heaviest tile only, every other tile and every tile empty, the time
   of one call as a caller sees it and the plain version's (CUDA events,
   median of 20), the heaviest tile's rows, the bound and the share of it;
4. headline: fit_caps, a stats frame, 20 frames timed with CUDA events;
   the kernel's launch count over those frames; the frame against the
   same frame rendered with the plain raster (byte-equal); coverage
   against the opaque_px_needed stat; non-black sky and helmet; and a
   256x128 frame on the card against the same frame on the CPU and
   against the JAX reference's frame stored in tests/goldens (>= 40 dB);
5. the raster kernel on the clip_blend frame's opaque setup, timed as in
   3; the k-buffer kernel against its plain version on the card, bit for
   bit in every depth plane, pair plane and layers count, for K in {1, 2,
   4, 8}, with and without depth planes and at every cluster size: the
   clip and the blend setup of the 1080p clip_blend frame over its opaque
   depth, a stack of 12 quads with equal-z ties (layers > K), the stack in
   forward z, a band with a non-zero y_offset, and the 2,044-row tile in
   both z directions over a floor that rejects some of its rows; timed at
   the frame's shapes (clip K=8 with depth planes, blend K=1 without) and
   at blend K=4, each at every cluster size with all tiles, the heaviest
   tile only, every other tile and every tile empty;
6. clip_blend: fit_caps, a stats frame, 20 frames timed with CUDA events;
   both kernels' launch counts; the frame against its twin rendered with
   both plain versions (byte-equal); the clip pass both keeps and drops
   clip fragments; the blend composite changes the pixels it covers; a
   256x128 frame on the card against the CPU frame and the JAX
   reference's frame in tests/goldens (>= 40 dB);
7. neither jax nor the JAX package (superconductor_tpu) was imported.

Any failure raises (non-zero exit) before the result lines. The last two
lines are the kernel table and the device record, each one JSON object.
A kernel's bound_ms is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations (12 FP32
operations for the three edge functions of a setup row at each pixel of
its tile that its triangle's bounding box covers) over 67 TFLOP/s: the
H100 SXM's published peaks (superconductor_tpu_torch/bench_raster.py
raster_bound). Kernel times are device times (bench_raster.graph_ms: a
CUDA graph of 20 launches).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

N_TIMED = 20
WIDTH, HEIGHT = 1920, 1080  # the headline frame
# the JAX reference's hero frame at 256x128 (tests/test_torch_frame.py)
HERO_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "goldens", "torch_hero_256x128.npz")
# the JAX reference's clip_blend frame at 256x128 (tests/test_torch_clip_blend.py)
CLIP_BLEND_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "goldens", "torch_clip_blend_256x128.npz")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, runs: int = N_TIMED) -> float:
    """Median device milliseconds of fn() over `runs`, CUDA events around
    each call (after one warm-up call)."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two u8 images in dB (the reference's utils/metrics.psnr)."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10.0 * np.log10(255.0 ** 2 / mse))


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fan_setup(width: int, height: int, device, w_scale=(1.0, 2.0)):
    """A fan of triangles around a pixel centre, outer vertices on pixel
    centres, every other triangle at another homogeneous w (same screen
    position) -- shared edges run through pixel centres."""
    from superconductor_tpu_torch.ops.geometry import TriangleSetup, _setup_from_clip

    cx, cy = 100.5, 60.5
    ring = [(40, 0), (28, 28), (0, 40), (-28, 28), (-40, 0), (-28, -28),
            (0, -40), (28, -28), (40, 13), (-13, 40), (-40, -13), (13, -40)]
    ring.sort(key=lambda d: math.atan2(d[1], d[0]))
    pts = [(cx, cy)] + [(cx + dx, cy + dy) for dx, dy in ring]
    n = len(ring)
    clip, ids = [], []
    for i in range(n):
        tri = (0, 1 + i, 1 + (i + 1) % n)
        w = w_scale[i % len(w_scale)]
        rows = []
        for v in tri:
            px, py = pts[v]
            xc = px / (width * 0.5) - 1.0
            yc = 1.0 - py / (height * 0.5)
            z = 0.25 + 0.01 * v
            rows.append([xc * w, yc * w, z * w, w])
        clip.append(rows)
        ids.append(tri)
    clip = torch.tensor(clip, dtype=torch.float32, device=device)
    ids = torch.tensor(ids, dtype=torch.int32, device=device)
    t = clip.shape[0]
    ones = torch.ones(t, dtype=torch.bool, device=device)
    setup, valid, bbox = _setup_from_clip(clip, ones, ones, width, height, False, vertex_ids=ids)
    return TriangleSetup(
        setup=setup, tri_id=torch.arange(t, dtype=torch.int32, device=device),
        inst_id=torch.zeros(t, dtype=torch.int32, device=device), bbox=bbox,
        valid=valid, num_valid=valid.sum(dtype=torch.int32),
    )


def compare_raster(name, tri, width, height, p_cap, results, reverse_z=True,
                   y_offset=0, init=None, clusters=None, min_rows=1, timed=False):
    """Kernel vs plain on the binned, sorted setup of `tri`, at each cluster
    size in `clusters` (None: the wrapper's RASTER_CLUSTER). The heaviest
    tile must hold `min_rows` rows. With `timed`, records in `results` the
    kernel's device time at RASTER_CLUSTER (every size is printed), one
    call's time, the plain version's, the bound and the heaviest tile."""
    from superconductor_tpu_torch.bench_raster import (
        format_sweep,
        graph_ms,
        kernel_constants,
        raster_bound,
        sweep,
    )
    from superconductor_tpu_torch.ops.binning import bin_triangles, gather_sorted_setup
    from superconductor_tpu_torch.ops.raster import (
        RASTER_CLUSTER,
        rasterize_sorted,
        rasterize_sorted_plain,
    )

    bins = bin_triangles(tri, width, height, p_cap, y_offset=y_offset)
    if int(bins.num_pairs) > p_cap:
        raise RuntimeError(f"{name}: p_cap {p_cap} < {int(bins.num_pairs)} pairs")
    heaviest = int(bins.tile_count.max())
    if heaviest < min_rows:
        raise RuntimeError(f"{name}: heaviest tile {heaviest} rows < {min_rows}")
    sorted_setup = gather_sorted_setup(tri, bins).contiguous()
    args = (sorted_setup, bins.tile_start, bins.tile_count, height, width)
    kw = dict(reverse_z=reverse_z, init=init, y_offset=y_offset)
    vp = rasterize_sorted_plain(*args, **kw)
    err = 0.0
    clusters = clusters or (RASTER_CLUSTER,)
    for cluster in clusters:
        with kernel_constants(RASTER_CLUSTER=cluster):
            vk = rasterize_sorted(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(vk.depth, vp.depth) and torch.equal(vk.pair, vp.pair)):
            diff = int((vk.pair != vp.pair).sum())
            raise RuntimeError(f"{name} cluster={cluster}: kernel != plain "
                               f"({diff} pair pixels differ)")
        err = max(err, float((vk.depth - vp.depth).abs().max()))
    covered = float((vk.pair >= 0).float().mean())
    sizes = ",".join(map(str, clusters))
    phase("raster", f"{name}: {width}x{height} pairs={int(bins.num_pairs)} heaviest tile "
          f"{heaviest} rows, cluster {sizes}: equal (tolerance: bit for bit) "
          f"max_abs_err={err} covered={covered:.4f}")
    if covered == 0.0:
        raise RuntimeError(f"{name}: nothing covered")
    results["max_abs_err"] = max(results["max_abs_err"], err)
    if timed:

        def run(tile_count):
            return graph_ms(lambda: rasterize_sorted(sorted_setup, bins.tile_start, tile_count,
                                                     height, width, **kw))

        times = sweep(run, bins.tile_count, "RASTER_CLUSTER")
        one_call = cuda_ms(lambda: rasterize_sorted(*args, **kw))
        plain_ms = cuda_ms(lambda: rasterize_sorted_plain(*args, **kw))
        bound_ms, bound_by, pairs = raster_bound(tri.bbox, bins, width, height,
                                                 8 if init is None else 16, y_offset)
        ms = times[RASTER_CLUSTER]["all tiles"]
        results.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       one_call_ms=one_call, heaviest=heaviest, pairs=pairs)
        phase("raster", f"{name}: kernel {ms:.4f} ms at cluster {RASTER_CLUSTER} (device "
              f"time, CUDA graph of 20 launches, median of {N_TIMED} replays); one call "
              f"{one_call:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, median of "
              f"{N_TIMED}); bound {bound_ms:.4f} ms ({bound_by}; {pairs} pairs, heaviest "
              f"tile {heaviest} rows), share {bound_ms / ms:.3f}")
        phase("raster", f"{name}: " + format_sweep(times))
    return vp


def heavy_init(vis, seed: int):
    """An init buffer for `vis`'s target: its depth on a third of the
    pixels (ties with the walk), 0.5 elsewhere, and random pair ids."""
    gen = torch.Generator(device=vis.depth.device).manual_seed(seed)
    keep = vis.pair % 3 == 0
    from superconductor_tpu_torch.ops.raster import VisibilityBuffer

    return VisibilityBuffer(
        depth=torch.where(keep, vis.depth, torch.full_like(vis.depth, 0.5)).contiguous(),
        pair=torch.randint(-1, 5000, tuple(vis.pair.shape), generator=gen,
                           device=vis.pair.device, dtype=torch.int32),
    )


def compare_kbuffer(name, tri, width, height, p_cap, results, reverse_z=True,
                    y_offset=0, floor=None, min_layers=1, min_rows=1, clusters=None,
                    timed=()):
    """Kernel vs plain for every K and both want_depth on the binned,
    sorted setup of `tri`, at each cluster size in `clusters` (None: the
    wrapper's KBUFFER_CLUSTER). The heaviest tile must hold `min_rows` rows.
    Times each (K, want_depth) of `timed` at every cluster size, with all
    tiles, the heaviest tile only, every other tile and every tile empty;
    returns {(K, want_depth): timings} at KBUFFER_CLUSTER."""
    from superconductor_tpu_torch.bench_raster import (
        format_sweep,
        graph_ms,
        kbuffer_px_bytes,
        kernel_constants,
        raster_bound,
        sweep,
    )
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.ops.binning import bin_triangles, gather_sorted_setup
    from superconductor_tpu_torch.ops.raster import KBUFFER_KS, kbuffer_sorted
    from superconductor_tpu_torch.ops.raster_kbuffer import kbuffer_sorted_plain

    bins = bin_triangles(tri, width, height, p_cap, y_offset=y_offset)
    if int(bins.num_pairs) > p_cap:
        raise RuntimeError(f"{name}: p_cap {p_cap} < {int(bins.num_pairs)} pairs")
    heaviest = int(bins.tile_count.max())
    if heaviest < min_rows:
        raise RuntimeError(f"{name}: heaviest tile {heaviest} rows < {min_rows}")
    sorted_setup = gather_sorted_setup(tri, bins).contiguous()
    args = (sorted_setup, bins.tile_start, bins.tile_count, height, width)
    clusters = clusters or (raster_mod.KBUFFER_CLUSTER,)
    for k in KBUFFER_KS:
        for want in (True, False):
            kw = dict(k=k, reverse_z=reverse_z, depth_floor=floor, y_offset=y_offset,
                      want_depth=want)
            pkb, players = kbuffer_sorted_plain(*args, **kw)
            for cluster in clusters:
                with kernel_constants(KBUFFER_CLUSTER=cluster):
                    kb, layers = kbuffer_sorted(*args, **kw)
                torch.cuda.synchronize()
                same = torch.equal(kb.pair, pkb.pair) and torch.equal(layers, players)
                err = 0.0
                if want:
                    same = same and torch.equal(kb.depth, pkb.depth)
                    err = float((kb.depth - pkb.depth).abs().max())
                if not same:
                    diff = int((kb.pair != pkb.pair).sum())
                    raise RuntimeError(f"{name} K={k} want_depth={want} cluster={cluster}: "
                                       f"kernel != plain ({diff} pair values differ)")
                results["max_abs_err"] = max(results["max_abs_err"], err)
    deepest = int(layers.max())
    sizes = ",".join(map(str, clusters))
    phase("kbuffer", f"{name}: {width}x{height} pairs={int(bins.num_pairs)} heaviest tile "
          f"{heaviest} rows, K=1,2,4,8 x want_depth, cluster {sizes}: equal (tolerance: bit "
          f"for bit); max layers {deepest}, covered {float((layers > 0).float().mean()):.4f}")
    if deepest < min_layers:
        raise RuntimeError(f"{name}: at most {deepest} layers, expected >= {min_layers}")
    timings = {}
    for k, want in timed:
        kw = dict(k=k, reverse_z=reverse_z, depth_floor=floor, y_offset=y_offset,
                  want_depth=want)

        def run(tile_count):
            return graph_ms(lambda: kbuffer_sorted(sorted_setup, bins.tile_start, tile_count,
                                                   height, width, **kw))

        times = sweep(run, bins.tile_count, "KBUFFER_CLUSTER")
        ms = times[raster_mod.KBUFFER_CLUSTER]["all tiles"]
        one_call = cuda_ms(lambda: kbuffer_sorted(*args, **kw))
        plain_ms = cuda_ms(lambda: kbuffer_sorted_plain(*args, **kw))
        bound_ms, bound_by, pairs = raster_bound(
            tri.bbox, bins, width, height, kbuffer_px_bytes(k, want, floor is not None), y_offset
        )
        timings[(k, want)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, heaviest=heaviest, pairs=pairs)
        phase("kbuffer", f"{name} K={k} want_depth={want}: kernel {ms:.4f} ms at cluster "
              f"{raster_mod.KBUFFER_CLUSTER} (device time, CUDA graph of 20 launches, median "
              f"of {N_TIMED} replays); one call {one_call:.4f} ms, plain {plain_ms:.4f} ms "
              f"(CUDA events, median of {N_TIMED}); bound {bound_ms:.4f} ms ({bound_by}; "
              f"{pairs} pairs, heaviest tile {heaviest} rows), share {bound_ms / ms:.3f}")
        phase("kbuffer", f"{name} K={k} want_depth={want}: " + format_sweep(times))
    return timings


def clip_blend_path(dev, kb_results, cb_raster) -> dict:
    """Phases 5 and 6: the raster kernel on the opaque setup and the
    k-buffer kernel against their plain versions, then the 1080p clip_blend
    frame. Returns the launch counts of its timed run."""
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.ops.raster_kbuffer import kbuffer_sorted_plain
    from superconductor_tpu_torch.render import frame as frame_mod
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.frame import (
        _merged_setup_for_view,
        _merged_vertex_stage,
        _rasterize,
        _rasterize_kbuffer,
        render_frame,
        render_frame_stats,
        stats_to_host,
    )
    from superconductor_tpu_torch.bench_raster import CLUSTERS
    from superconductor_tpu_torch.scenes import (
        CLIP_BLEND_SMALL,
        clip_blend_scene,
        heavy_tile_setup,
        quad_stack_setup,
    )

    t0 = time.perf_counter()
    scene_dev, build_state, config, env = clip_blend_scene(WIDTH, HEIGHT, dev)
    state0 = build_state(0.0)
    phase("clip_blend", f"scene on card in {time.perf_counter() - t0:.2f} s")

    # --- 5. raster kernel on the opaque setup, k-buffer kernel vs plain ---
    stages, attrs = _merged_vertex_stage(scene_dev, state0, config)
    tri = _merged_setup_for_view(stages, state0.uniforms["view_proj"][0], config)
    blend = scene_dev["materials"]["blend_mode"][attrs.material]
    opaque_tri = tri._replace(valid=tri.valid & (blend == 0))
    compare_raster("clip_blend-opaque", opaque_tri, WIDTH, HEIGHT, config.p_cap, cb_raster,
                   timed=True)
    opaque, _, _ = _rasterize(opaque_tri, config, HEIGHT, 0)
    floor = opaque.depth
    clip_tri = tri._replace(valid=tri.valid & (blend == 1))
    blend_tri = tri._replace(valid=tri.valid & (blend == 2))
    clip_t = compare_kbuffer("clip-1080p", clip_tri, WIDTH, HEIGHT, config.p_cap, kb_results,
                             floor=floor, min_layers=2, clusters=CLUSTERS, timed=[(8, True)])
    kb_results.update(clip_t[(8, True)])
    compare_kbuffer("blend-1080p", blend_tri, WIDTH, HEIGHT, config.p_cap, kb_results,
                    floor=floor, clusters=CLUSTERS, timed=[(1, False), (4, False)])
    compare_kbuffer("stack", quad_stack_setup(200, 80, dev), 200, 80, 512, kb_results,
                    min_layers=9, clusters=CLUSTERS)
    compare_kbuffer("stack-forward-z", quad_stack_setup(200, 80, dev, reverse_z=False),
                    200, 80, 512, kb_results, reverse_z=False, min_layers=9, clusters=CLUSTERS)
    band_y0, band_h = HEIGHT * 2 // 5, HEIGHT * 3 // 10
    compare_kbuffer("clip-band+y_offset", clip_tri, WIDTH, band_h, config.p_cap, kb_results,
                    y_offset=band_y0, floor=floor[band_y0:band_y0 + band_h].contiguous(),
                    min_layers=2, clusters=CLUSTERS)
    # one tile of 2,044 rows (every triangle twice, the equal-z copies ~1,000
    # rows apart) over a floor of random depths that rejects some of them
    gen = torch.Generator(device=dev).manual_seed(5)
    heavy_floor = torch.rand((96, 320), generator=gen, device=dev) * 0.35 + 0.15
    for reverse_z in (True, False):
        compare_kbuffer("heavy-tile" + ("" if reverse_z else "-forward-z"),
                        heavy_tile_setup(320, 96, dev, reverse_z=reverse_z), 320, 96, 4096,
                        kb_results, reverse_z=reverse_z,
                        floor=heavy_floor if reverse_z else 1.0 - heavy_floor,
                        min_layers=9, min_rows=2000, clusters=CLUSTERS)

    # --- 6. the clip_blend frame ---
    config = fit_caps(scene_dev, state0, config, env,
                      log=lambda s, g: phase("fit_caps", f"{s} grow={g or None}"))
    phase("clip_blend", f"fitted caps: p_cap={config.p_cap} clip_layers="
          f"{config.clip_layers} blend_layers={config.blend_layers} "
          f"shade_px_cap={config.shade_px_cap} shade_px_caps={config.shade_px_caps} "
          f"opaque_px_cap={config.opaque_px_cap} sky_px_cap={config.sky_px_cap}")
    img, stats = render_frame_stats(scene_dev, state0, config, env)
    stats = stats_to_host(stats)
    phase("clip_blend", f"stats {stats}")
    if stats["clip_layers_needed"] < 1 or stats["blend_layers_needed"] < 1:
        raise RuntimeError("the clip_blend frame has no clip or no blend fragment")

    raster_mod.rasterize_sorted.LAUNCHES = 0
    raster_mod.kbuffer_sorted.LAUNCHES = 0
    frames = [0]

    def one_frame():
        frames[0] += 1
        return render_frame(scene_dev, state0, config, env)

    frame_ms = cuda_ms(one_frame)
    launches = {"raster_sorted": raster_mod.rasterize_sorted.LAUNCHES,
                "kbuffer_sorted": raster_mod.kbuffer_sorted.LAUNCHES}
    phase("clip_blend", f"frame {frame_ms:.3f} ms (CUDA events, median of {N_TIMED}); "
          f"launches {launches} over {frames[0]} frames")
    if launches["raster_sorted"] < frames[0] or launches["kbuffer_sorted"] < 2 * frames[0]:
        raise RuntimeError("the clip_blend path did not launch raster once and the "
                           "k-buffer kernel twice per frame")

    img = render_frame(scene_dev, state0, config, env)
    frame_mod.rasterize_sorted = raster_mod.rasterize_sorted_plain
    frame_mod.kbuffer_sorted = kbuffer_sorted_plain
    try:
        img_plain = render_frame(scene_dev, state0, config, env)
    finally:
        frame_mod.rasterize_sorted = raster_mod.rasterize_sorted
        frame_mod.kbuffer_sorted = raster_mod.kbuffer_sorted
    if img.shape != (1, HEIGHT, WIDTH, 4) or img.dtype != torch.uint8:
        raise RuntimeError(f"bad frame {tuple(img.shape)} {img.dtype}")
    if not torch.equal(img, img_plain):
        raise RuntimeError("clip_blend frame differs from its plain-kernels twin")
    phase("clip_blend", "frame equals its twin rendered with both plain versions byte for byte")

    # the clip pass keeps some clip fragments and sees through others
    clip_kb = _rasterize_kbuffer(clip_tri, config,
                                  HEIGHT, 0, floor, k=config.resolve_clip_layers())[0]
    clip_cov = clip_kb.pair[0] >= 0
    no_clip = render_frame(scene_dev, state0, replace(config, enable_clip=False), env)
    no_blend = render_frame(scene_dev, state0, replace(config, enable_blend=False), env)
    kept = (img[0] != no_clip[0]).any(dim=-1) & clip_cov
    holes = int(clip_cov.sum()) - int(kept.sum())
    blended = int((img[0] != no_blend[0]).any(dim=-1).sum())
    phase("clip_blend", f"clip-covered px {int(clip_cov.sum())}: {int(kept.sum())} take a "
          f"clip surface, {holes} keep the opaque result or sky; blend changes "
          f"{blended} px (blend layer-0 need {stats['shade_px_needed_k'][0]} px, "
          f"granule-dilated)")
    if int(kept.sum()) == 0 or holes == 0:
        raise RuntimeError("the clip resolve neither kept nor dropped clip fragments")
    if blended == 0:
        raise RuntimeError("the blend composite changed no pixel")

    small = dict(CLIP_BLEND_SMALL)
    w, h = small.pop("width"), small.pop("height")
    small_gpu = clip_blend_scene(w, h, dev, **small)
    small_cpu = clip_blend_scene(w, h, "cpu", **small)
    img_g = render_frame(small_gpu[0], small_gpu[1](0.3), small_gpu[2], small_gpu[3]).cpu()
    img_c = render_frame(small_cpu[0], small_cpu[1](0.3), small_cpu[2], small_cpu[3])
    golden = np.load(CLIP_BLEND_GOLDEN)["image"]
    db_cpu = psnr(img_g.numpy(), img_c.numpy())
    db_ref = psnr(img_g.numpy(), golden)
    phase("clip_blend", f"{w}x{h} frame: card vs CPU PSNR {db_cpu:.2f} dB, card vs the "
          f"JAX reference's frame (tests/goldens) PSNR {db_ref:.2f} dB")
    if min(db_cpu, db_ref) < 40.0:
        raise RuntimeError("card frame disagrees with the CPU frame or the reference")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from superconductor_tpu_torch.bench_raster import CLUSTERS
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.render import frame as frame_mod
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.frame import (
        _merged_setup_for_view,
        _merged_vertex_stage,
        render_frame,
        render_frame_stats,
        stats_to_host,
    )
    from superconductor_tpu_torch.scenes import headline_scene, heavy_tile_setup

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)  # name, power limit: as nvidia-smi gives them
    phase("device", f"torch: {kind}, count={torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build = raster_mod.build_kernels(force=True, verbose=True)
    phase("build", f"both kernels built in {time.perf_counter() - t0:.2f} s (in parallel)")
    for name, b in build.items():
        phase("build", f"{name}.cu built in {b['seconds']:.2f} s")
        for line in b["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                phase("build", line.strip())
    phase("build", "kbuffer.cu dynamic shared memory a block: " + ", ".join(
        f"K={k} {raster_mod.kbuffer_smem_bytes(k)} B" for k in raster_mod.KBUFFER_KS))

    # --- 3. kernel vs plain ---
    results = {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
    t0 = time.perf_counter()
    scene_dev, build_state, config, env = headline_scene(WIDTH, HEIGHT, dev)
    state0 = build_state(0.0)
    phase("headline", f"scene on card in {time.perf_counter() - t0:.2f} s")
    stages, attrs = _merged_vertex_stage(scene_dev, state0, config)
    tri = _merged_setup_for_view(stages, state0.uniforms["view_proj"][0], config)
    blend = scene_dev["materials"]["blend_mode"][attrs.material]
    tri = tri._replace(valid=tri.valid & (blend == 0))
    vis = compare_raster("headline", tri, WIDTH, HEIGHT, config.p_cap, results,
                         clusters=CLUSTERS, timed=True)
    fan = fan_setup(256, 160, dev)
    compare_raster("fan", fan, 256, 160, 4096, results)
    compare_raster("fan-forward-z", fan_setup(256, 160, dev, w_scale=(1.0,)),
                   256, 160, 4096, results, reverse_z=False)
    compare_raster("empty-tiles", fan_setup(1000, 700, dev), 1000, 700, 4096, results)
    gen = torch.Generator(device=dev).manual_seed(7)
    band_y0, band_h = HEIGHT * 2 // 5, HEIGHT * 3 // 10
    init = raster_mod.VisibilityBuffer(
        depth=(vis.depth[band_y0:band_y0 + band_h] * 0.999).contiguous(),
        pair=torch.randint(-1, 1000, (band_h, WIDTH), generator=gen,
                           device=dev, dtype=torch.int32),
    )
    compare_raster("init+y_offset", tri, WIDTH, band_h, config.p_cap, results,
                   y_offset=band_y0, init=init)
    for reverse_z in (True, False):
        heavy = heavy_tile_setup(320, 96, dev, reverse_z=reverse_z)
        name = "heavy-tile" + ("" if reverse_z else "-forward-z")
        hv = compare_raster(name, heavy, 320, 96, 4096, results, reverse_z=reverse_z,
                            clusters=CLUSTERS, min_rows=2000)
        compare_raster(name + "+init", heavy, 320, 96, 4096, results, reverse_z=reverse_z,
                       init=heavy_init(hv, 9), clusters=CLUSTERS, min_rows=2000)

    # --- 4. headline frame ---
    config = fit_caps(scene_dev, state0, config, env,
                      log=lambda s, g: phase("fit_caps", f"{s} grow={g or None}"))
    phase("headline", f"fitted caps: p_cap={config.p_cap} "
          f"opaque_px_cap={config.opaque_px_cap} sky_px_cap={config.sky_px_cap}")
    img, stats = render_frame_stats(scene_dev, state0, config, env)
    stats = stats_to_host(stats)
    phase("headline", f"stats {stats}")

    raster_mod.rasterize_sorted.LAUNCHES = 0
    raster_mod.kbuffer_sorted.LAUNCHES = 0
    frames = [0]

    def one_frame():
        frames[0] += 1
        return render_frame(scene_dev, state0, config, env)

    frame_ms = cuda_ms(one_frame)
    launches = raster_mod.rasterize_sorted.LAUNCHES
    phase("headline", f"frame {frame_ms:.3f} ms (CUDA events, median of "
          f"{N_TIMED}); raster launches {launches} over {frames[0]} frames")
    if launches < frames[0]:
        raise RuntimeError("the frame path did not launch the raster kernel every frame")

    img = render_frame(scene_dev, state0, config, env)
    frame_mod.rasterize_sorted = raster_mod.rasterize_sorted_plain
    try:
        img_plain = render_frame(scene_dev, state0, config, env)
    finally:
        frame_mod.rasterize_sorted = raster_mod.rasterize_sorted
    if img.shape != (1, HEIGHT, WIDTH, 4) or img.dtype != torch.uint8:
        raise RuntimeError(f"bad frame {tuple(img.shape)} {img.dtype}")
    if not torch.equal(img, img_plain):
        raise RuntimeError("frame differs from its plain-raster twin")
    phase("headline", "frame equals its plain-raster twin byte for byte")

    hit = (vis.pair >= 0).reshape(-1)
    covered = float(hit.float().mean())
    gr = frame_mod._worklist_granule(config, WIDTH * HEIGHT)
    dilated = int(hit.reshape(-1, gr).any(dim=1).sum()) * gr
    need = stats["opaque_px_needed"] / (WIDTH * HEIGHT)
    rgb = img[0, :, :, :3].reshape(-1, 3).float()
    helmet_mean = float(rgb[hit].mean())
    sky_mean = float(rgb[~hit].mean())
    black = float((rgb[hit].amax(dim=1) == 0).float().mean())
    phase("headline", f"covered {covered:.4f}, granule-dilated {dilated} px vs "
          f"opaque_px_needed {stats['opaque_px_needed']} ({need:.4f} of npx); "
          f"helmet mean {helmet_mean:.1f}, sky mean {sky_mean:.1f}, "
          f"black helmet px {black:.4f}")
    if dilated != stats["opaque_px_needed"] or not 0.0 < covered <= need:
        raise RuntimeError("coverage disagrees with the opaque_px_needed stat")
    if helmet_mean < 10.0 or sky_mean < 10.0 or black > 0.01:
        raise RuntimeError("helmet or sky is black")

    small_gpu = headline_scene(256, 128, dev)
    small_cpu = headline_scene(256, 128, "cpu")
    img_g = render_frame(small_gpu[0], small_gpu[1](0.3), small_gpu[2], small_gpu[3]).cpu()
    img_c = render_frame(small_cpu[0], small_cpu[1](0.3), small_cpu[2], small_cpu[3])
    golden = np.load(HERO_GOLDEN)["image"]
    db_cpu = psnr(img_g.numpy(), img_c.numpy())
    db_ref = psnr(img_g.numpy(), golden)
    phase("headline", f"256x128 frame: card vs CPU PSNR {db_cpu:.2f} dB, card vs the "
          f"JAX reference's frame (tests/goldens) PSNR {db_ref:.2f} dB")
    if min(db_cpu, db_ref) < 40.0:
        raise RuntimeError("card frame disagrees with the CPU frame or the reference")

    kb_results = {"max_abs_err": 0.0}
    cb_raster = {"max_abs_err": 0.0}
    cb_launches = clip_blend_path(dev, kb_results, cb_raster)
    results["max_abs_err"] = max(results["max_abs_err"], cb_raster["max_abs_err"])

    for mod in ("jax", "superconductor_tpu"):
        if sys.modules.get(mod) is not None:
            raise RuntimeError(f"{mod} was imported")
    phase("imports", "neither jax nor superconductor_tpu was imported")

    print(json.dumps({"kernels": [{
        "name": "raster_sorted",
        "route": "cuda",
        "source": "superconductor_tpu_torch/csrc/raster.cu",
        "replaces": "superconductor_tpu/ops/raster_pallas.py:80",
        "launches": launches + cb_launches["raster_sorted"],
        "max_abs_err": results["max_abs_err"],
        "ms": results["ms"],
        "plain_ms": results["plain_ms"],
        "bound_ms": results["bound_ms"],
        "bound_by": results["bound_by"],
        "library_ms": None,
    }, {
        "name": "kbuffer_sorted",
        "route": "cuda",
        "source": "superconductor_tpu_torch/csrc/kbuffer.cu",
        "replaces": "superconductor_tpu/ops/raster_pallas.py:314",
        "launches": cb_launches["kbuffer_sorted"],
        "max_abs_err": kb_results["max_abs_err"],
        "ms": kb_results["ms"],
        "plain_ms": kb_results["plain_ms"],
        "bound_ms": kb_results["bound_ms"],
        "bound_by": kb_results["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
