"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives superconductor_tpu_torch's paths at 1920x1080 on the first CUDA
device -- the headline frame (hero_helmet.glb, opaque PBR + IBL
sky), the clip_blend frame (BASELINE config 3: the helmet plus a ring of
spheres, alpha-clipped and alpha-blended ones among them), the
all-passes frame (dense_terrain.glb, the ring, lines and particles) and
the stereo-animated frame (BASELINE configs 4 and 5: two eyes of skinned
tubes and spheres), both of them again sharded over a grid of views and
bands, the lit frame, and the app layer (the frame server and the demo
through the ECS) -- and checks them:

1. device: nvidia-smi name and power limit, torch's device name;
2. build: compiles csrc/raster.cu, csrc/kbuffer.cu and csrc/sample.cu
   (nvcc, sm_90a, one process each, at once) and prints the seconds, the
   compiler's
   registers, shared memory and spills of every kernel variant, and the
   k-buffer kernel's dynamic shared memory per template K;
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
   the 1080p frame with its material pool as the wide mq3 rows
   (Scene.matq3x3) >= 40 dB from it, and with shade_row_pad=128 equal to
   it byte for byte, each timed;
5. the raster kernel on the clip_blend frame's opaque setup, timed as in
   3; the k-buffer kernel against its plain version on the card, bit for
   bit in every depth plane, pair plane and layers count, for K in {1, 2,
   4, 8, 16}, with and without depth planes and at every cluster size: the
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
   reference's frame in tests/goldens (>= 40 dB); the same frame rendered
   on the card and on the CPU with every intermediate of render/frame.py
   recorded (TRACED: setup rows, bins, raster and k-buffer planes,
   worklists, g-buffers, albedo alpha, samples, shaded rows, the frame)
   and the first that differs printed, with its size and the stats;
7. all_passes (the terrain, the sphere ring, grid lines and particles,
   every pass on): fit_caps, with the material-path partition engaged; a
   stats frame that records each pass's inputs; the raster kernel at the
   lines pass's shape (line quads walked from the post-clip depth as its
   init buffer) and at the opaque pass's, and the k-buffer kernel at the
   particle pass's (particle quads over the lines' depth, K =
   particle_layers), the clip pass's (K = 16 with depth planes: 9 layers
   on some pixel) and the blend pass's, against their plain versions for
   every K and cluster size, bit for bit, and timed at the frame's K as in
   3 and 5;
   20 frames timed with CUDA events, each pass's launches counted in that
   run, exactly one a frame for each (2 raster and 3 k-buffer); the frame
   against its plain-versions twin (byte-equal); the frame with the sky
   worklist forced on at its sky_px_needed (fit_caps leaves it off here)
   equal to it byte for byte; lines and particles each change it; a
   256x128 frame (at the capacities stored with its golden) on the card
   against the CPU frame and the JAX reference's frame in tests/goldens
   (>= 40 dB);
   deep_k: the all-passes frame with 40 particles stacked along its view
   ray (two at one depth), fit_caps growing particle_layers to 64; the
   deep kernel's band and shared memory at each K and its largest K; the
   particle pass's k-buffer kernel on that frame's inputs against its plain
   version, bit for bit, at K = 3 (the next template's first planes), 17,
   24, 32, 64 and 128 (the deep kernel), at every cluster size, each timed
   with its bound and share (every cluster size and tile variant); the
   global-memory kernel on the same inputs at K = 24, 32 and 64, equal to
   the deep kernel and timed beside it; the peak memory of a K = 64 call
   without depth planes (its pair planes and layers only); the 2,044-row
   tile at K = 3, 5, 12, 17, 24, 32, 64, 128 and one past the deep
   kernel's largest K in both z directions, with and without a floor, at
   every cluster size; the frame's launches by pass (one a frame each)
   and its plain-versions twin, byte for byte;
8. stereo (two eyes, six skinned tubes whose joint palettes come from the
   native FK walk each frame, six spheres): the host time per frame of the
   palettes on the native and the numpy FK and the largest ulp gap between
   the two, the native draws against the numpy walk's (every column) and
   each one's build and upload time; fit_caps; the raster kernel
   against its plain version on each eye's opaque setup and on a band at
   y_offset 540, at every cluster size, and timed as in 3; 20 frames timed
   with CUDA events, the raster's launches counted per eye, exactly one a
   view a frame (num_views x row_chunks = 2) and no k-buffer launch; the
   frame against its plain-raster twin and against itself in two bands
   (4 launches), byte for byte; the eyes differ and the animation moves;
   a 256x128 frame on the card against the CPU frame and the JAX
   reference's in tests/goldens (>= 40 dB), and its raster="ref" twin on
   the card equal to it; its g-buffer lanes traced: every
   interpolate_gbuffer intermediate from the card frame's inputs on both
   devices, with the three-term sums by torch.sum and in the fixed order
   the port takes, the first that differs named, and the frame card vs
   CPU with each;
9. sharded (parallel.render_frame_sharded on the stereo and all-passes
   frames of 7 and 8, at their fitted caps): the stereo frame on a grid of
   2 eyes x 4 bands of 270 rows and the all-passes frame on 1 x 4 bands,
   the cells taking the visible cards in turn (all cuda:0 on one card),
   each cell rendering the frame's raster tiles that hold its band (rows
   0-288, 256-544, 512-832, 800-1080); each cell's raster and k-buffer
   calls against their plain versions bit for bit at every cluster size
   and every K, each timed at the wrapper's cluster size (device time),
   one call and the plain version over 5 runs, and the same calls cut to
   the band's own 270 rows (both kernels at y_offset 270, 540 and 810) bit
   for bit; each sharded frame byte-equal to its render_frame image (and
   the pixels printed where render_frame in 4 row_chunks, each band on a
   tile grid of its own, differs from it), timed
   with CUDA events (median of 5 after a warm-up), its launches counted
   per band pass in that run, one a frame in each: 8 raster launches a
   stereo frame, 4 opaque and 4 lines raster and 4 clip, 4 particle and 4
   blend k-buffer launches an all-passes frame;
10. lit_passes (the all-passes frame lit as bench.py lights it: the SH
   light volume, a lightmapped wall and the smoke pool, from seeded data):
   the scene's time to the card and the sizes of its SH-interleaved and
   smoke pools, all four present with the smoke pool's static placement
   bound; fit_caps, with the partition engaged and live lightmapped lanes
   in the stats frame; the raster kernel at the opaque pass's setup against
   its plain version at every cluster size, and timed as in 3; 20 frames
   timed with CUDA events, each pass's launches counted in that run, one a
   frame for each of the 2 raster and 3 k-buffer passes; the frame against
   its plain-versions twin and its classic-smoke twin (smoke pool removed),
   byte for byte, and against its layered-SH twin (SH pools removed) at
   >= 40 dB; the light volume, the lightmaps and the smoke maps each change
   it; a 256x128 frame (at the capacities stored with its golden) on the
   card against the CPU frame and the JAX reference's frame in
   tests/goldens (>= 40 dB, stats equal);
11. app (the app layer, python -m superconductor_tpu_torch.serve and
    .demo, in this process): the frame server on dense_terrain.glb --
    its capacity probe (a subprocess; a failed probe fails the run), a 5 s
    selftest at 2 frames in flight and stats_interval 0 with the probe's
    caps, latency p50 / p90 / p99, frames per second, the host ms per frame
    of each FrameProfiler scope, and the raster kernel's launches over the
    timed frames (one a frame a view a band); then the same app settled at
    stats_interval 1, its frame byte-equal to the frame at stats_interval
    0, to the frame rendered with both plain versions and to render_frame
    on a frame state built without the ECS from tables rebuilt whole
    (scene_to_torch, equal to the app's resident DeviceScene tables); the
    opaque pass's kernel against its plain version on that frame's inputs
    at every cluster size, and timed; then the demo for 8 frames on
    hero_helmet.glb with the skinned ribbon (scenes.skinned_ribbon_glb),
    debug overlays and particles: 8 PNGs written, the lines raster and the
    particle k-buffer passes (and the opaque, clip and blend passes)
    launching their kernel once every rendered frame, each of the five
    passes' kernels against its plain version on the last frame's inputs at
    every K and cluster size (lines and particles timed; the particles need
    more than K / 2 layers on some pixel; the clip and blend inputs are
    empty, as the content has no such material), and the ribbon's
    animation changing pixels at one camera; the server frame's native
    draws against the numpy walk's, and each one's build time;
12. roofline: the card's ceilings (utils/roofline.py): bf16 matmul
    TFLOP/s, stream GB/s, random-row gather Mrows/s and the dispatch
    floor, each by the dispatch-count slope of CUDA-event times;
13. bench: python3 -m superconductor_tpu_torch.bench in a subprocess (the
    headline, all_passes and stereo frames at 1920x1080, each held byte for
    byte against its plain-versions twin (every kernel's plain version),
    then timed; the card's ceilings)
    with a budget of BENCH_BUDGET_S; its last line printed, and it must
    exit 0 with the three frame rates, each configuration's device busy
    time, idle share and launches, "correct": true and this card's name;
14. graph (render_frame and render_frame_stats replay one CUDA graph a
    frame on the card, render/frame_graph.py): the headline, all-passes
    and stereo frames (the stereo joint palettes from the FK walk at each
    pose) at three poses, each replayed frame byte-equal to
    render_frame_impl's eager frame, image and stats; no
    device-synchronising call in an eager frame (profile_frame.sync_sites,
    its control a .item()), and an eager frame and two replays under
    torch.cuda.set_sync_debug_mode("error"); the launch counters' delta per
    replay equal to an eager frame's and to the hand kernels' events in a
    profiled replay (the raster, the k-buffer and both material samplers);
    eager and graph frame times (CUDA events over 10 frames; stereo also
    with its state and FK built each frame) beside nvidia-smi's name and
    power limit, and the launches of the timed replays;
15. sampler (the material samplers, csrc/sample.cu): every sampler call of
    one eager headline, all-passes and stereo frame recorded and held bit
    for bit against its plain version on its inputs; each site and shape
    timed (kernel and plain version, bench_raster.graph_ms) with its bound
    (bytes: the lanes' inputs, the material ints, the 32-B sectors of
    texel bytes the call uses, 16 B a slot written) and the time of one
    index_select of the texel rows it fetches as a yardstick for the
    gathers; each scene's graph frame byte-equal, image and stats, to its
    twin with every plain version swapped in and to its twin with only the
    samplers swapped; a replay's launch tally holding the samplers' calls
    of an eager frame; then the main path: every launch counter set to 0,
    every graph captured anew, 10 graph frames of each of the three, the
    counters read, each launch also counted at its site (a capture's tally
    of sites added at each replay), and each sampler kernel, and each
    site, must have launched its eager frame's calls a frame;
16. neither jax nor the JAX package (superconductor_tpu) was imported.

Any failure raises (non-zero exit) before the result lines. The last two
lines are the kernel table and the device record, each one JSON object.
The table holds the raster and k-buffer kernels (launches summed over the six frames' and
the two sharded frames' timed runs, the app phase's server and demo runs
and the graph phase's timed replays), the all-passes and lit frames' five passes, the stereo frame's two
eyes and each band pass of the two sharded frames, each with the launches
it made in that frame's timed run, the frame server's opaque pass
(launches over the selftest's timed frames) and the demo's lines and
particle passes (launches over the demo run), and the deep_k frame's
particle pass at K = 64, the deep kernel (launches in that frame's timed
run); then the two material samplers at their largest call (launches over
the sampler phase's main-path run and the graph phase's timed replays) and
at each site and shape of the headline, all-passes and stereo frames
(the launches counted at that site in the main-path run). A sampler
replaces no TPU kernel: its "replaces" names
the JAX package's XLA functions, and its library_ms is null (no one
PyTorch call computes it). Its bound is sampler_bound's.
A kernel's bound_ms is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations (12 FP32
operations for the three edge functions of a setup row at each pixel of
its tile that its triangle's bounding box covers) over 67 TFLOP/s: the
H100 SXM's published peaks (superconductor_tpu_torch/bench_raster.py
raster_bound). Kernel times are device times (bench_raster.graph_ms: a
CUDA graph of 20 launches).
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from superconductor_tpu_torch.bench import smi_line

N_TIMED = 20
WIDTH, HEIGHT = 1920, 1080  # the headline frame
# the JAX reference's hero frame at 256x128 (tests/test_torch_frame.py)
HERO_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "goldens", "torch_hero_256x128.npz")
# the JAX reference's clip_blend frame at 256x128 (tests/test_torch_clip_blend.py)
CLIP_BLEND_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "goldens", "torch_clip_blend_256x128.npz")
# the JAX reference's all-passes frame at 256x128 and the capacities it was
# rendered with (tests/test_torch_all_passes.py)
ALL_PASSES_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "goldens", "torch_all_passes_256x128.npz")
# the JAX reference's stereo-animated frame at 256x128 and the capacities it
# was rendered with (tests/test_torch_stereo.py)
STEREO_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "goldens", "torch_stereo_256x128.npz")
# the JAX reference's lit frame at 256x128, the capacities it was rendered
# with and its stats (tests/test_torch_lit.py)
LIT_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "goldens", "torch_lit_passes_256x128.npz")
# the lit frame's SH-interleaved and smoke pools (scene/upload.py)
LIT_POOLS = ("lv_sh", "lm_sh", "smoke_ab", "smoke_lut")
# kernel -> (its source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "raster": ("superconductor_tpu_torch/csrc/raster.cu",
               "superconductor_tpu/ops/raster_pallas.py:80"),
    "kbuffer": ("superconductor_tpu_torch/csrc/kbuffer.cu",
                "superconductor_tpu/ops/raster_pallas.py:314"),
    # csrc/sample.cu replaces no TPU kernel: the JAX package computes these in XLA
    "classic_sample": ("superconductor_tpu_torch/csrc/sample.cu",
                       "none (XLA: superconductor_tpu/ops/texture.py:629 sample_anisotropic, "
                       "superconductor_tpu/ops/shade.py:363 _material_rows)"),
    "material_sample": ("superconductor_tpu_torch/csrc/sample.cu",
                        "none (XLA: superconductor_tpu/ops/texture.py:556 "
                        "sample_material_interleaved)"),
}
# the all-passes frame's raster passes and k-buffer passes, in frame order
AP_RASTER = ("opaque", "lines")
AP_KBUFFER = ("clip", "particles", "blend")
# the stereo frame's raster passes: the opaque pass of each eye
EYES = ("left", "right")
# the lit frame's passes: the all-passes frame's, under their own keys
LIT_RASTER = tuple("lit_" + n for n in AP_RASTER)
LIT_KBUFFER = tuple("lit_" + n for n in AP_KBUFFER)
# the app phase's passes: the frame server's opaque pass and the demo's five
APP_RASTER = ("app_opaque",) + tuple("demo_" + n for n in AP_RASTER)
DEMO_KBUFFER = tuple("demo_" + n for n in AP_KBUFFER)
# the sharded phase: each 1080p view in SHARD_BANDS bands of 270 rows, the
# stereo frame on a (2, SHARD_BANDS) grid and the all-passes frame on a
# (1, SHARD_BANDS) one; one key a (view, band) cell's opaque raster, and one
# a band's pass
DEEP_PARTICLES = 40  # particles stacked along the all-passes view ray: K grows to 64
DEEP_KS = (3, 17, 24, 32, 64, 128)  # deep_k: the particle pass's kernel at each K, timed
DEEP_CHECK_KS = (3, 5, 12, 17, 24, 32, 64, 128)  # deep_k: the heavy tile at each K, bit for bit
DEEP_GLOBAL_KS = (24, 32, 64)  # deep_k: the global-memory kernel timed beside the deep one
SHARD_BANDS = 4
SHARD_RUNS = 5  # timed runs of a sharded frame, and of a band's one call and plain version
SH_STEREO = tuple(f"sharded_{eye}_band{b}" for eye in EYES for b in range(SHARD_BANDS))
SH_RASTER = tuple(f"sharded_{n}_band{b}" for b in range(SHARD_BANDS) for n in AP_RASTER)
SH_KBUFFER = tuple(f"sharded_{n}_band{b}" for b in range(SHARD_BANDS) for n in AP_KBUFFER)
BENCH_BUDGET_S = 400  # the bench's SC_BENCH_BUDGET_S: every configuration starts within it
BENCH_TIMEOUT_S = 900
# keys the bench's line must hold, beside "correct" and "device"
BENCH_KEYS = ("value", "device_frame_ms", "all_passes_true_fps", "stereo_anim_true_fps",
              "stereo_anim_dispatch_fps", "matmul_tflops_ceiling") + tuple(
    prefix + key for prefix in ("", "all_passes_", "stereo_anim_")
    for key in ("device_busy_ms", "idle_share", "launches_per_frame"))
# the graph phase: the poses (angle or time) each frame is held at, the frames
# a timing, and the hand kernels' names among a profile's device events
GRAPH_POSES = (0.0, 0.9, 2.1)
GRAPH_TIMED = 10
HAND_KERNELS = re.compile(
    r"\b(raster_sorted|kbuffer_sorted|kbuffer_deep|kbuffer_global|classic_sample|"
    r"material_sample)_kernel\b")
# render/frame.py names whose results trace_frame records, called in
# pipeline order: setup rows, bins, the raster planes, the k-buffer planes
# and layers, worklists, g-buffers, albedo alpha, material samples, sky,
# shaded rows, the tonemap and the u8 frame
TRACED = ("_merged_vertex_stage", "_merged_setup_for_view", "bin_triangles",
          "gather_sorted_setup", "rasterize_sorted", "kbuffer_sorted", "_compact_worklist",
          "interpolate_gbuffer", "albedo_alpha", "_partition_material_sample",
          "sample_skybox", "sample_skybox_at", "shade", "shade_particles",
          "tonemap_and_encode", "to_u8")


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
                   y_offset=0, init=None, clusters=None, min_rows=1, timed=False,
                   sweep_sizes=True, runs=N_TIMED):
    """Kernel vs plain on the binned, sorted setup of `tri`, at each cluster
    size in `clusters` (None: the wrapper's RASTER_CLUSTER). The heaviest
    tile must hold `min_rows` rows (0: the target may be empty). With
    `timed`, records in `results` the kernel's device time at
    RASTER_CLUSTER (with `sweep_sizes`, every size and tile variant is
    printed), one call's time and the plain version's (median of `runs`),
    the bound and the heaviest tile."""
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
    if covered == 0.0 and min_rows > 0:
        raise RuntimeError(f"{name}: nothing covered")
    results["max_abs_err"] = max(results["max_abs_err"], err)
    if timed:

        def run(tile_count):
            return graph_ms(lambda: rasterize_sorted(sorted_setup, bins.tile_start, tile_count,
                                                     height, width, **kw))

        times = (sweep(run, bins.tile_count, "RASTER_CLUSTER") if sweep_sizes
                 else {RASTER_CLUSTER: {"all tiles": run(bins.tile_count)}})
        one_call = cuda_ms(lambda: rasterize_sorted(*args, **kw), runs)
        plain_ms = cuda_ms(lambda: rasterize_sorted_plain(*args, **kw), runs)
        bound_ms, bound_by, pairs = raster_bound(tri.bbox, bins, width, height,
                                                 8 if init is None else 16, y_offset)
        ms = times[RASTER_CLUSTER]["all tiles"]
        results.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       one_call_ms=one_call, heaviest=heaviest, pairs=pairs)
        phase("raster", f"{name}: kernel {ms:.4f} ms at cluster {RASTER_CLUSTER} (device "
              f"time, CUDA graph of 20 launches, median of 20 replays); one call "
              f"{one_call:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, median of "
              f"{runs}); bound {bound_ms:.4f} ms ({bound_by}; {pairs} pairs, heaviest "
              f"tile {heaviest} rows), share {bound_ms / ms:.3f}")
        if sweep_sizes:
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
                    timed=(), sweep_sizes=True, runs=N_TIMED, ks=None):
    """Kernel vs plain for every K of `ks` (None: the templates, KBUFFER_KS)
    and both want_depth on the binned, sorted setup of `tri`, at each
    cluster size in `clusters` (None: the wrapper's, KBUFFER_CLUSTER for a
    template K and KBUFFER_DEEP_CLUSTER above 16; a K above
    KBUFFER_DEEP_MAX_K runs the global-memory kernel, which has no
    cluster, at the first size only). The heaviest tile must hold
    `min_rows` rows.
    Times each (K, want_depth) of `timed` at the wrapper's cluster size
    and, with `sweep_sizes`, at every cluster size with all tiles, the
    heaviest tile only, every other tile and every tile empty; one call and
    the plain version over `runs`. Returns {(K, want_depth): timings} at
    the wrapper's cluster size."""
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
    ks = ks or KBUFFER_KS

    def constant(k):  # the wrapper's cluster size constant at K = k
        return "KBUFFER_CLUSTER" if k <= KBUFFER_KS[-1] else "KBUFFER_DEEP_CLUSTER"

    for k in ks:
        sizes_k = clusters or (getattr(raster_mod, constant(k)),)
        for want in (True, False):
            kw = dict(k=k, reverse_z=reverse_z, depth_floor=floor, y_offset=y_offset,
                      want_depth=want)
            pkb, players = kbuffer_sorted_plain(*args, **kw)
            for cluster in (sizes_k if k <= raster_mod.KBUFFER_DEEP_MAX_K else sizes_k[:1]):
                with kernel_constants(**{constant(k): cluster}):
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
    sizes = ",".join(map(str, clusters)) if clusters else "the wrapper's"
    phase("kbuffer", f"{name}: {width}x{height} pairs={int(bins.num_pairs)} heaviest tile "
          f"{heaviest} rows, K={','.join(map(str, ks))} x want_depth, cluster {sizes}: "
          f"equal (tolerance: bit for bit); max layers {deepest}, covered {float((layers > 0).float().mean()):.4f}")
    if deepest < min_layers:
        raise RuntimeError(f"{name}: at most {deepest} layers, expected >= {min_layers}")
    timings = {}
    for k, want in timed:
        kw = dict(k=k, reverse_z=reverse_z, depth_floor=floor, y_offset=y_offset,
                  want_depth=want)

        def run(tile_count):
            return graph_ms(lambda: kbuffer_sorted(sorted_setup, bins.tile_start, tile_count,
                                                   height, width, **kw))

        at = getattr(raster_mod, constant(k))
        times = (sweep(run, bins.tile_count, constant(k)) if sweep_sizes
                 else {at: {"all tiles": run(bins.tile_count)}})
        ms = times[at]["all tiles"]
        one_call = cuda_ms(lambda: kbuffer_sorted(*args, **kw), runs)
        plain_ms = cuda_ms(lambda: kbuffer_sorted_plain(*args, **kw), runs)
        bound_ms, bound_by, pairs = raster_bound(
            tri.bbox, bins, width, height, y_offset=y_offset,
            **kbuffer_px_bytes(k, want, floor is not None),
        )
        timings[(k, want)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, heaviest=heaviest, pairs=pairs)
        phase("kbuffer", f"{name} K={k} want_depth={want}: kernel {ms:.4f} ms at cluster "
              f"{at} (device time, CUDA graph of 20 launches, median "
              f"of 20 replays); one call {one_call:.4f} ms, plain {plain_ms:.4f} ms "
              f"(CUDA events, median of {runs}); bound {bound_ms:.4f} ms ({bound_by}; "
              f"{pairs} pairs, heaviest tile {heaviest} rows), share {bound_ms / ms:.3f}")
        if sweep_sizes:
            phase("kbuffer", f"{name} K={k} want_depth={want}: " + format_sweep(times))
    return timings


def _tensors(x) -> list:
    """Every tensor in x (nested tuples, NamedTuples, lists, dicts), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


@contextlib.contextmanager
def trace_frame():
    """Inside the block, every call of a TRACED name of render/frame.py
    appends (name, its result's tensors copied to the CPU) to the list
    yielded. Of a g-buffer (a result with .valid), and of what is computed
    from one (a first argument with .valid), only the live lanes are kept:
    dead lanes hold whatever row 0 gives and are never read."""
    from superconductor_tpu_torch.render import frame as frame_mod

    records = []
    real = {name: getattr(frame_mod, name) for name in TRACED}

    def wrap(name, fn):
        def traced(*args, **kw):
            out = fn(*args, **kw)
            live = getattr(out, "valid", None)
            if live is None and args:
                live = getattr(args[0], "valid", None)
            tensors = [t[live] if live is not None and t.shape[:1] == live.shape else t
                       for t in _tensors(out)]
            records.append((name, [t.detach().cpu() for t in tensors]))
            return out

        return traced

    for name, fn in real.items():
        setattr(frame_mod, name, wrap(name, fn))
    try:
        yield records
    finally:
        for name, fn in real.items():
            setattr(frame_mod, name, fn)


def traced_differences(card: list, cpu: list) -> list:
    """The traced results, in call order, where the card's frame differs
    from the CPU's -> [(name, call number, output index, elements that
    differ, of how many, max abs difference)]; NaN equals NaN."""
    if [n for n, _ in card] != [n for n, _ in cpu]:
        raise RuntimeError("the card's and the CPU's frames took different paths")
    calls, out = {}, []
    for (name, a_list), (_, b_list) in zip(card, cpu):
        calls[name] = calls.get(name, 0) + 1
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            if a.shape != b.shape or a.dtype != b.dtype:
                out.append((name, calls[name], i, a.numel(), a.numel(), float("inf")))
                continue
            same = a == b
            if a.is_floating_point():
                same |= torch.isnan(a) & torch.isnan(b)
            if not bool(same.all()):
                err = (a.double() - b.double()).abs()[~same].max()
                out.append((name, calls[name], i, int((~same).sum()), a.numel(), float(err)))
    return out


# the elementwise functions of the shading path whose card and CPU results
# math_ops_card_vs_cpu compares (ops/texture.py sRGB decode and LOD,
# ops/shade.py, ops/tonemap.py)
MATH_OPS = {
    "x ** (1 / 2.2)": lambda x: x ** (1.0 / 2.2),
    "x ** 2.4": lambda x: x ** 2.4,
    "x ** 5": lambda x: torch.pow(x, 5.0),
    "log2": torch.log2,
    "rsqrt": torch.rsqrt,
    "sqrt": torch.sqrt,
    "1 / x": lambda x: 1.0 / x,
    "sum of 3": lambda x: x.reshape(-1, 3, 2).sum(dim=1),
}


def math_ops_card_vs_cpu(dev) -> dict:
    """MATH_OPS on the same 3 x 2^19 seeded values in (0, 4] on the card and
    on the CPU -> {op: (share of results that differ, most ulp apart)}."""
    x = torch.rand(3 << 19, generator=torch.Generator().manual_seed(3)) * 4.0 + 1e-3
    out = {}
    for name, fn in MATH_OPS.items():
        a, b = fn(x.to(dev)).cpu(), fn(x)
        ulp = (a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64)).abs()
        out[name] = (float((a != b).float().mean()), int(ulp.max()))
    return out


def localize_card_cpu_gap(name, make, dev) -> None:
    """Render the frame make(device) -> (tables, state, config, env) on the
    card and on the CPU under trace_frame; print the first traced result
    where they differ, and how many differ by stage, then the stats."""
    from superconductor_tpu_torch.render.frame import render_frame_stats, stats_to_host

    runs = []
    for device in (dev, "cpu"):
        tables, state, config, env = make(device)
        with trace_frame() as records:
            img, stats = render_frame_stats(tables, state, config, env)
        runs.append((records, img.cpu(), stats_to_host(stats)))
    (card, img_card, stats_card), (cpu, img_cpu, stats_cpu) = runs
    diffs = traced_differences(card, cpu)
    db = psnr(img_card.numpy(), img_cpu.numpy())
    phase(name, f"card vs CPU: {len(card)} traced results, {len(diffs)} outputs "
          f"differ; frame PSNR {db:.2f} dB")
    if diffs:
        first = diffs[0]
        phase(name, f"first difference: {first[0]} call {first[1]} output {first[2]}: "
              f"{first[3]} of {first[4]} elements, max abs difference {first[5]!r}")
        by_stage = {}
        for d in diffs:
            by_stage[d[0]] = by_stage.get(d[0], 0) + 1
        phase(name, f"differing outputs by traced name: {by_stage}")
    phase(name, f"stats equal card vs CPU: {stats_card == stats_cpu}")


@contextlib.contextmanager
def host_mode(mode: str):
    """Inside the block the host takes one path: "native" (the port's
    default: the draw build, FK walk and channel sampler of
    native/src/framestate.cpp) or "numpy" (animation's _joint_update_fn
    and _anim_sample_fn set to False and SC_TPU_NO_NATIVE_DRAWS set)."""
    from superconductor_tpu_torch import animation

    saved = (animation._joint_update_fn, animation._anim_sample_fn,
             os.environ.get("SC_TPU_NO_NATIVE_DRAWS"))
    if mode == "numpy":
        animation._joint_update_fn = animation._anim_sample_fn = False
        os.environ["SC_TPU_NO_NATIVE_DRAWS"] = "1"
    try:
        yield
    finally:
        animation._joint_update_fn, animation._anim_sample_fn = saved[:2]
        if saved[2] is None:
            os.environ.pop("SC_TPU_NO_NATIVE_DRAWS", None)
        else:
            os.environ["SC_TPU_NO_NATIVE_DRAWS"] = saved[2]


def max_ulp_gap(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in ulps between two f32 arrays' elements (the
    bit patterns mapped onto one ordered integer line, -0.0 on 0.0)."""

    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i >= 0, i, -(i & 0x7FFFFFFF))

    return int(np.abs(ordered(a) - ordered(b)).max()) if a.size else 0


def draws_equal(a, b) -> bool:
    """Two FrameStates' static and animated draws and joint palettes equal
    on every column (torch.equal)."""
    return all(
        torch.equal(getattr(getattr(a, d), f), getattr(getattr(b, d), f))
        for d in ("draws_static", "draws_animated")
        for f in getattr(a, d)._fields
    ) and torch.equal(a.joint_palette, b.joint_palette)


def host_draws(name: str, build) -> dict:
    """build() -> FrameState, on both host paths: the native draws against
    the numpy walk's (every column), and build's host ms on each path
    (median of N_TIMED, the upload synchronised). Fails when they differ."""
    ms, states = {}, {}
    for mode in ("native", "numpy"):
        with host_mode(mode):
            times = []
            for _ in range(N_TIMED):
                t0 = time.perf_counter()
                states[mode] = build()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        ms[mode] = statistics.median(times)
    equal = draws_equal(states["native"], states["numpy"])
    phase("host", f"{name}: native draws equal the numpy walk's on every column: {equal}; "
          f"build_frame_state host ms a frame (median of {N_TIMED}, with upload): native "
          f"{ms['native']:.3f}, numpy {ms['numpy']:.3f} ({smi_line()})")
    if not equal:
        raise RuntimeError(f"{name}: the native draws differ from the numpy walk's")
    return ms


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

    def small_frame(device):
        tables, build_small, cfg, env_small = clip_blend_scene(w, h, device, **small)
        return tables, build_small(0.3), cfg, env_small

    localize_card_cpu_gap("clip_blend", small_frame, dev)
    phase("clip_blend", "elementwise functions, card vs CPU on the same values (share that "
          "differ, most ulp apart): " + ", ".join(
              f"{op} {share:.4f} {ulp}" for op, (share, ulp) in math_ops_card_vs_cpu(dev).items()))
    golden = np.load(CLIP_BLEND_GOLDEN)["image"]
    db_cpu = psnr(img_g.numpy(), img_c.numpy())
    db_ref = psnr(img_g.numpy(), golden)
    phase("clip_blend", f"{w}x{h} frame: card vs CPU PSNR {db_cpu:.2f} dB, card vs the "
          f"JAX reference's frame (tests/goldens) PSNR {db_ref:.2f} dB")
    if min(db_cpu, db_ref) < 40.0:
        raise RuntimeError("card frame disagrees with the CPU frame or the reference")
    return launches


def all_passes_golden_frame(device):
    """The 256x128 all-passes frame at angle 0.3 on `device`, with the
    capacities stored beside the reference's image in ALL_PASSES_GOLDEN."""
    from superconductor_tpu_torch.render.frame import render_frame
    from superconductor_tpu_torch.scenes import ALL_PASSES_SMALL, all_passes_scene

    caps = {k: tuple(v) if isinstance(v, list) else v
            for k, v in json.loads(str(np.load(ALL_PASSES_GOLDEN)["caps"])).items()}
    small = dict(ALL_PASSES_SMALL)
    w, h = small.pop("width"), small.pop("height")
    scene_dev, build_state, config, env = all_passes_scene(w, h, device, **small)
    return render_frame(scene_dev, build_state(0.3), replace(config, **caps), env)


@contextlib.contextmanager
def frame_passes(keep_inputs: bool):
    """Inside the block, each raster and k-buffer pass of the frame path
    (render/frame.py _rasterize, _rasterize_kbuffer) appends to
    passes["raster"] / passes["kbuffer"], in call order, the launches its
    kernel's wrapper counted during the call and, with `keep_inputs`, the
    pass's inputs: (tri, init, rows, y_offset) and (tri, depth_floor,
    want_depth, K, rows, y_offset)."""
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.render import frame as frame_mod

    passes = {"raster": [], "kbuffer": []}
    real_r, real_k = frame_mod._rasterize, frame_mod._rasterize_kbuffer

    def rec_raster(tri, cfg, band_height, y_offset, init=None):
        before = raster_mod.rasterize_sorted.LAUNCHES
        out = real_r(tri, cfg, band_height, y_offset, init=init)
        passes["raster"].append((raster_mod.rasterize_sorted.LAUNCHES - before,
                                 (tri, init, band_height, y_offset) if keep_inputs else None))
        return out

    def rec_kbuffer(tri, cfg, band_height, y_offset, depth_floor, want_depth=True, k=None):
        before = raster_mod.kbuffer_sorted.LAUNCHES
        out = real_k(tri, cfg, band_height, y_offset, depth_floor, want_depth=want_depth, k=k)
        inputs = (tri, depth_floor, want_depth, k or cfg.blend_layers, band_height, y_offset)
        passes["kbuffer"].append((raster_mod.kbuffer_sorted.LAUNCHES - before,
                                  inputs if keep_inputs else None))
        return out

    frame_mod._rasterize, frame_mod._rasterize_kbuffer = rec_raster, rec_kbuffer
    try:
        yield passes
    finally:
        frame_mod._rasterize, frame_mod._rasterize_kbuffer = real_r, real_k


def timed_passes(name, scene_dev, state0, config, env, render=None, raster_names=AP_RASTER,
                 kbuffer_names=AP_KBUFFER, runs=N_TIMED):
    """`runs` frames (render_frame, or `render`) timed with CUDA events
    after a warm-up frame, each raster and k-buffer pass's kernel launches
    counted in that run; the passes of a frame come in the order of
    `raster_names` and `kbuffer_names`. Fails unless every pass launched
    its kernel once a frame. -> (frame ms, launches by kernel, launches by
    pass)."""
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.render.frame import render_frame

    render = render or render_frame
    raster_mod.rasterize_sorted.LAUNCHES = 0
    raster_mod.kbuffer_sorted.LAUNCHES = 0
    frames = [0]

    def one_frame():
        frames[0] += 1
        return render(scene_dev, state0, config, env)

    with frame_passes(keep_inputs=False) as passes:
        frame_ms = cuda_ms(one_frame, runs)
    launches = {"raster_sorted": raster_mod.rasterize_sorted.LAUNCHES,
                "kbuffer_sorted": raster_mod.kbuffer_sorted.LAUNCHES}
    by_pass = {}
    for kind, names in (("raster", raster_names), ("kbuffer", kbuffer_names)):
        counts = [n for n, _ in passes[kind]]
        if len(counts) != len(names) * frames[0]:
            raise RuntimeError(f"{len(counts)} {kind} passes over {frames[0]} frames, "
                               f"expected {len(names)} a frame")
        by_pass.update({pname: sum(counts[i::len(names)]) for i, pname in enumerate(names)})
    phase(name, f"frame {frame_ms:.3f} ms (CUDA events, median of {runs}); "
          f"launches {launches} over {frames[0]} frames, by pass {by_pass}")
    if set(by_pass.values()) != {frames[0]} or sum(by_pass.values()) != sum(launches.values()):
        raise RuntimeError(f"the {name} frame did not launch its kernel once a frame in each "
                           f"of its {len(raster_names)} raster and {len(kbuffer_names)} "
                           f"k-buffer passes")
    return frame_ms, launches, by_pass


def compare_passes(frame: str, calls: dict, p_cap: int, shapes: dict, prefix: str = "",
                   min_layers: dict = None, timed: tuple = AP_RASTER + AP_KBUFFER,
                   band: bool = False, suffix: str = ""):
    """Each of the five passes' kernels on the inputs `calls` recorded from
    a stats frame (frame_passes): the opaque raster, the lines raster (init
    buffer), the clip, particle and blend k-buffers, each at the K fit_caps
    pinned to the next power of two of its need, so more than K / 2 layers
    on some pixel (or min_layers[pass] where given; 0 lets the pass be
    empty, as the demo's clip and blend passes are: its helmet and ribbon
    have no clip or blend material, so those two are held on empty inputs
    and show only that they launch). Every pass is held
    against its plain version at every cluster size; the passes in `timed`
    are timed into shapes[prefix + pass + suffix]. With `band` the calls
    are one band's of a sharded frame: any pass may be empty there, and
    each is timed at the wrapper's cluster size only, one call and the
    plain version over SHARD_RUNS runs."""
    from superconductor_tpu_torch.bench_raster import CLUSTERS

    if len(calls["raster"]) != 2 or len(calls["kbuffer"]) != 3:
        raise RuntimeError(f"the {frame} frame made {len(calls['raster'])} raster and "
                           f"{len(calls['kbuffer'])} k-buffer passes, expected 2 and 3")
    min_layers = min_layers or {}
    kw = dict(clusters=CLUSTERS)
    if band:
        kw.update(sweep_sizes=False, runs=SHARD_RUNS)
        min_layers = dict.fromkeys(AP_KBUFFER, 0)
    for name, (tri, init, rows, y0) in zip(AP_RASTER, calls["raster"]):
        compare_raster(f"{frame}-{name}", tri, WIDTH, rows, p_cap,
                       shapes[prefix + name + suffix], init=init, y_offset=y0,
                       min_rows=0 if band else 1, timed=name in timed, **kw)
    for name, (tri, floor, want, k, rows, y0) in zip(AP_KBUFFER, calls["kbuffer"]):
        least = min_layers.get(name, k // 2 + 1)
        key = prefix + name + suffix
        timings = compare_kbuffer(f"{frame}-{name}", tri, WIDTH, rows, p_cap, shapes[key],
                                  y_offset=y0, floor=floor, min_layers=least,
                                  min_rows=min(least, 1),
                                  timed=[(k, want)] if name in timed else (), **kw)
        shapes[key].update(timings.get((k, want), {}))


def all_passes_path(dev, shapes: dict) -> dict:
    """Phase 7: the all-passes frame (the terrain, the sphere ring, grid
    lines and particles; every pass on) at 1920x1080 after fit_caps; the
    raster kernel at the lines pass's shape (line quads walked from the
    post-clip depth as init), the k-buffer kernel at the particle pass's
    (particle quads over the lines' depth, no depth planes), and each other
    pass's kernel at its shape (the clip pass at K = 16), against their
    plain versions at every cluster size, and timed; the frame's launches
    by pass (one a frame each), its plain-versions twin, the sky worklist
    forced on, and the 256x128 frame against the CPU and the reference's
    golden. Returns the launch counts of the timed run, by kernel and by
    pass, and the frame with its inputs (tables, state, fitted config,
    env, image)."""
    from superconductor_tpu_torch.bench import plain_kernels_frame
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.frame import (
        render_frame,
        render_frame_stats,
        stats_to_host,
    )
    from superconductor_tpu_torch.scenes import all_passes_scene

    t0 = time.perf_counter()
    scene_dev, build_state, config, env = all_passes_scene(WIDTH, HEIGHT, dev)
    state0 = build_state(0.0)
    phase("all_passes", f"scene on card in {time.perf_counter() - t0:.2f} s; "
          f"{int(state0.draws_static.tri_count.sum())} static triangles drawn")
    t0 = time.perf_counter()
    config = fit_caps(scene_dev, state0, config, env,
                      log=lambda s, g: phase("fit_caps", f"{s} grow={g or None}"))
    npx = WIDTH * HEIGHT
    engaged = {
        "sky_px_cap": 0 < (config.sky_px_cap or 0) < npx,
        "matq_classic_cap": (config.matq_classic_cap or 0) > 0,
        "particle_layers": config.particle_layers is not None,
    }
    phase("all_passes", f"fit_caps in {time.perf_counter() - t0:.2f} s: p_cap={config.p_cap} "
          f"clip_layers={config.clip_layers} blend_layers={config.blend_layers} "
          f"particle_layers={config.particle_layers} shade_px_cap={config.shade_px_cap} "
          f"shade_px_caps={config.shade_px_caps} opaque_px_cap={config.opaque_px_cap} "
          f"sky_px_cap={config.sky_px_cap} matq_classic_cap={config.matq_classic_cap}; "
          f"engaged {engaged}")
    if not engaged["matq_classic_cap"]:
        raise RuntimeError("the material-path partition did not engage")

    # one stats frame, recording the inputs of each raster and k-buffer pass
    with frame_passes(keep_inputs=True) as passes:
        img, stats = render_frame_stats(scene_dev, state0, config, env)
    calls = {kind: [inputs for _, inputs in passes[kind]] for kind in passes}
    stats = stats_to_host(stats)
    phase("all_passes", f"stats {stats}")
    if min(stats["clip_layers_needed"], stats["blend_layers_needed"],
           stats["particle_layers_needed"]) < 1:
        raise RuntimeError("the all-passes frame has no clip, blend or particle fragment")

    # --- each pass's kernel at its shape (the clip pass: 9 layers, K = 16) ---
    compare_passes("all_passes", calls, config.p_cap, shapes)

    # --- the frame ---
    _ms, launches, by_pass = timed_passes("all_passes", scene_dev, state0, config, env)

    img = render_frame(scene_dev, state0, config, env)
    img_plain = plain_kernels_frame(scene_dev, state0, config, env)
    if img.shape != (1, HEIGHT, WIDTH, 4) or img.dtype != torch.uint8:
        raise RuntimeError(f"bad frame {tuple(img.shape)} {img.dtype}")
    if not torch.equal(img, img_plain):
        raise RuntimeError("all-passes frame differs from its plain-kernels twin")
    phase("all_passes", "frame equals its twin rendered with both plain versions byte for byte")

    # the sky worklist, forced on at the frame's own need
    sky_cap = stats["sky_px_needed"]
    img_sky, sky_stats = render_frame_stats(scene_dev, state0,
                                            replace(config, sky_px_cap=sky_cap), env)
    sky_need = stats_to_host(sky_stats)["sky_px_needed"]
    phase("all_passes", f"sky worklist at sky_px_cap={sky_cap} of {npx} px: sky_px_needed "
          f"{sky_need}, frame equal to the full-screen sky's: {torch.equal(img_sky, img)}")
    if not 0 < sky_cap < npx or sky_need != sky_cap or not torch.equal(img_sky, img):
        raise RuntimeError("the sky-worklist frame differs from the full-screen sky's")

    # lines and particles both change the frame
    for flag in ("enable_lines", "enable_particles"):
        off = render_frame(scene_dev, state0, replace(config, **{flag: False}), env)
        changed = int((img[0] != off[0]).any(dim=-1).sum())
        phase("all_passes", f"{flag}: {changed} px change")
        if changed == 0:
            raise RuntimeError(f"{flag} changed no pixel")

    img_g = all_passes_golden_frame(dev).cpu()
    img_c = all_passes_golden_frame("cpu")
    golden = np.load(ALL_PASSES_GOLDEN)["image"]
    db_cpu = psnr(img_g.numpy(), img_c.numpy())
    db_ref = psnr(img_g.numpy(), golden)
    phase("all_passes", f"256x128 frame: card vs CPU PSNR {db_cpu:.2f} dB, card vs the "
          f"JAX reference's frame (tests/goldens) PSNR {db_ref:.2f} dB")
    if min(db_cpu, db_ref) < 40.0:
        raise RuntimeError("card frame disagrees with the CPU frame or the reference")
    return launches, by_pass, (scene_dev, state0, config, env, img)


def deep_k_path(dev, ap_config, shapes: dict) -> tuple:
    """Phase deep_k: the all-passes frame at 1080p with DEEP_PARTICLES
    particles stacked along its view ray (two at one depth), fit_caps from
    the all-passes frame's caps growing particle_layers to 64; the particle
    pass's k-buffer kernel on the stats frame's inputs against its plain
    version at every K of DEEP_KS and every cluster size, timed (device
    time, bound and share, shapes["deep_k<K>"], and at every cluster size
    with every tile variant); the global-memory kernel on the same inputs
    at each K of DEEP_GLOBAL_KS, bit for bit against the deep kernel and
    timed beside it; the peak memory of a K = 64 call without depth planes;
    the 2,044-row tile at every K of DEEP_CHECK_KS and at
    KBUFFER_DEEP_MAX_K + 1 (the global-memory kernel) in both z directions,
    over a floor and without one, and timed at K = 24 and 64 by cluster
    size; the frame's launches by pass in its timed run and its
    plain-versions twin, byte for byte. Returns the launches of the timed
    run, by kernel and by pass."""
    from superconductor_tpu_torch.bench import plain_kernels_frame
    from superconductor_tpu_torch.bench_raster import CLUSTERS, graph_ms
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.ops.binning import bin_triangles, gather_sorted_setup
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.frame import (
        render_frame,
        render_frame_stats,
        stats_to_host,
    )
    from superconductor_tpu_torch.scenes import all_passes_scene, heavy_tile_setup

    t0 = time.perf_counter()
    scene_dev, build_state, config, env = all_passes_scene(WIDTH, HEIGHT, dev,
                                                           deep_particles=DEEP_PARTICLES)
    state0 = build_state(0.0)
    phase("deep_k", f"scene on card in {time.perf_counter() - t0:.2f} s: the all-passes "
          f"frame with {DEEP_PARTICLES} particles along the view ray")
    t0 = time.perf_counter()
    config = fit_caps(scene_dev, state0, ap_config, env,
                      log=lambda s, g: phase("fit_caps", f"{s} grow={g or None}"))
    phase("deep_k", f"fit_caps from the all-passes caps in {time.perf_counter() - t0:.2f} s: "
          f"particle_layers={config.particle_layers} clip_layers={config.clip_layers} "
          f"blend_layers={config.blend_layers} p_cap={config.p_cap}")
    if config.particle_layers != 64:
        raise RuntimeError(f"fit_caps grew particle_layers to {config.particle_layers}, not 64")
    with frame_passes(keep_inputs=True) as passes:
        _img, stats = render_frame_stats(scene_dev, state0, config, env)
    stats = stats_to_host(stats)
    phase("deep_k", f"stats {stats}")
    if stats["particle_layers_needed"] < DEEP_PARTICLES:
        raise RuntimeError("the particle stack does not reach its depth at any pixel")
    tri, floor, want, k, rows, y0 = passes["kbuffer"][AP_KBUFFER.index("particles")][1]
    if k != 64:
        raise RuntimeError(f"the particle pass ran at K={k}, not 64")
    # a deep block of P pixels takes the 8 KB ring and P (8K + 4) bytes
    smem = raster_mod.kbuffer_smem_bytes
    most = raster_mod.KBUFFER_DEEP_MAX_K
    phase("deep_k", "deep kernel blocks: " + ", ".join(
        f"K={kk} {(smem(kk) - 8192) // (8 * kk + 4)} px, {smem(kk)} B"
        for kk in DEEP_KS if kk > 16)
        + f"; largest K {most} ({smem(most)} B; K={most + 1}: {smem(most + 1)})")
    if smem(most) <= 0 or smem(most + 1) != -1:
        raise RuntimeError("KBUFFER_DEEP_MAX_K is not the deep kernel's largest K")
    res = {"max_abs_err": 0.0}
    timings = compare_kbuffer("deep_k-particles", tri, WIDTH, rows, config.p_cap, res,
                              y_offset=y0, floor=floor, min_layers=DEEP_PARTICLES,
                              clusters=CLUSTERS, ks=DEEP_KS,
                              timed=[(kk, want) for kk in DEEP_KS])
    for kk in DEEP_KS:
        shapes[f"deep_k{kk}"] = dict(timings[(kk, want)], max_abs_err=res["max_abs_err"])

    # the global-memory kernel beside the deep one, on the same inputs
    bins = bin_triangles(tri, WIDTH, rows, config.p_cap, y_offset=y0)
    args = (gather_sorted_setup(tri, bins).contiguous(), bins.tile_start, bins.tile_count,
            rows, WIDTH)
    for kk in DEEP_GLOBAL_KS:
        kw = dict(k=kk, depth_floor=floor, y_offset=y0, want_depth=want)
        kb, layers = raster_mod.kbuffer_sorted(*args, **kw)
        gkb, glayers = raster_mod.kbuffer_sorted_global(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(kb.pair, gkb.pair) and torch.equal(layers, glayers)):
            raise RuntimeError(f"deep_k K={kk}: the global-memory kernel != the deep kernel")
        shapes[f"deep_k{kk}"]["global_ms"] = graph_ms(
            lambda: raster_mod.kbuffer_sorted_global(*args, **kw))
    phase("deep_k", f"particle pass ({smi_line()}; device time, CUDA graph of 20 launches, "
          f"median of 20 replays): " + "; ".join(
              f"K={kk} {shapes[f'deep_k{kk}']['ms']:.4f} ms, bound "
              f"{shapes[f'deep_k{kk}']['bound_ms']:.4f} ms ({shapes[f'deep_k{kk}']['bound_by']}), "
              f"share {shapes[f'deep_k{kk}']['bound_ms'] / shapes[f'deep_k{kk}']['ms']:.3f}, "
              f"plain {shapes[f'deep_k{kk}']['plain_ms']:.4f} ms"
              + (f", global-memory kernel {shapes[f'deep_k{kk}']['global_ms']:.4f} ms"
                 if kk in DEEP_GLOBAL_KS else "") for kk in DEEP_KS))

    # no depth planes: a K = 64 call's peak is its pair planes and layers
    kw = dict(k=64, depth_floor=floor, y_offset=y0, want_depth=False)
    raster_mod.kbuffer_sorted(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    kb, layers = raster_mod.kbuffer_sorted(*args, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    planes = 65 * rows * WIDTH * 4
    phase("deep_k", f"K=64 want_depth=False: the call allocates {peak} B at its peak; its "
          f"64 pair planes and layers are {planes} B, 64 depth planes would add "
          f"{64 * rows * WIDTH * 4} B")
    if not planes <= peak < planes + (64 << 20):
        raise RuntimeError("a K = 64 call without depth planes allocated more than its planes")

    gen = torch.Generator(device=dev).manual_seed(5)
    heavy_floor = torch.rand((96, 320), generator=gen, device=dev) * 0.35 + 0.15
    for reverse_z in (True, False):
        heavy = heavy_tile_setup(320, 96, dev, reverse_z=reverse_z)
        for with_floor in (True, False):
            # timed once: where a cluster split pays, a 2,044-row tile
            timed = [(24, False), (64, False)] if reverse_z and with_floor else ()
            compare_kbuffer("deep_k-heavy-tile" + ("" if reverse_z else "-forward-z")
                            + ("" if with_floor else "-no-floor"), heavy, 320, 96, 4096, res,
                            reverse_z=reverse_z,
                            floor=(heavy_floor if reverse_z else 1.0 - heavy_floor)
                            if with_floor else None, min_layers=9, min_rows=2000,
                            clusters=CLUSTERS,
                            ks=DEEP_CHECK_KS + (raster_mod.KBUFFER_DEEP_MAX_K + 1,),
                            timed=timed)

    _ms, launches, by_pass = timed_passes("deep_k", scene_dev, state0, config, env)
    img = render_frame(scene_dev, state0, config, env)
    img_plain = plain_kernels_frame(scene_dev, state0, config, env)
    if img.shape != (1, HEIGHT, WIDTH, 4) or not torch.equal(img, img_plain):
        raise RuntimeError("the deep_k frame differs from its plain-kernels twin")
    phase("deep_k", "frame (particle_layers 64) equals its twin rendered with both plain "
          "versions byte for byte")
    return launches, by_pass


def headline_variants(dev, scene_dev, state0, config, env, img, frame_ms) -> None:
    """The headline frame with its material pool as the wide mq3 rows
    (Scene.matq3x3: one 208 B row a trilinear sample) at the fitted caps:
    >= 40 dB from the default frame, and its frame time; and with
    shade_row_pad=128: byte-equal to the default frame, and its time."""
    from superconductor_tpu_torch import math3d
    from superconductor_tpu_torch.render.draws import build_frame_state
    from superconductor_tpu_torch.render.frame import render_frame
    from superconductor_tpu_torch.scene.upload import scene_to_torch
    from superconductor_tpu_torch.scenes import headline_host

    scene, model, uniforms, _env, _config = headline_host(WIDTH, HEIGHT)
    scene.matq3x3 = True
    dev_mq3 = scene_to_torch(scene, dev)
    width = dev_mq3["texels_mq"].shape[-1]
    sim = math3d.Similarity(rotation=math3d.quat_from_axis_angle([0, 1, 0], 0.0))
    state = build_frame_state(scene, [(model, sim)], uniforms, device=dev)
    img_mq3 = render_frame(dev_mq3, state, config, env)
    db = psnr(img_mq3.cpu().numpy(), img.cpu().numpy())
    padded = replace(config, shade_row_pad=128)
    img_pad = render_frame(scene_dev, state0, padded, env)
    runs = {"default": (scene_dev, state0, config), "mq3": (dev_mq3, state, config),
            "pad": (scene_dev, state0, padded)}
    ms = {name: [] for name in runs}
    for name in ("default", "mq3", "pad", "pad", "mq3", "default"):  # in turns
        tables, st, cfg = runs[name]
        ms[name].append(cuda_ms(lambda: render_frame(tables, st, cfg, env), N_TIMED // 2))
    ms = {name: statistics.median(v) for name, v in ms.items()}
    phase("headline", f"matq3x3 ({width} B rows): PSNR vs the default frame {db:.2f} dB; "
          f"shade_row_pad=128: byte-equal to pad 0: {torch.equal(img_pad, img)}; frame ms "
          f"(CUDA events, two runs of {N_TIMED // 2} in turns, the median of each taken, "
          f"the median of the two): default {ms['default']:.3f}, mq3 {ms['mq3']:.3f}, pad "
          f"{ms['pad']:.3f} (the headline's own run: {frame_ms:.3f}; {smi_line()})")
    if width != 208 or db < 40.0 or not torch.equal(img_pad, img):
        raise RuntimeError("the mq3 frame is under 40 dB from the default one, or the padded "
                           "frame differs from it")


def sampler_wrappers() -> dict:
    """kernel -> (the module the frame looks its wrapper up in, the
    wrapper's name, its plain version): csrc/sample.cu's two kernels."""
    from superconductor_tpu_torch.bench import PLAIN_VERSIONS

    return {k: PLAIN_VERSIONS[k] for k in ("classic_sample", "material_sample")}


@contextlib.contextmanager
def record_samplers():
    """Inside the block, every call of a material sampler's wrapper is
    appended to the list yielded as (kernel, calling function, its
    arguments by name); the wrapper still runs. The arguments are the
    frame's own tensors, strides kept."""
    import inspect

    calls, saved = [], []
    for kernel, (mod, name, _plain) in sampler_wrappers().items():
        real = getattr(mod, name)
        sig = inspect.signature(real)

        def recorded(*args, _kernel=kernel, _real=real, _sig=sig, **kw):
            bound = _sig.bind(*args, **kw)
            bound.apply_defaults()
            calls.append((_kernel, sys._getframe(1).f_code.co_name, dict(bound.arguments)))
            return _real(*args, **kw)

        saved.append((mod, name, real))
        setattr(mod, name, recorded)
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def sampler_site(kernel: str, caller: str, args: dict) -> str:
    """A sampler call's site and shape: its caller, lanes, slots and pool."""
    where = {"seg_sample": "partition", "_interleaved": "whole pool"}.get(caller, caller)
    if kernel == "classic_sample":
        pool = f"({args['pool'].shape[1]}-B rows)"
    else:
        pool = (f"({args['texels_mq'].shape[1]}-B rows"
                + (" + tail)" if args["texels_tail"] is not None
                   and args["texels_mq"].shape[1] == 64 else ")")
                + (" by material id" if args["mat"] is not None else " a row a lane"))
    return (f"{kernel} {where} {args['uv'].shape[0]} lanes slots "
            f"{''.join(map(str, args['slots']))} {pool}")


def sampler_bound(kernel: str, args: dict, fetched: list) -> tuple:
    """(bound_ms, bound_by) of one sampler call: the larger of its bytes
    over 3.35 TB/s and its FP32 operations over 67 TFLOP/s (H100 SXM).
    Bytes, each read once: the lanes' uv and derivatives (24 B) and
    material id (4 B); of each distinct material the lanes name, the ints
    the kernel reads (the classic sampler: a wanted slot's flags, its meta
    and its mip table; the interleaved one: its meta and level entries),
    or with a row a lane its meta and two level entries; the texel bytes
    the call uses, in whole 32-B sectors (texel_sectors); 16 B a slot
    written. The tables' columns are ops/sample.py's. Operations, counted
    from csrc/sample.cu: a bilinear level 76 (tap position 8, the
    4-channel lerp 52, u8 scale 4, sRGB 12 with its powf as one), a
    trilinear 166 (two levels, blend 12, floor 2), a tap 8 more, the LOD
    15."""
    from superconductor_tpu_torch.ops import sample as sample_mod

    lanes, n_slots, taps = args["uv"].shape[0], len(args["slots"]), max(1, int(args["taps"]))
    mat = args["mat"]
    if kernel == "classic_sample":
        table, head, per_level = args["mat_row"], sample_mod.MAT_ROW_HEAD, \
            sample_mod.MAT_ROW_LEVEL
        L = (table.shape[1] - head) // per_level
        per_material = n_slots * (1 + sample_mod.SLOT_META + 3 * L) * 4
    else:
        table, head, per_level = args["rows"], sample_mod.MQ_ROW_HEAD, sample_mod.MQ_ROW_LEVEL
        L = (table.shape[1] - head) // per_level
        per_material = (head - sample_mod.META + per_level * L) * 4
    nbytes = lanes * 24 + lanes * 16 * n_slots + texel_sectors(fetched, args["slots"]) * 32
    if mat is not None:
        distinct = torch.unique(torch.remainder(mat.long(), table.shape[0])).numel()
        nbytes += lanes * 4 + distinct * per_material
    else:
        nbytes += lanes * (head - sample_mod.META + 2 * per_level) * 4
    level, trilinear = 76, 166
    if kernel == "classic_sample":
        ops = lanes * n_slots * (15 + taps * (trilinear + 8))
    else:
        ops = lanes * (15 + taps * (8 + 16 + n_slots * (2 * (level - 8) + 12) + 8))
    bytes_ms, ops_ms = nbytes / 3.35e9, ops / 67e9
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def texel_sectors(fetched: list, slots) -> int:
    """The 32-B sectors of the texel pools that hold bytes a sampler call
    uses: of each distinct row it fetches (fetched_rows), a texel or quad
    row (4 or 16 B) whole; of a 64-B interleaved row the wanted slots'
    16-B quads; of a 208-B mq3 row the wanted slots' quads and 3 x 3 cells
    of the next level (36 B each). A sector two rows share counts once."""
    total = 0
    for pool, rows in fetched_rows(fetched):
        width = pool.shape[1] * pool.element_size()
        if width in (4, 16):
            spans = [(0, width)]
        elif width == 64:
            spans = [(16 * s, 16) for s in slots]
        elif width == 208:
            spans = [(16 * s, 16) for s in slots] + [(64 + 36 * s, 36) for s in slots]
        else:
            raise ValueError(f"a texel pool of {width}-B rows")
        base = torch.unique(rows) * width
        sectors = []
        for off, n in spans:
            first, last = (base + off) // 32, (base + off + n - 1) // 32
            for k in range((n + 31) // 32 + 1):
                sectors.append((first + k)[first + k <= last])
        total += torch.unique(torch.cat(sectors)).numel()
    return total


def fetched_rows(fetched: list) -> list:
    """[(pool, the row indices fetched from it, wrapped as torch's indexing
    wraps them)] of recorded_fetches' list, a pool once."""
    pools = {}
    for pool, index in fetched:
        pools.setdefault(pool.data_ptr(), (pool, []))[1].append(
            torch.remainder(index.reshape(-1).long(), pool.shape[0]))
    return [(pool, torch.cat(idx)) for pool, idx in pools.values()]


@contextlib.contextmanager
def recorded_fetches():
    """Inside the block, every texel-row fetch of ops/texture.py's plain
    chains (_fetch) is appended to the list yielded as (pool, index)."""
    from superconductor_tpu_torch.ops import texture as texture_mod

    real, fetched = texture_mod._fetch, []

    def fetch(texels, index):
        fetched.append((texels, index))
        return real(texels, index)

    texture_mod._fetch = fetch
    try:
        yield fetched
    finally:
        texture_mod._fetch = real


def compare_samplers(scene: str, calls: list, results: dict, timed: bool = True) -> None:
    """Each recorded sampler call's kernel against its plain version on the
    same inputs, bit for bit (the results' int32 views equal); the first
    call of each site and shape timed (device ms of the kernel and of the
    plain version, bench_raster.graph_ms), with its bound and share and the
    yardstick of one index_select of the texel rows the call fetches, into
    results[site]. Raises at the first call that differs."""
    from superconductor_tpu_torch.bench_raster import graph_ms

    wrappers = sampler_wrappers()
    for kernel, caller, args in calls:
        mod, name, plain = wrappers[kernel]
        wrapper = getattr(mod, name)
        site = f"{scene} {sampler_site(kernel, caller, args)}"
        out = wrapper(**args)
        with recorded_fetches() as fetched:
            want = plain(**args)
        torch.cuda.synchronize()
        if out.shape != want.shape or not torch.equal(out.view(torch.int32),
                                                      want.view(torch.int32)):
            diff = (out.double() - want.double()).abs()
            bad = int((out.view(torch.int32) != want.view(torch.int32)).sum())
            raise RuntimeError(f"{site}: the kernel differs from its plain version at {bad} of "
                               f"{want.numel()} values, max abs {float(diff.nan_to_num().max())}")
        if not args["uv"].shape[0]:
            continue  # no lanes: nothing launched, nothing to time
        entry = results.setdefault(site, {"kernel": kernel, "calls": 0, "max_abs_err": 0.0,
                                          "lanes": args["uv"].shape[0],
                                          "slots": len(args["slots"])})
        entry["calls"] += 1
        if "ms" in entry or not timed:
            continue
        entry["bound_ms"], entry["bound_by"] = sampler_bound(kernel, args, fetched)
        entry["ms"] = graph_ms(lambda: wrapper(**args))
        entry["plain_ms"] = graph_ms(lambda: plain(**args), launches=5, runs=10)
        rows = fetched_rows(fetched)
        entry["index_select_ms"] = graph_ms(
            lambda: [torch.index_select(pool, 0, idx) for pool, idx in rows])
        entry["rows_fetched"] = sum(int(idx.numel()) for _, idx in rows)
        phase("sampler", f"{site}: kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} "
              f"ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}), share "
              f"{entry['bound_ms'] / entry['ms']:.3f}; index_select of its "
              f"{entry['rows_fetched']} texel rows {entry['index_select_ms']:.4f} ms")


def sampler_path(smi: str, frames: dict) -> dict:
    """Phase [sampler]: the material samplers (csrc/sample.cu). For the
    headline, all-passes and stereo frames (`frames`: name -> (tables,
    build(pose), fitted config, env)): every sampler call of one eager frame
    (render_frame_impl) recorded, each held bit for bit against its plain
    version on its inputs, each site and shape timed with its bound and
    index_select yardstick; the graph frame (render_frame_stats) byte-equal,
    image and stats, to its twin with every plain version swapped in (raster,
    k-buffer, both samplers) and to its twin with only the samplers swapped;
    a replay's launch tally holding the samplers' launches, equal to the
    eager frame's calls. Then the main path (main_path_sites): every launch
    counter set to 0, GRAPH_TIMED graph frames of each scene, the counters
    read, and the run fails unless each sampler kernel launched, the
    kernels' counts equal their sites' sum, and each site launched
    GRAPH_TIMED times its calls in the eager frame. Returns {"sites":
    per-site results, "launches": the samplers' launches in that run,
    "site_launches": the launches at each site in that run}."""
    from superconductor_tpu_torch.bench import plain_versions
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.render import frame_graph
    from superconductor_tpu_torch.render.frame import render_frame_impl, render_frame_stats

    wrappers = sampler_wrappers()

    def counters():
        return {k: getattr(mod, name).LAUNCHES for k, (mod, name, _) in wrappers.items()}

    sites, per_frame = {}, {}
    for scene, (tables, build, config, env) in frames.items():
        state = build(0.0)
        with record_samplers() as calls:
            render_frame_impl(tables, state, config, env)
        # a call on no lanes launches nothing
        per_frame[scene] = {k: sum(1 for c in calls if c[0] == k and c[2]["uv"].shape[0])
                            for k in wrappers}
        phase("sampler", f"{scene}: {len(calls)} sampler calls in an eager frame "
              f"{per_frame[scene]}")
        compare_samplers(scene, calls, sites)
        del calls
        phase("sampler", f"{scene}: every sampler call equals its plain version bit for bit")

        img, stats = render_frame_stats(tables, state, config, env)
        for label, kernels in (("every plain version", None),
                               ("the plain samplers", ("classic_sample", "material_sample"))):
            with plain_versions(*(() if kernels is None else (kernels,))):
                twin, twin_stats = render_frame_stats(tables, state, config, env)
            if not (torch.equal(img, twin) and stats.keys() == twin_stats.keys()
                    and all(torch.equal(stats[k], twin_stats[k]) for k in stats)):
                raise RuntimeError(f"the {scene} graph frame differs from its twin with "
                                   f"{label}")
        key = frame_graph.frame_key(tables, state, config, env, True)[0]
        graph = frame_graph._runners[state.joint_palette.device].graphs[key]
        tally = {k: graph.tally.get(getattr(mod, name), 0)
                 for k, (mod, name, _) in wrappers.items()}
        before = counters()
        render_frame_stats(tables, build(0.9), config, env)
        replay = {k: v - before[k] for k, v in counters().items()}
        phase("sampler", f"{scene}: the graph frame equals its twins with every plain version "
              f"and with the plain samplers (image and stats); a replay's tally {tally}, its "
              f"launches {replay}")
        if tally != per_frame[scene] or replay != per_frame[scene]:
            raise RuntimeError(f"the {scene} replay's sampler launches {replay} (tally "
                               f"{tally}) differ from the eager frame's calls "
                               f"{per_frame[scene]}")

    # the main path: the graph frames of every scene, each counter from 0,
    # every graph captured anew in the run, each launch also counted at its
    # site as the wrappers count theirs (ops/raster.py _launched)
    site_launches, captures = main_path_sites(frames)
    launches = counters()
    phase("sampler", f"main path: {GRAPH_TIMED} graph frames of {', '.join(frames)}: sampler "
          f"launches {launches} (raster {raster_mod.rasterize_sorted.LAUNCHES}, k-buffer "
          f"{raster_mod.kbuffer_sorted.LAUNCHES}); by site {dict(site_launches)}; {smi}")
    want = {site: GRAPH_TIMED * r["calls"] for site, r in sites.items()}
    by_kernel = {k: sum(n for site, n in site_launches.items() if sites[site]["kernel"] == k)
                 for k in wrappers}
    if (launches != by_kernel or dict(site_launches) != want or not all(launches.values())
            or captures != len(frames)):
        raise RuntimeError(f"the main path launched the samplers {launches}, by site "
                           f"{dict(site_launches)} in {captures} captures; expected by site "
                           f"{want} in {len(frames)}")
    return {"sites": sites, "launches": launches, "site_launches": dict(site_launches)}


def main_path_sites(frames: dict) -> tuple:
    """Every launch counter set to 0 and every cached frame graph dropped,
    then GRAPH_TIMED graph frames of each scene of `frames` (as
    sampler_path's), cycling over GRAPH_POSES -> (Counter of the sampler
    launches by site, "scene kernel site" as compare_samplers names them;
    the number of graphs captured). A wrapper's launch also counts at its
    site: while a graph captures, into that graph's tally of sites, which
    each replay of the graph adds."""
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.ops import sample as sample_mod
    from superconductor_tpu_torch.render import frame_graph
    from superconductor_tpu_torch.render.frame import render_frame

    kernel_of = {sample_mod._CLASSIC_COUNTER: "classic_sample",
                 sample_mod._MATERIAL_COUNTER: "material_sample"}
    for wrapper in kernel_of:
        wrapper.LAUNCHES = 0
    raster_mod.rasterize_sorted.LAUNCHES = 0
    raster_mod.kbuffer_sorted.LAUNCHES = 0
    for runner in frame_graph._runners.values():
        runner.graphs.clear()
    real = sample_mod._launched
    site_launches, tallies, now = collections.Counter(), {}, {}

    def launched(wrapper):
        real(wrapper)
        call = sys._getframe(1)  # the wrapper's own frame: its arguments by name
        site = f"{now['scene']} " + sampler_site(kernel_of[wrapper], call.f_back.f_code.co_name,
                                                 call.f_locals)
        (now["tally"] if torch.cuda.is_current_stream_capturing() else site_launches)[site] += 1

    sample_mod._launched = launched
    try:
        for scene, (tables, build, config, env) in frames.items():
            states = [build(p) for p in GRAPH_POSES]
            device = states[0].joint_palette.device
            for i in range(GRAPH_TIMED):
                now.update(scene=scene, tally=collections.Counter())
                runner = frame_graph._runners.get(device)
                captured = runner.captured if runner is not None else 0
                render_frame(tables, states[i % len(states)], config, env)
                runner = frame_graph._runners.get(device)
                if runner is None or not runner.graphs:
                    raise RuntimeError(f"the {scene} frame replayed no graph")
                graph = next(reversed(runner.graphs.values()))  # the one this frame replayed
                if runner.captured != captured:
                    tallies[id(graph)] = now["tally"]
                site_launches.update(tallies[id(graph)])
    finally:
        sample_mod._launched = real
    torch.cuda.synchronize()
    return site_launches, len(tallies)


def graph_path(smi: str, frames: dict) -> dict:
    """Phase 14: the headline, all-passes and stereo frames (stereo: the
    joint palettes from the FK walk at each pose) through render_frame's
    CUDA graphs (render/frame_graph.py). `frames`: name -> (tables,
    build(pose), fitted config, env). At each of GRAPH_POSES the replayed
    frame (the pose copied into the graph's buffers) byte-equal to
    render_frame_impl's eager frame, image and stats; the eager frame's
    device-synchronising calls (profile_frame.sync_sites, which must see
    the one of a .item() first) none; an eager frame and two replays under
    torch.cuda.set_sync_debug_mode("error"); the
    launch counters' delta per replay equal to an eager frame's, and to the
    hand kernels' events in a profiled replay; eager and graph frame times
    (CUDA events over GRAPH_TIMED frames of the three poses' states, and
    for stereo the graph frame with its state built in the loop) beside
    nvidia-smi's name and power limit, and the device memory allocated at
    peak and reserved. The counters are set to 0 before each frame's timed
    graph run and read after it. Returns the kernels' launches over those
    runs."""
    from torch.profiler import ProfilerActivity, profile

    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.profile_frame import sync_sites
    from superconductor_tpu_torch.render import frame_graph
    from superconductor_tpu_torch.render.frame import (
        render_frame,
        render_frame_impl,
        render_frame_stats,
    )

    wrappers = [raster_mod.rasterize_sorted, raster_mod.kbuffer_sorted] + [
        getattr(mod, name) for mod, name, _ in sampler_wrappers().values()]

    def counts():
        return tuple(w.LAUNCHES for w in wrappers)

    def since(before):
        return tuple(b - a for a, b in zip(before, counts()))

    def window_ms(fn):
        fn(0)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(GRAPH_TIMED):
            fn(i)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / GRAPH_TIMED

    # a control: sync_sites sees a known synchronising call
    probe = torch.zeros((), device=next(iter(frames.values()))[0]["positions"].device)
    control = sync_sites(lambda: probe.item())
    phase("graph", f"control: sync_sites of a .item() {dict(control)}")
    if sum(control.values()) != 1:
        raise RuntimeError("sync_sites did not see the .item() of its control")

    total = dict.fromkeys(("raster_sorted", "kbuffer_sorted", *sampler_wrappers()), 0)
    cuda = torch.autograd.DeviceType.CUDA
    for name, (tables, build, config, env) in frames.items():
        states = [build(p) for p in GRAPH_POSES]
        runner_before = frame_graph._runners.get(states[0].joint_palette.device)
        captured0 = runner_before.captured if runner_before else 0
        for pose, state in zip(GRAPH_POSES, states):
            if not frame_graph.captures(state, config):
                raise RuntimeError(f"the {name} frame does not replay a CUDA graph")
            img, stats = render_frame_stats(tables, state, config, env)
            want, want_stats = render_frame_impl(tables, state, config, env, with_stats=True)
            if not (torch.equal(img, want) and stats.keys() == want_stats.keys()
                    and all(torch.equal(stats[k], want_stats[k]) for k in stats)
                    and torch.equal(render_frame(tables, state, config, env), want)):
                raise RuntimeError(f"the {name} graph frame at pose {pose} differs from "
                                   f"render_frame_impl's eager frame")
        captured = frame_graph._runners[states[0].joint_palette.device].captured - captured0
        phase("graph", f"{name}: graph frames at poses {GRAPH_POSES} byte-equal to the eager "
              f"frames (image and stats), {captured} graphs captured")

        torch.cuda.synchronize()
        sites = sync_sites(lambda: render_frame_impl(tables, states[1], config, env,
                                                     with_stats=True))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            render_frame_impl(tables, states[1], config, env, with_stats=True)
            render_frame_stats(tables, states[2], config, env)
            render_frame(tables, states[0], config, env)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        phase("graph", f"{name}: synchronising calls of an eager frame {dict(sites)}; an eager "
              f"frame and two replays raise nothing under set_sync_debug_mode(\"error\")")
        if sites:
            raise RuntimeError(f"the eager {name} frame synchronises at {dict(sites)}")

        l0 = counts()
        render_frame_impl(tables, states[0], config, env)
        eager = since(l0)
        l0 = counts()
        render_frame(tables, states[0], config, env)
        replay = since(l0)
        torch.cuda.synchronize()
        l0 = counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render_frame(tables, states[1], config, env)
            torch.cuda.synchronize()
        profiled = since(l0)
        seen = sum(1 for e in prof.events() if e.device_type == cuda and HAND_KERNELS.search(e.name))
        device_ops = sum(1 for e in prof.events() if e.device_type == cuda)
        phase("graph", f"{name}: launches (raster, k-buffer, classic sampler, material "
              f"sampler) eager {eager}, a replay {replay}; "
              f"a profiled replay: {seen} hand-kernel events of {device_ops} device events, "
              f"counters {profiled}")
        if replay != eager or profiled != eager or seen != sum(profiled):
            raise RuntimeError(f"the {name} replay's launch counts disagree with the eager "
                               f"frame's or with its profile")

        eager_ms = window_ms(lambda i: render_frame_impl(tables, states[i % 3], config, env))
        for w in wrappers:
            w.LAUNCHES = 0
        graph_ms = window_ms(lambda i: render_frame(tables, states[i % 3], config, env))
        launches = counts()
        line = (f"{name}: eager {eager_ms:.3f} ms, graph {graph_ms:.3f} ms a frame (CUDA "
                f"events over {GRAPH_TIMED} frames)")
        if name == "stereo":
            built_ms = window_ms(lambda i: render_frame(tables, build(0.1 * i), config, env))
            line += f"; graph with the state and FK built each frame {built_ms:.3f} ms"
        phase("graph", f"{line}; {smi}; launches over the {GRAPH_TIMED + 1} graph frames "
              f"{launches}; device memory allocated at peak "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB, reserved "
              f"{torch.cuda.memory_reserved() / 1e6:.1f} MB")
        if launches != tuple((GRAPH_TIMED + 1) * n for n in eager) or launches[0] == 0:
            raise RuntimeError(f"the {name} graph frames launched {launches}, not "
                               f"{GRAPH_TIMED + 1} x {eager}")
        for k, n in zip(total, launches):
            total[k] += n
    return total


def roofline_path(dev) -> None:
    """Phase roofline: the card's ceilings (utils/roofline.py
    probe_ceilings: chained bf16 4096^2 matmuls, a chained elementwise map
    over 256 MB, chained random-row gathers from a 256 MB table, a
    one-element add), each by the dispatch-count slope of CUDA-event
    times."""
    from superconductor_tpu_torch.utils.roofline import probe_ceilings

    t0 = time.perf_counter()
    c = probe_ceilings(device=dev)
    g = c["probes"]["gather"]
    phase("roofline", f"({smi_line()}) matmul {c['matmul_tflops']:.1f} TFLOP/s (bf16), "
          f"stream {c['stream_gbps']:.1f} GB/s, gather {c['gather_mrows_per_s']:.1f} Mrows/s "
          f"({c['gather_gbps']:.1f} GB/s payload, 32 B rows), dispatch floor "
          f"{c['dispatch_floor_ms'] * 1e3:.2f} us; slopes between n "
          f"{ {k: [round(x, 4) for x in v['check_ms']] for k, v in c['probes'].items()} }; "
          f"in {time.perf_counter() - t0:.2f} s")
    if not all(v and v > 0 for v in (c["matmul_tflops"], c["stream_gbps"],
                                     c["gather_mrows_per_s"], g["ms_per_dispatch"])):
        raise RuntimeError(f"a ceiling probe measured no positive rate: {c}")


def bench_path(kind: str, smi: str) -> dict:
    """Phase 13: the port's bench in a subprocess, as a user runs it; its
    last line is printed and checked. Returns that line."""
    torch.cuda.empty_cache()  # the bench's frames get the card's memory
    env = dict(os.environ, SC_BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "superconductor_tpu_torch.bench"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    lines = [x for x in out.stdout.splitlines() if x.startswith("{")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"the bench exited {out.returncode}: {out.stderr[-3000:]}")
    line = json.loads(lines[-1])
    phase("bench", f"{time.perf_counter() - t0:.2f} s, {len(lines)} lines; the last:")
    print(json.dumps(line), flush=True)
    missing = [k for k in BENCH_KEYS if line.get(k) is None]
    if missing or line.get("correct") is not True:
        raise RuntimeError(f"the bench's line lacks {missing} or is not correct")
    device = line.get("device", {})
    if device.get("kind") != kind or f"{device.get('name')}, {device.get('power_limit')}" != smi:
        raise RuntimeError(f"the bench's device {device} is not this card ({kind}; {smi})")
    return line


def stereo_golden_inputs(device, raster="auto"):
    """(tables, state, config, env) of the 256x128 stereo-animated frame at
    t = 0 on `device`, with the capacities stored beside the reference's
    image in STEREO_GOLDEN."""
    from superconductor_tpu_torch.scenes import STEREO_SMALL, stereo_animated_scene

    caps = {k: tuple(v) if isinstance(v, list) else v
            for k, v in json.loads(str(np.load(STEREO_GOLDEN)["caps"])).items()}
    small = dict(STEREO_SMALL)
    w, h = small.pop("width"), small.pop("height")
    scene_dev, build, config, env = stereo_animated_scene(w, h, device, **small)
    return scene_dev, build(0.0), replace(config, raster=raster, **caps), env


def stereo_golden_frame(device, raster="auto"):
    from superconductor_tpu_torch.render.frame import render_frame

    return render_frame(*stereo_golden_inputs(device, raster))


def gbuffer_steps(pair, px, py, tri, attrs, shade_row=None, row_cols=None, sum3=None):
    """ops/shade.py interpolate_gbuffer's intermediates, op by op in its
    order -> [(name, tensor)], with sum3(x, dim) for its three-term sums
    (None: shade._sum3, the fixed order (x0 + x1) + x2)."""
    from superconductor_tpu_torch.ops import shade as shade_mod

    sum3 = sum3 or shade_mod._sum3
    p = torch.clamp_min(pair, 0)
    if shade_row is not None:
        row = shade_row[p]
        row = row[:, :row_cols] if row_cols is not None else row
        setup, av32 = row[:, 0:16], row[:, 16:48]
    else:
        setup = tri.setup[p]
        av32 = attrs.packed[p] if attrs.packed is not None else None
    adj = setup[:, 0:9].reshape(-1, 3, 3)
    dx, dy = adj[:, :, 0], adj[:, :, 1]
    a_px = dx * px[:, None]
    b_py = dy * py[:, None]
    e = (a_px + b_py) + adj[:, :, 2]
    d_val, d_dx, d_dy = sum3(e, -1), sum3(dx, -1), sum3(dy, -1)
    inv_d = 1.0 / torch.where(d_val == 0, 1.0, d_val)
    bary = e * inv_d[:, None]
    steps = [("e: a*px", a_px), ("e: b*py", b_py), ("e", e), ("d_val: sum of e", d_val),
             ("d_dx", d_dx), ("d_dy", d_dy), ("inv_d", inv_d), ("bary", bary)]
    if av32 is not None:
        views = {"world_pos": av32[:, 0:9].reshape(-1, 3, 3),
                 "normal": av32[:, 9:18].reshape(-1, 3, 3),
                 "uv": av32[:, 18:24].reshape(-1, 3, 2), "lm_uv": av32[:, 24:30].reshape(-1, 3, 2)}
    else:
        views = {"world_pos": attrs.world_pos[p], "normal": attrs.normal[p], "uv": attrs.uv[p],
                 "lm_uv": attrs.lm_uv[p]}
    for name, av in views.items():
        prod = av * bary[..., None]
        steps += [(f"interp {name}: av * bary", prod), (f"interp {name}: sum", sum3(prod, -2))]
    for name in ("world_pos", "uv"):
        av = views[name]
        n_val = sum3(e[..., None] * av, -2)
        n_dx = sum3(dx[..., None] * av, -2)
        n_dy = sum3(dy[..., None] * av, -2)
        ddx = (n_dx - n_val * (d_dx * inv_d)[..., None]) * inv_d[..., None]
        ddy = (n_dy - n_val * (d_dy * inv_d)[..., None]) * inv_d[..., None]
        steps += [(f"deriv {name}: n_val", n_val), (f"deriv {name}: n_dx", n_dx),
                  (f"deriv {name}: n_dy", n_dy), (f"deriv {name}: ddx", ddx),
                  (f"deriv {name}: ddy", ddy)]
    return steps


def trace_gbuffer_lanes(dev) -> None:
    """The stereo 256x128 frame's g-buffer lanes on the card and the CPU:
    every interpolate_gbuffer call of the card's frame recorded, and its
    intermediates (gbuffer_steps) computed from the same inputs on both
    devices, once with torch.sum for the three-term sums and once with the
    fixed order of shade._sum3; the first intermediate that differs on a
    live lane is printed for each. Then the frame on both devices with each
    form, and the PSNR between them."""
    from superconductor_tpu_torch.ops import shade as shade_mod
    from superconductor_tpu_torch.render import frame as frame_mod
    from superconductor_tpu_torch.render.frame import render_frame

    calls = []
    real = frame_mod.interpolate_gbuffer

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    frame_mod.interpolate_gbuffer = rec
    try:
        render_frame(*stereo_golden_inputs(dev))
    finally:
        frame_mod.interpolate_gbuffer = real

    def to_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[to_cpu(v) for v in x])
        return x

    forms = {"torch.sum": lambda x, dim: torch.sum(x, dim=dim), "fixed order": None}
    for form, sum3 in forms.items():
        first, differ = None, 0
        for i, (args, kw) in enumerate(calls):
            live = (args[0] >= 0).cpu()
            card = gbuffer_steps(*args, **kw, sum3=sum3)
            cpu = gbuffer_steps(*[to_cpu(a) for a in args],
                                **{k: to_cpu(v) for k, v in kw.items()}, sum3=sum3)
            for (name, a), (_, b) in zip(card, cpu):
                a, b = a.cpu()[live], b[live]
                n = int((a != b).sum())
                if n:
                    differ += 1
                    if first is None:
                        first = (i, name, n, a.numel(), float((a - b).abs().max()))
        phase("stereo", f"g-buffer lanes, sums by {form}: {len(calls)} interpolate_gbuffer "
              f"calls, {differ} intermediates differ card vs CPU on live lanes; first: "
              + ("none" if first is None else
                 f"call {first[0]} {first[1]!r}: {first[2]} of {first[3]} values, max abs "
                 f"difference {first[4]!r}"))
    saved = shade_mod._sum3
    try:
        for form, sum3 in forms.items():
            shade_mod._sum3 = sum3 or saved
            a, b = render_frame(*stereo_golden_inputs(dev)).cpu(), render_frame(
                *stereo_golden_inputs("cpu"))
            phase("stereo", f"256x128 frame with the g-buffer sums by {form}: card vs CPU "
                  f"PSNR {psnr(a.numpy(), b.numpy()):.2f} dB")
    finally:
        shade_mod._sum3 = saved


def stereo_path(dev, shapes: dict) -> dict:
    """Phase 8: the stereo-animated frame (two 1080p eyes; six skinned
    tubes, their joint palettes from the numpy FK each frame, and six
    spheres): the host time of a frame's palettes and state, fit_caps, the
    raster kernel against its plain version on each eye's opaque setup
    (and a band at y_offset = 540) and timed; the frame timed, its raster
    launches counted per eye (one a view a band: 2 a frame); its
    plain-raster twin and its row_chunks=2 twin equal byte for byte; the
    256x128 frame against the CPU's and the reference's golden, and its
    raster="ref" twin on the card. Returns the raster launches of the timed
    run, by eye, and the frame with its inputs (tables, state at t = 0,
    fitted config, env, image)."""
    from superconductor_tpu_torch.bench_raster import CLUSTERS
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.render import frame as frame_mod
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.draws import build_frame_state
    from superconductor_tpu_torch.render.frame import (
        _merged_setup_for_view,
        _merged_vertex_stage,
        render_frame,
        render_frame_stats,
        stats_to_host,
    )
    from superconductor_tpu_torch.scene.upload import scene_to_torch
    from superconductor_tpu_torch.scenes import stereo_animated_host

    t0 = time.perf_counter()
    scene, frame_inputs, uniforms, env, config = stereo_animated_host(WIDTH, HEIGHT)
    scene_dev = scene_to_torch(scene, dev)

    def build(t):
        instances, palettes = frame_inputs(t)
        return build_frame_state(scene, instances, uniforms, joint_palettes=palettes, device=dev)

    state0 = build(0.0)
    phase("stereo", f"scene on card in {time.perf_counter() - t0:.2f} s; "
          f"{int(state0.draws_animated.tri_count.sum())} animated and "
          f"{int(state0.draws_static.tri_count.sum())} static triangles drawn")
    # --- the host paths: native (the default) against numpy ---
    fk_ms, palettes_by = {}, {}
    for mode in ("native", "numpy"):
        with host_mode(mode):
            fk = []
            for i in range(N_TIMED):
                t0 = time.perf_counter()
                frame_inputs(0.05 * (i + 1))
                fk.append((time.perf_counter() - t0) * 1e3)
            palettes_by[mode] = frame_inputs(0.5)[1]
        fk_ms[mode] = statistics.median(fk)
    keys = list(palettes_by["native"])
    gap = max(max_ulp_gap(palettes_by["native"][k], palettes_by["numpy"][k]) for k in keys)
    abs_gap = max(float(np.abs(palettes_by["native"][k] - palettes_by["numpy"][k]).max())
                  for k in keys)
    differ = sum(int((palettes_by["native"][k] != palettes_by["numpy"][k]).sum()) for k in keys)
    total = sum(palettes_by["native"][k].size for k in keys)
    phase("host", f"stereo: palette FK and instances host ms a frame (median of {N_TIMED}): "
          f"native {fk_ms['native']:.3f}, numpy {fk_ms['numpy']:.3f}; native vs numpy "
          f"palettes at t = 0.5: {differ} of {total} values differ, the largest gap {gap} "
          f"ulp, {abs_gap:.3g} abs ({smi_line()})")
    instances, palettes = frame_inputs(0.5)
    host_draws("stereo", lambda: build_frame_state(scene, instances, uniforms,
                                                   joint_palettes=palettes, device=dev))

    t0 = time.perf_counter()
    config = fit_caps(scene_dev, state0, config, env,
                      log=lambda s, g: phase("fit_caps", f"{s} grow={g or None}"))
    phase("stereo", f"fit_caps in {time.perf_counter() - t0:.2f} s: p_cap={config.p_cap} "
          f"opaque_px_cap={config.opaque_px_cap} sky_px_cap={config.sky_px_cap} "
          f"num_views={config.num_views} row_chunks={config.row_chunks}")
    img, stats = render_frame_stats(scene_dev, state0, config, env)
    phase("stereo", f"stats {stats_to_host(stats)}")

    # --- the raster kernel at each eye's opaque setup ---
    stages, attrs = _merged_vertex_stage(scene_dev, state0, config)
    blend = scene_dev["materials"]["blend_mode"][attrs.material]
    eye_tri = {}
    for v, eye in enumerate(EYES):
        tri = _merged_setup_for_view(stages, state0.uniforms["view_proj"][v], config)
        eye_tri[eye] = tri._replace(valid=tri.valid & (blend == 0))
        compare_raster(f"stereo-{eye}", eye_tri[eye], WIDTH, HEIGHT, config.p_cap, shapes[eye],
                       clusters=CLUSTERS, timed=True)
    compare_raster("stereo-left-band+y_offset", eye_tri["left"], WIDTH, HEIGHT // 2,
                   config.p_cap, shapes["left"], y_offset=HEIGHT // 2, clusters=CLUSTERS)

    # --- the frame ---
    raster_mod.rasterize_sorted.LAUNCHES = 0
    raster_mod.kbuffer_sorted.LAUNCHES = 0
    frames = [0]

    def one_frame():
        frames[0] += 1
        return render_frame(scene_dev, state0, config, env)

    with frame_passes(keep_inputs=False) as passes:
        frame_ms = cuda_ms(one_frame)
    launches = raster_mod.rasterize_sorted.LAUNCHES
    counts = [n for n, _ in passes["raster"]]
    by_eye = {eye: sum(counts[v::len(EYES)]) for v, eye in enumerate(EYES)}
    phase("stereo", f"frame {frame_ms:.3f} ms (CUDA events, median of {N_TIMED}; two eyes); "
          f"raster launches {launches} over {frames[0]} frames, by eye {by_eye}; k-buffer "
          f"launches {raster_mod.kbuffer_sorted.LAUNCHES}")
    if (len(counts) != len(EYES) * frames[0] or set(by_eye.values()) != {frames[0]}
            or launches != len(EYES) * frames[0] or raster_mod.kbuffer_sorted.LAUNCHES):
        raise RuntimeError("the stereo frame did not launch the raster kernel once a view "
                           "(num_views x row_chunks = 2) a frame")

    img = render_frame(scene_dev, state0, config, env)
    if img.shape != (2, HEIGHT, WIDTH, 4) or img.dtype != torch.uint8:
        raise RuntimeError(f"bad stereo frame {tuple(img.shape)} {img.dtype}")
    frame_mod.rasterize_sorted = raster_mod.rasterize_sorted_plain
    try:
        img_plain = render_frame(scene_dev, state0, config, env)
    finally:
        frame_mod.rasterize_sorted = raster_mod.rasterize_sorted
    if not torch.equal(img, img_plain):
        raise RuntimeError("stereo frame differs from its plain-raster twin")
    raster_mod.rasterize_sorted.LAUNCHES = 0
    img_bands = render_frame(scene_dev, state0, replace(config, row_chunks=2), env)
    band_launches = raster_mod.rasterize_sorted.LAUNCHES
    if not torch.equal(img, img_bands) or band_launches != 4:
        raise RuntimeError(f"the row_chunks=2 stereo frame differs from the row_chunks=1 "
                           f"one, or launched the raster {band_launches} times, not 4")
    eyes_differ = int((img[0] != img[1]).any(dim=-1).sum())
    moved = int((render_frame(scene_dev, build(1.0), config, env) != img).any(dim=-1).sum())
    phase("stereo", f"frame equals its plain-raster twin and its row_chunks=2 twin (4 "
          f"launches) byte for byte; the eyes differ at {eyes_differ} px; at t = 1 "
          f"{moved} px change")
    if eyes_differ == 0 or moved == 0:
        raise RuntimeError("the two eyes are equal, or the animation changes nothing")

    localize_card_cpu_gap("stereo", stereo_golden_inputs, dev)
    trace_gbuffer_lanes(dev)
    raster_mod.rasterize_sorted.LAUNCHES = 0
    img_g = stereo_golden_frame(dev).cpu()
    img_ref = stereo_golden_frame(dev, raster="ref").cpu()
    ref_launches = raster_mod.rasterize_sorted.LAUNCHES
    img_c = stereo_golden_frame("cpu")
    golden = np.load(STEREO_GOLDEN)["image"]
    db_cpu = psnr(img_g.numpy(), img_c.numpy())
    db_ref = psnr(img_g.numpy(), golden)
    phase("stereo", f"256x128 frame: card vs CPU PSNR {db_cpu:.2f} dB, card vs the JAX "
          f"reference's frame (tests/goldens) PSNR {db_ref:.2f} dB; its raster=\"ref\" "
          f"twin on the card equal: {torch.equal(img_g, img_ref)}")
    if min(db_cpu, db_ref) < 40.0:
        raise RuntimeError("stereo card frame disagrees with the CPU frame or the reference")
    if not torch.equal(img_g, img_ref) or ref_launches != 2:
        raise RuntimeError("the raster=\"ref\" stereo frame differs from the binned "
                           "raster's, or the frames launched the kernel other than twice")
    return by_eye, (scene_dev, state0, config, env, img)


def shard_cells(n: int) -> list:
    """n grid cells taking the visible cards in turn (every cell cuda:0 on
    a one-card machine)."""
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def sharded_path(shapes: dict, stereo: tuple, all_passes: tuple) -> dict:
    """Phase 9: the stereo and all-passes frames of phases 7 and 8 (their
    tables, states, fitted configs and images) through
    parallel.render_frame_sharded: 2 eyes x 4 bands and 1 x 4 bands of 270
    rows, each cell on the frame's 32-row raster tiles that hold its band
    (parallel.bands.frame_tile_rows: rows 0-288, 256-544, 512-832 and
    800-1080). Each cell's raster and k-buffer calls against their plain
    versions bit for bit at every cluster size and K, and timed; the same
    calls cut to the band's own 270 rows (y_offset 270, 540, 810) bit for
    bit too; each sharded frame byte-equal to its render_frame image and
    timed with CUDA events (median of SHARD_RUNS after a warm-up), its
    launches counted per band pass in that run: one a frame in each.
    Returns the launches by kernel and by pass of both timed runs."""
    from superconductor_tpu_torch.bench_raster import CLUSTERS
    from superconductor_tpu_torch.ops.raster import VisibilityBuffer
    from superconductor_tpu_torch.parallel import make_render_mesh, render_frame_sharded

    from superconductor_tpu_torch.render.frame import render_frame

    t0 = time.perf_counter()
    band_h = HEIGHT // SHARD_BANDS
    exact = {"max_abs_err": 0.0}
    launches = {"raster_sorted": 0, "kbuffer_sorted": 0}
    by_pass = {}
    for frame, (scene_dev, state0, config, env, img) in (("stereo", stereo),
                                                         ("all_passes", all_passes)):
        views = config.num_views
        mesh = make_render_mesh(shard_cells(views * SHARD_BANDS), num_views=views)
        with frame_passes(keep_inputs=True) as passes:
            img_sh = render_frame_sharded(scene_dev, state0, config, env, mesh)
        calls = {kind: [inputs for _, inputs in passes[kind]] for kind in passes}
        per_cell = (1, 0) if frame == "stereo" else (len(AP_RASTER), len(AP_KBUFFER))
        cells = views * SHARD_BANDS
        if (len(calls["raster"]), len(calls["kbuffer"])) != (cells * per_cell[0],
                                                             cells * per_cell[1]):
            raise RuntimeError(f"the sharded {frame} frame made {len(calls['raster'])} raster "
                               f"and {len(calls['kbuffer'])} k-buffer passes over {cells} cells, "
                               f"expected {per_cell} a cell")
        if frame == "stereo":
            for key, (tri, init, rows, top) in zip(SH_STEREO, calls["raster"]):
                shapes[key].update(rows=rows, y_offset=top)
                compare_raster(f"sharded-{key}", tri, WIDTH, rows, config.p_cap, shapes[key],
                               y_offset=top, init=init, clusters=CLUSTERS, min_rows=0,
                               timed=True, sweep_sizes=False, runs=SHARD_RUNS)
            names = (SH_STEREO, ())
        else:
            for b in range(SHARD_BANDS):
                band_calls = {"raster": calls["raster"][2 * b:2 * b + 2],
                              "kbuffer": calls["kbuffer"][3 * b:3 * b + 3]}
                compare_passes(f"sharded-all_passes-band{b}", band_calls, config.p_cap, shapes,
                               prefix="sharded_", suffix=f"_band{b}", band=True)
                for n, call in zip(AP_RASTER + AP_KBUFFER,
                                   band_calls["raster"] + band_calls["kbuffer"]):
                    shapes[f"sharded_{n}_band{b}"].update(rows=call[-2], y_offset=call[-1])
            names = (SH_RASTER, SH_KBUFFER)

        # the same calls on the band's own rows, where the reference's cells raster
        for i, (tri, init, rows, top) in enumerate(calls["raster"]):
            b = i // per_cell[0] % SHARD_BANDS
            y0 = b * band_h
            if b == 0:
                continue
            cut = slice(y0 - top, y0 - top + band_h)
            if init is not None:
                init = VisibilityBuffer(init.depth[cut].contiguous(), init.pair[cut].contiguous())
            compare_raster(f"sharded-{frame}-raster-call{i}-rows{y0}-{y0 + band_h}", tri, WIDTH,
                           band_h, config.p_cap, exact, y_offset=y0, init=init,
                           clusters=CLUSTERS, min_rows=0)
        for i, (tri, floor, want, k, rows, top) in enumerate(calls["kbuffer"]):
            b = i // per_cell[1] % SHARD_BANDS
            y0 = b * band_h
            if b == 0:
                continue
            cut = slice(y0 - top, y0 - top + band_h)
            compare_kbuffer(f"sharded-{frame}-kbuffer-call{i}-rows{y0}-{y0 + band_h}", tri,
                            WIDTH, band_h, config.p_cap, exact, y_offset=y0,
                            floor=floor[cut].contiguous(), min_layers=0, min_rows=0,
                            clusters=CLUSTERS)

        phase("sharded", f"{frame}: {views} x {SHARD_BANDS} grid of {mesh.devices}; frame "
              f"{tuple(img_sh.shape)} equal to render_frame's: {torch.equal(img_sh, img)}")
        if not torch.equal(img_sh, img):
            diff = (img_sh != img).any(dim=-1)
            raise RuntimeError(f"the sharded {frame} frame differs from render_frame's at "
                               f"{int(diff.sum())} px, e.g. {diff.nonzero()[:5].tolist()}")
        # bands on tile grids of their own (render_frame's row_chunks, the
        # reference's cell layout) let other pixels outside a sliver's box in
        own_grid = render_frame(scene_dev, state0, replace(config, row_chunks=SHARD_BANDS), env)
        phase("sharded", f"{frame}: render_frame in {SHARD_BANDS} row_chunks of {band_h} rows "
              f"(each on a tile grid from its first row) differs from it at "
              f"{int((own_grid != img).any(dim=-1).sum())} px")

        def render(*args):
            return render_frame_sharded(*args, mesh)

        _ms, frame_launches, frame_by_pass = timed_passes(
            f"sharded {frame}", scene_dev, state0, config, env, render=render,
            raster_names=names[0], kbuffer_names=names[1], runs=SHARD_RUNS)
        for k in launches:
            launches[k] += frame_launches[k]
        by_pass.update(frame_by_pass)
    for key in SH_STEREO + SH_RASTER + SH_KBUFFER:
        shapes[key]["max_abs_err"] = max(shapes[key]["max_abs_err"], exact["max_abs_err"])
    phase("sharded", f"phase in {time.perf_counter() - t0:.2f} s")
    return launches, by_pass


def lit_golden_frame(device):
    """(image, stats) of the 256x128 lit frame at angle 0.3 on `device`,
    with the capacities stored beside the reference's image in LIT_GOLDEN."""
    from superconductor_tpu_torch.render.frame import render_frame_stats, stats_to_host
    from superconductor_tpu_torch.scenes import LIT_PASSES_SMALL, lit_passes_scene

    caps = {k: tuple(v) if isinstance(v, list) else v
            for k, v in json.loads(str(np.load(LIT_GOLDEN)["caps"])).items()}
    scene_dev, build_state, config, env = lit_passes_scene(device=device, **LIT_PASSES_SMALL)
    img, stats = render_frame_stats(scene_dev, build_state(0.3), replace(config, **caps), env)
    return img.cpu(), stats_to_host(stats)


@contextlib.contextmanager
def lightmapped_lanes():
    """Inside the block, every g-buffer the frame path interpolates appends
    its count of live lightmapped lanes to the yielded list."""
    from superconductor_tpu_torch.render import frame as frame_mod

    counts = []
    real = frame_mod.interpolate_gbuffer

    def rec(*args, **kw):
        g = real(*args, **kw)
        counts.append(int((g.valid & g.lightmapped).sum()))
        return g

    frame_mod.interpolate_gbuffer = rec
    try:
        yield counts
    finally:
        frame_mod.interpolate_gbuffer = real


def lit_passes_path(dev, shapes: dict) -> dict:
    """Phase 10: the lit frame (the all-passes scene with the SH light
    volume, the lightmapped wall and the smoke maps, seeded) at 1920x1080:
    the pools on the card, fit_caps and the live lightmapped lanes of a
    stats frame, each pass's kernel at that frame's inputs (the wall moves
    the opaque depth every later pass reads) against its plain version at
    every cluster size and timed, the frame timed with
    its launches counted by pass (one a frame each), its plain-versions,
    classic-smoke and layered-SH twins, the effect of each lighting input,
    and the 256x128 frame against the CPU's and the reference's golden.
    Returns the launches of the timed run, by kernel and by pass."""
    from superconductor_tpu_torch.bench import plain_kernels_frame
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.draws import build_frame_state
    from superconductor_tpu_torch.render.frame import (
        render_frame,
        render_frame_stats,
        stats_to_host,
    )
    from superconductor_tpu_torch.scene.upload import scene_to_torch
    from superconductor_tpu_torch.scenes import lit_passes_host

    t0 = time.perf_counter()
    scene, instances, uniforms, env, config, draw_kw = lit_passes_host(WIDTH, HEIGHT)
    t1 = time.perf_counter()
    scene_dev = scene_to_torch(scene, dev)
    state0 = build_frame_state(scene, instances(0.0), uniforms, device=dev, **draw_kw)
    torch.cuda.synchronize()
    pools = {k: scene_dev[k] for k in LIT_POOLS if k in scene_dev}
    phase("lit_passes", f"scene built on the host in {t1 - t0:.2f} s, on card in "
          f"{time.perf_counter() - t1:.2f} s; " + ", ".join(
              f"{k} {tuple(v.shape)} {v.dtype} {v.numel() * v.element_size() / 2**20:.1f} MiB"
              for k, v in pools.items())
          + f"; smoke_static {env.smoke_static}; {int(state0.draws_static.tri_count.sum())} "
          f"static triangles drawn")
    if len(pools) != len(LIT_POOLS) or env.smoke_static is None:
        raise RuntimeError(f"the lit frame lacks a pool: {sorted(pools)} published, "
                           f"smoke_static {env.smoke_static}")

    t0 = time.perf_counter()
    config = fit_caps(scene_dev, state0, config, env,
                      log=lambda s, g: phase("fit_caps", f"{s} grow={g or None}"))
    phase("lit_passes", f"fit_caps in {time.perf_counter() - t0:.2f} s: p_cap={config.p_cap} "
          f"clip_layers={config.clip_layers} blend_layers={config.blend_layers} "
          f"particle_layers={config.particle_layers} shade_px_caps={config.shade_px_caps} "
          f"opaque_px_cap={config.opaque_px_cap} sky_px_cap={config.sky_px_cap} "
          f"matq_classic_cap={config.matq_classic_cap}")
    if not (config.matq_classic_cap or 0) > 0:
        raise RuntimeError("the material-path partition did not engage")

    # one stats frame, recording each pass's inputs and the lightmapped lanes
    with frame_passes(keep_inputs=True) as passes, lightmapped_lanes() as lm_lanes:
        img, stats = render_frame_stats(scene_dev, state0, config, env)
    calls = {kind: [inputs for _, inputs in passes[kind]] for kind in passes}
    stats = stats_to_host(stats)
    phase("lit_passes", f"stats {stats}; live lightmapped lanes {sum(lm_lanes)} "
          f"(by g-buffer, in call order: {lm_lanes})")
    if sum(lm_lanes) == 0:
        raise RuntimeError("no live lightmapped lane in the lit frame")

    compare_passes("lit_passes", calls, config.p_cap, shapes, prefix="lit_")

    # --- the frame ---
    _ms, launches, by_pass = timed_passes("lit_passes", scene_dev, state0, config, env)

    img = render_frame(scene_dev, state0, config, env)
    img_plain = plain_kernels_frame(scene_dev, state0, config, env)
    if img.shape != (1, HEIGHT, WIDTH, 4) or img.dtype != torch.uint8:
        raise RuntimeError(f"bad frame {tuple(img.shape)} {img.dtype}")
    without = {name: {k: v for k, v in scene_dev.items() if k not in keys}
               for name, keys in (("classic smoke", LIT_POOLS[2:]), ("layered SH", LIT_POOLS[:2]))}
    img_classic = render_frame(without["classic smoke"], state0, config, env)
    img_layered = render_frame(without["layered SH"], state0, config, env)
    db_layered = psnr(img.cpu().numpy(), img_layered.cpu().numpy())
    phase("lit_passes", f"frame vs its plain-kernels twin equal: {torch.equal(img, img_plain)}; "
          f"vs its classic-smoke twin equal: {torch.equal(img, img_classic)}; vs its "
          f"layered-SH twin {db_layered:.2f} dB, {int((img != img_layered).sum())} bytes differ")
    if not torch.equal(img, img_plain) or not torch.equal(img, img_classic):
        raise RuntimeError("the lit frame differs from its plain-kernels or classic-smoke twin")
    if db_layered < 40.0:
        raise RuntimeError("the lit frame disagrees with its layered-SH twin")

    # each lighting input changes the frame
    for name, off in (("light volume", dict(lightvol_tex_ids=None, lightvol_wh=None)),
                      ("lightmaps", dict(lightmap_tex_ids=None, lightmap_wh=None)),
                      ("smoke maps", dict(smoke_tex_ids=None, smoke_static=None))):
        changed = int((img[0] != render_frame(scene_dev, state0, config,
                                              replace(env, **off))[0]).any(dim=-1).sum())
        phase("lit_passes", f"{name} off: {changed} px change")
        if changed == 0:
            raise RuntimeError(f"switching off the {name} changed no pixel")

    img_g, stats_g = lit_golden_frame(dev)
    img_c, stats_c = lit_golden_frame("cpu")
    golden = np.load(LIT_GOLDEN)
    stats_ref = json.loads(str(golden["stats"]))
    db_cpu = psnr(img_g.numpy(), img_c.numpy())
    db_ref = psnr(img_g.numpy(), golden["image"])
    phase("lit_passes", f"256x128 frame: card vs CPU PSNR {db_cpu:.2f} dB, card vs the JAX "
          f"reference's frame (tests/goldens) PSNR {db_ref:.2f} dB; stats equal to the CPU's "
          f"{stats_g == stats_c} and the reference's {stats_g == stats_ref}")
    if min(db_cpu, db_ref) < 40.0 or not stats_g == stats_c == stats_ref:
        raise RuntimeError("the lit card frame disagrees with the CPU frame or the reference")
    return launches, by_pass


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def app_frame_state_fn(world, dev):
    """A function building, without the ECS, the frame state the app's
    render system builds: the camera's uniforms, culling and the draw build
    of the app's instances."""
    from superconductor_tpu_torch.ecs.components import Instance, InstanceOf, ModelComponent
    from superconductor_tpu_torch.ecs.resources import (
        CameraResource,
        RenderSettings,
        SceneResource,
    )
    from superconductor_tpu_torch.render.camera import make_uniforms
    from superconductor_tpu_torch.render.culling import sphere_culling_params
    from superconductor_tpu_torch.render.draws import build_frame_state

    cam = world.resource(CameraResource)
    config = world.resource(RenderSettings).config
    scene = world.resource(SceneResource).scene
    instances = [(world.get(of.model_entity, ModelComponent).model, inst.similarity)
                 for _e, inst, of in world.query(Instance, InstanceOf)]
    uniforms = make_uniforms(cam.camera, config.width, config.height, cam.fov_y, cam.z_near,
                             reverse_z=config.reverse_z)
    cull = [sphere_culling_params(uniforms.view_proj[v]) for v in range(config.num_views)]
    return lambda: build_frame_state(scene, instances, uniforms, cull_params=cull,
                                     screen_height=config.height, device=dev)


def app_frame_without_ecs(world, dev):
    """The frame the app's render system last rendered, built without the
    ECS (app_frame_state_fn), the scene's tables rebuilt whole
    (scene_to_torch), then render_frame at the app's config and env. ->
    (image, the tables)."""
    from superconductor_tpu_torch.ecs.resources import RenderSettings, SceneResource
    from superconductor_tpu_torch.render.frame import render_frame
    from superconductor_tpu_torch.scene.upload import scene_to_torch

    settings = world.resource(RenderSettings)
    state = app_frame_state_fn(world, dev)()
    tables = scene_to_torch(world.resource(SceneResource).scene, dev)
    return render_frame(tables, state, settings.config, settings.env), tables


def app_path(dev, shapes: dict, smi: str) -> dict:
    """Phase 11: the app layer at 1920x1080. The port's frame server on
    dense_terrain.glb (its capacity probe, a subprocess, then a 5 s selftest
    at 2 frames in flight with stats_interval 0): the probe's caps, latency
    p50 / p99, throughput, host ms per frame by FrameProfiler scope, and
    the raster kernel's launches over the timed frames (one a frame a view a
    band). Then the same app settled at stats_interval 1: its frame byte-equal
    to the same app's frame at stats_interval 0, to the frame rendered with
    both plain versions, and to render_frame on a frame state built without
    the ECS from tables rebuilt whole (which equal the app's resident ones);
    the opaque pass's kernel against its plain version on that frame's
    inputs, and timed. Then the port's demo for 8 frames on hero_helmet.glb
    with the skinned ribbon, debug overlays and particles: the PNGs, the
    animation moving pixels, the lines raster and particle k-buffer passes
    launching once a rendered frame, and each pass's kernel against its plain
    version on the last frame's inputs. Returns the launch counts."""
    from superconductor_tpu_torch import demo, serve
    from superconductor_tpu_torch.bench import plain_kernels_frame
    from superconductor_tpu_torch.bench_raster import CLUSTERS
    from superconductor_tpu_torch.ecs.components import JointsComponent
    from superconductor_tpu_torch.ecs.resources import (
        CameraResource,
        FrameOutput,
        RenderSettings,
        SceneResource,
    )
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.scenes import HERO_GLB, skinned_ribbon_glb

    # --- the frame server ---
    t0 = time.perf_counter()
    device = str(dev)
    server = serve.prepare(serve.parse_args(["--size", f"{WIDTH}x{HEIGHT}", "--device", device]))
    phase("app", f"capacity probe (a subprocess) in {time.perf_counter() - t0:.2f} s: "
          f"caps {server.probe}; failure: {server.probe_failed}")
    if server.probe_failed is not None:
        raise RuntimeError(f"the capacity probe failed: {server.probe_failed}")
    raster_mod.rasterize_sorted.LAUNCHES = 0
    raster_mod.kbuffer_sorted.LAUNCHES = 0
    report = serve.selftest(server, 5.0, frames_in_flight=2)
    run_launches = {"raster_sorted": raster_mod.rasterize_sorted.LAUNCHES,
                    "kbuffer_sorted": raster_mod.kbuffer_sorted.LAUNCHES}
    phase("app", f"selftest ({smi}): {report['frames']} frames in {report['seconds']:.3f} s, "
          f"{report['fps']:.3f} frames/s, latency p50 {report['latency_p50_ms']:.3f} ms, "
          f"p90 {report['latency_p90_ms']:.3f} ms, p99 {report['latency_p99_ms']:.3f} ms "
          f"(submit to ready, {report['frames_in_flight']} frames in flight, stats_interval 0)")
    phase("app", "host ms per frame by FrameProfiler scope: " + ", ".join(
        f"{k} {v:.3f}" for k, v in report["host_ms_per_frame"].items()))
    phase("app", f"launches over the timed frames: raster {report['raster_launches']}, "
          f"k-buffer {report['kbuffer_launches']} ({report['views_x_bands']} view x band a "
          f"frame); over the whole server run {run_launches}")
    if report["raster_launches"] != report["frames"] * report["views_x_bands"]:
        raise RuntimeError("the frame server did not launch the raster kernel once a frame "
                           "a view a band")

    # --- twins at the settled config, back at the selftest's first pose ---
    app, w = server.app, server.app.world
    settings, out = w.resource(RenderSettings), w.resource(FrameOutput)
    cam = w.resource(CameraResource).camera
    cam.position, cam.rotation = serve.start_rig().update(1 / 60.0)
    settings.stats_interval = 1
    seen = []
    for _ in range(8):
        app.update()
        seen.append(settings.config)
        if len(seen) >= 3 and seen[-1] == seen[-2] == seen[-3] == out.last_config:
            break
    else:
        raise RuntimeError(f"the app's config did not settle at stats_interval 1: {seen[-1]}")
    config = settings.config
    img_1 = out.image
    settings.stats_interval = 0
    with frame_passes(keep_inputs=True) as passes:
        app.update()
    img_0, state = out.image, out.state
    arrays = w.resource(SceneResource).device_scene.arrays()
    img_plain = plain_kernels_frame(arrays, state, config, settings.env)
    img_free, tables = app_frame_without_ecs(w, dev)
    fa, fb = _flat(arrays), _flat(tables)
    tables_equal = sorted(fa) == sorted(fb) and all(  # bit for bit: some rows hold bitcast ints
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape and torch.equal(
            fa[k].contiguous().reshape(-1).view(torch.uint8),
            fb[k].contiguous().reshape(-1).view(torch.uint8)) for k in fa)
    phase("app", f"settled after {len(seen)} frames at stats_interval 1: p_cap={config.p_cap} "
          f"opaque_px_cap={config.opaque_px_cap} sky_px_cap={config.sky_px_cap} "
          f"matq_classic_cap={config.matq_classic_cap} blend_layers={config.blend_layers}")
    phase("app", f"frame at stats_interval 0 vs 1 equal: {torch.equal(img_0, img_1)}; vs "
          f"its plain-versions twin: {torch.equal(img_0, img_plain)}; vs render_frame "
          f"without the ECS: {torch.equal(img_0, img_free)}; resident tables equal to "
          f"scene_to_torch's: {tables_equal} ({len(fa)} tensors)")
    if img_0.shape != (1, HEIGHT, WIDTH, 4) or img_0.dtype != torch.uint8:
        raise RuntimeError(f"bad app frame {tuple(img_0.shape)} {img_0.dtype}")
    if not (torch.equal(img_0, img_1) and torch.equal(img_0, img_plain)
            and torch.equal(img_0, img_free) and tables_equal):
        raise RuntimeError("the app's frame differs from one of its twins")
    if float(img_0[0, :, :, :3].float().std()) < 1.0:
        raise RuntimeError("the app's frame is flat")
    host_draws("app", app_frame_state_fn(w, dev))
    if len(passes["raster"]) != 1 or passes["kbuffer"]:
        raise RuntimeError(f"the app frame made {len(passes['raster'])} raster and "
                           f"{len(passes['kbuffer'])} k-buffer passes, expected 1 and 0")
    tri, init, _rows, _y0 = passes["raster"][0][1]
    compare_raster("app-opaque", tri, WIDTH, HEIGHT, config.p_cap, shapes["app_opaque"],
                   init=init, clusters=CLUSTERS, timed=True)
    del server, app, w, passes, arrays, tables
    torch.cuda.empty_cache()

    # --- the demo ---
    work = tempfile.mkdtemp(prefix="sc_demo_")
    ribbon = os.path.join(work, "ribbon.glb")
    with open(ribbon, "wb") as f:
        f.write(skinned_ribbon_glb())
    raster_mod.rasterize_sorted.LAUNCHES = 0
    raster_mod.kbuffer_sorted.LAUNCHES = 0
    t0 = time.perf_counter()
    with frame_passes(keep_inputs=True) as passes:
        app, info = demo.run(["--frames", "8", "--size", f"{WIDTH}x{HEIGHT}", "--model", HERO_GLB,
                              "--animated-model", ribbon, "--debug-overlays", "--particles",
                              "--out", work, "--device", device])
    demo_launches = {"raster_sorted": raster_mod.rasterize_sorted.LAUNCHES,
                     "kbuffer_sorted": raster_mod.kbuffer_sorted.LAUNCHES}
    renders = len(passes["raster"]) // 2
    by_pass = {name: [n for n, _ in passes[kind][i::len(names)]]
               for kind, names in (("raster", AP_RASTER), ("kbuffer", AP_KBUFFER))
               for i, name in enumerate(names)}
    sizes = [os.path.getsize(p) for p in info["paths"]]
    phase("demo", f"8 frames in {time.perf_counter() - t0:.2f} s ({smi}); host ms a frame "
          f"incl. readback and PNG: " + ", ".join(f"{1e3 * t:.1f}" for t in info["frame_seconds"])
          + f"; PNG bytes {sizes}")
    phase("demo", f"{renders} rendered frames (the model loads included); launches by pass "
          + ", ".join(f"{k} {sum(v)}" for k, v in by_pass.items()) + f"; by kernel {demo_launches}")
    if len(sizes) != 8 or min(sizes) < 1000:
        raise RuntimeError("the demo did not write its 8 PNGs")
    if (len(passes["raster"]) != 2 * renders or len(passes["kbuffer"]) != 3 * renders
            or renders < 8 or any(set(v) != {1} for v in by_pass.values())):
        raise RuntimeError("a demo pass did not launch its kernel once a rendered frame")
    calls = {kind: [inputs for _, inputs in passes[kind][-n:]]
             for kind, n in (("raster", 2), ("kbuffer", 3))}
    config = app.world.resource(RenderSettings).config
    compare_passes("demo", calls, config.p_cap, shapes, prefix="demo_",
                   min_layers={"clip": 0, "blend": 0},
                   timed=("lines", "particles"))
    del passes, calls

    # the animation moves pixels: the same camera at two animation times
    w = app.world
    out = w.resource(FrameOutput)
    frames = []
    for t in (0.0, 0.5):
        for _e, jc in list(w.components.get(JointsComponent, {}).items()):
            jc.time = t
        app.update()
        frames.append(out.image)
    moved = int((frames[0][0] != frames[1][0]).any(dim=-1).sum())
    shutil.rmtree(work, ignore_errors=True)
    phase("demo", f"animation time 0.0 vs 0.5 at one camera: {moved} px change")
    if moved == 0:
        raise RuntimeError("the skinned ribbon's animation moved no pixel")
    return {"app": report, "app_run": run_launches, "demo": demo_launches,
            "demo_by_pass": {k: sum(v) for k, v in by_pass.items()}}


def kernels_line(headline_launches: int, cb_launches: dict, ap_launches: dict,
                 ap_by_pass: dict, stereo_by_eye: dict, sh_launches: dict, sh_by_pass: dict,
                 lit_launches: dict, lit_by_pass: dict, app: dict, deep_launches: dict,
                 deep_by_pass: dict, graph_launches: dict, raster_res: dict,
                 kbuffer_res: dict, shapes: dict, sampler: dict) -> dict:
    """The kernels line: each kernel at its representative shape (the
    headline's opaque raster, clip_blend's clip k-buffer) with its launches
    over the six frames' and the two sharded frames' timed runs, the app
    phase's server and demo runs and the graph phase's timed replays, then each all-passes pass, each
    stereo eye, each sharded band pass and each lit pass at its own shape
    with the launches counted in that pass during the frame's timed run
    (one a frame), the frame server's opaque pass with its launches over
    the selftest's timed frames, and the demo's lines and particle passes
    with their launches over the demo run, and the deep_k frame's particle
    pass at K = 64 with its launches in that frame's timed run; then each
    material sampler at its largest call (launches over the sampler phase's
    main-path run and the graph phase's timed replays, max_abs_err over
    every recorded call) and at each site and shape of the headline,
    all-passes and stereo frames (the launches counted at that site in the
    main-path run)."""

    def entry(name, kernel, n_launches, res, max_abs_err=None):
        source, replaces = KERNEL_SOURCES[kernel]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches,
            "max_abs_err": res["max_abs_err"] if max_abs_err is None else max_abs_err,
            "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
        }

    ap_raster, ap_kbuffer = ap_launches["raster_sorted"], ap_launches["kbuffer_sorted"]
    app_runs = (app["app_run"], app["demo"])
    sampler_sites = {k: {s: r for s, r in sampler["sites"].items() if r["kernel"] == k}
                     for k in ("classic_sample", "material_sample")}
    bands = range(SHARD_BANDS)

    def band(key):
        return f"{WIDTH}x{shapes[key]['rows']} at y_offset {shapes[key]['y_offset']}"

    return {"kernels": [
        entry("raster_sorted", "raster",
              headline_launches + cb_launches["raster_sorted"] + ap_raster
              + sum(stereo_by_eye.values()) + sh_launches["raster_sorted"]
              + lit_launches["raster_sorted"] + sum(r["raster_sorted"] for r in app_runs)
              + deep_launches["raster_sorted"] + graph_launches["raster_sorted"],
              raster_res,
              max(raster_res["max_abs_err"],
                  *(shapes[n]["max_abs_err"]
                    for n in AP_RASTER + EYES + SH_STEREO + SH_RASTER + LIT_RASTER + APP_RASTER))),
        entry("kbuffer_sorted", "kbuffer",
              cb_launches["kbuffer_sorted"] + ap_kbuffer + sh_launches["kbuffer_sorted"]
              + lit_launches["kbuffer_sorted"] + sum(r["kbuffer_sorted"] for r in app_runs)
              + deep_launches["kbuffer_sorted"] + graph_launches["kbuffer_sorted"],
              kbuffer_res,
              max(kbuffer_res["max_abs_err"],
                  *(shapes[n]["max_abs_err"]
                    for n in AP_KBUFFER + SH_KBUFFER + LIT_KBUFFER + DEMO_KBUFFER),
                  *(shapes[f"deep_k{k}"]["max_abs_err"] for k in DEEP_KS))),
        *[entry(f"raster_sorted[all_passes {n}]", "raster", ap_by_pass[n], shapes[n])
          for n in AP_RASTER],
        *[entry(f"kbuffer_sorted[all_passes {n}]", "kbuffer", ap_by_pass[n], shapes[n])
          for n in AP_KBUFFER],
        *[entry(f"raster_sorted[stereo {eye}]", "raster", stereo_by_eye[eye], shapes[eye])
          for eye in EYES],
        *[entry(f"raster_sorted[sharded stereo {eye} {band(f'sharded_{eye}_band{b}')}]",
                "raster", sh_by_pass[f"sharded_{eye}_band{b}"],
                shapes[f"sharded_{eye}_band{b}"])
          for eye in EYES for b in bands],
        *[entry(f"{kernel}_sorted[sharded all_passes {n} {band(f'sharded_{n}_band{b}')}]",
                kernel, sh_by_pass[f"sharded_{n}_band{b}"], shapes[f"sharded_{n}_band{b}"])
          for b in bands for kernel, names in (("raster", AP_RASTER), ("kbuffer", AP_KBUFFER))
          for n in names],
        *[entry(f"raster_sorted[lit_passes {n}]", "raster", lit_by_pass[n], shapes["lit_" + n])
          for n in AP_RASTER],
        *[entry(f"kbuffer_sorted[lit_passes {n}]", "kbuffer", lit_by_pass[n], shapes["lit_" + n])
          for n in AP_KBUFFER],
        entry("raster_sorted[app opaque]", "raster", app["app"]["raster_launches"],
              shapes["app_opaque"]),
        entry("raster_sorted[demo lines]", "raster", app["demo_by_pass"]["lines"],
              shapes["demo_lines"]),
        entry("kbuffer_sorted[demo particles]", "kbuffer", app["demo_by_pass"]["particles"],
              shapes["demo_particles"]),
        entry("kbuffer_sorted[deep_k particles K=64]", "kbuffer", deep_by_pass["particles"],
              shapes["deep_k64"]),
        *[entry(kernel, kernel, sampler["launches"][kernel] + graph_launches[kernel],
                max((r for r in sites.values() if "ms" in r),
                    key=lambda r: r["lanes"] * r["slots"]),
                max(r["max_abs_err"] for r in sites.values()))
          for kernel, sites in sampler_sites.items()],
        *[entry(f"{r['kernel']}[{site}]", r["kernel"], sampler["site_launches"][site], r)
          for site, r in sampler["sites"].items() if "ms" in r],
    ]}


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
    from superconductor_tpu_torch.scenes import (
        all_passes_scene,
        headline_scene,
        heavy_tile_setup,
        stereo_animated_scene,
    )

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)  # name, power limit: as nvidia-smi gives them
    phase("device", f"torch: {kind}, count={torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build = raster_mod.build_kernels(force=True, verbose=True)
    phase("build", f"every kernel built in {time.perf_counter() - t0:.2f} s (in parallel)")
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
    headline_variants(dev, scene_dev, state0, config, env, img, frame_ms)

    kb_results = {"max_abs_err": 0.0}
    cb_raster = {"max_abs_err": 0.0}
    cb_launches = clip_blend_path(dev, kb_results, cb_raster)
    results["max_abs_err"] = max(results["max_abs_err"], cb_raster["max_abs_err"])

    shapes = {name: {"max_abs_err": 0.0} for name in AP_RASTER + AP_KBUFFER + EYES + SH_STEREO
              + SH_RASTER + SH_KBUFFER + LIT_RASTER + LIT_KBUFFER + APP_RASTER + DEMO_KBUFFER}
    ap_launches, ap_by_pass, ap_frame = all_passes_path(dev, shapes)
    deep_launches, deep_by_pass = deep_k_path(dev, ap_frame[2], shapes)
    stereo_by_eye, stereo_frame = stereo_path(dev, shapes)
    sh_launches, sh_by_pass = sharded_path(shapes, stereo_frame, ap_frame)
    ap_config, stereo_config = ap_frame[2], stereo_frame[2]
    del ap_frame, stereo_frame
    lit_launches, lit_by_pass = lit_passes_path(dev, shapes)
    app = app_path(dev, shapes, smi)
    roofline_path(dev)
    bench_path(kind, smi)
    ap_tables, ap_build, _, ap_env = all_passes_scene(WIDTH, HEIGHT, dev)
    st_tables, st_build, _, st_env = stereo_animated_scene(WIDTH, HEIGHT, dev)
    graph_frames = {
        "headline": (scene_dev, build_state, config, env),
        "all_passes": (ap_tables, ap_build, ap_config, ap_env),
        "stereo": (st_tables, st_build, stereo_config, st_env),
    }
    graph_launches = graph_path(smi, graph_frames)
    sampler = sampler_path(smi, graph_frames)

    for mod in ("jax", "superconductor_tpu"):
        if sys.modules.get(mod) is not None:
            raise RuntimeError(f"{mod} was imported")
    phase("imports", "neither jax nor superconductor_tpu was imported")

    print(json.dumps(kernels_line(launches, cb_launches, ap_launches, ap_by_pass,
                                  stereo_by_eye, sh_launches, sh_by_pass, lit_launches,
                                  lit_by_pass, app, deep_launches, deep_by_pass, graph_launches,
                                  results, kb_results, shapes, sampler)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
