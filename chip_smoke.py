"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--baseline DIR]

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
2. build: compiles csrc/raster.cu, csrc/kbuffer.cu, csrc/sample.cu,
   csrc/gbuffer.cu, csrc/sky.cu, csrc/shade.cu, csrc/geometry.cu and
   csrc/worklist.cu (nvcc, sm_90a, one process each, at once) and prints the seconds, the compiler's
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
    profiled replay (the raster, the k-buffer, both material samplers, the
    g-buffer, the sky, the shade, the vertex stage and the view setup);
    eager and graph frame times (CUDA events over 10 frames; stereo also
    with its state and FK built each frame) beside nvidia-smi's name and
    power limit, and the launches of the timed replays;
15. sampler (the material samplers, csrc/sample.cu): each kernel's
    registers and local (spill) bytes a thread and resident blocks an SM
    (ops/sample.py kernel_info); every sampler call of
    one eager headline, all-passes and stereo frame recorded and held bit
    for bit against its plain version on its inputs (a call on a segment,
    lane_ids, as the material partition makes its head and tail: the
    kernel and the plain version each write into their own copy of `out`
    filled with a sentinel, the segment's rows compared and every other
    row held to the sentinel); each site and shape
    timed (kernel and plain version, bench_raster.graph_ms) with its bound
    (bytes: the lane ids, the lanes' inputs, the material ints, the 32-B
    sectors of texel bytes the call uses, 16 B a slot written in place)
    and the time of one
    index_select of the texel rows it fetches as a yardstick for the
    gathers; each scene's graph frame byte-equal, image and stats, to its
    twin with every plain version swapped in and to its twin with only the
    samplers swapped; a replay's launch tally holding the samplers' calls
    of an eager frame; then the main path: every launch counter set to 0,
    every graph captured anew, 10 graph frames of each of the three, the
    counters read, each launch also counted at its site (a capture's tally
    of sites added at each replay), and each sampler kernel, and each
    site, must have launched its eager frame's calls a frame;
16. deferred (the g-buffer and the sky, csrc/gbuffer.cu and csrc/sky.cu):
    as 15 for every interpolate_gbuffer, sample_skybox and sample_skybox_at
    call of one eager headline, all-passes and stereo frame, each held bit
    for bit against its plain version (every GBuffer field), each site timed
    with its bound (bytes: the lanes' inputs, the 32-B sectors of the rows'
    columns or cube quads read, the fields written) and the time of one
    index_select of the rows it reads (the shade rows, the cube quads); the
    graph frames' twins with every plain version and with these two
    kernels' plain versions; a replay's tally; then its own main-path run,
    each launch counted at its site; then [sky]: of the sky kernel's
    template each site launches, its registers and spills (ptxas), its
    static SASS instructions (cuobjdump -sass) and the time they would take
    at the site's pixels if a thread ran each once (an estimate, not a
    bound), beside its time and bytes bound;
17. shade (the deferred shade, csrc/shade.cu): as 15 for every shade call
    of one eager headline, all-passes, stereo and lit frame (the lit one
    with the light volume's and the lightmaps' per-lane SH), each held bit
    for bit against shade_plain (rgb and alpha); each site timed as the
    kernel's launch (shade_lanes) and the torch chain it replaces
    (shade_lanes_plain) on the call's sampled inputs, with its bound
    (shade_bound) and the time of one index_select of the material rows
    its lanes read; the graph frames' twins with every plain version and
    with shade_plain alone; a replay's tally; its own main-path run, each
    launch counted at its site;
18. geometry (the vertex stage and the view setup, csrc/geometry.cu; 2
    prints their registers and spills): as 15 for every
    geometry_vertex_stage_merged and geometry_view_setup_merged call of one
    eager headline, all-passes, stereo and lit frame (both draw lists'
    vertex stage in one call, two launches: the vertex phase and the
    triangle phase, writing the lists' rows into the frame's merged table;
    both lists' setup of a view in one launch), each held bit for bit
    against its plain version (every field of the VertexStages and their
    packed attributes, or of the TriangleSetup, by its int32 view, each
    written into its own sentinel-filled copy of the call's `out`); each
    site timed (kernel and torch chain) with its bound (geometry_bound: the
    sum of its lists', geometry_bytes_ops) and the time of one
    index_select of the rows it reads (the vertices, the triangles'
    indices, the corners' w1 rows), each list alone through its per-list
    wrapper and the merged call's device ms by kernel (a profile), and,
    with --baseline DIR, the geometry kernels of the tree at DIR (say, a
    git archive of an earlier commit) as that tree's frame called them at
    the same site; the graph frames' twins with every plain version and
    with the two geometry plain versions (render/frame.py
    GEOMETRY_PLAIN_VERSIONS); a replay's tally; its own main-path run, each
    launch counted at its site; each frame's launches (at most 2 of the
    vertex stage, 1 setup a view);
19. worklist (the shading worklists' compaction, compose and clip-round
    compose, csrc/worklist.cu): the kernels' registers, stack and spills
    (ptxas); as 15 for every worklist_compact, worklist_compose and
    worklist_compose_clip call of one eager headline, all-passes, stereo
    and lit frame (the composes write in place: the recorded call keeps a
    copy of dst or of the clip round's three planes, and the kernel and the
    plain version each write into their own copy, the kernel's result that
    copy's storage), each held bit for bit against its plain version (idx,
    safe, live and need; the composed bytes; the three planes); each site
    timed (kernel and torch chain) with its bound (worklist_bytes), its
    yardstick (a compaction's torch.sort of its int32 keys, a compose's
    index_copy_ into an (n_g + 1)-row buffer; a clip round's index_copy_ of
    its found rows, which is not the round: its library_ms is null) and
    its detail (a compaction's grid at GRID_BLOCKS blocks, at the rule's
    (ops/worklist.py compact_blocks) and at twice that; a clip round as
    separate takes, masks and three compose launches) and, with --baseline
    DIR, the worklist kernels of the tree at DIR as that tree's frame
    called them at the same site; the graph frames' twins with
    every plain version and with the worklist plain versions
    (render/frame.py WORKLIST_PLAIN_VERSIONS); a replay's tally; its own
    main-path run, each launch counted at its site; each frame's launches
    of both kernels, read from their counters around one eager frame, one
    a compaction and one a compose or clip round, one clip round a
    k-buffer layer; then every call of two more eager frames held and
    timed the same way: the headline at gr = 1 (2,073,600 one-pixel
    granules, a grid of 507 blocks) and the all-passes frame with every
    worklist cap halved (compactions over their cap);
20. neither jax nor the JAX package (superconductor_tpu) was imported.

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
(the launches counted at that site in the main-path run), the
g-buffer and sky kernels the same way (the deferred phase's main-path run),
the shade kernel (the shade phase's main-path run, with the lit frame), and
the vertex stage and view setup kernels (the geometry phase's main-path
run, with the lit frame), and the worklist compaction and compose kernels
(the worklist phase's main-path run, with the lit frame). A sampler, the
g-buffer, the sky, the shade, the geometry and the worklists replace no
TPU kernel: their "replaces" names the JAX package's XLA functions. The
library_ms of the worklist kernels is their yardstick's (a torch.sort of
the keys, an index_copy_ of the rows; null at a clip round, which no one
PyTorch call computes); the others' is null (no one PyTorch call computes
them). Their bounds are sampler_bound's,
deferred_bound's, shade_bound's, geometry_bound's and worklist_bound's.
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
from typing import Callable, NamedTuple, Optional

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
    # csrc/gbuffer.cu and csrc/sky.cu replace no TPU kernel either
    "gbuffer": ("superconductor_tpu_torch/csrc/gbuffer.cu",
                "none (XLA: superconductor_tpu/ops/shade.py:73 interpolate_gbuffer)"),
    "sky": ("superconductor_tpu_torch/csrc/sky.cu",
            "none (XLA: superconductor_tpu/ops/sky.py:56 shade_sky_rays, :76 sample_skybox, "
            ":94 sample_skybox_at)"),
    # csrc/shade.cu neither: the deferred shade after the material sampling
    "shade": ("superconductor_tpu_torch/csrc/shade.cu",
              "none (XLA: superconductor_tpu/ops/shade.py:410 shade)"),
    # csrc/geometry.cu neither: the vertex stage and each view's edge setup
    "vertex_stage": ("superconductor_tpu_torch/csrc/geometry.cu",
                     "none (XLA: superconductor_tpu/ops/geometry.py:194 "
                     "geometry_vertex_stage)"),
    "view_setup": ("superconductor_tpu_torch/csrc/geometry.cu",
                   "none (XLA: superconductor_tpu/ops/geometry.py:292 geometry_view_setup, "
                   ":386 _setup_from_clip)"),
    # csrc/worklist.cu neither: the shading worklists' compaction and compose
    "worklist_compact": ("superconductor_tpu_torch/csrc/worklist.cu",
                         "none (XLA: superconductor_tpu/render/frame.py:419 _compact_px, "
                         ":532 _compact_worklist)"),
    "worklist_compose": ("superconductor_tpu_torch/csrc/worklist.cu",
                         "none (XLA: superconductor_tpu/render/frame.py:543 _compose_worklist)"),
    # the particle pass neither: the shade of a layer's lanes and the billboards
    "particle_shade": ("superconductor_tpu_torch/csrc/shade.cu",
                       "none (XLA: superconductor_tpu/ops/particles.py:166 shade_particles)"),
    "particle_geometry": ("superconductor_tpu_torch/csrc/geometry.cu",
                          "none (XLA: superconductor_tpu/ops/particles.py:42 "
                          "particle_geometry)"),
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
    r"material_sample|gbuffer|sky|shade|vertex_stage|view_setup|worklist_compact|"
    r"worklist_compose)_kernel\b")
# the hand kernels that replace no TPU kernel, by phase
SAMPLERS = ("classic_sample", "material_sample")
DEFERRED = ("gbuffer", "sky")
GEOMETRY = ("vertex_stage", "view_setup")
WORKLIST = ("worklist_compact", "worklist_compose")
PARTICLES = ("particle_shade", "particle_geometry")
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
    run, by kernel and by pass, and the frame (tables, build(pose), fitted
    config, env)."""
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
    return launches, by_pass, (scene_dev, build_state, config, env)


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


def plain_tables() -> dict:
    """kernel -> its wrappers' bindings (module, name, plain version):
    bench.PLAIN_VERSIONS and render/frame.py GEOMETRY_PLAIN_VERSIONS,
    WORKLIST_PLAIN_VERSIONS and PARTICLE_PLAIN_VERSIONS."""
    from superconductor_tpu_torch.bench import PLAIN_VERSIONS
    from superconductor_tpu_torch.render.frame import (
        GEOMETRY_PLAIN_VERSIONS,
        PARTICLE_PLAIN_VERSIONS,
        WORKLIST_PLAIN_VERSIONS,
    )

    return {**PLAIN_VERSIONS, **GEOMETRY_PLAIN_VERSIONS, **WORKLIST_PLAIN_VERSIONS,
            **PARTICLE_PLAIN_VERSIONS}


def kernel_bindings(kernels) -> dict:
    """wrapper name -> (kernel, the module the frame looks the wrapper up
    in, its plain version) of the `kernels`' wrappers (plain_tables)."""
    tables = plain_tables()
    return {name: (k, mod, plain) for k in kernels for mod, name, plain in tables[k]}


@contextlib.contextmanager
def plain_versions(kernels=None):
    """Inside the block, the named kernels' wrappers (every kernel of
    plain_tables when None) are replaced by their plain versions where the
    frame looks them up; they are put back after."""
    tables = plain_tables()
    bindings = [b for k in (tables if kernels is None else kernels) for b in tables[k]]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in bindings]
    try:
        for mod, name, plain in bindings:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def kernel_counters() -> dict:
    """hand kernel -> the wrappers whose LAUNCHES count its launches (the
    sky kernel has two, the band's and the worklist's; each geometry kernel
    two, the per-list wrapper's and the merged one's; the particle kernels,
    overloads of the shade and view setup kernels, their own)."""
    from superconductor_tpu_torch.ops import geometry as geometry_mod
    from superconductor_tpu_torch.ops import particles as particles_mod
    from superconductor_tpu_torch.ops import raster as raster_mod
    from superconductor_tpu_torch.ops import sample as sample_mod
    from superconductor_tpu_torch.ops import shade as shade_mod
    from superconductor_tpu_torch.ops import sky as sky_mod
    from superconductor_tpu_torch.ops import worklist as worklist_mod

    return {"raster_sorted": (raster_mod.rasterize_sorted,),
            "kbuffer_sorted": (raster_mod.kbuffer_sorted,),
            "classic_sample": (sample_mod._CLASSIC_COUNTER,),
            "material_sample": (sample_mod._MATERIAL_COUNTER,),
            "gbuffer": (shade_mod._GBUFFER_COUNTER,),
            "sky": (sky_mod._SKYBOX_COUNTER, sky_mod._SKYBOX_AT_COUNTER),
            "shade": (shade_mod._SHADE_COUNTER,),
            "vertex_stage": (geometry_mod._VERTEX_STAGE_COUNTER,
                             geometry_mod._VERTEX_STAGE_MERGED_COUNTER),
            "view_setup": (geometry_mod._VIEW_SETUP_COUNTER,
                           geometry_mod._VIEW_SETUP_MERGED_COUNTER),
            "worklist_compact": (worklist_mod._COMPACT_COUNTER,),
            "worklist_compose": (worklist_mod._COMPOSE_COUNTER,
                                 worklist_mod._COMPOSE_CLIP_COUNTER),
            "particle_shade": (particles_mod._PARTICLE_SHADE_COUNTER,),
            "particle_geometry": (particles_mod._PARTICLE_GEOMETRY_COUNTER,)}


@contextlib.contextmanager
def record_calls(kernels, keep=None):
    """Inside the block, every call of a wrapper of `kernels` is appended
    to the list yielded as (wrapper name, calling function, its arguments
    by name); the wrapper still runs. The arguments are the frame's own
    tensors, strides kept, or what keep(name, arguments) makes of them
    before the call runs (a copy of a tensor the call writes in place)."""
    import inspect

    calls, saved = [], []
    for name, (_kernel, mod, _plain) in kernel_bindings(kernels).items():
        real = getattr(mod, name)
        sig = inspect.signature(real)

        def recorded(*args, _name=name, _real=real, _sig=sig, **kw):
            bound = _sig.bind(*args, **kw)
            bound.apply_defaults()
            kept = dict(bound.arguments)
            calls.append((_name, sys._getframe(1).f_code.co_name,
                          kept if keep is None else keep(_name, kept)))
            return _real(*args, **kw)

        saved.append((mod, name, real))
        setattr(mod, name, recorded)
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


# ops/sample.py's wrappers -> their kernels
SAMPLER_KERNELS = {"sample_classic": "classic_sample", "sample_material": "material_sample"}


def sampler_registers(smi: str) -> None:
    """Phase [sampler]'s first lines: each sampler kernel's registers and
    local (spill) bytes a thread and its resident blocks an SM (occupancy:
    their threads of the SM's 2,048) at each block size its wrapper
    launches, from the built library."""
    from superconductor_tpu_torch.ops import sample as sample_mod

    for (kernel, taps1, block), (regs, local, blocks) in sample_mod.kernel_info().items():
        phase("sampler", f"{kernel}<{1 if taps1 else 'any taps'}>: {regs} registers a thread, "
              f"{local} B of local memory, {blocks} blocks of {block} threads an SM (occupancy "
              f"{blocks * block / 2048:.3f}); {smi}")


def sampler_lanes(name: str, args: dict) -> int:
    """The lanes a sampler call samples: its segment's (lane_ids), else
    every lane."""
    ids = args.get("lane_ids")
    return args["uv"].shape[0] if ids is None else ids.shape[0]


def sampler_site(name: str, caller: str, args: dict) -> str:
    """A sampler call's site and shape: its caller (the partition's head or
    tail segment), lanes, slots and pool."""
    kernel = SAMPLER_KERNELS[name]
    where = {"_interleaved": "whole pool"}.get(caller, caller)
    if caller == "_partition_material_sample":
        where = "partition " + ("head" if kernel == "material_sample" else "tail")
    if kernel == "classic_sample":
        pool = f"({args['pool'].shape[1]}-B rows)"
    else:
        pool = (f"({args['texels_mq'].shape[1]}-B rows"
                + (" + tail)" if args["texels_tail"] is not None
                   and args["texels_mq"].shape[1] == 64 else ")")
                + (" by material id" if args["mat"] is not None else " a row a lane"))
    return (f"{kernel} {where} {sampler_lanes(name, args)} lanes slots "
            f"{''.join(map(str, args['slots']))} {pool}")


def sampler_bound(name: str, args: dict, fetched: list) -> tuple:
    """(bound_ms, bound_by) of one sampler call: the larger of its bytes
    over 3.35 TB/s and its FP32 operations over 67 TFLOP/s (H100 SXM).
    Bytes, each read once, of the lanes the call samples (its segment's
    with lane_ids): the lane id (4 B), the lanes' uv and derivatives (24
    B) and material id (4 B); of each distinct material the lanes name, the ints
    the kernel reads (the classic sampler: a wanted slot's flags, its meta
    and its mip table; the interleaved one: its meta and level entries),
    or with a row a lane its meta, level a's entry and level b's where the
    kernel reads it (level_b_read; always with mq3 rows); the texel bytes
    the kernel reads, in whole 32-B sectors (texel_sectors: level b's only
    at the lanes whose level fraction is not 0, as csrc/sample.cu skips it
    elsewhere); 16 B a slot written in place, at each lane's own row. The
    tables' columns are ops/sample.py's. Operations, counted
    from csrc/sample.cu: a bilinear level 76 (tap position 8, the
    4-channel lerp 52, u8 scale 4, sRGB 12 with its powf as one), a
    trilinear 166 (two levels, blend 12, floor 2), a tap 8 more, the LOD
    15."""
    from superconductor_tpu_torch.ops import sample as sample_mod

    kernel = SAMPLER_KERNELS[name]
    lanes, n_slots, taps = sampler_lanes(name, args), len(args["slots"]), max(1, int(args["taps"]))
    mat, ids = args["mat"], args.get("lane_ids")
    if mat is not None and ids is not None:
        mat = mat[ids.long()]
    read_b = level_b_read(name, args)
    if kernel == "classic_sample":
        table, head, per_level = args["mat_row"], sample_mod.MAT_ROW_HEAD, \
            sample_mod.MAT_ROW_LEVEL
        L = (table.shape[1] - head) // per_level
        per_material = n_slots * (1 + sample_mod.SLOT_META + 3 * L) * 4
    else:
        table, head, per_level = args["rows"], sample_mod.MQ_ROW_HEAD, sample_mod.MQ_ROW_LEVEL
        L = (table.shape[1] - head) // per_level
        per_material = (head - sample_mod.META + per_level * L) * 4
    nbytes = (lanes * 24 + lanes * 16 * n_slots
              + texel_sectors(fetched, args["slots"], read_b) * 32)
    if ids is not None:
        nbytes += lanes * 4
    if mat is not None:
        distinct = torch.unique(torch.remainder(mat.long(), table.shape[0])).numel()
        nbytes += lanes * 4 + distinct * per_material
    else:
        b_entries = lanes if args["texels_mq"].shape[1] == 208 else int(read_b[0].sum())
        nbytes += (lanes * (head - sample_mod.META + per_level) + b_entries * per_level) * 4
    level, trilinear = 76, 166
    if kernel == "classic_sample":
        ops = lanes * n_slots * (15 + taps * (trilinear + 8))
    else:
        ops = lanes * (15 + taps * (8 + 16 + n_slots * (2 * (level - 8) + 12) + 8))
    bytes_ms, ops_ms = nbytes / 3.35e9, ops / 67e9
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def level_b_read(name: str, args: dict) -> torch.Tensor:
    """(wanted slots of a classic call or 1, lanes) bool: the lanes of a
    sampler call at which its kernel reads level b, those whose level
    fraction is not 0 (csrc/sample.cu trilinear). The lod as ops/texture.py
    sample_anisotropic and sample_material_interleaved compute it, the same
    operations in the same order, from the lanes' derivatives and the
    mip-0 size of the slot's texture (classic) or of the material's
    interleaved chain (its slots share one lod); it is >= 0, so the fraction
    is lod - floor(lod)."""
    from superconductor_tpu_torch.ops import sample as sample_mod

    ids = args.get("lane_ids")

    def pick(t):
        return t if ids is None else t[ids.long()]

    dx, dy = pick(args["duvdx"]), pick(args["duvdy"])
    if SAMPLER_KERNELS[name] == "classic_sample":
        mtm = sample_mod._unpack_mat_row(args["mat_row"][pick(args["mat"])])[2]
        meta = sample_mod.SLOT_META
        sizes = [(mtm[:, meta * s + 4], mtm[:, meta * s + 5]) for s in args["slots"]]
    else:
        rows = pick(args["rows"]) if args["mat"] is None else args["rows"][pick(args["mat"])]
        owh = sample_mod._unpack_mq_row(rows)[3]
        sizes = [(owh[:, 0, 1], owh[:, 0, 2])]
    taps = int(args["taps"])
    read = []
    for w, h in sizes:
        w, h = w.to(torch.float32), h.to(torch.float32)
        dx2 = (dx[..., 0] * w) ** 2 + (dx[..., 1] * h) ** 2
        dy2 = (dy[..., 0] * w) ** 2 + (dy[..., 1] * h) ** 2
        if taps <= 1:
            lod = torch.clamp_min(
                0.5 * torch.log2(torch.clamp_min(torch.maximum(dx2, dy2), 1e-12)), 0.0)
        else:
            maj, mnr = torch.maximum(dx2, dy2), torch.minimum(dx2, dy2)
            ratio2 = torch.clamp(maj / torch.clamp_min(mnr, 1e-12), 1.0, float(taps) ** 2)
            lod = torch.clamp_min(0.5 * torch.log2(torch.clamp_min(maj / ratio2, 1e-12)), 0.0)
        read.append(lod != torch.floor(lod))
    return torch.stack(read)


def texel_sectors(fetched: list, slots, read_b: torch.Tensor) -> int:
    """The 32-B sectors of the texel pools that hold bytes a sampler call's
    kernel reads, of the rows its plain version fetches (recorded_fetches):
    a texel or quad row (4 or 16 B) whole; of a 64-B interleaved row the
    wanted slots' 16-B quads; of a 208-B mq3 row the wanted slots' quads
    and, level b, their 3 x 3 cells of the next level (36 B each). The
    plain chains fetch, for each wanted slot (classic) and tap, level a's
    rows and then level b's, four fetches a level from the flat pool and
    one from the others; the mq3 chain one row a tap. Level b's bytes
    count only at the lanes read_b (level_b_read) marks. A sector two rows
    share counts once."""
    def width(pool):
        return pool.shape[1] * pool.element_size()

    k = 4 if all(width(pool) == 4 for pool, _ in fetched) else 1
    groups = [fetched[j:j + k] for j in range(0, len(fetched), k)]
    per_row = len(groups) // read_b.shape[0]
    if not groups or per_row * read_b.shape[0] != len(groups):
        raise ValueError(f"{len(fetched)} texel fetches for {read_b.shape[0]} lod rows")
    pools = {}
    for j, group in enumerate(groups):
        b = read_b[j // per_row]
        for pool, index in group:
            rows = torch.remainder(index.reshape(-1).long(), pool.shape[0])
            if rows.shape != b.shape:
                raise ValueError(f"a fetch of {rows.numel()} rows for {b.numel()} lanes")
            n = width(pool)
            if n in (4, 16):
                reads = [(rows if j % 2 == 0 else rows[b], [(0, n)])]
            elif n == 64:
                reads = [(rows if j % 2 == 0 else rows[b], [(16 * s, 16) for s in slots])]
            elif n == 208:
                reads = [(rows, [(16 * s, 16) for s in slots]),
                         (rows[b], [(64 + 36 * s, 36) for s in slots])]
            else:
                raise ValueError(f"a texel pool of {n}-B rows")
            found = pools.setdefault(pool.data_ptr(), [])
            for r, spans in reads:
                base = pool.data_ptr() + torch.unique(r) * n
                found += [sector_ids(base + off, size) for off, size in spans]
    return sum(torch.unique(torch.cat(found)).numel() for found in pools.values())


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


def deferred_lanes(name: str, args: dict) -> int:
    if name == "interpolate_gbuffer":
        return args["pair"].shape[0]
    if name == "sample_skybox_at":
        return args["idx"].shape[0]
    return args["height"] * args["width"]


def deferred_site(name: str, caller: str, args: dict) -> str:
    """A deferred call's site and shape: the kernel, its caller, lanes and
    rows (the g-buffer) or band / worklist (the sky)."""
    lanes = deferred_lanes(name, args)
    if name == "interpolate_gbuffer":
        row = args["shade_row"]
        if row is None:
            rows = "setup + packed tables"
        else:
            real = row.shape[1] if args["row_cols"] is None else args["row_cols"]
            rows = f"{real}-float shade rows" + (f" of {row.shape[1]}" if real != row.shape[1]
                                                 else "")
        return f"gbuffer {caller} {lanes} lanes ({rows})"
    where = "worklist" if name == "sample_skybox_at" else "band"
    return f"sky {where} {caller} {lanes} px"


def sector_ids(addresses: torch.Tensor, nbytes: int) -> torch.Tensor:
    """The 32-B sectors (their indices, each once) that hold the byte
    ranges [a, a + nbytes) of the start addresses (bytes) `addresses`."""
    first, last = addresses // 32, (addresses + nbytes - 1) // 32
    spans = [(first + k)[first + k <= last] for k in range((nbytes + 31) // 32 + 1)]
    return torch.unique(torch.cat(spans))


def sector_count(addresses: torch.Tensor, nbytes: int) -> int:
    """The number of sector_ids(addresses, nbytes)."""
    return sector_ids(addresses, nbytes).numel()


def deferred_bound(name: str, args: dict, fetched: list) -> tuple:
    """(bound_ms, bound_by) of one deferred call: the larger of its bytes
    over 3.35 TB/s and its FP32 operations over 67 TFLOP/s (H100 SXM).
    The g-buffer's bytes, each read once: the lanes' pair, px and py (12
    B); of each distinct row the lanes read (pairs clamped to 0), the 32-B
    sectors holding the columns the kernel reads (setup 0-8 and 15,
    packed 0-31, the tail); written, 87 B a lane and its tail. Its
    operations, counted from csrc/gbuffer.cu: 184 a lane. The sky's: the
    lanes' indices (on the worklist), the projection's inverse and the
    quaternion (80 B), the sectors of each distinct pool row the plain
    version fetches, 12 B a pixel written; 140 operations a pixel (the
    ray 57, the face and uv 16, the tap and lerp 36, the display transform
    31, a powf as one)."""
    if name == "interpolate_gbuffer":
        pair = args["pair"]
        lanes = pair.shape[0]
        rows = torch.unique(torch.clamp_min(pair, 0).long())
        head = list(range(9)) + [15]
        row = args["shade_row"]
        if row is not None:
            real = row.shape[1] if args["row_cols"] is None else args["row_cols"]
            tables = [(row, head + list(range(16, real)))]
            tail = real - 48
        else:
            tables = [(args["tri"].setup, head), (args["attrs"].packed, list(range(32)))]
            tail = 0
        sectors = 0
        for t, cols in tables:
            cols = torch.tensor(cols, device=rows.device)
            addr = t.data_ptr() + (rows[:, None] * t.stride(0) + cols[None, :]) * 4
            sectors += sector_count(addr.reshape(-1), 4)
        nbytes = lanes * (12 + 87 + 4 * tail) + sectors * 32
        ops = lanes * 184
    else:
        lanes = deferred_lanes(name, args)
        nbytes = lanes * 12 + 80
        if name == "sample_skybox_at":
            nbytes += lanes * args["idx"].element_size()
        for pool, idx in fetched_rows(fetched):
            width = pool.shape[1] * pool.element_size()
            nbytes += sector_count(pool.data_ptr() + torch.unique(idx) * width, width) * 32
        ops = lanes * 140
    bytes_ms, ops_ms = nbytes / 3.35e9, ops / 67e9
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def deferred_equal(out, want, args: dict) -> tuple:
    """(equal bit for bit, values compared, values that differ): a GBuffer
    field by field (f32 fields by their int32 views), or one tensor."""
    pairs = list(zip(out, want)) if isinstance(want, tuple) else [(out, want)]
    total = bad = 0
    ok = True
    for a, b in pairs:
        if a is None or b is None:
            ok = ok and a is None and b is None
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, b.numel(), b.numel()
        if b.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        n = int((a != b).sum())
        total, bad = total + b.numel(), bad + n
    return ok and bad == 0, total, bad


def deferred_rows(name: str, args: dict, fetched: list) -> list:
    """[(table, row indices)] a deferred call reads: the g-buffer's shade
    rows (or setup and packed rows) at the lanes' pairs clamped to 0, the
    sky's cube quads."""
    if name != "interpolate_gbuffer":
        return fetched_rows(fetched)
    pair = torch.clamp_min(args["pair"], 0)
    if args["shade_row"] is not None:
        return [(args["shade_row"], pair)]
    return [(args["tri"].setup, pair), (args["attrs"].packed, pair)]


class HandPhase(NamedTuple):
    """A chip_smoke phase of hand kernels that replace no TPU kernel,
    checked where the frame calls them (hand_path). Its functions take a
    wrapper's name and its arguments by name."""

    label: str
    kernels: tuple  # bench.PLAIN_VERSIONS keys
    lanes: Callable  # (name, args) -> lanes (0: nothing launched)
    site: Callable  # (name, caller, args) -> the call's site and shape
    equal: Callable  # (out, want, args) -> (bit for bit, values, values that differ)
    bound: Callable  # (name, args, fetched) -> (bound_ms, bound_by)
    rows: Callable  # (name, args, fetched) -> [(table, row indices)] read
    modules: tuple  # names of the ops modules whose _launched the main path wraps
    # (name, args) -> (the kernel's call, its plain version's call) to time,
    # where the wrapper does more than launch the kernel; None: the wrapper
    # and its plain version on args
    timed: Optional[Callable] = None
    # (name, args) -> the kernel launches a call makes (None: one)
    call_launches: Optional[Callable] = None
    # (name, args) -> a call of a baseline tree's kernels at the same site
    # to time beside the kernel, or None (None: no baseline)
    baseline: Optional[Callable] = None
    # (name, args) -> a line of further timings at a site, or None (None:
    # none)
    detail: Optional[Callable] = None
    # (name, args) -> the arguments record_calls keeps of a call (None: as
    # they are)
    keep: Optional[Callable] = None
    # args -> the arguments of one comparing or timed call, with its own
    # copy of what the call writes (None: fresh_out)
    fresh: Optional[Callable] = None
    # (name, args) -> (label, one PyTorch call, whether it computes the same
    # function) timed as the site's yardstick and, where it does, kept as
    # its library_ms (None: one index_select of the rows the call reads,
    # `rows`)
    yardstick: Optional[Callable] = None


# what compare_calls fills a sampler's `out` with before the kernel and
# the plain version write their rows into their own copies (a NaN pattern)
OUT_SENTINEL = 0x7FBADBAD


def fresh_out(args: dict) -> dict:
    """args with a new `out` (its shape, every value OUT_SENTINEL's bits,
    a bool True) where the call writes into one, so that the kernel and
    its plain version each write their own; an `out` of several tensors
    (a NamedTuple: the geometry's rows) gets a new one of each."""
    out = args.get("out")
    if out is None:
        return args

    def fresh(t):
        if t is None or t.dim() == 0:
            return t
        if t.dtype == torch.bool:
            return torch.ones(t.shape, dtype=torch.bool, device=t.device)
        return torch.full(t.shape, OUT_SENTINEL, dtype=torch.int32, device=t.device).view(t.dtype)

    if isinstance(out, torch.Tensor):
        return dict(args, out=fresh(out))
    return dict(args, out=type(out)(*[fresh(t) for t in out]))


def tensor_equal(out, want, args: dict) -> tuple:
    """(bit for bit, values compared, values that differ) of a sampler's
    result and its plain version's, by their int32 views; with lane_ids,
    the rows the call writes compared and every other row of both held
    to OUT_SENTINEL (untouched)."""
    if out.shape != want.shape:
        return False, want.numel(), want.numel()
    a, b = out.view(torch.int32), want.view(torch.int32)
    ids = args.get("lane_ids")
    if ids is None:
        bad = int((a != b).sum())
        return bad == 0, want.numel(), bad
    rows = ids.long()
    others = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    others[rows] = False
    bad = int((a[rows] != b[rows]).sum()) + int((a[others] != OUT_SENTINEL).sum()) \
        + int((b[others] != OUT_SENTINEL).sum())
    return bad == 0, want.numel(), bad


SAMPLER_PHASE = HandPhase("sampler", SAMPLERS, sampler_lanes, sampler_site, tensor_equal,
                          sampler_bound, lambda name, args, fetched: fetched_rows(fetched),
                          ("sample",))
DEFERRED_PHASE = HandPhase("deferred", DEFERRED, deferred_lanes, deferred_site, deferred_equal,
                           deferred_bound, deferred_rows, ("shade", "sky"))


# csrc/shade.cu's FP32 operations a lane, counted from the kernel (each
# product, sum, quotient, clamp, maximum, square root, reciprocal square
# root and powf one): a lit lane 346 before the display transform, aces 9
# and linear_to_srgb_approx 2 a channel; an unlit lane its albedo and alpha
# (4) and the sRGB encode
SHADE_OPS_LIT, SHADE_OPS_UNLIT, SHADE_OPS_ACES, SHADE_OPS_SRGB = 346, 4, 27, 6
_shade_inputs: dict = {}  # id(args) -> (args, shade_lanes' arguments)


def shade_inputs(args: dict) -> dict:
    """shade_lanes' arguments of a recorded shade call (ops/shade.py
    shade_inputs: the material sampling and the SH), made once a call."""
    from superconductor_tpu_torch.ops import shade as shade_mod

    if id(args) not in _shade_inputs:
        _shade_inputs[id(args)] = (args, shade_mod.shade_inputs(**args))
    return _shade_inputs[id(args)][1]


def shade_lanes_count(name: str, args: dict) -> int:
    return args["gbuf"].valid.shape[0]


def shade_site(name: str, caller: str, args: dict) -> str:
    """A shade call's site and shape: its caller, lanes, where its textures
    and factors come from, its SH and its inline flags."""
    from superconductor_tpu_torch.ops import shade as shade_mod

    g = args["gbuf"]
    rows = "mat_tail rows" if g.mat_tail is not None else "rows by id"
    if args["s16"] is not None:
        source = f"partition s16, {rows}"
    elif shade_mod._whole_pool(args["scene"]):
        source = f"whole pool, {rows}"
    else:
        source = "classic, mat_row by id"
    sh = {"ambient": "ambient SH", "pools": "SH pools in the launch",
          "per-lane": "per-lane SH"}[shade_sh_form(shade_inputs(args))]
    return (f"shade {caller} {shade_lanes_count(name, args)} lanes ({source}; {sh}; tonemap "
            f"{int(bool(args['inline_tonemapping']))} srgb {int(bool(args['inline_srgb']))})")


def shade_sh_form(k: dict) -> str:
    """How a shade_lanes call (its arguments `k`) takes its SH: "ambient",
    "pools" (a pooled PoolSH: sampled in the launch) or "per-lane" (a (P,
    4, 3) tensor, or a PoolSH on the layered path, sampled first)."""
    from superconductor_tpu_torch.ops.shade import PoolSH

    if k["sh"] is None:
        return "ambient"
    return "pools" if isinstance(k["sh"], PoolSH) and k["sh"].pooled() else "per-lane"


def shade_timed(name: str, args: dict) -> tuple:
    """The shade kernel's launch (shade_lanes) and the torch chain it
    replaces (shade_lanes_plain) on the call's sampled inputs, as the frame
    makes the call: with a PoolSH the SH lookup is part of both (in the
    kernel's launch, the torch sampler in the chain's); the material
    samplers ahead of both are not the kernel's."""
    from superconductor_tpu_torch.ops import shade as shade_mod

    k = shade_inputs(args)
    return (lambda: shade_mod.shade_lanes(**k)), (lambda: shade_mod.shade_lanes_plain(**k))


def shade_material_rows(k: dict) -> tuple:
    """(the material table, the row each lane reads)."""
    lanes = k["gbuf"].valid.shape[0]
    if k["mat"] is None:
        return k["rows"], torch.arange(lanes, device=k["rows"].device)
    return k["rows"], torch.clamp(k["mat"].long(), 0, k["rows"].shape[0] - 1)


# the shade's loads and stores: an invalid lane's valid byte and its rgb
# and alpha (5); a lit lane's flags, material id, s16 (4 16-B loads), six
# g-buffer vectors (16), the material row's factors and flag (11), the eye
# (3) and the result (4); an unlit lane's flags, id, s16's albedo, the row
# and the result (21); a given SH's 12, lm_uv and lightmapped 3
SHADE_IO_INVALID, SHADE_IO_LIT, SHADE_IO_UNLIT = 5, 41, 21


def sh_pool_rows(pool, world_pos, lm_uv=None, lightmapped=None) -> list:
    """[(SH pool, row indices)] the lanes at world_pos read of a PoolSH's
    pools (lm_uv and lightmapped: the particle shade's stand-in, 0 and
    false, where None), one entry a tap (the light volume's two layers
    where a lane is not lightmapped or no lightmaps are bound, the
    lightmaps' one elsewhere), as csrc/sh_sample.cuh reads them."""
    from superconductor_tpu_torch.ops.texture import _layer_pair, _sh_plane_index

    lv, lm = pool._sets()
    n, dev = world_pos.shape[0], world_pos.device
    if lm_uv is None:
        lm_uv = torch.zeros_like(world_pos[..., :2])
        lightmapped = torch.zeros(n, dtype=torch.bool, device=dev)
    use_lm = torch.ones(n, dtype=torch.bool, device=dev)
    if lv is not None:
        use_lm = lightmapped.clone() if lm is not None else ~use_lm
    out = []
    if lv is not None:
        w, h = (int(v) for v in lv[1])
        rescaled = ((world_pos - pool.uniforms["probes_bottom_left"])
                    / pool.uniforms["probes_scale"])[~use_lm]
        plane, _fx, _fy = _sh_plane_index(w, h, rescaled[..., 0], rescaled[..., 1])
        zi, zi1, _fz = _layer_pair(rescaled[..., 2], int(pool.env.lightvol_z_layers))
        out += [(pool.scene["lv_sh"], (z * (w * h) + plane).long()) for z in (zi, zi1)]
    if lm is not None:
        w, h = (int(v) for v in lm[1])
        plane, _fx, _fy = _sh_plane_index(w, h, lm_uv[use_lm][..., 0], lm_uv[use_lm][..., 1])
        out.append((pool.scene["lm_sh"], plane.long()))
    return out


def shade_sh_rows(k: dict) -> list:
    """[(SH pool, row indices)] the lit valid lanes of a shade call with
    the SH pools read (sh_pool_rows at their world_pos, lm_uv and
    lightmapped); [] with another SH."""
    from superconductor_tpu_torch.ops import shade as shade_mod

    if shade_sh_form(k) != "pools":
        return []
    g = k["gbuf"]
    table, idx = shade_material_rows(k)
    unlit_row = (table[:, 16].contiguous().view(torch.int32) & shade_mod.MAT_UNLIT) != 0
    lit = g.valid & ~unlit_row[idx]
    pool = k["sh"]
    lm = pool._sets()[1] is not None
    return sh_pool_rows(pool, g.world_pos[lit], g.lm_uv[lit] if lm else None,
                        g.lightmapped[lit] if lm else None)


def shade_bound(name: str, args: dict, fetched: list) -> tuple:
    """(bound_ms, bound_by) of one shade launch: the larger of its bytes
    over 3.35 TB/s and its instruction floor over INSTRUCTIONS_PER_S
    ("operations"), as this call's lanes need them. Every lane reads its
    valid byte and writes rgb and alpha (16 B); a valid lane reads
    front_facing, its material id (by id, 4 B) and s16's albedo (16 B); a
    lit one also the rest of s16 (48 B), six g-buffer vectors (64 B) and
    its SH: 48 B of per-lane SH, or with the SH pools the 32-B sectors of
    the pool rows the lit lanes tap, their lm_uv and lightmapped (9 B,
    where the lightmaps are bound) and the probe box (24 B); of the
    material rows the valid lanes read, the 32-B sectors that hold columns
    0-9 and 16; the eye (12 B). Instructions: SHADE_OPS_* of each valid
    lane, by lit or unlit and the call's inline flags, the lanes' loads and
    stores (SHADE_IO_*), and each lit lane's SH lookup (SH_INSTRUCTIONS by
    the texture set it taps)."""
    from superconductor_tpu_torch.ops import shade as shade_mod

    k = shade_inputs(args)
    g = k["gbuf"]
    table, idx = shade_material_rows(k)
    valid = g.valid
    unlit_row = (table[:, 16].contiguous().view(torch.int32) & shade_mod.MAT_UNLIT) != 0
    unlit = valid & unlit_row[idx]
    n_valid, n_unlit = int(valid.sum()), int(unlit.sum())
    n_lit = n_valid - n_unlit
    rows = torch.unique(idx[valid])
    cols = torch.tensor(list(range(10)) + [16], device=rows.device)
    addr = table.data_ptr() + (rows[:, None] * table.stride(0) + cols[None, :]) * 4
    sectors = sector_count(addr.reshape(-1), 4) if rows.numel() else 0
    lanes = valid.shape[0]
    form = shade_sh_form(k)
    nbytes = (lanes * 17 + n_valid * (1 + 16 + (4 if k["mat"] is not None else 0))
              + n_lit * (48 + 64 + (48 if form == "per-lane" else 0)) + sectors * 32 + 12)
    display = (SHADE_OPS_ACES if k["inline_tonemapping"] else 0) + (
        SHADE_OPS_SRGB if k["inline_srgb"] else 0)
    instructions = (lanes - n_valid) * SHADE_IO_INVALID + n_lit * (
        SHADE_OPS_LIT + display + SHADE_IO_LIT + (12 if form == "per-lane" else 0)) + n_unlit * (
        SHADE_OPS_UNLIT + (SHADE_OPS_SRGB if k["inline_srgb"] else 0) + SHADE_IO_UNLIT)
    if form == "pools":
        taps = shade_sh_rows(k)
        nbytes += pool_sectors(taps) * 32 + 24
        lv, lm = k["sh"]._sets()
        n_lm = next(int(i.numel()) for t, i in taps if t is k["sh"].scene["lm_sh"]) if lm else 0
        if lm:
            nbytes += n_lit * (8 + (1 if lv else 0))
        instructions += n_lm * SH_INSTRUCTIONS["lightmaps"] + (
            n_lit - n_lm) * SH_INSTRUCTIONS["volume"] + (n_lit * 3 if lm else 0)
    bytes_ms, ops_ms = nbytes / 3.35e9, instructions / INSTRUCTIONS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def shade_rows(name: str, args: dict, fetched: list) -> list:
    """[(table, row indices)] a shade launch reads by index: the lanes'
    material rows and, with the SH pools, the pool rows its lit lanes
    tap."""
    k = shade_inputs(args)
    return [shade_material_rows(k)] + shade_sh_rows(k)


def shade_detail(name: str, args: dict):
    """At a shade call with the SH pools: the frame's former form of the
    call (the torch sampler, then the kernel with that SH given), the
    kernel with the SH given alone, and the sampler alone
    (bench_raster.graph_ms); None elsewhere."""
    from superconductor_tpu_torch.bench_raster import graph_ms
    from superconductor_tpu_torch.ops import shade as shade_mod

    k = shade_inputs(args)
    if shade_sh_form(k) != "pools":
        return None
    pool, g = k["sh"], k["gbuf"]
    given = dict(k, sh=pool.sample(g))
    former_ms = graph_ms(lambda: shade_mod.shade_lanes(**dict(k, sh=pool.sample(g))),
                         launches=5, runs=10)
    alone_ms = graph_ms(lambda: shade_mod.shade_lanes(**given))
    sampler_ms = graph_ms(lambda: pool.sample(g), launches=5, runs=10)
    return (f"the torch SH sampler, then the kernel with its SH given {former_ms:.4f} ms; that "
            f"kernel alone {alone_ms:.4f} ms, the sampler alone {sampler_ms:.4f} ms")


def shade_baseline(name: str, args: dict):
    """The baseline tree's shade at a call, its ops/shade.py on its
    csrc/shade.cu, as its frame made the call: with a light volume or
    lightmaps bound, its torch SH sampler, then its kernel with that SH;
    None without a baseline."""
    if BASELINE["root"] is None:
        return None
    mod = baseline_module("shade")
    k = shade_inputs(args)
    if k["sh"] is None:
        return lambda: mod.shade_lanes(**k)
    pool = k["sh"]
    return lambda: mod.shade_lanes(**dict(k, sh=mod.sample_spherical_harmonics(
        k["gbuf"], pool.scene, pool.uniforms, pool.env)))


SHADE_PHASE = HandPhase("shade", ("shade",), shade_lanes_count, shade_site, deferred_equal,
                        shade_bound, shade_rows, ("shade",), shade_timed,
                        baseline=shade_baseline, detail=shade_detail)


# The geometry's FP32 operations, counted from the torch chains that
# csrc/geometry.cu follows (each product, sum, quotient, clamp, minimum,
# maximum, floor, ceil, cosf and sinf one): a vertex slot's transform,
# normal rotation and uv transform 78, its skinning on four joints 341 more
# (the weights' sum 7, 4 quotients, 72 a joint, the two weighted sums 42);
# a triangle slot's edge setup 97, a distinct corner's clip coordinates 28
GEOMETRY_OPS_VERTEX, GEOMETRY_OPS_SKIN = 78, 341
GEOMETRY_OPS_SETUP, GEOMETRY_OPS_CLIP = 97, 28


def geometry_parts(name: str, args: dict) -> list:
    """[(per-list wrapper name, its arguments by name)] of a geometry call:
    the call itself, or each list of a merged call as the per-list
    wrapper would take it (its rows of the merged `out`; a merged setup
    always writes tri_id and inst_id, so its parts have an `out`)."""
    from superconductor_tpu_torch.ops.geometry import row_slice, setup_table

    if name == "geometry_vertex_stage_merged":
        parts, at = [], 0
        for lst in args["lists"]:
            out = args["out"]
            parts.append(("geometry_vertex_stage", dict(
                lst._asdict(), materials=args["materials"],
                out=None if out is None else row_slice(out, at, at + lst.t_cap))))
            at += lst.t_cap
        return parts
    if name == "geometry_view_setup_merged":
        parts, at = [], 0
        for stage in args["stages"]:
            t = stage.row3.shape[0]
            out = args["out"]
            parts.append(("geometry_view_setup", dict(
                stage=stage, view_proj=args["view_proj"], width=args["width"],
                height=args["height"], flip_viewport=args["flip_viewport"],
                out=setup_table(t, "meta") if out is None else row_slice(out, at, at + t))))
            at += t
        return parts
    return [(name, args)]


def geometry_calls(name: str, args: dict) -> int:
    """The kernel launches a geometry call makes: the vertex stage's two
    phases, one setup launch."""
    return 2 if name.startswith("geometry_vertex_stage") else 1


def geometry_lanes(name: str, args: dict) -> int:
    """The slots a geometry call computes: vertex and triangle slots (the
    vertex stage) or triangle slots (the view setup), of every list."""
    if name != "geometry_vertex_stage" and name != "geometry_view_setup":
        return sum(geometry_lanes(n, a) for n, a in geometry_parts(name, args))
    if name == "geometry_vertex_stage":
        return args["t_cap"] + (args["v_cap"] or args["t_cap"])
    return args["stage"].row3.shape[0]


def geometry_site(name: str, caller: str, args: dict) -> str:
    """A geometry call's site and shape: its caller, each list's kind and
    its slots."""
    parts = geometry_parts(name, args)
    if name.startswith("geometry_vertex_stage"):
        lists = []
        for _, a in parts:
            kind = "skinned" if a["joint_palette"] is not None else "static"
            lm = "" if a["lm_uvs"] is None else ", lightmap uvs"
            lists.append(f"{kind} t_cap {a['t_cap']} v_cap {a['v_cap'] or a['t_cap']}{lm}")
        return f"vertex_stage {caller} {' + '.join(lists)}"
    flip = ", flipped" if args["flip_viewport"] else ""
    slots = " + ".join(str(a["stage"].row3.shape[0]) for _, a in parts)
    return f"view_setup {caller} {slots} triangle slots{flip}"


def geometry_read_rows(name: str, args: dict) -> dict:
    """What a per-list geometry call reads by index, each row once:
    {"vertices": the distinct scene vertices its vertex slots read,
    "triangles": the distinct scene triangles, "joints": the distinct
    clamped palette rows, "draw_materials" / "tri_materials": the distinct
    material rows read for the uv transform and for the flags} (the vertex
    stage), or {"corners": the distinct w1 rows its triangles' corners
    read} (the view setup). Each an int64 tensor of row indices."""
    from superconductor_tpu_torch.ops import geometry as geometry_mod

    if name == "geometry_view_setup":
        return {"corners": torch.unique(args["stage"].row3.long())}
    draws, t_cap = args["draws"], args["t_cap"]
    v_cap = args["v_cap"] or t_cap
    vp_inst, scene_v, _off, _ok, _total = geometry_mod.expand_draw_vertices(draws, v_cap)
    _pair_inst, scene_tri, _ok, _total = geometry_mod.expand_draws(draws, t_cap)
    rows = {"vertices": torch.unique(scene_v.long()),
            "triangles": torch.unique(scene_tri.long()),
            "draw_materials": torch.unique(draws.material[vp_inst].long()),
            "tri_materials": torch.unique(args["tri_material"][scene_tri].long())}
    if args["joint_palette"] is not None:
        ji = args["joint_indices"][scene_v] + draws.joints_offset[vp_inst][:, None]
        rows["joints"] = torch.unique(ji.clamp(0, args["joint_palette"].shape[0] - 1).long())
    return rows


def geometry_bytes_ops(name: str, args: dict) -> tuple:
    """(bytes, FP32 operations) a geometry call needs, each input read
    once and each output written once, as this call's data needs them; a
    merged call's, the sums of its lists'. The vertex stage reads each
    draw's sim8 and five int columns (the joints' offset too when skinned)
    and its two flags; each distinct scene vertex its slots read (position,
    normal, uv, 32 B; the lightmap uv 8 B; skinned, its joint indices and
    weights 32 B); each distinct palette row (32 B); each distinct draw
    material's uv offset, scale and rotation (20 B) and each distinct
    triangle material's flags (4 B); each distinct scene triangle's indices
    and material (16 B); it writes 16 B a vertex slot (w1), 151 B a
    triangle slot (the packed row, row3, pair_inst, scene_tri and three
    flags) and the count (4 B). The view setup reads 14 B a triangle slot
    (row3 and two flags), 16 B a distinct corner row of w1 and the matrix
    (64 B), and writes 81 B a slot (the setup row, valid and bbox); into an
    `out` also tri_id and inst_id, read and written (16 B). Operations:
    GEOMETRY_OPS_* of each slot and distinct corner."""
    if name != "geometry_vertex_stage" and name != "geometry_view_setup":
        sums = [geometry_bytes_ops(n, a) for n, a in geometry_parts(name, args)]
        return sum(b for b, _ in sums), sum(o for _, o in sums)
    rows = geometry_read_rows(name, args)
    if name == "geometry_view_setup":
        t = args["stage"].row3.shape[0]
        corners = rows["corners"].numel()
        nbytes = t * (14 + 81 + (16 if args["out"] is not None else 0)) + corners * 16 + 64
        return nbytes, t * GEOMETRY_OPS_SETUP + corners * GEOMETRY_OPS_CLIP
    skinned = args["joint_palette"] is not None
    t_cap = args["t_cap"]
    v_cap = args["v_cap"] or t_cap
    n = args["draws"].sim8.shape[0]
    vertex = 32 + (8 if args["lm_uvs"] is not None else 0) + (32 if skinned else 0)
    nbytes = (n * (32 + 4 * (6 if skinned else 5) + 2) + rows["vertices"].numel() * vertex
              + (rows["joints"].numel() * 32 if skinned else 0)
              + rows["draw_materials"].numel() * 20 + rows["tri_materials"].numel() * 4
              + rows["triangles"].numel() * 16 + v_cap * 16 + t_cap * 151 + 4)
    return nbytes, v_cap * (GEOMETRY_OPS_VERTEX + (GEOMETRY_OPS_SKIN if skinned else 0))


def geometry_bound(name: str, args: dict, fetched: list) -> tuple:
    """(bound_ms, bound_by) of one geometry call: the larger of
    geometry_bytes_ops' bytes over 3.35 TB/s and its operations over 67
    TFLOP/s (H100 SXM); a merged call's, the sum of its lists' bounds (by
    what bounds the largest)."""
    if name != "geometry_vertex_stage" and name != "geometry_view_setup":
        bounds = [geometry_bound(n, a, fetched) for n, a in geometry_parts(name, args)]
        return sum(ms for ms, _ in bounds), max(bounds)[1]
    nbytes, ops = geometry_bytes_ops(name, args)
    bytes_ms, ops_ms = nbytes / 3.35e9, ops / 67e9
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def geometry_rows(name: str, args: dict, fetched: list) -> list:
    """[(table, row indices)] a geometry call reads by index: the vertex
    stage's distinct vertices' positions, normals and uvs and its distinct
    triangles' three indices; the view setup's distinct corner rows of
    w1; a merged call's, its lists'."""
    if name != "geometry_vertex_stage" and name != "geometry_view_setup":
        return [r for n, a in geometry_parts(name, args) for r in geometry_rows(n, a, fetched)]
    rows = geometry_read_rows(name, args)
    if name == "geometry_view_setup":
        return [(args["stage"].w1, rows["corners"])]
    v, tri = rows["vertices"], rows["triangles"]
    corners = (tri[:, None] * 3 + torch.arange(3, device=tri.device)).reshape(-1)
    return [(args["positions"], v), (args["normals"], v), (args["uvs"], v),
            (args["indices"], corners.clamp(0, args["indices"].shape[0] - 1))]


# The root of a baseline tree of this repo whose geometry and worklist
# kernels [geometry] and [worklist] time beside this tree's at each site
# (chip_smoke.py --baseline DIR: say, a git archive of the commit before a
# redesign), or None; and its loaded ops modules by name
BASELINE = {"root": None, "modules": {}, "libraries": {}}


def baseline_module(name: str, source: Optional[str] = None):
    """The baseline tree's superconductor_tpu_torch/ops/{name}.py (name
    "geometry", "worklist", "shade" or "particles"), loaded as a module of
    this package (its relative imports resolve here), its library built
    once by nvcc from the tree's csrc/{source}.cu (source: `name`; the
    particles' is "shade") into build/baseline/ and bound in place of this
    tree's, with the argument types the tree's ops/raster.py _SIGNATURES
    gives: the geometry module's `_kernel(symbol)` (after checking each of
    its argument structs' sizes against the library's) or the other
    modules' `_kernel_fn(symbol)`."""
    import ast
    import ctypes
    import importlib.util

    from superconductor_tpu_torch.ops import raster as raster_mod

    if name in BASELINE["modules"]:
        return BASELINE["modules"][name]
    source = source or name
    src = os.path.join(BASELINE["root"], "superconductor_tpu_torch")
    t0 = time.perf_counter()
    if source not in BASELINE["libraries"]:
        lib = os.path.join(raster_mod.BUILD_DIR, "baseline", f"libsc_{source}.so")
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        subprocess.run([raster_mod._nvcc(), *raster_mod.NVCC_FLAGS, "-o", lib,
                        os.path.join(src, "csrc", f"{source}.cu")], check=True,
                       capture_output=True)
        BASELINE["libraries"][source] = ctypes.CDLL(lib)
    cdll = BASELINE["libraries"][source]
    spec = importlib.util.spec_from_file_location(
        f"superconductor_tpu_torch.ops._baseline_{name}", os.path.join(src, "ops", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(src, "ops", "raster.py")) as f:
        tree = ast.parse(f.read())
    table = next(node.value for node in tree.body if isinstance(node, ast.Assign)
                 and any(getattr(t, "id", None) == "_SIGNATURES" for t in node.targets))
    types = {"_P": ctypes.c_void_p, "_I": ctypes.c_int, "_L": ctypes.c_longlong,
             "_F": ctypes.c_float, "ctypes": ctypes}
    signatures = eval(compile(ast.Expression(table), "_SIGNATURES", "eval"), types)

    def kernel_fn(symbol):
        fn = getattr(cdll, symbol)
        fn.restype, fn.argtypes = ctypes.c_int, signatures[symbol][1]
        return fn

    if name == "geometry":
        for which, mirror in enumerate(mod._MIRRORS):
            size = kernel_fn("sc_geometry_args_bytes")(which)
            if size != ctypes.sizeof(mirror):
                raise RuntimeError(f"the baseline's struct {which} takes {size} B, its mirror "
                                   f"{ctypes.sizeof(mirror)} B")
        mod._kernel = kernel_fn
    else:
        mod._kernel_fn = kernel_fn
    BASELINE["modules"][name] = mod
    phase(name, f"baseline: {src}'s ops/{name}.py on its csrc/{source}.cu, built in "
          f"{time.perf_counter() - t0:.1f} s")
    return mod


def geometry_detail(name: str, args: dict) -> str:
    """At a merged geometry call: each list alone through its per-list
    wrapper (device ms, bench_raster.graph_ms), and the merged call's
    device ms by kernel (the vertex stage's two phases) from a profile of
    20 eager calls."""
    from torch.profiler import ProfilerActivity, profile

    from superconductor_tpu_torch.bench_raster import graph_ms
    from superconductor_tpu_torch.ops import geometry as geometry_mod
    from superconductor_tpu_torch.profile_frame import hand_kernel_label

    alone = [graph_ms(lambda n=n, a=a: getattr(geometry_mod, n)(**a))
             for n, a in geometry_parts(name, args)]
    call = getattr(geometry_mod, name)
    call(**args)
    torch.cuda.synchronize()
    runs = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            call(**args)
        torch.cuda.synchronize()
    by_kernel = collections.Counter()
    for e in prof.events():
        m = re.search(r"(vertex_stage_kernel<\d+>|view_setup_kernel)", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and m \
                and hand_kernel_label(e.name) in ("vertex_stage_kernel", "view_setup_kernel"):
            by_kernel[m.group(1)] += e.device_time / runs / 1e3
    kernels = ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_kernel.items()))
    return (f"each list alone (per-list wrapper) {' / '.join(f'{ms:.4f}' for ms in alone)} ms; "
            f"device ms a merged call by kernel (profile of {runs} calls): {kernels}")


def geometry_baseline(name: str, args: dict):
    """The baseline tree's kernels at a merged geometry call, as its frame
    called them there: each list's per-list wrapper into its rows of the
    call's `out`, and for the setup the torch add of the two counts; None
    without a baseline."""
    if BASELINE["root"] is None:
        return None
    mod = baseline_module("geometry")
    parts = geometry_parts(name, args)
    wrapper = {"geometry_vertex_stage": mod.geometry_vertex_stage,
               "geometry_view_setup": mod.geometry_view_setup}

    def call():
        results = [wrapper[n](**a) for n, a in parts]
        if name == "geometry_view_setup_merged" and len(results) > 1:
            return results[0].num_valid + results[1].num_valid
        return results

    return call


def geometry_equal(out, want, args: dict) -> tuple:
    """(equal bit for bit, values compared, values that differ) of two
    VertexStages (their packed attributes and views included) or two
    TriangleSetups: every tensor, f32 ones by their int32 views."""

    def leaves(x):
        if isinstance(x, torch.Tensor) or x is None:
            return [x]
        return [leaf for v in x for leaf in leaves(v)]

    total = bad = 0
    for a, b in zip(leaves(out), leaves(want)):
        if a is None or b is None:
            if (a is None) != (b is None):
                return False, total, bad + 1
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, b.numel(), b.numel()
        if b.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        total, bad = total + b.numel(), bad + int((a != b).sum())
    return bad == 0, total, bad


GEOMETRY_PHASE = HandPhase("geometry", GEOMETRY, geometry_lanes, geometry_site, geometry_equal,
                           geometry_bound, geometry_rows, ("geometry",),
                           call_launches=geometry_calls, baseline=geometry_baseline,
                           detail=geometry_detail)


CLIP_PLANES = ("found", "pair", "depth")  # what a clip round writes in place


def worklist_lanes(name: str, args: dict) -> int:
    """The mask's pixels a compaction reads, or the lanes a compose writes
    (0: no slot, nothing launched)."""
    if name == "worklist_compact":
        return args["mask"].shape[0]
    return args["idx"].shape[0] * args["gr"]


def worklist_site(name: str, caller: str, args: dict) -> str:
    """A worklist call's site and shape: the granule size, the slots and
    the granules; a compose's destination and its lane mask; a clip round's
    planes. The wrapper's caller is always render/frame.py's
    _compact_worklist or compose, so the shapes tell the sites apart."""
    gr = args["gr"]
    if name == "worklist_compact":
        from superconductor_tpu_torch.ops.worklist import compact_blocks

        n_g = args["mask"].shape[0] // gr
        return (f"compact {gr}-px granules, {min(args['cap_g'], n_g)} slots of {n_g} "
                f"({compact_blocks(n_g)} blocks)")
    if name == "worklist_compose_clip":
        return (f"compose clip round (found i32, pair i32, depth f32) into "
                f"{args['found'].shape[0]} px, {gr}-px granules, {args['idx'].shape[0]} slots")
    dst = args["dst"]
    kind = str(dst.dtype).replace("torch.", "") + ("" if dst.dim() == 1 else f"x{dst.shape[1]}")
    where = ", lane mask" if args["where"] is not None else ""
    return (f"compose {kind} into {dst.shape[0]} px, {gr}-px granules, "
            f"{args['idx'].shape[0]} slots{where}")


def clip_lane_masks(args: dict) -> tuple:
    """(live, needs the test, ok) over a clip round's lanes, from its
    recorded inputs (found as it was before the call): live lanes, those
    whose pixel has no find yet (their valid is read), and those that find
    their fragment (their pair and depth are written)."""
    found, idx, gr = args["found"], args["idx"], args["gr"]
    n_g = found.shape[0] // gr
    live = (idx < n_g)[:, None].expand(-1, gr).reshape(-1)
    off = torch.arange(gr, device=idx.device)
    pix = (torch.clamp_max(idx, n_g - 1).long()[:, None] * gr + off).reshape(-1)
    test = live & (found[pix] == 0)
    ok = test & args["valid"] & (args["alpha"] >= args["cutoff"])
    return live, test, ok


def worklist_bytes(name: str, args: dict) -> int:
    """The bytes a worklist call must move, each input read once and each
    output written once, as this call's data needs them: a compaction reads
    the mask (npx B) and writes idx, safe (4 B a slot), live (1 B) and need
    (4 B); a compose reads idx (4 B a slot) and, at the live slots' lanes
    (with a lane mask, those whose mask is true), reads its row and writes
    it into dst (4 B a word each way), and reads the lane mask at the live
    slots' lanes (1 B a lane); a clip round reads idx, reads and writes
    found at the live lanes (4 B each way), reads valid where the pixel has
    no find yet (1 B), alpha and cutoff where that lane is valid too (8 B),
    and where it finds its fragment reads its pair row and the layer's depth
    and writes both (16 B)."""
    gr = args["gr"]
    if name == "worklist_compact":
        n_g = args["mask"].shape[0] // gr
        return args["mask"].shape[0] + min(args["cap_g"], n_g) * 9 + 4
    if name == "worklist_compose_clip":
        live, test, ok = clip_lane_masks(args)
        tested = int((test & args["valid"]).sum())
        return (args["idx"].shape[0] * 4 + int(live.sum()) * 8 + int(test.sum()) + tested * 8
                + int(ok.sum()) * 16)
    dst, idx, where = args["dst"], args["idx"], args["where"]
    words = 1 if dst.dim() == 1 else dst.shape[1]
    live = (idx < dst.shape[0] // gr)[:, None].expand(-1, gr).reshape(-1)
    lanes = int((live & where).sum()) if where is not None else int(live.sum())
    mask_bytes = int(live.sum()) if where is not None else 0
    return idx.shape[0] * 4 + lanes * words * 8 + mask_bytes


def worklist_bound(name: str, args: dict, fetched: list) -> tuple:
    """(bound_ms, "bytes") of a worklist call: worklist_bytes over 3.35
    TB/s (H100 SXM); neither kernel computes beyond integer indexing."""
    return worklist_bytes(name, args) / 3.35e9, "bytes"


def worklist_fresh(args: dict) -> dict:
    """A compose's arguments with their own copy of dst, or a clip round's
    with their own copies of its planes, to write into."""
    return dict(args, **{k: args[k].clone() for k in ("dst",) + CLIP_PLANES if k in args})


def worklist_keep(name: str, args: dict) -> dict:
    """What record_calls keeps of a worklist call: a compose's dst and a
    clip round's planes copied before the call writes into them."""
    return worklist_fresh(args)


def worklist_equal(out, want, args: dict) -> tuple:
    """geometry_equal of the results (idx, safe, live, need; the composed
    dst; a clip round's three planes), and a compose's result the storage
    of what it writes."""
    written = [args[k] for k in ("dst",) + CLIP_PLANES if k in args]
    got = list(out) if isinstance(out, tuple) and written else [out]
    if written and [t.data_ptr() for t in got] != [t.data_ptr() for t in written]:
        return False, 1, 1
    return geometry_equal(out, want, args)


def worklist_yardstick(name: str, args: dict) -> tuple:
    """(label, call, whether that one PyTorch call computes the same
    function) of the library yardstick at a worklist call: a compaction's
    torch.sort of its int32 keys alone (where(granule set, index, n_g),
    made here); a compose's index_copy_ of its rows into a preallocated
    (n_g + 1)-row buffer (the sentinel row last); a clip round's
    index_copy_ of its found rows alone the same way (one of its three
    planes, and no test: no one call computes the round)."""
    gr = args["gr"]
    if name == "worklist_compact":
        mask = args["mask"]
        n_g = mask.shape[0] // gr
        gmask = mask.reshape(-1, gr).any(dim=1)
        keys = torch.where(gmask, torch.arange(n_g, dtype=torch.int32, device=mask.device),
                           torch.full((), n_g, dtype=torch.int32, device=mask.device))
        return f"torch.sort of its {n_g} int32 keys", lambda: torch.sort(keys), True
    clip = name == "worklist_compose_clip"
    dst, idx = args["found" if clip else "dst"], args["idx"]
    width = gr * (1 if dst.dim() == 1 else dst.shape[1])
    n_g = dst.shape[0] // gr
    buf = torch.empty((n_g + 1, width), dtype=dst.dtype, device=dst.device)
    rows = (torch.ones_like(args["rows"]) if clip else args["rows"]).reshape(-1, width)
    index = idx.long()
    what = "found rows (not the same function)" if clip else "rows"
    return (f"index_copy_ of its {idx.shape[0]} {what} into an ({n_g} + 1)-row buffer",
            lambda: buf.index_copy_(0, index, rows), not clip)


def separate_clip_composes(args: dict, worklist_compose=None):
    """A clip round as separate operations on the card: the takes of found
    and of the layer's depth, the masks, and three launches of
    `worklist_compose` (None: this tree's; found, then pair and depth with
    the lane mask), into the planes of `args` in place, as the kernel
    writes them."""
    if worklist_compose is None:
        from superconductor_tpu_torch.ops.worklist import worklist_compose

    a = args
    gr, idx = a["gr"], a["idx"]
    safe = torch.clamp_max(idx, a["found"].shape[0] // gr - 1)
    cur = a["found"].reshape(-1, gr)[safe].reshape(-1) != 0
    ok = a["valid"] & (a["alpha"] >= a["cutoff"]) & ~cur
    worklist_compose(a["found"], idx, (cur | ok).to(torch.int32), gr)
    worklist_compose(a["pair"], idx, a["rows"], gr, ok)
    worklist_compose(a["depth"], idx, a["layer_depth"].reshape(-1, gr)[safe].reshape(-1), gr, ok)


def worklist_detail(name: str, args: dict) -> str:
    """Further timings at a worklist site (bench_raster.graph_ms): a
    compaction's grid at GRID_BLOCKS blocks, at the rule's
    (compact_blocks) and at twice the rule's (the entry point holds a grid
    to what the card runs at once); a clip round as separate operations
    (two takes, the masks, three compose launches); None for a compose of
    rows."""
    from superconductor_tpu_torch.bench_raster import graph_ms
    from superconductor_tpu_torch.ops import worklist as worklist_mod

    if name == "worklist_compose_clip":
        return (f"the round as separate operations (2 takes, the masks, 3 compose launches) "
                f"{graph_ms(lambda: separate_clip_composes(args)):.4f} ms")
    if name != "worklist_compact":
        return None
    mask, gr, cap_g = args["mask"], args["gr"], args["cap_g"]
    rule = worklist_mod.compact_blocks(mask.shape[0] // gr)
    return "; ".join(
        f"{blocks} blocks{' (the rule)' if blocks == rule else ''}: "
        f"{graph_ms(lambda: worklist_mod.worklist_compact(mask, gr, cap_g, blocks)):.4f} ms"
        for blocks in sorted({worklist_mod.GRID_BLOCKS, rule, 2 * rule}))


def worklist_baseline(name: str, args: dict):
    """The baseline tree's worklist kernels at a worklist call, as its
    frame called them there: its compaction, its compose, or the clip
    round as separate takes, masks and three of its composes; None without
    a baseline."""
    if BASELINE["root"] is None:
        return None
    mod = baseline_module("worklist")
    if name == "worklist_compact":
        return lambda: mod.worklist_compact(args["mask"], args["gr"], args["cap_g"])
    if name == "worklist_compose_clip":
        return lambda: separate_clip_composes(args, mod.worklist_compose)
    return lambda: mod.worklist_compose(**args)


WORKLIST_PHASE = HandPhase("worklist", WORKLIST, worklist_lanes, worklist_site, worklist_equal,
                           worklist_bound, lambda name, args, fetched: [], ("worklist",),
                           baseline=worklist_baseline, detail=worklist_detail,
                           keep=worklist_keep, fresh=worklist_fresh,
                           yardstick=worklist_yardstick)


def worklist_path(smi: str, frames: dict, log: str) -> dict:
    """Phase [worklist] (csrc/worklist.cu): the worklist kernels' registers,
    stack and spills (ptxas, `log`: the build's -Xptxas -v output);
    hand_path for the compaction, the compose and the clip round of the
    headline, all-passes, stereo and lit frames (each site's detail: the
    compaction's grid at other sizes, the separate operations beside a
    clip round; with --baseline, the baseline tree's kernels there); each
    frame's launches of both kernels, read from their counters set to 0
    just before one more eager frame and read just after, which must be
    one a compaction and one a compose or clip round (and one clip round a
    k-buffer layer a view's band); then every call of two more eager
    frames held against its plain version and timed the same way: the
    headline at gr = 1 (worklist_granules off: the opaque worklist
    compacts 2,073,600 pixel flags) and the all-passes frame with every
    worklist cap halved (each compaction overflows, need above its cap).
    Returns hand_path's result."""
    from superconductor_tpu_torch.render.frame import render_frame_impl, stats_to_host

    for fn, (regs, stack, spill_st, spill_ld) in ptxas_resources(log).items():
        phase("worklist", f"{fn}: {regs} registers a thread, {stack} B stack, spill stores "
              f"{spill_st} B, spill loads {spill_ld} B")
    result = hand_path(WORKLIST_PHASE, smi, frames)
    counters = {k: ws for k, ws in kernel_counters().items() if k in WORKLIST}
    for scene, (tables, build, config, env) in frames.items():
        calls = result["frame_calls"][scene]
        rounds = (config.resolve_clip_layers() * config.num_views * config.row_chunks
                  if config.enable_clip else 0)
        state = build(0.0)
        for ws in counters.values():
            for w in ws:
                w.LAUNCHES = 0
        render_frame_impl(tables, state, config, env)
        torch.cuda.synchronize()
        counts = {k: sum(w.LAUNCHES for w in ws) for k, ws in counters.items()}
        phase("worklist", f"{scene}: launches of one eager frame by the counters: compaction "
              f"{counts['worklist_compact']} ({calls['worklist_compact']} calls), compose "
              f"{counts['worklist_compose']} ({calls['worklist_compose']} of rows, "
              f"{calls['worklist_compose_clip']} clip rounds)")
        if (counts["worklist_compact"] != calls["worklist_compact"]
                or counts["worklist_compose"] != calls["worklist_compose"]
                + calls["worklist_compose_clip"] or calls["worklist_compose_clip"] != rounds):
            raise RuntimeError(f"the {scene} frame's worklist launches {counts}, calls "
                               f"{dict(calls)}: expected one a call and {rounds} clip rounds")

    def halved(caps):
        return None if caps is None else tuple(max(1, int(c) // 2) for c in caps)

    tables, build, config, env = frames["headline"]
    ap_tables, ap_build, ap_config, ap_env = frames["all_passes"]
    npx = WIDTH * HEIGHT
    for scene, (tabs, bld, cfg, ev) in (
            ("headline gr=1", (tables, build, replace(config, worklist_granules=False), env)),
            ("all_passes caps halved", (ap_tables, ap_build, replace(
                ap_config, opaque_px_cap=max(1, (ap_config.opaque_px_cap or npx) // 2),
                sky_px_cap=max(1, (ap_config.sky_px_cap or npx) // 2),
                shade_px_cap=max(1, ap_config.shade_px_cap // 2),
                shade_px_caps=halved(ap_config.shade_px_caps),
                clip_px_caps=halved(ap_config.clip_px_caps)), ap_env))):
        with record_calls(WORKLIST, worklist_keep) as calls:
            _img, stats = render_frame_impl(tabs, bld(0.0), cfg, ev, with_stats=True)
        over = [name for name, _, args in calls if name == "worklist_compact"
                and args["mask"].reshape(-1, args["gr"]).any(dim=1).sum()
                > min(args["cap_g"], args["mask"].shape[0] // args["gr"])]
        phase("worklist", f"{scene}: {len(calls)} calls in an eager frame, "
              f"{len(over)} compactions over their cap; stats {stats_to_host(stats)}")
        if scene.endswith("halved") and not over:
            raise RuntimeError("no compaction of the halved-caps frame overflowed")
        if scene.endswith("gr=1") and not any(name == "worklist_compact" and args["gr"] == 1
                                              for name, _, args in calls):
            raise RuntimeError("the gr=1 frame compacted no pixel worklist")
        compare_calls(WORKLIST_PHASE, scene, calls, results={})
        del calls
        phase("worklist", f"{scene}: every call equals its plain version bit for bit")
    return result


# --- [particles]: csrc/shade.cu shade_kernel(ParticleShadeArgs) and
# csrc/geometry.cu view_setup_kernel(ParticleQuadArgs) -------------------------

# The particle shade's FP32 operations a lane before the display transform,
# counted from the kernel as SHADE_OPS_* are (each product, sum, quotient,
# clamp, square root, reciprocal square root and powf one, an FMA one): the
# row's barycentrics, uv and position 48, the normal 19, the SH's direction
# and lengths 38, the frame and the light 58, the colour 27; the smoke maps
# 10 (the puff) or 120 (two taps' four channels: 8 for the position, 13 a
# channel's lerp and 1 its scale), the LUT 77 (its tap, the sRGB decode)
PARTICLE_OPS = {"puff": 199, "smoke pool": 386, "per-slot": 386}
# a particle's billboards: its centre and four corners through three
# matrices, their uvs, two triangles' setup (GEOMETRY_OPS_SETUP)
PARTICLE_QUAD_OPS = 28 + 4 * (5 + 2 * 28 + 4) + 2 * GEOMETRY_OPS_SETUP
# An instruction floor a lane, from the kernels' source: each FP32
# operation (SHADE_OPS_*, PARTICLE_OPS, SH_INSTRUCTIONS: a powf, an IEEE
# division or a square root one, though each runs several), each f16
# widening and each load and store instruction (a 16-B load one) counted
# once; integer, conversion, predicate and branch instructions not counted.
# Over the instructions the card starts a second: 132 SMs x 4 schedulers x
# 32 lanes at the top SM clock, 1,980 MHz (H100 SXM; half its 67 TFLOP/s
# FP32 rate, which counts an FMA as two operations)
INSTRUCTIONS_PER_S = 132 * 128 * 1.98e9
# csrc/sh_sample.cuh sample_sh at a lane, by the texture set it taps: the
# light volume's FP32 operations 343 (the rescale 6, the texel and its
# fractions 10, the layer pair 5, two taps' _lerp4 of 12 channels 268, the
# z lerp 36, the unpack 18), 96 f16 widenings and 18 loads (the probe box
# 6, two 96-B rows 12); the lightmaps' 162 (10, one tap 134, the unpack
# 18), 48 widenings and 6 loads
SH_INSTRUCTIONS = {"volume": 343 + 96 + 18, "lightmaps": 162 + 48 + 6}
# the particle shade's loads and stores: a lane's pair, pixel centre, rgb
# and alpha (7); a key's packed row (8), eye and inverse view (9), and the
# smoke pool's and LUT's taps (12) or the per-slot taps' descriptor rows and
# texels (33); a given SH's 12 a lane
PARTICLE_LANE_IO = 7
PARTICLE_KEY_LOADS = {"puff": 17, "smoke pool": 29, "per-slot": 50}
# bytes a particle's columns hold (center 12, scale 8, valid 1, uv_offset
# and uv_scale 16, colour and emissive colour 24, LUT flag and lut_y 8) and
# its two triangles' results (setup 64, bbox 16, valid 1, tri_id and
# particle 8, corner uvs 24 and world positions 36, packed row 128)
PARTICLE_IN_BYTES, PARTICLE_OUT_BYTES = 69, 2 * 277


def particle_smoke(args: dict) -> str:
    """The smoke branch shade_particles takes for the call."""
    env, scene = args["env"], args["scene"]
    if env.smoke_tex_ids is None:
        return "puff"
    if env.smoke_static is not None and "smoke_ab" in scene:
        return "smoke pool"
    return "per-slot"


def particle_lanes(name: str, args: dict) -> int:
    if name == "particle_geometry":
        return args["particles"]["center"].shape[0]
    return args["pair"].shape[0]


def particle_sh_form(args: dict) -> str:
    """How a shade_particles call takes its SH (ops/particles.py sh_form):
    "ambient", "pools" (sampled in the launch) or "sampled" (two launches
    around the sampler)."""
    from superconductor_tpu_torch.ops.particles import sh_form

    return sh_form(args["env"], args["sh_sampler"])


PARTICLE_SH_LABELS = {"ambient": "ambient SH", "pools": "SH pools in the launch",
                      "sampled": "sampled SH, 2 launches"}


def particle_site(name: str, caller: str, args: dict) -> str:
    """A particle call's site and shape: the billboards' particles and
    target, or a layer's lanes, smoke branch, SH and inline flags."""
    if name == "particle_geometry":
        return (f"particle_geometry {caller} {particle_lanes(name, args)} particles at "
                f"{args['width']}x{args['height']}")
    sh = PARTICLE_SH_LABELS[particle_sh_form(args)]
    return (f"shade_particles {caller} {particle_lanes(name, args)} lanes "
            f"({particle_smoke(args)}; {sh}; tonemap {int(bool(args['inline_tonemapping']))} "
            f"srgb {int(bool(args['inline_srgb']))})")


def particle_launches(name: str, args: dict) -> int:
    return 2 if name == "shade_particles" and particle_sh_form(args) == "sampled" else 1


def _leaves(x) -> list:
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [x]


def particle_equal(out, want, args: dict) -> tuple:
    """deferred_equal over every tensor of the results (the billboards'
    TriangleSetup and ParticleAttrs, or rgb and alpha)."""
    return deferred_equal(tuple(_leaves(out)), tuple(_leaves(want)), args)


_particle_world_pos: dict = {}  # id(args) -> (args, the lanes' world positions)


def particle_world_pos(args: dict) -> torch.Tensor:
    """The lanes' interpolated world positions, where a layer's SH is
    sampled, as shade_particles_plain hands them to its sh_sampler; found
    once a call."""
    from superconductor_tpu_torch.ops.particles import shade_particles_plain

    if id(args) not in _particle_world_pos:
        seen, sampler = [], args["sh_sampler"]
        shade_particles_plain(**dict(args, sh_sampler=lambda wp: (seen.append(wp),
                                                                   sampler(wp))[1]))
        _particle_world_pos[id(args)] = (args, seen[0])
    return _particle_world_pos[id(args)][1]


def pool_sectors(rows: list) -> int:
    """The 32-B sectors that hold the 96-B SH pool rows [(pool, row
    indices)] (sh_pool_rows)."""
    addr = [t.data_ptr() + idx * (t.stride(0) * t.element_size()) for t, idx in rows
            if idx.numel()]
    return sector_count(torch.cat(addr), 96) if addr else 0


def distinct_keys(args: dict) -> int:
    """The distinct (pair, pixel centre bits) of a layer's lanes: the lanes
    whose results the kernel must compute."""
    keys = torch.stack([args["pair"].to(torch.int32), args["px"].view(torch.int32),
                        args["py"].view(torch.int32)], dim=1)
    return int(torch.unique(keys, dim=0).shape[0])


def particle_bound_parts(name: str, args: dict) -> dict:
    """A call's work, as this run's inputs need it: "bytes" it must move
    and, for a layer's shade, "instructions" (the floor of
    INSTRUCTIONS_PER_S's note), "keys" and "per_key" (the instructions of a
    distinct key's result, the lanes' loads and stores beside them), or for
    the billboards "ops" (FP32 operations). Billboards: each particle's
    columns read and its two triangles' results written, the three matrices
    read, num_valid written; PARTICLE_QUAD_OPS a particle. A layer's shade:
    each lane's pair and pixel centre read and its rgb and alpha written
    (28 B); each distinct packed row the lanes read (128 B), the eye and
    the inverse view; a given SH's 48 B a lane, or the 32-B sectors of the
    SH pools' rows the lanes tap and the probe box (24 B). The smoke
    texels the lanes tap are left out (a floor)."""
    if name == "particle_geometry":
        n = particle_lanes(name, args)
        return {"bytes": n * (PARTICLE_IN_BYTES + PARTICLE_OUT_BYTES) + 3 * 64 + 4,
                "ops": n * PARTICLE_QUAD_OPS}
    lanes, form, smoke = particle_lanes(name, args), particle_sh_form(args), particle_smoke(args)
    rows = int(torch.unique(torch.clamp_min(args["pair"], 0)).numel())
    nbytes = lanes * 28 + rows * 128 + 12 + 64
    per_key = PARTICLE_OPS[smoke] + PARTICLE_KEY_LOADS[smoke] + (
        SHADE_OPS_ACES if args["inline_tonemapping"] else 0) + (
        SHADE_OPS_SRGB if args["inline_srgb"] else 0)
    if form == "sampled":
        nbytes += lanes * 48
        per_key += 12
    elif form == "pools":
        pool = args["sh_sampler"]
        nbytes += pool_sectors(sh_pool_rows(pool, particle_world_pos(args))) * 32 + 24
        # the stand-in is not lightmapped: the volume where one is bound
        per_key += SH_INSTRUCTIONS["volume" if pool._sets()[0] is not None else "lightmaps"]
    # a given SH is an input of its own: each lane computed
    keys = lanes if form == "sampled" else distinct_keys(args)
    return {"bytes": nbytes, "instructions": keys * per_key + lanes * PARTICLE_LANE_IO,
            "keys": keys, "per_key": per_key}


def particle_bound(name: str, args: dict, fetched: list) -> tuple:
    """(bound_ms, bound_by) of one call (particle_bound_parts): the larger
    of its bytes over 3.35 TB/s and, for the billboards, its FP32
    operations over 67 TFLOP/s (H100 SXM), for a layer's shade its
    instruction floor over INSTRUCTIONS_PER_S ("operations")."""
    parts = particle_bound_parts(name, args)
    bytes_ms = parts["bytes"] / 3.35e9
    ops_ms = (parts["ops"] / 67e9 if name == "particle_geometry"
              else parts["instructions"] / INSTRUCTIONS_PER_S * 1e3)
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def particle_rows(name: str, args: dict, fetched: list) -> list:
    """[(table, row indices)] a call reads: a layer's packed rows at its
    pairs clamped to 0, or each particle's row of every particle column."""
    if name == "shade_particles":
        return [(args["attrs"].packed, torch.clamp_min(args["pair"], 0).long())]
    cols = args["particles"]
    idx = torch.arange(particle_lanes(name, args), device=cols["center"].device)
    return [(t.reshape(t.shape[0], -1), idx) for t in cols.values()]


def particle_detail(name: str, args: dict):
    """At a layer's shade: its bytes and instruction bounds apart
    (particle_bound_parts); with the SH pools, the two-launch form with the
    frame's torch sampler in the sampler's place (a closure over the
    PoolSH, which the wrapper cannot read in place) and that sampler alone
    on the lanes' positions; with sampled SH, its two launches alone (the
    SH the sampler gave handed back by a stand-in) and the sampler alone
    (bench_raster.graph_ms); None at the billboards."""
    if name != "shade_particles":
        return None
    from superconductor_tpu_torch.bench_raster import graph_ms
    from superconductor_tpu_torch.ops import particles as particles_mod

    parts = particle_bound_parts(name, args)
    line = (f"bounds: bytes {parts['bytes'] / 3.35e9:.4f} ms ({parts['bytes']} B), "
            f"instructions {parts['instructions'] / INSTRUCTIONS_PER_S * 1e3:.4f} ms "
            f"({parts['keys']} distinct keys x {parts['per_key']} + "
            f"{particle_lanes(name, args)} lanes x {PARTICLE_LANE_IO})")
    form = particle_sh_form(args)
    if form == "pools":
        pool = args["sh_sampler"]
        world_pos = particle_world_pos(args)
        closure = dict(args, sh_sampler=lambda wp: pool(wp))
        two_ms = graph_ms(lambda: particles_mod.shade_particles(**closure), launches=5,
                          runs=10)
        sampler_ms = graph_ms(lambda: pool(world_pos), launches=5, runs=10)
        line += (f"; the two-launch form with the torch sampler {two_ms:.4f} ms, that sampler "
                 f"alone {sampler_ms:.4f} ms")
    elif form == "sampled":
        seen = {}

        def sample(world_pos):
            seen["world_pos"], seen["sh"] = world_pos, args["sh_sampler"](world_pos)
            return seen["sh"]

        particles_mod.shade_particles(**dict(args, sh_sampler=sample))
        given = dict(args, sh_sampler=lambda world_pos: seen["sh"])
        kernel_ms = graph_ms(lambda: particles_mod.shade_particles(**given))
        sampler_ms = graph_ms(lambda: args["sh_sampler"](seen["world_pos"]), launches=5,
                              runs=10)
        line += (f"; its two launches alone (the SH given) {kernel_ms:.4f} ms, the frame's SH "
                 f"sampler alone {sampler_ms:.4f} ms")
    return line


def particle_baseline(name: str, args: dict):
    """The baseline tree's particle shade at a layer, its ops/particles.py
    on its csrc/shade.cu, as its frame called it there (a PoolSH is a
    callable sampler to it); None at the billboards or without a
    baseline."""
    if BASELINE["root"] is None or name != "shade_particles":
        return None
    mod = baseline_module("particles", "shade")
    return lambda: mod.shade_particles(**args)


PARTICLES_PHASE = HandPhase("particles", PARTICLES, particle_lanes, particle_site,
                            particle_equal, particle_bound, particle_rows, ("particles",),
                            call_launches=particle_launches, baseline=particle_baseline,
                            detail=particle_detail)


def covered_layers(calls: list, smi: str) -> None:
    """The deep_k frame's layers by their covered lanes (pair >= 0; the
    lanes past the worklist's count are dead and repeat one granule): for
    each count, its first layer held bit for bit against its plain version
    and timed as the frame calls it and, with --baseline, the baseline
    tree's kernel (bench_raster.graph_ms)."""
    from superconductor_tpu_torch.bench_raster import graph_ms
    from superconductor_tpu_torch.ops import particles as particles_mod

    by_covered = collections.defaultdict(list)
    for name, _, args in calls:
        by_covered[int((args["pair"] >= 0).sum())].append(args)
    for covered, layers in sorted(by_covered.items()):
        args = layers[0]
        out = particles_mod.shade_particles(**args)
        want = particles_mod.shade_particles_plain(**args)
        equal, total, bad = particle_equal(out, want, args)
        if not equal:
            raise RuntimeError(f"deep_k layer with {covered} covered lanes: {bad} of {total} "
                               f"values differ from the plain version")
        ms = graph_ms(lambda: particles_mod.shade_particles(**args))
        base = particle_baseline("shade_particles", args)
        phase("particles", f"deep_k layer with {covered} of {args['pair'].shape[0]} lanes "
              f"covered ({len(layers)} layers): kernel {ms:.4f} ms, the baseline tree's kernel "
              + ("not measured" if base is None else f"{graph_ms(base):.4f} ms")
              + f"; bit for bit; {smi}")


def particles_path(smi: str, frames: dict) -> dict:
    """Phase [particles] (the particle shade, csrc/shade.cu, and the
    billboards, csrc/geometry.cu): hand_path on the all-passes frame (4
    particle layers), the lit frame (the smoke pool, the light volume
    sampled from its SH pool in the launch) and the deep_k frame (64
    layers); each frame's launches of both kernels read from their
    counters, set to 0 just before one more eager frame and read just
    after: one billboard launch a view, and one shade launch a particle
    layer a view's band (two where a layer's SH is sampled between two
    launches, which none of these frames does), with the torch SH sampler
    (ops/shade.py sample_spherical_harmonics.CALLS) run in none of the
    frame's calls, and the deep_k frame's layers timed once a count of
    covered lanes (covered_layers); then a constructed call of the per-slot LDR branch (the
    lit frame's largest layer with the smoke pool taken out of its
    tables), held against its plain version and timed. Returns
    hand_path's result."""
    from superconductor_tpu_torch.ops.shade import sample_spherical_harmonics
    from superconductor_tpu_torch.render.frame import render_frame_impl

    result = hand_path(PARTICLES_PHASE, smi, frames)
    counters = {k: ws for k, ws in kernel_counters().items() if k in PARTICLES}
    for scene, (tables, build, config, env) in frames.items():
        state = build(0.0)
        for ws in counters.values():
            for w in ws:
                w.LAUNCHES = 0
        sampled = sample_spherical_harmonics.CALLS
        with record_calls(("particle_shade",)) as calls:
            render_frame_impl(tables, state, config, env)
        torch.cuda.synchronize()
        sampled = sample_spherical_harmonics.CALLS - sampled
        counts = {k: sum(w.LAUNCHES for w in ws) for k, ws in counters.items()}
        layers = len(config.layer_caps(config.resolve_particle_layers())) * config.num_views \
            * config.row_chunks
        forms = collections.Counter(particle_sh_form(args) for _, _, args in calls)
        phase("particles", f"{scene}: launches of one eager frame by the counters: shade "
              f"{counts['particle_shade']} ({layers} layers, SH {dict(forms)}: one launch a "
              f"layer), billboards {counts['particle_geometry']} ({config.num_views} "
              f"view(s)); the torch SH sampler ran {sampled} times in the frame; {smi}")
        if counts["particle_shade"] != layers or forms["sampled"] or sampled \
                or counts["particle_geometry"] != config.num_views:
            raise RuntimeError(f"the {scene} frame's particle launches {counts}, SH forms "
                               f"{dict(forms)}, torch SH sampler calls {sampled}: expected "
                               f"{layers} and {config.num_views}, none sampled")
        if scene == "lit_passes" and forms["pools"] != layers:
            raise RuntimeError(f"the lit frame's layers took the SH as {dict(forms)}")
        if scene == "deep_k":
            covered_layers(calls, smi)

    tables, build, config, env = frames["lit_passes"]
    with record_calls(("particle_shade",)) as calls:
        render_frame_impl(tables, build(0.0), config, env)
    name, caller, args = max(calls, key=lambda c: particle_lanes(c[0], c[2]))
    slots = {k: v for k, v in tables.items() if k not in ("smoke_ab", "smoke_lut")}
    constructed = dict(args, scene=slots)
    if particle_smoke(constructed) != "per-slot":
        raise RuntimeError("the constructed call does not take the per-slot branch")
    compare_calls(PARTICLES_PHASE, "lit_passes constructed", [(name, caller, constructed)],
                  results={})
    phase("particles", "lit_passes constructed: the per-slot call equals its plain version bit "
          "for bit")
    return result


SM_LANES = 128  # thread instructions an SM starts a clock: 4 schedulers of a warp each


def ptxas_resources(log: str) -> dict:
    """{entry function (mangled): (registers, stack bytes, spill store
    bytes, spill load bytes)} from an nvcc -Xptxas -v log."""
    out, name, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + frame
    return out


def sass_counts(library: str) -> dict:
    """{function (mangled): Counter of its static SASS instructions by
    opcode (the mnemonic before its first '.'), NOPs not counted} of a
    built kernel library (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return count_sass(subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                                     timeout=300, check=True).stdout)


def count_sass(text: str) -> dict:
    """sass_counts of cuobjdump -sass's output `text`."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name and m.group(1) != "NOP":
            out[name][m.group(1)] += 1
    return out


def sm_clock_mhz() -> float:
    """The card's top SM clock (MHz), as nvidia-smi gives it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def sky_variant(name: str, args: dict) -> tuple:
    """(csrc/sky.cu sky_kernel's template arguments, its mangled name's
    fragment) of a recorded sky call."""
    from superconductor_tpu_torch.ops import sky as sky_mod

    variant = sky_mod.kernel_variant(args["scene"], args["env"], name == "sample_skybox",
                                     args["inline_tonemapping"], args["inline_srgb"])
    return variant, "10sky_kernelI" + "".join(f"Li{v}E" for v in variant) + "EE"


def sky_kernel_stats(smi: str, log: str, sites: dict) -> None:
    """Phase [sky]: of the sky_kernel function each site launches
    (`sites`: compare_calls' results of the sky's sites, each with its
    first call): its registers, stack and spills (ptxas, `log`), its static
    SASS instructions (sass_counts; the most frequent opcodes after them)
    and the static-count estimate they give at the site: instructions x
    threads / (SMs x SM_LANES x the top SM clock), beside the kernel's time
    and its bytes bound. The static count holds every path of the function
    (vector and scalar loads, the 64-bit division, the slow paths of powf
    and the divisions), of which a thread runs some once and some not at
    all, and a thread computes ops/sky.py pixels_a_thread() pixels
    (lanes): the estimate is neither a floor nor a bound."""
    from superconductor_tpu_torch.ops import sky as sky_mod
    from superconductor_tpu_torch.ops.raster import KERNELS

    ptxas = ptxas_resources(log)
    sass = sass_counts(KERNELS["sky"][1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_mhz()
    per_thread = sky_mod.pixels_a_thread()
    for site, r in sites.items():
        name, args = r["call"]
        variant, fragment = sky_variant(name, args)
        fns = [fn for fn in sass if fragment in fn]
        if len(fns) != 1:
            raise RuntimeError(f"{site}: {len(fns)} functions of the sky library match "
                               f"{fragment}")
        fn = fns[0]
        if variant[0]:  # the band: a thread per_thread columns of a row
            threads = -(-args["width"] // per_thread) * args["height"]
        else:
            threads = -(-r["lanes"] // per_thread)
        n = sum(sass[fn].values())
        estimate_ms = n * threads / (sms * SM_LANES * clock * 1e6) * 1e3
        ops = ", ".join(f"{op} {k}" for op, k in sass[fn].most_common(10))
        phase("sky", f"{site}: sky_kernel<{', '.join(map(str, variant))}>: registers, stack, "
              f"spill stores, spill loads {ptxas.get(fn)}; {n} static SASS instructions a "
              f"thread of {per_thread} px ({ops}), {threads} threads: static-count estimate "
              f"{estimate_ms:.4f} ms ({sms} SMs x {SM_LANES} at {clock:.0f} MHz; not a bound); "
              f"kernel {r['ms']:.4f} ms, bytes bound {r['bound_ms']:.4f} ms; {smi}")


def launches_a_call(hp: HandPhase, name: str, args: dict) -> int:
    """The kernel launches one call of the phase's wrapper `name` makes."""
    return hp.call_launches(name, args) if hp.call_launches is not None else 1


def compare_calls(hp: HandPhase, scene: str, calls: list, results: dict) -> None:
    """Each recorded call's kernel against its plain version on the same
    inputs, bit for bit (f32 results by their int32 views); the first call
    of each site and shape timed (device ms of the kernel and of the plain
    version, bench_raster.graph_ms), with its bound and share and the
    phase's yardstick (one index_select of the rows the call reads, unless
    the phase names another; and, where the phase has a baseline, the
    baseline tree's kernels at the call), into results[site], and kept
    there as "call": (wrapper name, arguments). The kernel and the plain
    version each get their own copy of what the call writes (hp.fresh).
    Raises at the first call that differs."""
    from superconductor_tpu_torch.bench_raster import graph_ms

    bindings = kernel_bindings(hp.kernels)
    fresh = hp.fresh or fresh_out
    for name, caller, recorded in calls:
        kernel, mod, plain = bindings[name]
        wrapper = getattr(mod, name)
        site = f"{scene} {hp.site(name, caller, recorded)}"
        args = fresh(recorded)
        out = wrapper(**args)
        with recorded_fetches() as fetched:
            want = plain(**fresh(recorded))
        torch.cuda.synchronize()
        equal, total, bad = hp.equal(out, want, args)
        if not equal:
            raise RuntimeError(f"{site}: the kernel differs from its plain version at {bad} of "
                               f"{total} values")
        lanes = hp.lanes(name, args)
        if not lanes:
            continue  # nothing launched, nothing to time
        entry = results.setdefault(site, {"kernel": kernel, "calls": 0, "max_abs_err": 0.0,
                                          "lanes": lanes, "slots": len(args.get("slots", ())),
                                          "launches_a_call": launches_a_call(hp, name, args)})
        entry["calls"] += 1
        if "ms" in entry:
            continue
        entry["call"] = (name, args)
        entry["bound_ms"], entry["bound_by"] = hp.bound(name, args, fetched)
        kernel_call, plain_call = (lambda: wrapper(**args)), (lambda: plain(**args))
        if hp.timed is not None:
            kernel_call, plain_call = hp.timed(name, args)
        entry["ms"] = graph_ms(kernel_call)
        entry["plain_ms"] = graph_ms(plain_call, launches=5, runs=10)
        if hp.yardstick is not None:
            label, library_call, same_function = hp.yardstick(name, args)
            entry["yardstick_ms"] = graph_ms(library_call)
            entry["library_ms"] = entry["yardstick_ms"] if same_function else None
            yardstick = f"{label} {entry['yardstick_ms']:.4f} ms"
        else:
            rows = hp.rows(name, args, fetched)
            entry["index_select_ms"] = graph_ms(
                lambda: [torch.index_select(t, 0, idx) for t, idx in rows])
            entry["rows_read"] = sum(int(idx.numel()) for _, idx in rows)
            yardstick = (f"index_select of its {entry['rows_read']} rows "
                         f"{entry['index_select_ms']:.4f} ms")
        base = hp.baseline(name, args) if hp.baseline is not None else None
        entry["baseline_ms"] = graph_ms(base) if base is not None else None
        baseline = ("not measured" if base is None else
                    f"{entry['baseline_ms']:.4f} ms (kernel / baseline "
                    f"{entry['ms'] / entry['baseline_ms']:.3f})")
        phase(hp.label, f"{site}: kernel {entry['ms']:.4f} ms ({entry['launches_a_call']} "
              f"launches), plain {entry['plain_ms']:.4f} "
              f"ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}), share "
              f"{entry['bound_ms'] / entry['ms']:.3f}; {yardstick}"
              + (f"; the baseline tree's kernels at this site {baseline}"
                 if hp.baseline is not None else ""))
        detail = hp.detail(name, args) if hp.detail is not None else None
        if detail is not None:
            phase(hp.label, f"{site}: {detail}")


def hand_path(hp: HandPhase, smi: str, frames: dict) -> dict:
    """Phase [sampler] (the material samplers, csrc/sample.cu), [deferred]
    (the g-buffer and the sky, csrc/gbuffer.cu and csrc/sky.cu), [shade]
    (csrc/shade.cu), [geometry] (csrc/geometry.cu) or [worklist]
    (csrc/worklist.cu). For the headline,
    all-passes and stereo frames, and the lit frame for [shade] and
    [geometry] (`frames`: name -> (tables, build(pose),
    fitted config, env)): every call of the phase's
    wrappers in one eager frame (render_frame_impl) recorded, each held bit
    for bit against its plain version on its inputs, each site and shape
    timed with its bound and index_select yardstick (compare_calls); the
    graph frame (render_frame_stats) byte-equal, image and stats, to its
    twin with every plain version swapped in and to its twin with only the
    phase's kernels swapped; a replay's launch tally equal to the eager
    frame's calls. Then the main path (main_path_sites): every launch
    counter set to 0, GRAPH_TIMED graph frames of each scene, the counters
    read, and the run fails unless each kernel launched, the kernels'
    counts equal their sites' sum, and each site launched GRAPH_TIMED
    times its calls' launches in the eager frame. Returns {"sites":
    per-site results, "launches": the kernels' launches in that run,
    "site_launches": the launches at each site in that run, "per_frame":
    each scene's launches of each kernel in an eager frame, "frame_calls":
    each scene's calls (with lanes) of each wrapper there}."""
    from superconductor_tpu_torch.render import frame_graph
    from superconductor_tpu_torch.render.frame import render_frame_impl, render_frame_stats

    bindings = kernel_bindings(hp.kernels)
    counters = {k: ws for k, ws in kernel_counters().items() if k in hp.kernels}

    def counts():
        return {k: sum(w.LAUNCHES for w in ws) for k, ws in counters.items()}

    sites, per_frame, frame_calls = {}, {}, {}
    for scene, (tables, build, config, env) in frames.items():
        state = build(0.0)
        with record_calls(hp.kernels, hp.keep) as calls:
            render_frame_impl(tables, state, config, env)
        per_frame[scene] = {k: sum(launches_a_call(hp, name, args) for name, _, args in calls
                                   if bindings[name][0] == k and hp.lanes(name, args))
                            for k in hp.kernels}
        frame_calls[scene] = collections.Counter(name for name, _, args in calls
                                                 if hp.lanes(name, args))
        phase(hp.label, f"{scene}: {len(calls)} calls in an eager frame {per_frame[scene]}")
        compare_calls(hp, scene, calls, results=sites)
        del calls
        phase(hp.label, f"{scene}: every call equals its plain version bit for bit")

        img, stats = render_frame_stats(tables, state, config, env)
        for label, kernels in (("every plain version", None),
                               (f"the plain {hp.label} kernels", hp.kernels)):
            with plain_versions(kernels):
                twin, twin_stats = render_frame_stats(tables, state, config, env)
            if not (torch.equal(img, twin) and stats.keys() == twin_stats.keys()
                    and all(torch.equal(stats[k], twin_stats[k]) for k in stats)):
                raise RuntimeError(f"the {scene} graph frame differs from its twin with "
                                   f"{label}")
        key = frame_graph.frame_key(tables, state, config, env, True)[0]
        graph = frame_graph._runners[state.joint_palette.device].graphs[key]
        tally = {k: sum(graph.tally.get(w, 0) for w in ws) for k, ws in counters.items()}
        before = counts()
        render_frame_stats(tables, build(0.9), config, env)
        replay = {k: v - before[k] for k, v in counts().items()}
        phase(hp.label, f"{scene}: the graph frame equals its twins with every plain version "
              f"and with the plain {hp.label} kernels (image and stats); a replay's tally "
              f"{tally}, its launches {replay}")
        if tally != per_frame[scene] or replay != per_frame[scene]:
            raise RuntimeError(f"the {scene} replay's launches {replay} (tally {tally}) differ "
                               f"from the eager frame's calls {per_frame[scene]}")

    # the main path: the graph frames of every scene, each counter from 0,
    # every graph captured anew in the run, each launch also counted at its
    # site as the wrappers count theirs (ops/raster.py _launched)
    site_launches, captures = main_path_sites(hp, frames)
    launches = counts()
    phase(hp.label, f"main path: {GRAPH_TIMED} graph frames of {', '.join(frames)}: launches "
          f"{launches}; by site {dict(site_launches)}; {smi}")
    want = {site: GRAPH_TIMED * r["calls"] * r["launches_a_call"] for site, r in sites.items()}
    by_kernel = {k: sum(n for site, n in site_launches.items() if sites[site]["kernel"] == k)
                 for k in hp.kernels}
    if (launches != by_kernel or dict(site_launches) != want or not all(launches.values())
            or captures != len(frames)):
        raise RuntimeError(f"the main path launched {launches}, by site {dict(site_launches)} "
                           f"in {captures} captures; expected by site {want} in {len(frames)}")
    return {"sites": sites, "launches": launches, "site_launches": dict(site_launches),
            "per_frame": per_frame, "frame_calls": frame_calls}


def launch_site(hp: HandPhase, frame) -> str:
    """The site of a launch, from the frame that called _launched: the
    nearest frame up the stack that runs one of the phase's wrappers, and
    its caller."""
    wrappers = kernel_bindings(hp.kernels)
    while frame.f_code.co_name not in wrappers:
        frame = frame.f_back
    return hp.site(frame.f_code.co_name, frame.f_back.f_code.co_name, frame.f_locals)


def main_path_sites(hp: HandPhase, frames: dict) -> tuple:
    """Every launch counter set to 0 and every cached frame graph dropped,
    then GRAPH_TIMED graph frames of each scene of `frames` (as
    hand_path's), cycling over GRAPH_POSES -> (Counter of the launches of
    the phase's kernels by site, "scene site" as compare_calls names them;
    the number of graphs captured). A wrapper's launch also counts at its
    site (the phase's modules' _launched, ops/raster.py's, is wrapped):
    while a graph captures, into that graph's tally of sites, which each
    replay of the graph adds."""
    import importlib

    from superconductor_tpu_torch.render import frame_graph
    from superconductor_tpu_torch.render.frame import render_frame

    counters = kernel_counters()
    for wrappers in counters.values():
        for wrapper in wrappers:
            wrapper.LAUNCHES = 0
    ours = {w for k in hp.kernels for w in counters[k]}
    for runner in frame_graph._runners.values():
        runner.graphs.clear()
    modules = [importlib.import_module(f"superconductor_tpu_torch.ops.{m}") for m in hp.modules]
    real = modules[0]._launched
    site_launches, tallies, now = collections.Counter(), {}, {}

    def launched(wrapper):
        real(wrapper)
        if wrapper in ours:
            site = f"{now['scene']} " + launch_site(hp, sys._getframe(1))
            (now["tally"] if torch.cuda.is_current_stream_capturing()
             else site_launches)[site] += 1

    for mod in modules:
        mod._launched = launched
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
        for mod in modules:
            mod._launched = real
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

    counters = kernel_counters()

    def counts():
        return tuple(sum(w.LAUNCHES for w in ws) for ws in counters.values())

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

    total = dict.fromkeys(counters, 0)
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
        phase("graph", f"{name}: launches ({', '.join(counters)}) eager {eager}, a replay "
              f"{replay}; "
              f"a profiled replay: {seen} hand-kernel events of {device_ops} device events, "
              f"counters {profiled}")
        if replay != eager or profiled != eager or seen != sum(profiled):
            raise RuntimeError(f"the {name} replay's launch counts disagree with the eager "
                               f"frame's or with its profile")

        eager_ms = window_ms(lambda i: render_frame_impl(tables, states[i % 3], config, env))
        for ws in counters.values():
            for w in ws:
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
    Returns the launches of the timed run, by kernel and by pass, and the
    frame as (tables, build(angle), fitted config, env), as hand_path
    takes it."""
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

    def build(angle: float):
        return build_frame_state(scene, instances(angle), uniforms, device=dev, **draw_kw)

    return launches, by_pass, (scene_dev, build, config, env)


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
                 kbuffer_res: dict, shapes: dict, sampler: dict, deferred: dict,
                 shade: dict, geometry: dict, worklist: dict, particles: dict) -> dict:
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
    main-path run); then the g-buffer and the sky kernels the same way, at
    their largest call and at each site (the deferred phase's main-path
    run), the shade kernel (the shade phase's main-path run, which also
    renders the lit frame), and the vertex stage and view setup kernels the
    same way, at their largest call and at each site (the geometry phase's
    main-path run, with the lit frame), and the worklist compaction and
    compose kernels the same way (the worklist phase's main-path run, with
    the lit frame; their library_ms the yardstick's), and the particle
    shade and billboard kernels the same way (the particles phase's
    main-path run: the all-passes, lit and deep_k frames)."""

    def entry(name, kernel, n_launches, res, max_abs_err=None):
        source, replaces = KERNEL_SOURCES[kernel]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches,
            "max_abs_err": res["max_abs_err"] if max_abs_err is None else max_abs_err,
            "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res.get("library_ms"),
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
        *[entry(kernel, kernel, deferred["launches"][kernel] + graph_launches[kernel],
                max((r for r in deferred["sites"].values() if r["kernel"] == kernel),
                    key=lambda r: r["lanes"]))
          for kernel in DEFERRED],
        *[entry(f"{r['kernel']}[{site}]", r["kernel"], deferred["site_launches"][site], r)
          for site, r in deferred["sites"].items()],
        entry("shade", "shade", shade["launches"]["shade"] + graph_launches["shade"],
              max(shade["sites"].values(), key=lambda r: r["lanes"])),
        *[entry(f"shade[{site}]", "shade", shade["site_launches"][site], r)
          for site, r in shade["sites"].items()],
        *[entry(kernel, kernel, geometry["launches"][kernel] + graph_launches[kernel],
                max((r for r in geometry["sites"].values() if r["kernel"] == kernel),
                    key=lambda r: r["lanes"]))
          for kernel in GEOMETRY],
        *[entry(f"{r['kernel']}[{site}]", r["kernel"], geometry["site_launches"][site], r)
          for site, r in geometry["sites"].items()],
        *[entry(kernel, kernel, worklist["launches"][kernel] + graph_launches[kernel],
                max((r for r in worklist["sites"].values() if r["kernel"] == kernel),
                    key=lambda r: r["lanes"]))
          for kernel in WORKLIST],
        *[entry(f"{r['kernel']}[{site}]", r["kernel"], worklist["site_launches"][site], r)
          for site, r in worklist["sites"].items()],
        *[entry(kernel, kernel, particles["launches"][kernel] + graph_launches[kernel],
                max((r for r in particles["sites"].values() if r["kernel"] == kernel),
                    key=lambda r: r["lanes"]))
          for kernel in PARTICLES],
        *[entry(f"{r['kernel']}[{site}]", r["kernel"], particles["site_launches"][site], r)
          for site, r in particles["sites"].items()],
    ]}


def geometry_launches_a_frame(per_frame: dict, frames: dict) -> None:
    """Each frame's geometry launches in an eager frame: at most 2 of the
    vertex stage (one merged call, its two phases) and one setup launch a
    view; raises otherwise."""
    for scene, counts in per_frame.items():
        views = frames[scene][2].num_views
        phase("geometry", f"{scene}: launches a frame: vertex stage {counts['vertex_stage']} "
              f"(at most 2), view setup {counts['view_setup']} ({views} view(s): one a view)")
        if counts["vertex_stage"] > 2 or counts["view_setup"] != views:
            raise RuntimeError(f"the {scene} frame's geometry launches {counts}")


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    parser.add_argument("--baseline", default=None,
                        help="root of another tree of this repo whose geometry, "
                             "worklist, shade and particle shade kernels [geometry], "
                             "[worklist], [shade] and [particles] time beside this tree's "
                             "at each site, as its frame called them")
    BASELINE["root"] = parser.parse_args().baseline
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
    deep_launches, deep_by_pass, deep_frame = deep_k_path(dev, ap_frame[2], shapes)
    stereo_by_eye, stereo_frame = stereo_path(dev, shapes)
    sh_launches, sh_by_pass = sharded_path(shapes, stereo_frame, ap_frame)
    ap_config, stereo_config = ap_frame[2], stereo_frame[2]
    del ap_frame, stereo_frame
    lit_launches, lit_by_pass, lit_frame = lit_passes_path(dev, shapes)
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
    sampler_registers(smi)
    sampler = hand_path(SAMPLER_PHASE, smi, graph_frames)
    deferred = hand_path(DEFERRED_PHASE, smi, graph_frames)
    sky_kernel_stats(smi, build["sky"]["log"],
                     {site: r for site, r in deferred["sites"].items() if r["kernel"] == "sky"})
    shade = hand_path(SHADE_PHASE, smi, dict(graph_frames, lit_passes=lit_frame))
    geometry = hand_path(GEOMETRY_PHASE, smi, dict(graph_frames, lit_passes=lit_frame))
    geometry_launches_a_frame(geometry["per_frame"], dict(graph_frames, lit_passes=lit_frame))
    worklist = worklist_path(smi, dict(graph_frames, lit_passes=lit_frame),
                             build["worklist"]["log"])
    particles = particles_path(smi, {"all_passes": graph_frames["all_passes"],
                                     "lit_passes": lit_frame, "deep_k": deep_frame})
    del lit_frame, deep_frame

    for mod in ("jax", "superconductor_tpu"):
        if sys.modules.get(mod) is not None:
            raise RuntimeError(f"{mod} was imported")
    phase("imports", "neither jax nor superconductor_tpu was imported")

    print(json.dumps(kernels_line(launches, cb_launches, ap_launches, ap_by_pass,
                                  stereo_by_eye, sh_launches, sh_by_pass, lit_launches,
                                  lit_by_pass, app, deep_launches, deep_by_pass, graph_launches,
                                  results, kb_results, shapes, sampler, deferred, shade,
                                  geometry, worklist, particles)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
