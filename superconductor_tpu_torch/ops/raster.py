"""Binned tile rasterizers: the opaque visibility pass and the k-buffer
passes (alpha clip, alpha blend).

Ports of ``superconductor_tpu/ops/raster_pallas.py``: ``rasterize_pallas_sorted``
(:194, kernel ``_raster_kernel`` :80) and ``kbuffer_pallas_sorted`` (:456,
kernel ``_kbuffer_kernel`` :314). Given tile-sorted (P, 16) setup rows and
each tile's range [tile_start, tile_start + tile_count), they leave SORTED
positions (-1 = miss) in their pair planes; the caller remaps them.

* ``rasterize_sorted`` -- VisibilityBuffer of the nearest fragment. A CUDA
  tensor launches ``csrc/raster.cu``; a CPU tensor runs
  ``rasterize_sorted_plain`` (vectorised torch, chunked over pairs).
* ``kbuffer_sorted`` -- the K nearest fragments in front of a depth floor
  and the accepted-fragment count. A CUDA tensor launches
  ``csrc/kbuffer.cu``; a CPU tensor runs ``raster_kbuffer.kbuffer_sorted_plain``.
  ``kbuffer_sorted_global`` runs the same file's global-memory kernel at any
  K, which ``kbuffer_sorted`` runs only above ``KBUFFER_DEEP_MAX_K``.
* ``build_kernels`` -- compile the CUDA libraries (idempotent; one nvcc per
  stale source, all started together) into ``build/``; they are loaded
  with ctypes at first use. Besides the two raster sources it builds
  ``csrc/sample.cu``, the material samplers, whose wrappers are
  ``ops/sample.py`` ``sample_classic`` and ``sample_material`` (they
  count their launches as the wrappers here do).

No wrapper falls back: anything its kernel does not take raises. Each
plain version equals its kernel, and the reference's interpret-mode
kernel, bit for bit. ``rasterize_sorted.LAUNCHES``,
``kbuffer_sorted.LAUNCHES`` and ``kbuffer_sorted_global.LAUNCHES`` count
the kernel launches the device runs (never plain calls): a launch made
while the current stream captures a CUDA graph goes into the tally of
``capture_tally`` instead, and ``replay_launches`` adds that tally at each
replay of the graph.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import torch

from .geometry import ragged_owner
from .raster_ref import VisibilityBuffer, _tie

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
# kernel name -> (source, library)
KERNELS = {
    name: (os.path.join(_PKG_DIR, "csrc", f"{name}.cu"),
           os.path.join(BUILD_DIR, f"libsc_{name}.so"))
    for name in ("raster", "kbuffer", "sample")
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)
KERNEL_TILE = (32, 128)  # kTileH, kTileW in csrc/raster_common.cuh
# csrc/raster.cu: blocks of a thread-block cluster sharing a tile (1..8),
# and the fewest rows a tile part holds before the tile is split. 4 is the
# fastest on the headline frame's opaque pass and within 2% of 8 on the
# clip_blend frame's (PERF.md); 8 pays for its idle blocks on light tiles.
# csrc/kbuffer.cu's templates (K <= 16): the same two for a band of a
# tile. 2 is within 2% of the fastest (4) on the clip_blend frame's clip
# pass (K=8) and 8-13% faster than 4 on its blend pass (K=1, 4); it
# launches half the idle blocks (PERF.md). The wrappers read all five
# constants at each call (bench_raster.kernel_constants sets them for a
# sweep); no result depends on them.
RASTER_CLUSTER = 4
RASTER_MIN_PART_ROWS = 32
KBUFFER_CLUSTER = 2
KBUFFER_MIN_PART_ROWS = 32
# csrc/kbuffer.cu's deep kernel (K > 16): blocks of a cluster sharing a
# band. 1 is the fastest on the deep_k frame's particle pass at every K
# from 17 to 128, whose heaviest tile holds 86 rows: most of its time is
# empty tiles writing K + 1 planes, which a cluster only adds blocks to
# (PERF.md).
KBUFFER_DEEP_CLUSTER = 1
# The k-buffer kernel's template depths. Another K up to 16 runs the next
# of them and keeps its first K planes; a K above 16 runs the deep kernel
# (csrc/kbuffer.cu kbuffer_deep_kernel: lists in shared memory, up to
# KBUFFER_DEEP_MAX_K) or, above that, the global-memory kernel, which keeps
# the lists in the depth and pair planes and so needs depth planes.
KBUFFER_KS = (1, 2, 4, 8, 16)
KBUFFER_DEEP_MAX_K = 875  # csrc/kbuffer.cu deep_band_px: 32 pixels fill a block

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> (kernel library, argument types)
_SIGNATURES = {
    "sc_raster_sorted": ("raster",
                         [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "sc_kbuffer_sorted": ("kbuffer",
                          [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                           _P]),
    "sc_kbuffer_global": ("kbuffer",
                          [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "sc_kbuffer_smem_bytes": ("kbuffer", [_I]),
    # ops/sample.py's material samplers (csrc/sample.cu)
    "sc_classic_sample": ("sample",
                          [_I, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _L, _I, _P, _L, _I, _I, _I,
                           _I, _I, _P, _P]),
    "sc_material_sample": ("sample",
                           [_I, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _L, _I, _P, _L, _I, _P, _L,
                            _I, _I, _I, _I, _P, _P]),
}
_libs: dict = {}
_tallies: list = []  # the tallies of the captures under way, innermost last


@contextlib.contextmanager
def capture_tally():
    """Inside the block, a wrapper whose kernel launches into a capturing
    stream adds one to the yielded Counter (wrapper -> launches) instead of
    its LAUNCHES: the launch runs only when the graph replays. A capture
    outside such a block counts nothing."""
    tally = collections.Counter()
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.remove(tally)


def replay_launches(tally: dict) -> None:
    """Count the launches of one replay of a graph captured with `tally`."""
    for wrapper, n in tally.items():
        wrapper.LAUNCHES += n


def _launched(wrapper) -> None:
    """One launch of `wrapper`'s kernel on the current stream."""
    if torch.cuda.is_current_stream_capturing():
        if _tallies:
            _tallies[-1][wrapper] += 1
    else:
        wrapper.LAUNCHES += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def is_fresh(source: str, library: str) -> bool:
    """True when `library` exists and is no older than `source` and every
    header csrc/*.cuh (which any source may include)."""
    if not os.path.exists(library):
        return False
    headers = glob.glob(os.path.join(os.path.dirname(source), "*.cuh"))
    built = os.path.getmtime(library)
    return all(built >= os.path.getmtime(f) for f in (source, *headers))


def build_kernels(force: bool = False, verbose: bool = False) -> dict:
    """Compile every csrc/<name>.cu whose build/libsc_<name>.so is not
    `is_fresh` (all of them when `force`), one nvcc process per source, all
    running at once. Returns {name: {"library", "seconds", "log"}} for each
    kernel (seconds 0.0 and an empty log when it was up to date); `log`
    holds the compiler's output, with -Xptxas -v when verbose."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, running = {}, {}
    for name, (source, library) in KERNELS.items():
        if is_fresh(source, library) and not force:
            out[name] = {"library": library, "seconds": 0.0, "log": ""}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in running.items():
        log, _ = proc.communicate(timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{KERNELS[name][0]}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, KERNELS[name][1])
        out[name] = {"library": KERNELS[name][1], "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building the libraries first
    when needed."""
    if name not in _libs:
        build_kernels()
        _libs[name] = ctypes.CDLL(KERNELS[name][1])
    return _libs[name]


def _kernel_fn(symbol: str):
    """The C entry point `symbol` of its kernel library."""
    name, argtypes = _SIGNATURES[symbol]
    fn = getattr(_library(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def kbuffer_smem_bytes(k: int) -> int:
    """Dynamic shared memory (bytes) a block of the K-slot k-buffer kernel
    takes, from the built library: the template's (K in KBUFFER_KS), the
    deep kernel's (16 < K <= KBUFFER_DEEP_MAX_K), else -1."""
    return int(_kernel_fn("sc_kbuffer_smem_bytes")(int(k)))


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tile_grid(height: int, width: int, tile_h: int, tile_w: int):
    return -(-width // tile_w), -(-height // tile_h)


def tile_pixel_centres(tiles: torch.Tensor, ntx: int, tile_h: int, tile_w: int,
                       y_offset: int):
    """Pixel centres of tiles (n,) -> px (n, tile_w), py (n, tile_h)."""
    dev = tiles.device
    lx = torch.arange(tile_w, dtype=torch.float32, device=dev)
    ly = torch.arange(tile_h, dtype=torch.float32, device=dev)
    ox = (torch.remainder(tiles, ntx) * tile_w).to(torch.float32)
    oy = (torch.div(tiles, ntx, rounding_mode="floor") * tile_h + y_offset).to(torch.float32)
    return (lx[None, :] + ox[:, None]) + 0.5, (ly[None, :] + oy[:, None]) + 0.5


def fragment_z(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """The kernels' per-pixel test, op by op in their order: setup rows
    (..., 16) at pixel centres px, py (broadcast against rows[..., 0]) ->
    (z, inside): the fill rule on the three edges, wsum > 0 and z in [0, 1]."""

    def col(k):
        return rows[..., k, None, None]

    def edge(i):
        a, b, c = col(3 * i), col(3 * i + 1), col(3 * i + 2)
        e = a * px + b * py + c
        return e, (e > 0) | ((e == 0) & _tie(a, b))

    e0, ok0 = edge(0)
    e1, ok1 = edge(1)
    e2, ok2 = edge(2)
    zsum = e0 * col(9) + e1 * col(10) + e2 * col(11)
    wsum = e0 * col(12) + e1 * col(13) + e2 * col(14)
    z = zsum / torch.where(wsum == 0, 1.0, wsum)
    return z, ok0 & ok1 & ok2 & (wsum > 0) & (z >= 0) & (z <= 1)


def rasterize_sorted(
    sorted_setup: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    height: int,
    width: int,
    tile_h: int = 32,
    tile_w: int = 128,
    reverse_z: bool = True,
    init: Optional[VisibilityBuffer] = None,
    y_offset: int = 0,
) -> VisibilityBuffer:
    """Visibility of tile-sorted setup rows; ``pair`` holds sorted
    positions. CUDA tensors launch the kernel, CPU tensors run
    rasterize_sorted_plain. The kernel splits heavy tiles by the module's
    RASTER_CLUSTER and RASTER_MIN_PART_ROWS; the result does not depend on
    them."""
    dev = sorted_setup.device
    if dev.type == "cpu":
        return rasterize_sorted_plain(
            sorted_setup, tile_start, tile_count, height, width, tile_h=tile_h,
            tile_w=tile_w, reverse_z=reverse_z, init=init, y_offset=y_offset,
        )
    if dev.type != "cuda":
        raise ValueError(f"rasterize_sorted: unsupported device {dev}")
    if (tile_h, tile_w) != KERNEL_TILE:
        raise ValueError(f"the raster kernel takes {KERNEL_TILE} tiles, got {(tile_h, tile_w)}")
    if height <= 0 or width <= 0:
        raise ValueError("empty raster target")
    ntx, nty = _tile_grid(height, width, tile_h, tile_w)
    p = sorted_setup.shape[0]
    _check(sorted_setup, "sorted_setup", torch.float32, (p, 16), dev)
    if sorted_setup.data_ptr() % 16:
        raise ValueError("sorted_setup must be 16-byte aligned")
    _check(tile_start, "tile_start", torch.int32, (ntx * nty,), dev)
    _check(tile_count, "tile_count", torch.int32, (ntx * nty,), dev)
    init_depth = init_pair = None
    if init is not None:
        _check(init.depth, "init.depth", torch.float32, (height, width), dev)
        _check(init.pair, "init.pair", torch.int32, (height, width), dev)
        init_depth, init_pair = init.depth.data_ptr(), init.pair.data_ptr()
    launch = _kernel_fn("sc_raster_sorted")
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    pair = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            sorted_setup.data_ptr(), p, tile_start.data_ptr(),
            tile_count.data_ptr(), ntx, nty, height, width, int(y_offset),
            int(bool(reverse_z)), RASTER_CLUSTER, RASTER_MIN_PART_ROWS, init_depth,
            init_pair, depth.data_ptr(), pair.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError_t {err}")
    _launched(rasterize_sorted)
    return VisibilityBuffer(depth=depth, pair=pair)


rasterize_sorted.LAUNCHES = 0


def kbuffer_sorted(
    sorted_setup: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    height: int,
    width: int,
    k: int = 4,
    tile_h: int = 32,
    tile_w: int = 128,
    reverse_z: bool = True,
    depth_floor: Optional[torch.Tensor] = None,
    y_offset: int = 0,
    want_depth: bool = True,
):
    """K-layer raster of tile-sorted setup rows in front of depth_floor
    (H, W) (None = far) -> (KBuffer with SORTED positions in .pair and
    .depth None unless want_depth, layers (H, W) i32). CUDA tensors launch
    the kernel, CPU tensors run kbuffer_sorted_plain. Any k >= 1: a k up to
    16 that is not in KBUFFER_KS runs the next template and returns its
    first k planes (views of the template's, contiguous); a k above 16 runs
    the deep kernel, which allocates no depth planes when not want_depth,
    up to KBUFFER_DEEP_MAX_K, and above it the global-memory kernel, with
    scratch depth planes when not want_depth. The templates split heavy
    tiles by the module's KBUFFER_CLUSTER, the deep kernel by
    KBUFFER_DEEP_CLUSTER, both by KBUFFER_MIN_PART_ROWS; the result does
    not depend on them."""
    from .raster_kbuffer import kbuffer_sorted_plain

    if sorted_setup.device.type == "cpu":
        return kbuffer_sorted_plain(
            sorted_setup, tile_start, tile_count, height, width, k=k, tile_h=tile_h,
            tile_w=tile_w, reverse_z=reverse_z, depth_floor=depth_floor,
            y_offset=y_offset, want_depth=want_depth,
        )
    k = int(k)
    planes = k if k > KBUFFER_KS[-1] else next(t for t in KBUFFER_KS if t >= k)
    out = _kbuffer_launch(
        "sc_kbuffer_sorted", sorted_setup, tile_start, tile_count, height, width, k, planes,
        tile_h, tile_w, reverse_z, depth_floor, y_offset,
        want_depth or planes > KBUFFER_DEEP_MAX_K, want_depth,
        (KBUFFER_CLUSTER if planes <= KBUFFER_KS[-1] else KBUFFER_DEEP_CLUSTER,
         KBUFFER_MIN_PART_ROWS),
    )
    _launched(kbuffer_sorted)
    return out


kbuffer_sorted.LAUNCHES = 0


def kbuffer_sorted_global(
    sorted_setup: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    height: int,
    width: int,
    k: int = 4,
    reverse_z: bool = True,
    depth_floor: Optional[torch.Tensor] = None,
    y_offset: int = 0,
    want_depth: bool = True,
):
    """kbuffer_sorted's result from csrc/kbuffer.cu's global-memory kernel
    at any k >= 1 (CUDA tensors only; depth planes are always allocated, as
    its lists live in them): what kbuffer_sorted runs above
    KBUFFER_DEEP_MAX_K, callable below it to time the deep kernel against
    it. Counts its launches in kbuffer_sorted_global.LAUNCHES."""
    out = _kbuffer_launch(
        "sc_kbuffer_global", sorted_setup, tile_start, tile_count, height, width, int(k),
        int(k), *KERNEL_TILE, reverse_z, depth_floor, y_offset, True, want_depth, (),
    )
    _launched(kbuffer_sorted_global)
    return out


kbuffer_sorted_global.LAUNCHES = 0


def _kbuffer_launch(symbol, sorted_setup, tile_start, tile_count, height, width, k, planes,
                    tile_h, tile_w, reverse_z, depth_floor, y_offset, depth_planes,
                    want_depth, split):
    """Check the inputs of a k-buffer kernel, allocate `planes` pair planes
    (and depth planes when `depth_planes`) and `layers`, and launch the C
    entry point `symbol` on the current stream with `split` (cluster size
    and min_part_rows, or nothing) after the reverse-z flag -> (KBuffer of
    the first k planes, .depth None unless want_depth, layers). Raises on
    anything the kernel does not take and on a failed launch."""
    from .raster_kbuffer import KBuffer

    dev = sorted_setup.device
    if dev.type != "cuda":
        raise ValueError(f"the k-buffer kernel runs on CUDA tensors, not {dev}")
    if (tile_h, tile_w) != KERNEL_TILE:
        raise ValueError(f"the k-buffer kernel takes {KERNEL_TILE} tiles, got {(tile_h, tile_w)}")
    if k < 1:
        raise ValueError(f"the k-buffer kernel takes k >= 1, got {k}")
    if height <= 0 or width <= 0:
        raise ValueError("empty raster target")
    ntx, nty = _tile_grid(height, width, tile_h, tile_w)
    p = sorted_setup.shape[0]
    _check(sorted_setup, "sorted_setup", torch.float32, (p, 16), dev)
    if sorted_setup.data_ptr() % 16:
        raise ValueError("sorted_setup must be 16-byte aligned")
    _check(tile_start, "tile_start", torch.int32, (ntx * nty,), dev)
    _check(tile_count, "tile_count", torch.int32, (ntx * nty,), dev)
    floor_ptr = None
    if depth_floor is not None:
        _check(depth_floor, "depth_floor", torch.float32, (height, width), dev)
        floor_ptr = depth_floor.data_ptr()
    launch = _kernel_fn(symbol)
    depth = None
    if depth_planes:
        depth = torch.empty((planes, height, width), dtype=torch.float32, device=dev)
    pair = torch.empty((planes, height, width), dtype=torch.int32, device=dev)
    layers = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            sorted_setup.data_ptr(), p, tile_start.data_ptr(), tile_count.data_ptr(),
            ntx, nty, height, width, int(y_offset), planes, int(bool(reverse_z)), *split,
            floor_ptr, None if depth is None else depth.data_ptr(), pair.data_ptr(),
            layers.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"k-buffer kernel launch failed: cudaError_t {err}")
    return KBuffer(depth=depth[:k] if want_depth else None, pair=pair[:k]), layers


def rasterize_sorted_plain(
    sorted_setup: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    height: int,
    width: int,
    tile_h: int = 32,
    tile_w: int = 128,
    reverse_z: bool = True,
    init: Optional[VisibilityBuffer] = None,
    y_offset: int = 0,
) -> VisibilityBuffer:
    """Plain torch version of the tile walk, on any device.

    A sequential walk with a strict depth test keeps the FIRST maximum, so
    per pixel this takes the max of the accepted z that beat the running
    depth and, among the pairs reaching it, the smallest sorted position.
    Each (tile, pair) entry is evaluated over its own tile's pixels only,
    so memory stays chunk x tile_h x tile_w (256 entries per chunk on the
    CPU, 4096 on a GPU)."""
    dev = sorted_setup.device
    chunk = 256 if dev.type == "cpu" else 4096
    ntx, nty = _tile_grid(height, width, tile_h, tile_w)
    ntiles, npix = ntx * nty, tile_h * tile_w
    pad_h, pad_w = nty * tile_h, ntx * tile_w
    far = 0.0 if reverse_z else 1.0
    sign = 1.0 if reverse_z else -1.0  # compare on key = sign * z (max wins)

    depth = torch.full((pad_h, pad_w), far, dtype=torch.float32, device=dev)
    pair = torch.full((pad_h, pad_w), -1, dtype=torch.int32, device=dev)
    if init is not None:
        depth[:height, :width] = init.depth
        pair[:height, :width] = init.pair

    def to_tiles(a):
        return a.reshape(nty, tile_h, ntx, tile_w).permute(0, 2, 1, 3).reshape(ntiles, npix)

    key = to_tiles(depth) * sign
    pos = to_tiles(pair).clone()

    p = sorted_setup.shape[0]
    begin = tile_start.to(torch.int64).clamp(0, p)
    end = torch.maximum(
        (tile_start.to(torch.int64) + tile_count.to(torch.int64)).clamp(max=p), begin
    )
    counts = (end - begin).to(torch.int32)
    total = int(counts.sum())
    entry_tile, _, offsets, _ = ragged_owner(counts, total)
    local = torch.arange(total, dtype=torch.int32, device=dev) - offsets[entry_tile]
    entry_pos = (begin[entry_tile] + local).to(torch.int32)

    neg_inf = torch.tensor(float("-inf"), device=dev)
    no_pos = torch.iinfo(torch.int32).max
    for s0 in range(0, total, chunk):
        tiles = entry_tile[s0:s0 + chunk]
        epos = entry_pos[s0:s0 + chunk]
        px, py = tile_pixel_centres(tiles, ntx, tile_h, tile_w, y_offset)
        z, accept = fragment_z(sorted_setup[epos], px[:, None, :], py[:, :, None])
        cand = torch.where(accept, z * sign, neg_inf).reshape(-1, npix)

        uniq, inv = torch.unique_consecutive(tiles, return_inverse=True)
        idx = inv[:, None].expand(-1, npix)
        best = torch.full((uniq.shape[0], npix), float("-inf"), device=dev)
        best = best.scatter_reduce(0, idx, cand, "amax")
        at_best = accept.reshape(-1, npix) & (cand == best[inv])
        cand_pos = torch.where(at_best, epos[:, None], no_pos)
        bpos = torch.full((uniq.shape[0], npix), no_pos, dtype=torch.int32, device=dev)
        bpos = bpos.scatter_reduce(0, idx, cand_pos, "amin")
        cur_key = key[uniq]
        better = best > cur_key
        key[uniq] = torch.where(better, best, cur_key)
        pos[uniq] = torch.where(better, bpos, pos[uniq])

    def from_tiles(a):
        return a.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3).reshape(pad_h, pad_w)

    out_depth = from_tiles(key * sign)[:height, :width].contiguous()
    out_pair = from_tiles(pos)[:height, :width].contiguous()
    return VisibilityBuffer(depth=out_depth, pair=out_pair)
