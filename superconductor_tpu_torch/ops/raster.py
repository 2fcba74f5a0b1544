"""Binned tile rasterizer: the opaque visibility pass.

Port of ``superconductor_tpu/ops/raster_pallas.py`` ``rasterize_pallas_sorted``
(:194) and its kernel ``_raster_kernel`` (:80). Given tile-sorted (P, 16)
setup rows and each tile's range [tile_start, tile_start + tile_count), it
returns a VisibilityBuffer whose ``pair`` holds the winner's SORTED
position (-1 = miss) and whose ``depth`` is the winner's z (reverse-z: 0 =
far).

* ``rasterize_sorted`` -- the wrapper. A CUDA tensor launches the
  hand-written kernel ``csrc/raster.cu`` (built with nvcc at first use into
  ``build/``, loaded with ctypes); a CPU tensor runs the plain version. It
  never falls back: anything the kernel does not take raises.
* ``rasterize_sorted_plain`` -- vectorised torch, chunked over pairs, equal
  bit for bit to the kernel and to the reference's interpret-mode kernel.
* ``build_kernels`` -- compile the CUDA library (idempotent).

``rasterize_sorted.LAUNCHES`` counts kernel launches (never plain calls).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import torch

from .geometry import ragged_owner
from .raster_ref import VisibilityBuffer

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "raster.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
_LIBRARY = os.path.join(BUILD_DIR, "libsc_raster.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)
KERNEL_TILE = (32, 128)  # kTileH, kTileW in csrc/raster.cu

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the raster kernel cannot be built")


def build_kernels(force: bool = False, verbose: bool = False) -> dict:
    """Compile csrc/raster.cu into build/libsc_raster.so unless an up to
    date library exists. Returns {"library", "seconds", "log"}; `log`
    holds the compiler's output (with -Xptxas -v when verbose)."""
    fresh = (
        os.path.exists(_LIBRARY)
        and os.path.getmtime(_LIBRARY) >= os.path.getmtime(_SOURCE)
    )
    if fresh and not force:
        return {"library": _LIBRARY, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, _SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, _LIBRARY)
    return {"library": _LIBRARY, "seconds": seconds, "log": log}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build_kernels()
        lib = ctypes.CDLL(_LIBRARY)
        fn = lib.sc_raster_sorted
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


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
    rasterize_sorted_plain."""
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
    lib = _library()
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    pair = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sc_raster_sorted(
            sorted_setup.data_ptr(), p, tile_start.data_ptr(),
            tile_count.data_ptr(), ntx, nty, height, width, int(y_offset),
            int(bool(reverse_z)), init_depth, init_pair, depth.data_ptr(),
            pair.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError_t {err}")
    rasterize_sorted.LAUNCHES += 1
    return VisibilityBuffer(depth=depth, pair=pair)


rasterize_sorted.LAUNCHES = 0


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

    lx = torch.arange(tile_w, dtype=torch.float32, device=dev)
    ly = torch.arange(tile_h, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    no_pos = torch.iinfo(torch.int32).max
    for s0 in range(0, total, chunk):
        tiles = entry_tile[s0:s0 + chunk]
        epos = entry_pos[s0:s0 + chunk]
        rows = sorted_setup[epos]
        ox = (torch.remainder(tiles, ntx) * tile_w).to(torch.float32)
        oy = (torch.div(tiles, ntx, rounding_mode="floor") * tile_h + y_offset).to(
            torch.float32
        )
        px = ((lx[None, :] + ox[:, None]) + 0.5)[:, None, :]  # (c, 1, tw)
        py = ((ly[None, :] + oy[:, None]) + 0.5)[:, :, None]  # (c, th, 1)

        def col(k):
            return rows[:, k][:, None, None]

        def edge(i):
            a, b, c = col(3 * i), col(3 * i + 1), col(3 * i + 2)
            e = a * px + b * py + c
            tie = (a > 0) | ((a == 0) & (b > 0))
            return e, (e > 0) | ((e == 0) & tie)

        e0, ok0 = edge(0)
        e1, ok1 = edge(1)
        e2, ok2 = edge(2)
        zsum = e0 * col(9) + e1 * col(10) + e2 * col(11)
        wsum = e0 * col(12) + e1 * col(13) + e2 * col(14)
        inside = ok0 & ok1 & ok2 & (wsum > 0)
        z = zsum / torch.where(wsum == 0, 1.0, wsum)
        accept = inside & (z >= 0) & (z <= 1)
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
