"""K-layer visibility (k-buffer) for the alpha-clip and alpha-blend passes
(port of ``superconductor_tpu/ops/raster_kbuffer.py``).

Each pixel keeps its K nearest accepted fragments, slot 0 nearest; the
clip resolve evaluates alpha on them, the blend composite shades them back
to front. ``KBuffer``, ``empty_kbuffer`` and ``kbuffer_insert`` are the
reference's per-fragment insert; ``rasterize_kbuffer_ref`` is its
brute-force K-layer raster (``raster="ref"``, plain torch: the reference
compiles it with XLA); ``kbuffer_sorted_plain`` is the plain
version of the binned k-buffer raster ``kbuffer_pallas_sorted``
(``raster_pallas.py:456``, kernel ``_kbuffer_kernel`` :314), whose CUDA
kernel is ``csrc/kbuffer.cu`` behind ``ops/raster.py`` ``kbuffer_sorted``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .raster import _tile_grid, fragment_z, tile_pixel_centres
from .raster_ref import band_chunks, nearness_bits


class KBuffer(NamedTuple):
    """Per-pixel K nearest fragments, slot 0 = nearest. Shapes (K, H, W)."""

    depth: Optional[torch.Tensor]  # None when produced with want_depth=False
    pair: torch.Tensor  # -1 = empty


def empty_kbuffer(k: int, height: int, width: int, reverse_z: bool = True,
                  device="cuda") -> KBuffer:
    far = 0.0 if reverse_z else 1.0
    return KBuffer(
        depth=torch.full((k, height, width), far, dtype=torch.float32, device=device),
        pair=torch.full((k, height, width), -1, dtype=torch.int32, device=device),
    )


def kbuffer_insert(kb: KBuffer, z, pair, accept, reverse_z: bool = True) -> KBuffer:
    """Insert one fragment candidate per pixel into the sorted k-buffer;
    z, pair, accept (H, W). The new fragment lands behind the occupied
    slots strictly nearer than it (ahead of equal depths)."""
    k = kb.depth.shape[0]
    if reverse_z:
        nearer = z[None] >= kb.depth  # new fragment nearer than (or tied with) the slot
    else:
        nearer = z[None] <= kb.depth
    rank = torch.sum(~nearer & (kb.pair >= 0), dim=0)
    rank = torch.where(accept, rank, k)  # rejected: lands past the end
    depth, pairs = [], []
    for i in range(k):
        is_new = rank == i
        shifted = rank < i
        prev = max(i - 1, 0)
        depth.append(torch.where(is_new, z, torch.where(shifted, kb.depth[prev], kb.depth[i])))
        pairs.append(torch.where(is_new, pair, torch.where(shifted, kb.pair[prev], kb.pair[i])))
    return KBuffer(depth=torch.stack(depth), pair=torch.stack(pairs))


def _nearness_key(z: torch.Tensor, pos: torch.Tensor, reverse_z: bool) -> torch.Tensor:
    """i64 key ordering fragments as the kernel's insertion shift leaves
    them: nearer first, and among equal depths the later sorted position
    first. z in [0, 1] (-0.0 compares equal to 0.0), pos >= 0."""
    return (nearness_bits(z, reverse_z) << 32) | pos.to(torch.int64)


def kbuffer_sorted_plain(
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
    """Plain torch version of the k-buffer tile walk, on any device ->
    (KBuffer with SORTED positions in .pair, layers (H, W) i32).

    The sequential insert keeps, per pixel, the top K accepted fragments
    by (nearness, sorted position), both descending, in that order; layers
    counts every accepted fragment. So this walks the tile-local index in
    steps: each step takes the next `rounds` rows of every tile still
    holding rows, evaluates them over their own tile's pixels, and merges
    them into the running top K with one i64 top-k. A step holds about
    `budget` (tile, row) entries (256 on the CPU, 4096 on a GPU), so
    memory stays budget x tile_h x tile_w, and as light tiles run out the
    heavy ones take more rows per step."""
    dev = sorted_setup.device
    budget = 256 if dev.type == "cpu" else 4096
    ntx, nty = _tile_grid(height, width, tile_h, tile_w)
    ntiles, npix = ntx * nty, tile_h * tile_w
    pad_h, pad_w = nty * tile_h, ntx * tile_w
    far = 0.0 if reverse_z else 1.0

    def to_tiles(a):
        return a.reshape(nty, tile_h, ntx, tile_w).permute(0, 2, 1, 3).reshape(ntiles, npix)

    floor = torch.full((pad_h, pad_w), far, dtype=torch.float32, device=dev)
    if depth_floor is not None:
        floor[:height, :width] = depth_floor
    floor = to_tiles(floor)

    p = sorted_setup.shape[0]
    begin = tile_start.to(torch.int64).clamp(0, p)
    end = torch.maximum(
        (tile_start.to(torch.int64) + tile_count.to(torch.int64)).clamp(max=p), begin
    )
    counts = end - begin

    key = torch.full((ntiles, k, npix), -1, dtype=torch.int64, device=dev)
    depth = torch.full((ntiles, k, npix), far, dtype=torch.float32, device=dev)
    pos = torch.full((ntiles, k, npix), -1, dtype=torch.int32, device=dev)
    layers = torch.zeros((ntiles, npix), dtype=torch.int32, device=dev)
    most = int(counts.max()) if ntiles else 0
    j0 = 0
    while j0 < most:
        active = torch.nonzero(counts > j0).flatten()
        rounds = max(1, budget // active.numel())
        group = max(1, budget // rounds)
        j = torch.arange(rounds, dtype=torch.int64, device=dev)
        for g0 in range(0, active.numel(), group):
            t = active[g0:g0 + group]
            live = (j0 + j)[None, :] < counts[t][:, None]  # (g, rounds)
            epos = torch.clamp_max(begin[t][:, None] + j0 + j[None, :], p - 1)
            px, py = tile_pixel_centres(t, ntx, tile_h, tile_w, y_offset)
            z, accept = fragment_z(
                sorted_setup[epos], px[:, None, None, :], py[:, None, :, None]
            )
            z = z.reshape(t.numel(), rounds, npix)
            fl = floor[t][:, None, :]
            nearer = z > fl if reverse_z else z < fl
            accept = accept.reshape(z.shape) & nearer & live[:, :, None]
            layers[t] += accept.sum(dim=1, dtype=torch.int32)
            epos32 = epos.to(torch.int32)[:, :, None].expand(z.shape)
            cand = torch.where(accept, _nearness_key(z, epos32, reverse_z), -1)
            top, idx = torch.topk(torch.cat([key[t], cand], dim=1), k, dim=1)
            empty = top < 0
            key[t] = top
            pos[t] = torch.where(empty, -1, torch.gather(torch.cat([pos[t], epos32], 1), 1, idx))
            depth[t] = torch.where(empty, far, torch.gather(torch.cat([depth[t], z], 1), 1, idx))
        j0 += rounds

    def from_tiles(a):
        return (
            a.reshape(nty, ntx, -1, tile_h, tile_w).permute(2, 0, 3, 1, 4)
            .reshape(-1, pad_h, pad_w)[:, :height, :width].contiguous()
        )

    kb = KBuffer(
        depth=from_tiles(depth) if want_depth else None,
        pair=from_tiles(pos),
    )
    return kb, from_tiles(layers[:, None, :])[0]


def rasterize_kbuffer_ref(
    tri,
    height: int,
    width: int,
    k: int = 4,
    reverse_z: bool = True,
    chunk: int = 32,
    depth_floor: Optional[torch.Tensor] = None,
    y_offset: int = 0,
):
    """Brute-force K-layer raster over the band [y_offset, y_offset +
    height) (reference ops/raster_kbuffer.py:83) -> (KBuffer with ORIGINAL
    row indices in .pair and its depth planes, layers (H, W) i32). Only
    fragments nearer than `depth_floor` (None = far) are accepted; layers
    counts every accepted fragment, those ranked past K included.

    The reference inserts row after row (kbuffer_insert), which keeps per
    pixel the top K accepted fragments by (nearness, index), both
    descending. This merges `chunk` rows at a time into that top K with one
    i64 top-k, each chunk over the pixels its bounding boxes cover
    (raster_ref.band_chunks)."""
    dev = tri.setup.device
    far = 0.0 if reverse_z else 1.0
    kb = empty_kbuffer(k, height, width, reverse_z, dev)
    depth, pair = kb.depth, kb.pair
    key = torch.full((k, height, width), -1, dtype=torch.int64, device=dev)
    layers = torch.zeros((height, width), dtype=torch.int32, device=dev)
    if depth_floor is None:
        depth_floor = torch.full((height, width), far, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5 + y_offset
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    for ids, y0, y1, x0, x1 in band_chunks(tri, height, width, y_offset, chunk):
        z, inside = fragment_z(tri.setup[ids], xs[None, x0:x1], ys[y0:y1, None])
        fl = depth_floor[y0:y1, x0:x1]
        accept = inside & (z > fl if reverse_z else z < fl)
        box = (slice(None), slice(y0, y1), slice(x0, x1))
        layers[box[1:]] += accept.sum(dim=0, dtype=torch.int32)
        pos = ids.to(torch.int32)[:, None, None].expand(z.shape)
        cand = torch.where(accept, _nearness_key(z, pos, reverse_z), -1)
        top, idx = torch.topk(torch.cat([key[box], cand]), k, dim=0)
        empty = top < 0
        key[box] = top
        pair[box] = torch.where(empty, -1, torch.gather(torch.cat([pair[box], pos]), 0, idx))
        depth[box] = torch.where(empty, far, torch.gather(torch.cat([depth[box], z]), 0, idx))
    return KBuffer(depth=depth, pair=pair), layers
