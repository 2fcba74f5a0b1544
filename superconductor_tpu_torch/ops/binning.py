"""Tile binning: triangle -> screen-tile pair lists, sorted by tile (port
of ``superconductor_tpu/ops/binning.py``).

Same three primitives as the reference: a capped ragged expansion
(``searchsorted`` over the count prefix sum), a STABLE sort by tile id
(``lax.sort_key_val`` is stable; torch's default sort is not), and
``searchsorted`` for each tile's range. Outputs are bit-identical to the
reference's Bins for the same setup rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import TriangleSetup, ragged_owner

TILE_H = 32
TILE_W = 128


class Bins(NamedTuple):
    order: torch.Tensor  # (P,) i32 pair index into the setup rows, tile-sorted
    tile_of_pair: torch.Tensor  # (P,) i32 tile id per sorted pair (sentinel ntiles)
    tile_start: torch.Tensor  # (ntiles,) i32
    tile_count: torch.Tensor  # (ntiles,) i32
    num_pairs: torch.Tensor  # () i32 real pairs (may exceed P on overflow)


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def bin_triangles(
    tri: TriangleSetup, width: int, height: int, p_cap: int,
    tile_h: int = TILE_H, tile_w: int = TILE_W, y_offset: int = 0,
) -> Bins:
    """Bin triangles into the band [y_offset, y_offset + height)."""
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    ntiles = ntx * nty

    by0_px = (tri.bbox[:, 1] - y_offset).clamp(0, height - 1)
    by1_px = (tri.bbox[:, 3] - y_offset).clamp(0, height - 1)
    in_band = (tri.bbox[:, 3] >= y_offset) & (tri.bbox[:, 1] < y_offset + height)

    bx0 = _floordiv(tri.bbox[:, 0], tile_w)
    by0 = _floordiv(by0_px, tile_h)
    bx1 = _floordiv(tri.bbox[:, 2], tile_w)
    by1 = _floordiv(by1_px, tile_h)
    tw = bx1 - bx0 + 1
    th = by1 - by0 + 1
    counts = torch.where(tri.valid & in_band, tw * th, torch.zeros_like(tw))

    pair_tri, pair_ok, offsets, total = ragged_owner(counts, p_cap)
    pos = torch.arange(p_cap, dtype=torch.int32, device=counts.device)
    local = pos - offsets[pair_tri]
    # Unused slots (pair_ok False) may own a triangle whose empty bbox gives
    # w <= 0; their tile id is replaced below, so only guard the division
    # (torch raises on integer division by zero, XLA does not).
    w = tw[pair_tri]
    w = torch.where(w > 0, w, torch.ones_like(w))
    tile_x = bx0[pair_tri] + torch.remainder(local, w)
    tile_y = by0[pair_tri] + _floordiv(local, w)
    tile_id = torch.where(
        pair_ok, tile_y * ntx + tile_x, torch.full_like(tile_x, ntiles)
    )

    tile_sorted, perm = torch.sort(tile_id, stable=True)
    order = pair_tri[perm]

    tile_range = torch.arange(ntiles, dtype=torch.int32, device=counts.device)
    tile_start = torch.searchsorted(tile_sorted, tile_range, out_int32=True)
    tile_end = torch.searchsorted(tile_sorted, tile_range, right=True, out_int32=True)
    return Bins(
        order=order,
        tile_of_pair=tile_sorted,
        tile_start=tile_start,
        tile_count=tile_end - tile_start,
        num_pairs=total.to(torch.int32),
    )


def gather_sorted_setup(tri: TriangleSetup, bins: Bins) -> torch.Tensor:
    """(P, 16) setup rows in tile-sorted order."""
    return tri.setup[bins.order]
