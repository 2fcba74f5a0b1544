"""Brute-force visibility raster (port of
``superconductor_tpu/ops/raster_ref.py``): every triangle against the
band's pixels in plain torch, on any device. It is what ``raster="ref"``
selects, the reference's CPU path and the independent check of the binned
raster; the reference compiles it with XLA, so it has no hand kernel. The
binned tile raster is ``ops/raster.py``.

Output is the visibility buffer the tile raster produces, except that
``pair`` holds the ORIGINAL index into the TriangleSetup rows:
  depth (H, W) f32 -- reverse-z by default (0 = far, larger = nearer)
  pair  (H, W) i32 -- -1 = miss
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_LOW = (1 << 32) - 1


class VisibilityBuffer(NamedTuple):
    depth: torch.Tensor  # (H, W) f32; reverse-z: 0 = far
    pair: torch.Tensor  # (H, W) i32; -1 = miss


def empty_visibility(height: int, width: int, reverse_z: bool = True,
                     device="cuda") -> VisibilityBuffer:
    far = 0.0 if reverse_z else 1.0
    return VisibilityBuffer(
        depth=torch.full((height, width), far, dtype=torch.float32, device=device),
        pair=torch.full((height, width), -1, dtype=torch.int32, device=device),
    )


def _tie(a, b):
    """Edge tie-break bit: accept e == 0 iff (a, b) lexicographically > 0."""
    return (a > 0) | ((a == 0) & (b > 0))


def nearness_bits(z: torch.Tensor, reverse_z: bool) -> torch.Tensor:
    """i64 nearness of depths z in [0, 1], larger = nearer; -0.0 and 0.0
    are equal, as they are to the depth test."""
    bits = torch.where(z == 0, 0, z.contiguous().view(torch.int32)).to(torch.int64)
    return bits if reverse_z else 0x3F800000 - bits


def band_chunks(tri, height: int, width: int, y_offset: int, chunk: int):
    """The valid rows of `tri` in index order, `chunk` at a time, each with
    the box of band pixels its rows' bounding boxes cover -> [(rows' indices
    (c,) i64, y0, y1, x0, x1)] with band rows [y0, y1) and columns [x0, x1);
    chunks that miss the band are left out. A pixel outside a triangle's
    bounding box fails its edge test (the tile binning relies on the same
    box), so walking each chunk over its box alone leaves every pixel as
    the walk over the whole band would. One read of the boxes to the host."""
    ids = torch.nonzero(tri.valid).flatten()
    if ids.numel() == 0:
        return []
    n = -(-ids.numel() // chunk)
    pad = n * chunk - ids.numel()
    box = tri.bbox[ids].to(torch.int64)
    lo = torch.nn.functional.pad(box[:, :2], (0, 0, 0, pad), value=1 << 40)
    hi = torch.nn.functional.pad(box[:, 2:], (0, 0, 0, pad), value=-(1 << 40))
    lo = lo.reshape(n, chunk, 2).amin(dim=1)
    hi = hi.reshape(n, chunk, 2).amax(dim=1)
    y0 = (lo[:, 1] - y_offset).clamp(0, height)
    y1 = (hi[:, 1] + 1 - y_offset).clamp(0, height)
    x0 = lo[:, 0].clamp(0, width)
    x1 = (hi[:, 0] + 1).clamp(0, width)
    out = []
    for i, (a, b, c, d) in enumerate(torch.stack([y0, y1, x0, x1], 1).tolist()):
        if a < b and c < d:
            out.append((ids[i * chunk:(i + 1) * chunk], a, b, c, d))
    return out


def rasterize_ref(
    tri,
    height: int,
    width: int,
    reverse_z: bool = True,
    chunk: int = 32,
    init: VisibilityBuffer | None = None,
    y_offset: int = 0,
) -> VisibilityBuffer:
    """Brute-force visibility over the band [y_offset, y_offset + height)
    at full image width, walked from `init` (None = far, no pair).

    The reference walks the rows one at a time with a strict depth test, so
    per pixel it keeps the first of the nearest accepted fragments that
    beat the running depth. This takes `chunk` rows at a time: their
    fragments by (nearness, first index) in one i64 max, then the strict
    test against the running depth. The per-pixel arithmetic is the tile
    raster's, op by op (ops/raster.py fragment_z)."""
    from .raster import fragment_z

    dev = tri.setup.device
    vis = init if init is not None else empty_visibility(height, width, reverse_z, dev)
    depth, pair = vis.depth.clone(), vis.pair.clone()
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5 + y_offset
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    for ids, y0, y1, x0, x1 in band_chunks(tri, height, width, y_offset, chunk):
        z, inside = fragment_z(tri.setup[ids], xs[None, x0:x1], ys[y0:y1, None])
        first = (ids.numel() - 1 - torch.arange(ids.numel(), device=dev))[:, None, None]
        key = torch.where(inside, (nearness_bits(z, reverse_z) << 32) | first, -1)
        best = key.amax(dim=0)
        local = ids.numel() - 1 - (best & _LOW).clamp_max(ids.numel() - 1)
        z_best = torch.gather(z, 0, local[None])[0]
        cur = depth[y0:y1, x0:x1]
        nearer = z_best > cur if reverse_z else z_best < cur
        win = (best >= 0) & nearer
        depth[y0:y1, x0:x1] = torch.where(win, z_best, cur)
        pair[y0:y1, x0:x1] = torch.where(win, ids[local].to(torch.int32), pair[y0:y1, x0:x1])
    return VisibilityBuffer(depth=depth, pair=pair)
