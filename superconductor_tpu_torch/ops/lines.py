"""Line rendering: segments -> screen-space quads -> flat-colour raster
(port of ``superconductor_tpu/ops/lines.py``).

Each segment becomes a quad extruded line_width_px / 2 either side of it
in screen space (two triangles with w = 1) that goes through the binned
raster with an init buffer; colours come from the reference's 16-entry
debug palette. Every product and sum is a separate op in the reference's
order, so the setup rows equal the reference's op-by-op result bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import TriangleSetup, clip_transform, device_values

# The reference's DEBUG_COLOURS palette (reference ops/lines.py:20).
DEBUG_COLOURS = np.array(
    [
        [0.0, 0.0, 0.0],
        [0.0, 0.0, 0.1647],
        [0.0, 0.0, 0.3647],
        [0.0, 0.0, 0.6647],
        [0.0, 0.0, 0.9647],
        [0.0, 0.9255, 0.9255],
        [0.0, 0.5647, 0.0],
        [0.0, 0.7843, 0.0],
        [1.0, 1.0, 0.0],
        [0.90588, 0.75294, 0.0],
        [1.0, 0.5647, 0.0],
        [1.0, 0.0, 0.0],
        [0.8392, 0.0, 0.0],
        [1.0, 0.0, 1.0],
        [0.6, 0.3333, 0.7882],
        [1.0, 1.0, 1.0],
    ],
    dtype=np.float32,
)


def _quad_corner_ids(n: int, device) -> torch.Tensor:
    """Corner identities of n two-triangle quads, (0, 1, 2) then (0, 2, 3)
    per quad, as (2n, 3) i32: a shared diagonal gets exactly negated edge
    functions."""
    base = torch.arange(n, dtype=torch.int32, device=device)[:, None] * 4
    a = device_values([0, 1, 2], torch.int32, device)[None, :]
    b = device_values([0, 2, 3], torch.int32, device)[None, :]
    return torch.cat([base + a, base + b])


def line_geometry(line_pos, color_ids, valid, view_proj, width: int, height: int,
                  line_width_px: float = 1.5, flip_viewport: bool = False):
    """(L, 2, 3) world endpoints, (L,) colour ids, (L,) valid -> (TriangleSetup
    of 2L triangles, (2L, 3) flat colours) (reference ops/lines.py:43).
    Segments with an endpoint behind the near plane, or shorter than 1e-3
    px, are dropped."""
    dev = line_pos.device
    n = line_pos.shape[0]
    p1 = torch.cat([line_pos, torch.ones((n, 2, 1), dtype=line_pos.dtype, device=dev)], dim=-1)
    clip = clip_transform(p1, view_proj)
    xc, yc, zc, wc = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    if flip_viewport:
        yc = -yc
    ok = torch.all(wc > 1e-6, dim=1) & valid
    w_safe = torch.clamp_min(wc, 1e-6)
    px = (xc / w_safe + 1.0) * (width * 0.5)
    py = (1.0 - yc / w_safe) * (height * 0.5)
    z = zc / w_safe

    d = torch.stack([px[:, 1] - px[:, 0], py[:, 1] - py[:, 0]], dim=-1)
    dlen = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    ok = ok & (dlen[:, 0] > 1e-3)
    d = d / torch.clamp_min(dlen, 1e-3)
    nrm = torch.stack([-d[:, 1], d[:, 0]], dim=-1) * (line_width_px * 0.5)

    # quad corners: 0 = p0 - n, 1 = p0 + n, 2 = p1 + n, 3 = p1 - n
    c0 = torch.stack([px[:, 0] - nrm[:, 0], py[:, 0] - nrm[:, 1], z[:, 0]], dim=-1)
    c1 = torch.stack([px[:, 0] + nrm[:, 0], py[:, 0] + nrm[:, 1], z[:, 0]], dim=-1)
    c2 = torch.stack([px[:, 1] + nrm[:, 0], py[:, 1] + nrm[:, 1], z[:, 1]], dim=-1)
    c3 = torch.stack([px[:, 1] - nrm[:, 0], py[:, 1] - nrm[:, 1], z[:, 1]], dim=-1)
    tris = torch.cat([torch.stack([c0, c1, c2], dim=1), torch.stack([c0, c2, c3], dim=1)])
    setup = _screen_space_setup(tris, torch.cat([ok, ok]), width, height,
                                vertex_ids=_quad_corner_ids(n, dev))
    palette = device_values(DEBUG_COLOURS.tolist(), torch.float32, dev)
    colors = palette[torch.remainder(color_ids, 16).long()]
    return setup, torch.cat([colors, colors])


def _screen_space_setup(tris, valid, width: int, height: int,
                        vertex_ids=None) -> TriangleSetup:
    """TriangleSetup rows of screen-space (px, py, z_ndc) triangles (T, 3,
    3) with w = 1, double-sided (reference ops/lines.py:103)."""
    x, y, z = tris[..., 0], tris[..., 1], tris[..., 2]
    one = torch.ones_like(x)

    def edge_coeffs(j, k):
        if vertex_ids is None:
            yj, wj, xj = y[:, j], one[:, j], x[:, j]
            yk, wk, xk = y[:, k], one[:, k], x[:, k]
            sign = 1.0
        else:
            swap = vertex_ids[:, j] > vertex_ids[:, k]
            sign = torch.where(swap, -1.0, 1.0)

            def pick(arr):
                return (torch.where(swap, arr[:, k], arr[:, j]),
                        torch.where(swap, arr[:, j], arr[:, k]))

            yj, yk = pick(y)
            wj, wk = pick(one)
            xj, xk = pick(x)
        a = (yj * wk - yk * wj) * sign
        b = (wj * xk - wk * xj) * sign
        c = (xj * yk - xk * yj) * sign
        return a, b, c

    a0, b0, c0 = edge_coeffs(1, 2)
    a1, b1, c1 = edge_coeffs(2, 0)
    a2, b2, c2 = edge_coeffs(0, 1)
    det = x[:, 0] * a0 + y[:, 0] * b0 + one[:, 0] * c0

    # double-sided: flip edges so e_i > 0 inside either way round
    flip = torch.where(det < 0.0, -1.0, 1.0)
    edge = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2], dim=-1) * flip[:, None]
    setup = torch.cat([edge, z, one, torch.zeros_like(x[:, :1])], dim=-1).to(torch.float32)

    valid = valid & (det != 0.0)
    xmin, xmax = torch.amin(x, dim=1), torch.amax(x, dim=1)
    ymin, ymax = torch.amin(y, dim=1), torch.amax(y, dim=1)
    x0 = torch.floor(xmin - 0.5).clamp(0, width - 1).to(torch.int32)
    y0 = torch.floor(ymin - 0.5).clamp(0, height - 1).to(torch.int32)
    x1 = torch.ceil(xmax + 0.5).clamp(0, width - 1).to(torch.int32)
    y1 = torch.ceil(ymax + 0.5).clamp(0, height - 1).to(torch.int32)
    offscreen = (xmax < 0) | (ymax < 0) | (xmin > width - 1) | (ymin > height - 1)
    valid = valid & ~offscreen
    t = tris.shape[0]
    dev = tris.device
    return TriangleSetup(
        setup=setup,
        tri_id=torch.arange(t, dtype=torch.int32, device=dev),
        inst_id=torch.zeros(t, dtype=torch.int32, device=dev),
        bbox=torch.stack([x0, y0, x1, y1], dim=-1),
        valid=valid,
        num_valid=valid.sum(dtype=torch.int32),
    )
