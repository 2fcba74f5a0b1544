"""Blit, sRGB blit and mip generation (port of
``superconductor_tpu/ops/blit.py``), plain torch on the input's device.

The reference resamples with ``jax.image.resize`` (method "bilinear" /
"linear"), which antialiases: when it downsamples, its triangle kernel is
widened by the inverse scale. This builds the same weight matrices (the
triangle kernel over the sample positions, each column normalised, zero
where the sample lies outside the input) and contracts the image with them
along each resized axis; an axis whose size does not change is left as is.
"""

from __future__ import annotations

import torch

from .tonemap import linear_to_srgb_exact

_EPS32 = 1.1920928955078125e-07  # float32 machine epsilon


def _weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) f32 resampling weights of jax.image.resize's
    linear kernel with antialiasing (jax/_src/image/scale.py
    compute_weight_mat, translation 0)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample = (torch.arange(out_size, **f32) + 0.5) * torch.tensor(inv_scale, **f32) - 0.5
    x = (sample[None, :] - torch.arange(in_size, **f32)[:, None]).abs()
    w = torch.clamp_min(1.0 - x / torch.tensor(kernel_scale, **f32), 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    out = image.to(torch.float32)
    if out_h != out.shape[0]:
        out = torch.einsum("hwc,ho->owc", out, _weights(out.shape[0], out_h, out.device))
    if out_w != out.shape[1]:
        out = torch.einsum("hwc,wo->hoc", out, _weights(out.shape[1], out_w, out.device))
    return out


def blit(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resample (H, W, C) -> (out_h, out_w, C) f32."""
    return _resize(image, out_h, out_w)


def srgb_blit(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Blit with the exact linear -> sRGB encode on the colour channels."""
    out = blit(image, out_h, out_w)
    return torch.cat([linear_to_srgb_exact(out[..., :3]), out[..., 3:]], dim=-1)


def generate_mips(image: torch.Tensor, max_levels: int = 16) -> list:
    """Mip chain by successive halving (each axis floored at 1) with the
    same resampling, at most max_levels levels, the image first."""
    levels = [image]
    cur = image
    while (cur.shape[0] > 1 or cur.shape[1] > 1) and len(levels) < max_levels:
        cur = _resize(cur, max(1, cur.shape[0] // 2), max(1, cur.shape[1] // 2))
        levels.append(cur)
    return levels
