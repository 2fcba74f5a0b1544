"""Tonemapping and colour-space ops (port of
``superconductor_tpu/ops/tonemap.py``): Narkowicz ACES filmic, the
gamma-2.2 sRGB approximation, the exact sRGB transfer functions, and the
u8 quantisation of the final frame."""

from __future__ import annotations

import torch


def aces_filmic(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb_approx(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0) ** (1.0 / 2.2)


def srgb_to_linear_exact(c: torch.Tensor) -> torch.Tensor:
    """Exact sRGB EOTF for decoding sRGB8 texels (c in [0, 1])."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb_exact(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def tonemap_and_encode(rgb, inline_tonemapping=True, inline_srgb=True):
    """HDR linear -> display (potentially_tonemap)."""
    if inline_tonemapping:
        rgb = aces_filmic(rgb)
    if inline_srgb:
        rgb = linear_to_srgb_approx(rgb)
    return rgb


def to_u8(rgb: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp, u8 (jnp.round and torch.round agree)."""
    return torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
