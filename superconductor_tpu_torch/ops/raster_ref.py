"""Visibility buffer type (port of ``superconductor_tpu/ops/raster_ref.py``
:31). The reference's brute-force ``rasterize_ref`` is not ported yet
(ROADMAP queue 1); the binned tile raster is ``ops/raster.py``."""

from __future__ import annotations

from typing import NamedTuple

import torch


class VisibilityBuffer(NamedTuple):
    depth: torch.Tensor  # (H, W) f32; reverse-z: 0 = far
    pair: torch.Tensor  # (H, W) i32; -1 = miss

