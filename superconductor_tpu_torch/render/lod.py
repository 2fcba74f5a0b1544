"""Screen-coverage LOD selection (MSFT_screencoverage).

Exact port of the coverage formula in push_entity_instances
(src/systems.rs:222-256): coverage = pi*(r/d)^2 / (tan(29.5deg)^2 * aspect),
LOD index = number of thresholds greater than the coverage (thresholds are
stored descending in glTF extras).
"""

from __future__ import annotations

import numpy as np

from ..math3d import Similarity
from ..scene.scene import Primitive


def screen_coverage(
    center: np.ndarray,
    radius: float,
    eye: np.ndarray,
    width: int = 1024,
    height: int = 1024,
) -> float:
    distance = float(np.linalg.norm(np.asarray(center) - np.asarray(eye)))
    if distance <= 0.0:
        return float("inf")
    visible_radius = radius / distance
    mesh_area = np.pi * visible_radius * visible_radius
    aspect = width / height
    y = np.tan(np.radians(59.0) / 2.0)
    x = y * aspect
    return float(mesh_area / (x * y))


def select_lod(
    prim: Primitive,
    world_sim: Similarity,
    eye: np.ndarray,
    screen_height: int = 1080,
    screen_width: int = 1920,
) -> int:
    if not prim.lod_coverages or len(prim.lods) <= 1:
        return 0
    cov = screen_coverage(
        world_sim.translation,
        prim.bounding_sphere_radius * world_sim.scale,
        eye,
        screen_width,
        screen_height,
    )
    lod = int(np.sum(np.asarray(prim.lod_coverages, np.float32) > cov))
    return min(lod, len(prim.lods) - 1)
