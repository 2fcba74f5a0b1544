"""ECS components, mirroring src/components.rs.

The reference's scene-graph-free model: a *model entity* owns the loaded
Model; *instance entities* carry an Instance (world Similarity) plus an
InstanceOf pointing at the model entity (components.rs:8-11). Async loads
park a PendingModel on the entity until the future resolves
(components.rs:14-24 uses ArcSwapOption; here a concurrent Future).
The port's copy of ``superconductor_tpu/ecs/components.py``.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..animation import AnimationJoints
from ..math3d import Similarity
from ..scene.scene import Model


@dataclass
class Instance:
    """World transform of an instance entity (components.rs:8)."""

    similarity: Similarity = field(default_factory=Similarity.identity)


@dataclass
class InstanceOf:
    """Link from instance entity to its model entity (components.rs:11)."""

    model_entity: int


@dataclass
class ModelUrl:
    url: str


@dataclass
class AnimatedModelUrl:
    url: str


@dataclass
class PendingModel:
    """Load-in-flight handoff (components.rs:14-24)."""

    future: Future


@dataclass
class ModelComponent:
    """A fully loaded model attached to a model entity."""

    model: Model


@dataclass
class JointsComponent:
    """Animation state for an instance of an animated model
    (components.rs:123-177: JointBuffers + AnimationJoints + AnimationState
    collapsed — there is no 64 KiB UBO chunking here, one palette array
    covers everything)."""

    joints: AnimationJoints
    animation_index: int = 0
    time: float = 0.0
    # cached palette for this frame (J, 8)
    palette: Optional[np.ndarray] = None
