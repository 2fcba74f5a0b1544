from .app import App, Stage, World
from .components import (
    AnimatedModelUrl,
    Instance,
    InstanceOf,
    JointsComponent,
    ModelComponent,
    ModelUrl,
    PendingModel,
)

__all__ = [
    "App",
    "Stage",
    "World",
    "AnimatedModelUrl",
    "Instance",
    "InstanceOf",
    "JointsComponent",
    "ModelComponent",
    "ModelUrl",
    "PendingModel",
]
