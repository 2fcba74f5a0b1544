"""Minimal ECS app: entities, components, resources, staged systems.

Mirrors the reference's bevy_app/bevy_ecs usage (XrPlugin::build registers
systems into 5 ordered update stages, src/lib.rs:40-47, 63-173):

    AssetLoading -> BufferResetting -> InstanceBuffering ->
    BufferUploading -> Rendering

plus Startup / PostStartup one-shot stages. The host-side scheduler is
plain Python (it orchestrates; the per-frame compute lives in the frame
function), so this ECS favors clarity over cache tricks: components
are per-type dicts keyed by entity id. The port's copy of
``superconductor_tpu/ecs/app.py``.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Type, TypeVar

T = TypeVar("T")


class Stage(enum.IntEnum):
    ASSET_LOADING = 0
    BUFFER_RESETTING = 1
    INSTANCE_BUFFERING = 2
    BUFFER_UPLOADING = 3
    RENDERING = 4


class StartupStage(enum.IntEnum):
    STARTUP = 0
    POST_STARTUP = 1


class World:
    """Entity/component store + singleton resources."""

    def __init__(self):
        self._next_entity = 0
        self.components: Dict[type, Dict[int, object]] = {}
        self.resources: Dict[type, object] = {}

    # -- entities ------------------------------------------------------
    def spawn(self, *components) -> int:
        e = self._next_entity
        self._next_entity += 1
        for c in components:
            self.insert(e, c)
        return e

    def despawn(self, entity: int) -> None:
        for store in self.components.values():
            store.pop(entity, None)

    def insert(self, entity: int, component) -> None:
        self.components.setdefault(type(component), {})[entity] = component

    def remove(self, entity: int, ctype: type):
        return self.components.get(ctype, {}).pop(entity, None)

    def get(self, entity: int, ctype: Type[T]) -> Optional[T]:
        return self.components.get(ctype, {}).get(entity)

    def query(self, *ctypes):
        """Iterate (entity, comp1, comp2, ...) for entities with all types."""
        if not ctypes:
            return
        stores = [self.components.get(t, {}) for t in ctypes]
        smallest = min(stores, key=len)
        for e in list(smallest.keys()):
            vals = []
            ok = True
            for s in stores:
                v = s.get(e)
                if v is None:
                    ok = False
                    break
                vals.append(v)
            if ok:
                yield (e, *vals)

    # -- resources -----------------------------------------------------
    def insert_resource(self, resource) -> None:
        self.resources[type(resource)] = resource

    def resource(self, rtype: Type[T]) -> T:
        return self.resources[rtype]

    def get_resource(self, rtype: Type[T]) -> Optional[T]:
        return self.resources.get(rtype)


class App:
    """Staged system runner; ``update()`` is one frame (app.update() in
    run_rendering_loop, src/lib.rs:498)."""

    def __init__(self):
        self.world = World()
        self._systems: Dict[Stage, List[Callable[[World], None]]] = {
            s: [] for s in Stage
        }
        self._startup: Dict[StartupStage, List[Callable[[World], None]]] = {
            s: [] for s in StartupStage
        }
        self._started = False

    def add_system(self, stage: Stage, fn: Callable[[World], None]) -> "App":
        self._systems[stage].append(fn)
        return self

    def add_startup_system(
        self, fn: Callable[[World], None], stage: StartupStage = StartupStage.STARTUP
    ) -> "App":
        self._startup[stage].append(fn)
        return self

    def add_plugin(self, plugin) -> "App":
        plugin.build(self)
        return self

    def update(self) -> None:
        if not self._started:
            for s in StartupStage:
                for fn in self._startup[s]:
                    fn(self.world)
            self._started = True
        for stage in Stage:
            for fn in self._systems[stage]:
                fn(self.world)

    def run(self, frames: int) -> None:
        for _ in range(frames):
            self.update()
