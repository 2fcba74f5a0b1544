"""ECS resources (singletons), mirroring src/resources.rs (the port's copy
of ``superconductor_tpu/ecs/resources.py``).

What the port adds: ``RenderSettings.device`` (where the frame renders,
default "cuda"), ``SceneResource.device_scene`` (the scene's tables kept
resident there, ``scene/upload.py`` DeviceScene) and
``FrameOutput.state`` (the last frame's FrameState).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..assets.fetch import FetchClient, FileClient
from ..render.camera import Camera
from ..render.env import EnvBindings
from ..render.frame import RenderConfig
from ..scene.scene import Scene


@dataclass
class SceneResource:
    scene: Scene
    # the scene's tables on RenderSettings.device, made by the render
    # system on its first frame (DeviceScene)
    device_scene: Optional[object] = None


@dataclass
class CameraResource:
    """resources.rs:138-164."""

    camera: Camera = field(default_factory=Camera)
    fov_y: float = np.radians(59.0)
    z_near: float = 0.05
    ipd: float = 0.064  # interpupillary distance for stereo (num_views=2)


@dataclass
class RenderSettings:
    """Render config + environment bindings resource.

    Overflow semantics: the render system checks bin-pair / k-layer
    overflow stats SYNCHRONOUSLY whenever the config just changed (first
    frame, scene/resolution churn — when overflow typically appears) and
    re-renders before output. In the steady state it reads the PREVIOUS
    frame's stats instead, to avoid a host-device sync every frame — so an
    overflow caused by steady-state scene churn is detected one frame
    late: that single frame is emitted with dropped geometry (with a
    warning logged), and the grown config takes effect on the next frame.

    stats_interval controls how often the steady-state device stats are
    READ on the host: 1 (default) = every frame (full never-drop
    semantics); N > 1 = every Nth frame (overflow detected up to N frames
    late); 0 = never — no device->host transfer of stats happens on the
    frame loop, the plain (stats-free) frame function is used, and
    bin-pair / k-layer overflow detection is OFF (geometry t/v capacities
    still grow from exact host-side counts). In the steady state the
    previous frame's stats arrive by an asynchronous copy to pinned host
    memory, read after its CUDA event, so the read waits for that frame
    only, never for the frame just submitted.

    device: where the scene's tables live and the frame renders.
    """

    config: RenderConfig = field(default_factory=RenderConfig)
    env: Optional[EnvBindings] = None  # rebuilt when scene env changes
    stats_interval: int = 1
    device: str = "cuda"


@dataclass
class HttpClientResource:
    client: FetchClient = field(default_factory=FileClient)
    streamer: Optional[object] = None  # TextureStreamer
    # Texture dimension cap for streamed + scene textures (None = unlimited);
    # the analog of device.limits().max_texture_dimension_2d (textures.rs:716).
    max_texture_size: Optional[int] = None

    def __post_init__(self):
        if self.streamer is None:
            from ..assets.texture_stream import TextureStreamer

            self.streamer = TextureStreamer(
                self.client, max_texture_size=self.max_texture_size
            )


@dataclass
class FrameOutput:
    """Latest rendered frame(s) (V, H, W, 4) u8 tensor."""

    image: object = None
    frame_index: int = 0
    # (stats, config) of the in-flight frame, for the one-frame-late
    # overflow check in systems.render (avoids a per-frame device sync)
    pending_stats: object = None
    last_config: object = None
    # the FrameState the latest image was rendered from
    state: object = None


@dataclass
class FrameTiming:
    """progress_animation_times uses a fixed 1/60 step (systems.rs:76-107)."""

    delta: float = 1.0 / 60.0


@dataclass
class LineBuffer:
    """Debug line accumulation, cleared per frame (clear_line_buffer)."""

    segments: List = field(default_factory=list)
    colors: List = field(default_factory=list)

    def push(self, a, b, color_id: int):
        self.segments.append([a, b])
        self.colors.append(color_id)

    def clear(self):
        self.segments.clear()
        self.colors.clear()


@dataclass
class ParticleBuffer:
    particles: List[dict] = field(default_factory=list)

    def push(self, **kwargs):
        self.particles.append(kwargs)

    def clear(self):
        self.particles.clear()


@dataclass
class EventQueue:
    """resources.rs:30-31."""

    events: List = field(default_factory=list)


@dataclass
class NewIblCubemap:
    """Request to (re)load the IBL cubemap (demo/src/lib.rs:114-119)."""

    url: str


@dataclass
class NewLightvolTextures:
    """Request to (re)load the SH light volume (demo/src/lib.rs:135-192)."""

    urls: List[str]  # [l0, x, y, z]
    bottom_left: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
