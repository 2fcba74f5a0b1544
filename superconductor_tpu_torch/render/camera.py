"""Camera and per-frame uniforms.

The reference keeps a stereo Uniforms UBO (left/right matrices selected by
view_index, shared-structs/src/lib.rs:14-121). Here uniforms are a pytree of
small arrays with a leading view axis — single view uses V=1, stereo V=2 and
the whole frame pipeline batches over it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..math3d import (
    QUAT_IDENTITY,
    mat4_inverse,
    perspective_reversed_z_infinite,
    perspective_z01,
    view_from_camera,
)


@dataclass
class Camera:
    """Position + orientation camera (src/resources.rs:138-164)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: QUAT_IDENTITY.copy())

    def view_matrix(self) -> np.ndarray:
        return view_from_camera(self.position, self.rotation)


@dataclass
class Uniforms:
    """Host-built per-frame matrices; all arrays have leading view axis V."""

    view_proj: np.ndarray  # (V, 4, 4)
    view: np.ndarray  # (V, 4, 4)
    view_inverse: np.ndarray  # (V, 4, 4)
    projection: np.ndarray  # (V, 4, 4)
    projection_inverse: np.ndarray  # (V, 4, 4)
    view_inverse_quat: np.ndarray  # (V, 4) camera rotation quat
    eye: np.ndarray  # (V, 3)
    # SH light-volume placement (probes array box, shared-structs lib.rs:38-43)
    probes_bottom_left: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    probes_scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))

    @property
    def num_views(self) -> int:
        return self.view_proj.shape[0]

    def as_device_dict(self) -> dict:
        return {
            "view_proj": self.view_proj,
            "view": self.view,
            "view_inverse": self.view_inverse,
            "projection": self.projection,
            "projection_inverse": self.projection_inverse,
            "view_inverse_quat": self.view_inverse_quat,
            "eye": self.eye,
            "probes_bottom_left": self.probes_bottom_left,
            "probes_scale": self.probes_scale,
        }


def make_uniforms(
    camera: Camera,
    width: int,
    height: int,
    fov_y: float = np.pi / 3.0,
    z_near: float = 0.05,
    reverse_z: bool = True,
    z_far: Optional[float] = None,
) -> Uniforms:
    """Single-view uniforms (update_desktop_uniform_buffers analog,
    src/systems.rs:782-861)."""
    aspect = width / height
    if reverse_z:
        proj = perspective_reversed_z_infinite(fov_y, aspect, z_near)
    else:
        proj = perspective_z01(fov_y, aspect, z_near, z_far or 1000.0)
    view = camera.view_matrix()
    vp = (proj @ view)[None]
    return Uniforms(
        view_proj=vp.astype(np.float32),
        view=view[None].astype(np.float32),
        view_inverse=mat4_inverse(view)[None],
        projection=proj[None].astype(np.float32),
        projection_inverse=mat4_inverse(proj)[None],
        view_inverse_quat=np.asarray(camera.rotation, np.float32)[None],
        eye=np.asarray(camera.position, np.float32)[None],
    )


def make_stereo_uniforms(
    left_view: np.ndarray,
    right_view: np.ndarray,
    left_proj: np.ndarray,
    right_proj: np.ndarray,
    left_eye: np.ndarray,
    right_eye: np.ndarray,
    left_rot_quat: np.ndarray,
    right_rot_quat: np.ndarray,
) -> Uniforms:
    """Stereo uniforms from per-eye poses (update_webxr_uniform_buffers
    analog, src/systems.rs:871-989)."""
    views = np.stack([left_view, right_view]).astype(np.float32)
    projs = np.stack([left_proj, right_proj]).astype(np.float32)
    return Uniforms(
        view_proj=np.einsum("vij,vjk->vik", projs, views).astype(np.float32),
        view=views,
        view_inverse=np.stack([mat4_inverse(v) for v in views]),
        projection=projs,
        projection_inverse=np.stack([mat4_inverse(p) for p in projs]),
        view_inverse_quat=np.stack([left_rot_quat, right_rot_quat]).astype(np.float32),
        eye=np.stack([left_eye, right_eye]).astype(np.float32),
    )
