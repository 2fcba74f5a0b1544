"""Stereo multiview helpers (port of ``superconductor_tpu/render/stereo.py``):
two eyes' uniforms from one camera, and the side-by-side composite.

Views are the leading axis of the frame (``RenderConfig.num_views=2``),
so the composite is an array concatenation. Host numpy, bit for bit with
the reference.
"""

from __future__ import annotations

import numpy as np

from ..math3d import (
    perspective_reversed_z_infinite,
    perspective_z01,
    quat_rotate,
    view_from_camera,
)
from .camera import Camera, Uniforms, make_stereo_uniforms


def stereo_uniforms_from_camera(
    camera: Camera,
    width: int,
    height: int,
    ipd: float = 0.064,
    fov_y: float = np.pi / 3,
    z_near: float = 0.05,
    reverse_z: bool = True,
    z_far: float | None = None,
) -> Uniforms:
    """Two eye views offset by half the interpupillary distance along the
    camera's local x axis, each eye rendering width x height."""
    right_axis = quat_rotate(camera.rotation, np.array([1.0, 0, 0], np.float32))
    half = 0.5 * ipd * right_axis
    left_eye = camera.position - half
    right_eye = camera.position + half
    if reverse_z:
        proj = perspective_reversed_z_infinite(fov_y, width / height, z_near)
    else:
        proj = perspective_z01(fov_y, width / height, z_near, z_far or 1000.0)
    lv = view_from_camera(left_eye, camera.rotation)
    rv = view_from_camera(right_eye, camera.rotation)
    return make_stereo_uniforms(
        lv, rv, proj, proj, left_eye, right_eye, camera.rotation, camera.rotation
    )


def composite_side_by_side(frames) -> np.ndarray:
    """(2, H, W, 4) -> (H, 2W, 4): left eye left, right eye right. Takes a
    numpy array or a tensor on any device."""
    frames = np.asarray(frames.cpu() if hasattr(frames, "cpu") else frames)
    if frames.shape[0] != 2:
        raise ValueError(f"expected two views, got {frames.shape[0]}")
    return np.concatenate([frames[0], frames[1]], axis=1)
