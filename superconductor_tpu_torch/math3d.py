"""3D math: quaternions, Similarity transforms, matrices (the port's copy
of ``superconductor_tpu/math3d.py``).

The reference engine composes all rigid transforms as ``Similarity``
(translation + uniform scale + rotation quaternion; 8 floats) rather than
4x4 matrices. Host-side math (Similarity, look_at, projections, culling
inputs) is numpy. ``quat_rotate`` and ``similarity_apply`` take numpy
arrays or torch tensors, dispatching on the argument's type as the
reference dispatches numpy or jax.numpy through ``_xp`` (math3d.py:26-33);
their expressions keep the reference's operand order term for term.

Conventions:
  * quaternions are (x, y, z, w), matching glTF and glam.
  * matrices are row-major numpy arrays; ``mat @ v`` with column vectors.
  * clip space is wgpu-style: x,y in [-1,1], z in [0,1] (reverse-z: 1 near).
"""

from __future__ import annotations

import numpy as np
import torch


def _stack(parts, like):
    """Stack on a new last axis: torch.stack for a torch tensor `like`, else
    np.stack."""
    if isinstance(like, torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

QUAT_IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def quat_mul(a, b):
    """Hamilton product a*b. Supports leading batch dims."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conj(q):
    return np.stack([-q[..., 0], -q[..., 1], -q[..., 2], q[..., 3]], axis=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4), numpy arrays or
    torch tensors alike.

    Uses the optimized form t = 2*cross(q.xyz, v); v' = v + q.w*t + cross(q.xyz, t)
    (no trig, 18 mul + 12 add), term for term the reference's order, so the
    port's vertex stage rounds the way the reference's does.
    """
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    # t = 2 * cross(q.xyz, v)
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    # v + w*t + cross(q.xyz, t)
    rx = vx + qw * tx + (qy * tz - qz * ty)
    ry = vy + qw * ty + (qz * tx - qx * tz)
    rz = vz + qw * tz + (qx * ty - qy * tx)
    return _stack([rx, ry, rz], v)


def quat_normalize(q):
    n = np.sqrt((q * q).sum(axis=-1, keepdims=True))
    return q / n


def quat_slerp(a, b, t):
    """Spherical interpolation with shortest-path sign fix (host-side; scalar t)."""
    dot = (a * b).sum(axis=-1, keepdims=True)
    b = np.where(dot < 0.0, -b, b)
    dot = abs(dot)
    # Fall back to nlerp when nearly parallel.
    theta = np.arccos(np.clip(np.asarray(dot, dtype=np.float64), -1.0, 1.0))
    sin_theta = np.sin(theta)
    near = sin_theta < 1e-5
    wa = np.where(near, 1.0 - t, np.sin((1.0 - t) * theta) / np.where(near, 1.0, sin_theta))
    wb = np.where(near, t, np.sin(t * theta) / np.where(near, 1.0, sin_theta))
    return quat_normalize(a * wa.astype(np.float32) + b * wb.astype(np.float32))


def quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float32)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return np.array(
        [axis[0] * s, axis[1] * s, axis[2] * s, np.cos(angle / 2.0)], dtype=np.float32
    )


def quat_to_mat3(q):
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1)
    row1 = np.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1)
    row2 = np.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def mat3_to_quat(m):
    """3x3 rotation matrix -> quaternion (host-side, numpy only)."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], dtype=np.float32)
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# Similarity: translation (3) + scale (1) + rotation quat (4), SoA-friendly.
# ---------------------------------------------------------------------------


class Similarity:
    """Host-side similarity transform (translation + uniform scale + quat).

    Mirrors the reference's 8-float transform (gltf-helpers/src/lib.rs:9-104):
    composition is ``(t1, s1, r1) * (t2, s2, r2) = (t1 + s1*(r1*t2), s1*s2,
    r1*r2)`` and point application is ``t + s*(r*p)``. Non-uniform glTF node
    scales are collapsed to their maximum component, as the reference does
    (gltf-helpers/src/lib.rs:44-59).
    """

    __slots__ = ("translation", "scale", "rotation")

    def __init__(self, translation=None, scale=1.0, rotation=None):
        self.translation = (
            np.zeros(3, dtype=np.float32)
            if translation is None
            else np.asarray(translation, dtype=np.float32)
        )
        self.scale = float(scale)
        self.rotation = (
            QUAT_IDENTITY.copy()
            if rotation is None
            else np.asarray(rotation, dtype=np.float32)
        )

    @staticmethod
    def identity() -> "Similarity":
        return Similarity()

    def __mul__(self, other: "Similarity") -> "Similarity":
        return Similarity(
            translation=self.apply_point(other.translation),
            scale=self.scale * other.scale,
            rotation=quat_mul(self.rotation, other.rotation),
        )

    def apply_point(self, p):
        return self.translation + self.scale * quat_rotate(self.rotation, p)

    def apply_vector(self, v):
        """Rotate-only (for normals; uniform scale preserves direction)."""
        return quat_rotate(self.rotation, v)

    def inverse(self) -> "Similarity":
        inv_rot = quat_conj(self.rotation)
        inv_scale = 1.0 / self.scale
        return Similarity(
            translation=-inv_scale * quat_rotate(inv_rot, self.translation),
            scale=inv_scale,
            rotation=inv_rot,
        )

    def to_array(self) -> np.ndarray:
        """Pack as 8 floats: [tx, ty, tz, scale, qx, qy, qz, qw]."""
        return np.concatenate(
            [self.translation, [self.scale], self.rotation]
        ).astype(np.float32)

    @staticmethod
    def from_array(a) -> "Similarity":
        a = np.asarray(a, dtype=np.float32)
        return Similarity(a[:3], float(a[3]), a[4:8])

    @staticmethod
    def from_gltf_trs(translation, rotation, scale) -> "Similarity":
        """From glTF node TRS; non-uniform scale collapses to max component."""
        s = np.asarray(scale, dtype=np.float32)
        if not np.allclose(s, s[0], rtol=1e-3, atol=1e-5):
            import logging

            logging.getLogger(__name__).warning(
                "collapsing non-uniform scale %s to %s", s, s.max()
            )
        return Similarity(translation, float(s.max()), rotation)

    @staticmethod
    def from_mat4(m) -> "Similarity":
        """Decompose an affine matrix; assumes uniform-ish scale."""
        m = np.asarray(m, dtype=np.float64)
        basis = m[:3, :3]
        scales = np.linalg.norm(basis, axis=0)
        scale = float(scales.max())
        rot = basis / np.where(scales == 0, 1.0, scales)[None, :]
        return Similarity(m[:3, 3].astype(np.float32), scale, mat3_to_quat(rot))

    def __repr__(self):
        return (
            f"Similarity(t={self.translation.tolist()}, s={self.scale}, "
            f"r={self.rotation.tolist()})"
        )


def similarity_apply(sim8, points):
    """Vectorized Similarity application on packed 8-float arrays.

    sim8: (..., 8) [tx ty tz s qx qy qz qw]; points: (..., 3). Broadcasts.
    Numpy arrays (host culling) or torch tensors (the vertex stage) alike.
    """
    t = sim8[..., 0:3]
    s = sim8[..., 3:4]
    q = sim8[..., 4:8]
    return t + s * quat_rotate(q, points)


def similarity_compose8(a8, b8):
    """Compose packed similarities: result applies b first, then a."""
    t = similarity_apply(a8, b8[..., 0:3])
    s = a8[..., 3:4] * b8[..., 3:4]
    q = quat_mul(a8[..., 4:8], b8[..., 4:8])
    return np.concatenate([t, s, q], axis=-1)


# ---------------------------------------------------------------------------
# Matrices / projections
# ---------------------------------------------------------------------------


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Right-handed view matrix (camera looks down -Z in view space)."""
    eye = np.asarray(eye, dtype=np.float64)
    f = np.asarray(target, dtype=np.float64) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, dtype=np.float64)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def view_from_camera(position, rotation_quat) -> np.ndarray:
    """View matrix from camera position + orientation quaternion.

    Matches the reference camera (src/resources.rs:138-164): the view matrix
    is the inverse of the camera's rigid transform.
    """
    r = quat_to_mat3(np.asarray(rotation_quat, dtype=np.float32))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.T
    m[:3, 3] = -(r.T @ np.asarray(position, dtype=np.float32))
    return m


def perspective_reversed_z_infinite(fov_y, aspect, z_near) -> np.ndarray:
    """Reverse-z infinite-far perspective (wgpu depth range [0,1], 1=near).

    The reference enables reverse-z on desktop (src/lib.rs:406-415) for float
    depth precision; an infinite far plane drops one subtraction and is exact
    in f32. Maps z=-z_near -> depth 1, z=-inf -> depth 0.
    """
    f = 1.0 / np.tan(fov_y / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    # z' = z_near / -z_view  (projective): row2 = [0,0,0,z_near], row3=[0,0,-1,0]
    m[2, 3] = z_near
    m[3, 2] = -1.0
    return m


def perspective_z01(fov_y, aspect, z_near, z_far) -> np.ndarray:
    """Standard forward-z [0,1] perspective (for non-reverse-z paths)."""
    f = 1.0 / np.tan(fov_y / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = z_far / (z_near - z_far)
    m[2, 3] = z_near * z_far / (z_near - z_far)
    m[3, 2] = -1.0
    return m


def mat4_inverse(m) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, dtype=np.float64)).astype(np.float32)
