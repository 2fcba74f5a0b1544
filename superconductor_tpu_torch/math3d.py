"""Torch versions of the reference's device-side transform math.

Mirrors ``superconductor_tpu/math3d.py`` (quat_rotate :64,
similarity_apply :256), which dispatches numpy/jax.numpy through ``_xp``.
The expressions keep the reference's operand order term for term, so the
port's vertex stage rounds the way the reference's does. Host-side math
(Similarity, look_at, projections) is the reference's own, through
``_host.math3d``.
"""

from __future__ import annotations

import torch


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4), (x, y, z, w):
    t = 2*cross(q.xyz, v); v' = v + q.w*t + cross(q.xyz, t)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    rx = vx + qw * tx + (qy * tz - qz * ty)
    ry = vy + qw * ty + (qz * tx - qx * tz)
    rz = vz + qw * tz + (qx * ty - qy * tx)
    return torch.stack([rx, ry, rz], dim=-1)


def similarity_apply(sim8: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Packed Similarity [tx ty tz s qx qy qz qw] applied to points (..., 3):
    t + s * (q * p). Broadcasts."""
    t = sim8[..., 0:3]
    s = sim8[..., 3:4]
    q = sim8[..., 4:8]
    return t + s * quat_rotate(q, points)
