"""CPU frustum culling: bounding spheres now, SAT OBB refinement included.

Vectorized ports of renderer-core/src/culling.rs:
  * ``sphere_culling_params`` / ``test_bounding_spheres``: frustum planes
    extracted from the view-projection matrix (Gribb-Hartmann, the
    niagara-style construction in culling.rs:345-359) and tested against
    many spheres at once — the reference tests one primitive at a time in
    a hot loop; we do the whole scene as one numpy expression.
  * ``test_obbs_sat``: separating-axis OBB vs frustum test
    (culling.rs:75-334), optional per-primitive refinement.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..math3d import quat_to_mat3


@dataclass
class BoundingSphereParams:
    planes: np.ndarray  # (P, 4) world-space planes, normal . x + d >= 0 inside


def sphere_culling_params(view_proj: np.ndarray, infinite_far: bool = True):
    """Extract frustum planes from a view-projection matrix (row-major,
    clip = M @ [x,1]; wgpu z in [0, 1])."""
    m = np.asarray(view_proj, np.float64)
    rows = []
    rows.append(m[3] + m[0])  # left:   x >= -w
    rows.append(m[3] - m[0])  # right:  x <= w
    rows.append(m[3] + m[1])  # bottom
    rows.append(m[3] - m[1])  # top
    rows.append(m[2])  # near for z >= 0 convention (covers reverse-z too)
    if not infinite_far:
        rows.append(m[3] - m[2])
    planes = np.stack(rows)
    n = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    planes = planes / np.where(n == 0, 1.0, n)
    return BoundingSphereParams(planes=planes.astype(np.float32))


def test_bounding_spheres(
    centers: np.ndarray, radii: np.ndarray, params: BoundingSphereParams
) -> np.ndarray:
    """(N,) bool visibility for N spheres (world space)."""
    d = centers @ params.planes[:, :3].T + params.planes[None, :, 3]
    return np.all(d >= -radii[:, None], axis=1)


def test_obbs_sat(
    bbox_min: np.ndarray,  # (N, 3) model-space boxes
    bbox_max: np.ndarray,
    sim8: np.ndarray,  # (N, 8) world transforms
    params: BoundingSphereParams,
) -> np.ndarray:
    """Conservative OBB-vs-frustum: project the 8 transformed corners of
    each box onto every frustum plane (a cheaper but still exact-for-planes
    variant of the reference's SAT test — it omits the cross-axis tests of
    culling.rs:75-334 which only remove a sliver of false positives)."""
    n = len(bbox_min)
    if n == 0:
        return np.zeros(0, bool)
    corners = np.stack(
        [
            np.where(
                np.array([(i >> k) & 1 for k in range(3)], bool), bbox_max[j], bbox_min[j]
            )
            for j in range(n)
            for i in range(8)
        ]
    ).reshape(n, 8, 3)
    rot = quat_to_mat3(sim8[:, 4:8])  # (N, 3, 3)
    world = (
        sim8[:, None, 0:3]
        + sim8[:, None, 3:4] * np.einsum("nij,nkj->nki", rot, corners)
    )
    d = (
        np.einsum("nkc,pc->nkp", world, params.planes[:, :3])
        + params.planes[None, None, :, 3]
    )
    # Box visible iff no plane has all 8 corners outside.
    return ~np.any(np.all(d < 0, axis=1), axis=1)


# ---------------------------------------------------------------------------
# Exact SAT OBB-vs-frustum culling (test_using_separating_axis_theorem,
# culling.rs:75-334; the "improved frustum culling" construction with ~zero
# false positives). Vectorized over N boxes.
# ---------------------------------------------------------------------------


@dataclass
class CullingFrustum:
    """View-space frustum description (culling.rs:49-68)."""

    near_right: float
    near_top: float
    near_plane: float  # negative z
    far_plane: float  # negative z

    @staticmethod
    def new(vertical_fov: float, aspect_ratio: float, near: float, far: float):
        tan_fov = np.tan(0.5 * vertical_fov)
        return CullingFrustum(
            near_right=aspect_ratio * near * tan_fov,
            near_top=near * tan_fov,
            near_plane=-near,
            far_plane=-far,
        )


def test_obbs_sat_exact(
    bbox_min: np.ndarray,  # (N, 3)
    bbox_max: np.ndarray,  # (N, 3)
    sim8: np.ndarray,  # (N, 8) world transforms
    view: np.ndarray,  # (4, 4)
    frustum: CullingFrustum,
) -> np.ndarray:
    """(N,) visibility. Separating axes: near/far, the 4 frustum planes,
    the 3 OBB axes, R x A_i, U x A_i, and the 4 frustum edges x A_i."""
    n = len(bbox_min)
    if n == 0:
        return np.zeros(0, bool)
    z_near, z_far = frustum.near_plane, frustum.far_plane
    x_near, y_near = frustum.near_right, frustum.near_top

    # OBB in view space from 4 transformed corners (culling.rs:88-126).
    mn, mx = bbox_min, bbox_max
    corners = np.stack(
        [
            mn,
            np.stack([mx[:, 0], mn[:, 1], mn[:, 2]], -1),
            np.stack([mn[:, 0], mx[:, 1], mn[:, 2]], -1),
            np.stack([mn[:, 0], mn[:, 1], mx[:, 2]], -1),
        ],
        axis=1,
    )  # (N, 4, 3)
    from ..math3d import similarity_apply

    world = similarity_apply(sim8[:, None, :], corners)
    view_c = world @ view[:3, :3].T + view[:3, 3]
    axes = view_c[:, 1:4] - view_c[:, 0:1]  # (N, 3axes, 3)
    extents = np.linalg.norm(axes, axis=-1)  # (N, 3)
    safe = np.where(extents == 0, 1.0, extents)
    axes = axes / safe[..., None]
    center = view_c[:, 0] + 0.5 * (view_c[:, 1] + view_c[:, 2] + view_c[:, 3] - 3 * view_c[:, 0])
    extents = extents * 0.5

    visible = np.ones(n, bool)

    def axis_test(m, m_dot_c=None):
        """m: (N, K, 3) candidate axes; update `visible` in place."""
        nonlocal visible
        mdx = np.abs(m[..., 0])
        mdy = np.abs(m[..., 1])
        mdz = m[..., 2]
        if m_dot_c is None:
            mdc = np.einsum("nkc,nc->nk", m, center)
        else:
            mdc = m_dot_c
        radius = np.sum(
            np.abs(np.einsum("nkc,nac->nka", m, axes)) * extents[:, None, :],
            axis=-1,
        )
        obb_min = mdc - radius
        obb_max = mdc + radius
        p = x_near * mdx + y_near * mdy
        tau0 = z_near * mdz - p
        tau1 = z_near * mdz + p
        tau0 = np.where(tau0 < 0.0, tau0 * (z_far / z_near), tau0)
        tau1 = np.where(tau1 > 0.0, tau1 * (z_far / z_near), tau1)
        degenerate = (mdx < 1e-4) & (mdy < 1e-4) & (np.abs(mdz) < 1e-4)
        separated = (obb_min > tau1) | (obb_max < tau0)
        visible &= ~np.any(separated & ~degenerate, axis=1)

    # near/far (m = +z)
    radius_z = np.sum(np.abs(axes[..., 2]) * extents, axis=-1)
    obb_min = center[:, 2] - radius_z
    obb_max = center[:, 2] + radius_z
    visible &= ~((obb_min > z_near) | (obb_max < z_far))

    # the 4 frustum plane normals (culling.rs:148-153)
    planes = np.array(
        [
            [z_near, 0.0, x_near],
            [-z_near, 0.0, x_near],
            [0.0, -z_near, y_near],
            [0.0, z_near, y_near],
        ],
        np.float32,
    )
    axis_test(np.broadcast_to(planes, (n, 4, 3)))

    # OBB axes themselves — radius is just the extent (culling.rs:186-213)
    mdc = np.einsum("nkc,nc->nk", axes, center)
    mdx = np.abs(axes[..., 0])
    mdy = np.abs(axes[..., 1])
    mdz = axes[..., 2]
    p = x_near * mdx + y_near * mdy
    tau0 = z_near * mdz - p
    tau1 = z_near * mdz + p
    tau0 = np.where(tau0 < 0.0, tau0 * (z_far / z_near), tau0)
    tau1 = np.where(tau1 > 0.0, tau1 * (z_far / z_near), tau1)
    visible &= ~np.any(
        (mdc - extents > tau1) | (mdc + extents < tau0), axis=1
    )

    # R x A_i = (0, -a.z, a.y) and U x A_i = (a.z, 0, -a.x)
    zeros = np.zeros_like(axes[..., 0])
    axis_test(np.stack([zeros, -axes[..., 2], axes[..., 1]], axis=-1))
    axis_test(np.stack([axes[..., 2], zeros, -axes[..., 0]], axis=-1))

    # frustum edges x A_i (culling.rs:285-333)
    edges = np.array(
        [
            [-x_near, 0.0, z_near],
            [x_near, 0.0, z_near],
            [0.0, y_near, z_near],
            [0.0, -y_near, z_near],
        ],
        np.float32,
    )
    for a_i in range(3):
        m = np.cross(edges[None, :, :], axes[:, a_i][:, None, :])
        axis_test(m)

    return visible
