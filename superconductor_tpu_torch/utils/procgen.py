"""Procedural test content: UV spheres, checker textures, PBR materials.

This repository has no DamagedHelmet.glb, so the benchmark scene is
a procedural stand-in with comparable workload: a ~15k-triangle UV sphere
with full PBR material textures (albedo/normal/metallic-roughness/emissive)
— the same per-pixel shading cost and triangle density as the BASELINE.json
north-star scene.
"""

from __future__ import annotations

import numpy as np

from ..math3d import Similarity
from ..scene.scene import (
    MaterialSettings,
    Model,
    Primitive,
    PrimitiveLod,
    Scene,
    TEXFLAG_SRGB,
    build_mip_chain,
)


def uv_sphere(stacks: int = 88, slices: int = 88, radius: float = 1.0):
    """Positions/normals/uvs/indices for a UV sphere.

    stacks x slices of 88 gives 2*88*88 = 15,488 triangles — DamagedHelmet
    has 15,452.
    """
    phi = np.linspace(0, np.pi, stacks + 1)
    theta = np.linspace(0, 2 * np.pi, slices + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(pp) * np.cos(tt)
    y = np.cos(pp)
    z = np.sin(pp) * np.sin(tt)
    positions = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32) * radius
    normals = positions / radius
    u = (tt / (2 * np.pi)).reshape(-1)
    v = (pp / np.pi).reshape(-1)
    uvs = np.stack([u, v], axis=-1).astype(np.float32)

    idx = np.arange((stacks + 1) * (slices + 1)).reshape(stacks + 1, slices + 1)
    a = idx[:-1, :-1]
    b = idx[1:, :-1]
    c = idx[1:, 1:]
    d = idx[:-1, 1:]
    # Outward CCW winding (viewed from outside).
    t1 = np.stack([a, d, b], axis=-1).reshape(-1, 3)
    t2 = np.stack([b, d, c], axis=-1).reshape(-1, 3)
    indices = np.concatenate([t1, t2]).astype(np.uint32).reshape(-1)
    return positions, normals.astype(np.float32), uvs, indices


def checker_texture(size: int = 512, tiles: int = 16, c0=(200, 60, 40), c1=(240, 230, 220)):
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((xx * tiles // size) + (yy * tiles // size)) % 2 == 0
    img = np.where(mask[..., None], np.array(c0, np.uint8), np.array(c1, np.uint8))
    return np.concatenate([img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def noise_normal_map(size: int = 512, strength: float = 0.4, seed: int = 7):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(size, size)).astype(np.float32)
    # blur to get smooth bumps
    for _ in range(4):
        h = (np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 4
    dx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * strength
    dy = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * strength
    n = np.stack([-dx, -dy, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = np.clip((n * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def mr_texture(size: int = 512):
    """Metallic-roughness: roughness in G varies, metallic in B varies."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    g = (yy * 255 // size).astype(np.uint8)
    b = ((xx * 2 % size) * 255 // size).astype(np.uint8)
    r = np.zeros_like(g)
    a = np.full_like(g, 255)
    return np.stack([r, g, b, a], axis=-1)


def add_pbr_sphere(scene: Scene, stacks: int = 88, slices: int = 88, name: str = "sphere") -> Model:
    """Insert the benchmark sphere + full PBR material set into the scene."""
    albedo = scene.textures.add_texture(
        build_mip_chain(checker_texture()), flags=TEXFLAG_SRGB
    )
    normal = scene.textures.add_texture(build_mip_chain(noise_normal_map()))
    mr = scene.textures.add_texture(build_mip_chain(mr_texture()))
    mat = scene.add_material(
        MaterialSettings(
            base_color_factor=(1.0, 1.0, 1.0, 1.0),
            metallic_factor=1.0,
            roughness_factor=1.0,
            albedo_tex=albedo,
            normal_tex=normal,
            metallic_roughness_tex=mr,
        )
    )
    pos, nrm, uv, idx = uv_sphere(stacks, slices)
    first, count, fv, vc = scene.insert_static_mesh(
        pos, nrm, uv, np.zeros_like(uv), idx, mat
    )
    prim = Primitive(
        material=mat,
        blend_mode=0,
        double_sided=False,
        animated=False,
        lods=[PrimitiveLod(first_index=first, index_count=count, first_vertex=fv, vertex_count=vc)],
        bounding_sphere_radius=1.0,
        bbox_min=pos.min(0),
        bbox_max=pos.max(0),
    )
    prim.transform = Similarity.identity()
    model = Model(primitives=[prim])
    model.bounding_sphere_radius = 1.0
    scene.models[name] = model
    return model


def gradient_cubemap(scene: Scene, size: int = 64) -> int:
    """Simple sky: vertical gradient + sun blob, 6 faces into the HDR pool.
    Returns the base texture id (faces consecutive)."""
    faces = []
    for face in range(6):
        uu, vv = np.meshgrid(
            np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="xy"
        )
        # face direction math mirrors ops/texture.py sample_cubemap
        if face == 0:
            d = np.stack([np.ones_like(uu), -vv, -uu], -1)
        elif face == 1:
            d = np.stack([-np.ones_like(uu), -vv, uu], -1)
        elif face == 2:
            d = np.stack([uu, np.ones_like(uu), vv], -1)
        elif face == 3:
            d = np.stack([uu, -np.ones_like(uu), -vv], -1)
        elif face == 4:
            d = np.stack([uu, -vv, np.ones_like(uu)], -1)
        else:
            d = np.stack([-uu, -vv, -np.ones_like(uu)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        sky = np.array([0.35, 0.55, 0.95]) * (0.5 + 0.5 * d[..., 1:2].clip(0, 1))
        ground = np.array([0.25, 0.22, 0.2])
        col = np.where(d[..., 1:2] > 0, sky, ground[None, None])
        sun_dir = np.array([0.5, 0.6, 0.3])
        sun_dir /= np.linalg.norm(sun_dir)
        sun = np.clip((d @ sun_dir - 0.995) * 200, 0, 1)[..., None] * np.array(
            [20.0, 18.0, 15.0]
        )
        rgba = np.concatenate(
            [(col + sun).astype(np.float32), np.ones((size, size, 1), np.float32)],
            axis=-1,
        )
        faces.append(rgba)
    base = None
    for f in faces:
        tid = scene.textures_hdr.add_texture([f], wrap=1)
        if base is None:
            base = tid
    # record as the scene's IBL cubemap so EnvBindings.from_scene picks
    # it up (incl. the static skybox placement)
    scene.ibl_cubemap_base = base
    return base


def default_ambient_sh():
    """A daylight-ish constant SH (L0 + mild directional L1/L0 ratios)."""
    return (
        0.9, 0.9, 1.0,   # L0 rgb
        0.25, 0.22, 0.2,  # L1x/L0
        0.4, 0.4, 0.38,   # L1y/L0 (sky above)
        0.15, 0.15, 0.12,  # L1z/L0
    )


def skinned_tube_mesh(
    segments: int = 64,
    slices: int = 48,
    length: float = 2.0,
    radius: float = 0.25,
    num_joints: int = 8,
):
    """An open cylinder along +y whose vertices are skinned to the two
    nearest joints of a chain — the procedural analog of a skinned glTF
    (animated_vertex 4-joint weighted path, shaders/src/lib.rs:64-127).

    Returns (pos, nrm, uv, joint_indices (V,4) i32, joint_weights (V,4) f32,
    indices)."""
    ys = np.linspace(0.0, length, segments + 1, dtype=np.float32)
    # slices+1 columns: the seam ring is duplicated with u=1.0 so the wrap
    # quad interpolates u forward instead of smearing the whole texture back
    # through one column (same trick as uv_sphere's endpoint=True).
    cols = slices + 1
    ang = np.linspace(0.0, 2.0 * np.pi, cols, endpoint=True, dtype=np.float32)
    ca, sa = np.cos(ang), np.sin(ang)
    # rings: (segments+1, cols, 3)
    pos = np.stack(
        [
            np.broadcast_to(radius * ca, (segments + 1, cols)),
            np.broadcast_to(ys[:, None], (segments + 1, cols)),
            np.broadcast_to(radius * sa, (segments + 1, cols)),
        ],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    nrm = np.stack(
        [
            np.broadcast_to(ca, (segments + 1, cols)),
            np.zeros((segments + 1, cols), np.float32),
            np.broadcast_to(sa, (segments + 1, cols)),
        ],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    uv = np.stack(
        [
            np.broadcast_to(ang / (2.0 * np.pi), (segments + 1, cols)),
            np.broadcast_to(ys[:, None] / length, (segments + 1, cols)),
        ],
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)

    # 2-joint linear blend between the chain joints bracketing each ring.
    seg_len = length / (num_joints - 1)
    f = pos[:, 1] / seg_len
    j0 = np.clip(np.floor(f).astype(np.int32), 0, num_joints - 2)
    w1 = np.clip(f - j0, 0.0, 1.0).astype(np.float32)
    joint_indices = np.zeros((len(pos), 4), np.int32)
    joint_indices[:, 0] = j0
    joint_indices[:, 1] = j0 + 1
    joint_weights = np.zeros((len(pos), 4), np.float32)
    joint_weights[:, 0] = 1.0 - w1
    joint_weights[:, 1] = w1

    # quads between adjacent rings (the duplicated seam column closes the
    # loop); CCW from outside so the faces wind with the outward normals
    i = np.arange(segments)[:, None]
    j = np.arange(slices)[None, :]
    jn = j + 1
    v00 = i * cols + j
    v01 = i * cols + jn
    v10 = (i + 1) * cols + j
    v11 = (i + 1) * cols + jn
    tris = np.stack(
        [v00, v11, v01, v00, v10, v11], axis=-1
    ).reshape(-1).astype(np.uint32)
    return pos, nrm, uv, joint_indices, joint_weights, tris


def add_skinned_tube(
    scene: Scene,
    segments: int = 64,
    slices: int = 48,
    length: float = 2.0,
    radius: float = 0.25,
    num_joints: int = 8,
    name: str = "tube",
) -> Model:
    """Insert a skinned tube (animated mega-buffers) with a PBR material."""
    albedo = scene.textures.add_texture(
        build_mip_chain(checker_texture(tiles=8, c0=(60, 120, 220), c1=(230, 235, 240))),
        flags=TEXFLAG_SRGB,
    )
    mat = scene.add_material(
        MaterialSettings(
            base_color_factor=(1.0, 1.0, 1.0, 1.0),
            metallic_factor=0.0,
            roughness_factor=0.8,
            albedo_tex=albedo,
        )
    )
    pos, nrm, uv, ji, jw, idx = skinned_tube_mesh(
        segments, slices, length, radius, num_joints
    )
    first, count, fv, vc = scene.insert_animated_mesh(
        pos, nrm, uv, ji, jw, idx, mat
    )
    r = float(np.linalg.norm(pos, axis=1).max())
    prim = Primitive(
        material=mat,
        blend_mode=0,
        double_sided=True,  # open tube: both sides visible when it bends
        animated=True,
        lods=[PrimitiveLod(first_index=first, index_count=count,
                           first_vertex=fv, vertex_count=vc)],
        bounding_sphere_radius=r,
        bbox_min=pos.min(0),
        bbox_max=pos.max(0),
    )
    model = Model(primitives=[prim], animated=True, num_joints=num_joints)
    model.bounding_sphere_radius = r
    scene.models[name] = model
    return model


def wave_joint_palettes(
    ts, num_joints: int = 8, length: float = 2.0, amp: float = 0.4
) -> np.ndarray:
    """(T, J, 8) waving-chain palettes for a batch of phases: each joint
    rotates about z by a phase-shifted sine, composed FK parent-to-child,
    times the inverse bind (the host analog of AnimationJoints::iter,
    animation.rs:138-164) — batched over instances so per-frame palette
    sampling is numpy-wide, not per-joint Python (the scalar Similarity loop
    cost ~5 ms/frame for 6 tubes; this is ~50x cheaper)."""
    from ..math3d import quat_mul, quat_rotate

    ts = np.atleast_1d(np.asarray(ts, np.float32))
    T = len(ts)
    seg = length / (num_joints - 1)

    # Fast path: express the wave as per-node locals and run the batched
    # native hierarchy walk (sc_joint_update) — the same FK the engine's
    # AnimationJoints does, ~20x cheaper than the numpy chain loop below.
    from ..animation import joint_palettes_batch

    J = num_joints
    half = 0.5 * amp * np.sin(
        1.7 * ts[:, None] + 0.9 * np.arange(J, dtype=np.float32)[None, :]
    )
    lr = np.zeros((T, J, 4), np.float32)
    lr[..., 2] = np.sin(half)
    lr[..., 3] = np.cos(half)
    lt = np.zeros((T, J, 3), np.float32)
    lt[:, 1:, 1] = seg
    ls = np.ones((T, J), np.float32)
    ib = np.zeros((J, 8), np.float32)
    ib[:, 1] = -seg * np.arange(J, dtype=np.float32)
    ib[:, 3] = 1.0
    ib[:, 7] = 1.0
    out = joint_palettes_batch(
        lt, ls, lr,
        np.zeros(1, np.int32),
        np.arange(J - 1, dtype=np.int32),
        np.arange(1, J, dtype=np.int32),
        np.arange(J), ib,
    )
    if out is not None:
        return out

    step = np.broadcast_to(np.array([0.0, seg, 0.0], np.float32), (T, 3))
    gt = np.zeros((T, 3), np.float32)
    gq = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (T, 1))
    rows = np.zeros((T, num_joints, 8), np.float32)
    zeros = np.zeros(T, np.float32)
    for j in range(num_joints):
        half = 0.5 * amp * np.sin(1.7 * ts + 0.9 * j)
        lq = np.stack([zeros, zeros, np.sin(half), np.cos(half)], -1)
        if j:
            # parent-frame offset first, then accumulate this joint's spin
            # ((t1,q1)*(t2,q2): t = t1 + rot(q1, t2); q = q1*q2, scale 1)
            gt = gt + quat_rotate(gq, step)
        gq = quat_mul(gq, lq).astype(np.float32)
        ti = np.broadcast_to(np.array([0.0, -j * seg, 0.0], np.float32), (T, 3))
        rows[:, j, 0:3] = gt + quat_rotate(gq, ti)
        rows[:, j, 3] = 1.0
        rows[:, j, 4:8] = gq
    return rows


def wave_joint_palette(
    t: float, num_joints: int = 8, length: float = 2.0, amp: float = 0.4
) -> np.ndarray:
    """(J, 8) single-phase convenience wrapper over wave_joint_palettes."""
    return wave_joint_palettes([t], num_joints, length, amp)[0]
