"""Particle pipeline: camera-facing quads and the 6-way smoke lighting
model (port of ``superconductor_tpu/ops/particles.py``).

Each particle is a view-space quad scaled by (scale.x, scale.y), rastered
by the k-buffer pass and shaded per pixel. Bound smoke textures are
sampled on the smoke pool (both maps in one row gather, the emissive LUT
from its own rows) when the scene publishes it, else per slot from the
LDR pool; without smoke textures the reference shades a procedural radial
puff (its own branch, not a fallback).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry import TriangleSetup, _setup_from_clip, clip_transform, device_values
from .lines import _quad_corner_ids
from .shade import _normalize, sh_channel_vectors
from .texture import (
    TEXFLAG_SRGB,
    _bilinear_core,
    ldr_pool,
    sample_bilinear_level,
    sample_smoke_interleaved,
)
from .tonemap import srgb_to_linear_exact, tonemap_and_encode


class ParticleAttrs(NamedTuple):
    uv: torch.Tensor  # (T, 3, 2) corner uvs
    world_pos: torch.Tensor  # (T, 3, 3) corner world positions
    particle: torch.Tensor  # (T,) particle id
    # (T, 32) f32: adj(9) | uv(6) | world_pos(9) | colour(3) |
    # emissive_colour(3) | lut_y, or -1 without the emissive LUT | which
    # corner is diagonal to corner 0 (0: corner 2, 1: corner 1)
    packed: Optional[torch.Tensor] = None


def particle_geometry(particles: dict, view, view_inverse, projection, width: int,
                      height: int, flip_viewport: bool = False):
    """Particles -> camera-facing quads -> (TriangleSetup, ParticleAttrs)
    (reference ops/particles.py:42). Corners x, y in {-0.5, 0.5}, two
    triangles (0, 1, 2) and (0, 2, 3) per quad, all of the first triangles
    before all of the second."""
    center = particles["center"]
    scale = particles["scale"]
    valid = particles["valid"]
    dev = center.device
    p = center.shape[0]

    c1 = torch.cat([center, torch.ones((p, 1), dtype=center.dtype, device=dev)], dim=-1)
    view_center = clip_transform(c1, view)[:, :3]
    corner_x = device_values([-0.5, 0.5, 0.5, -0.5], torch.float32, dev)
    corner_y = device_values([-0.5, -0.5, 0.5, 0.5], torch.float32, dev)
    vpos = view_center[:, None, :] + torch.stack(
        [scale[:, 0:1] * corner_x[None, :], scale[:, 1:2] * corner_y[None, :],
         torch.zeros((p, 4), dtype=torch.float32, device=dev)],
        dim=-1,
    )
    v1 = torch.cat([vpos, torch.ones((p, 4, 1), dtype=torch.float32, device=dev)], dim=-1)
    clip = clip_transform(v1, projection)
    world = clip_transform(v1, view_inverse)[..., :3]

    # uv: (x + 0.5, 0.5 - y) scaled and offset
    u = particles["uv_offset"][:, None, 0] + (corner_x + 0.5)[None, :] * particles["uv_scale"][:, None, 0]
    v = particles["uv_offset"][:, None, 1] + (0.5 - corner_y)[None, :] * particles["uv_scale"][:, None, 1]
    uv = torch.stack([u, v], dim=-1)  # (P, 4, 2)

    ia = device_values([0, 1, 2], torch.int64, dev)
    ib = device_values([0, 2, 3], torch.int64, dev)
    clip_t = torch.cat([clip[:, ia], clip[:, ib]])
    world_t = torch.cat([world[:, ia], world[:, ib]])
    uv_t = torch.cat([uv[:, ia], uv[:, ib]])
    valid_t = torch.cat([valid, valid])
    pid = torch.cat([torch.arange(p, device=dev), torch.arange(p, device=dev)]).to(torch.int32)

    setup, tvalid, bbox = _setup_from_clip(
        clip_t, valid_t, torch.ones_like(valid_t), width, height, flip_viewport,
        vertex_ids=_quad_corner_ids(p, dev),
    )
    t = clip_t.shape[0]
    tri_setup = TriangleSetup(
        setup=setup, tri_id=torch.arange(t, dtype=torch.int32, device=dev), inst_id=pid,
        bbox=bbox, valid=tvalid, num_valid=tvalid.sum(dtype=torch.int32),
    )
    lut_packed = torch.where(particles["use_emissive_lut"] != 0, particles["lut_y"], -1.0)
    per_particle = torch.cat(
        [particles["colour"], particles["emissive_colour"], lut_packed[:, None]], dim=1
    )
    csel = torch.cat([torch.zeros((p, 1), device=dev), torch.ones((p, 1), device=dev)])
    packed = torch.cat(
        [setup[:, 0:9], uv_t.reshape(t, 6), world_t.reshape(t, 9),
         per_particle[pid.long()], csel],
        dim=1,
    )
    return tri_setup, ParticleAttrs(uv=uv_t, world_pos=world_t, particle=pid, packed=packed)


def _norm(v):
    """Euclidean norm over the last axis as sqrt(sum(v * v))."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def shade_particles(pair, px, py, tri: TriangleSetup, attrs: ParticleAttrs,
                    particles: dict, scene: dict, uniforms: dict, env, view_index: int,
                    sh_sampler, inline_tonemapping: bool = True,
                    inline_srgb: bool = True):
    """Per-pixel particle shading -> (rgb display-encoded, alpha)
    (reference ops/particles.py:166): barycentrics from the quad
    triangle's setup edges, SH lighting at the interpolated world position,
    the six-way light maps and emissive mask from the smoke maps (or a
    radial puff without them), the emission from the LUT where the
    particle asks for it."""
    valid = pair >= 0
    idx = torch.clamp_min(pair, 0).long()
    if attrs.packed is not None:
        row = attrs.packed[idx]  # (P, 32)
        adj = row[:, 0:9].reshape(-1, 3, 3)
        uv_v = row[:, 9:15].reshape(-1, 3, 2)
        wp_v = row[:, 15:24].reshape(-1, 3, 3)
        p_colour = row[:, 24:27]
        p_emissive = row[:, 27:30]
        p_use_lut = row[:, 30] >= 0.0
        p_lut_y = torch.clamp_min(row[:, 30], 0.0)
        partner = torch.where(row[:, 31:32] > 0.5, wp_v[:, 1], wp_v[:, 2])
        p_center = 0.5 * (wp_v[:, 0] + partner)
    else:
        adj = tri.setup[idx, 0:9].reshape(-1, 3, 3)
        uv_v = attrs.uv[idx]
        wp_v = attrs.world_pos[idx]
        pid = attrs.particle[idx].long()
        p_colour = particles["colour"][pid]
        p_emissive = particles["emissive_colour"][pid]
        p_use_lut = particles["use_emissive_lut"][pid] != 0
        p_lut_y = particles["lut_y"][pid]
        p_center = particles["center"][pid]
    e = adj[:, :, 0] * px[:, None] + adj[:, :, 1] * py[:, None] + adj[:, :, 2]
    d_val = torch.sum(e, dim=-1)
    bary = e / torch.where(d_val == 0, 1.0, d_val)[:, None]
    uv = torch.sum(uv_v * bary[..., None], dim=-2)
    world_pos = torch.sum(wp_v * bary[..., None], dim=-2)

    eye = uniforms["eye"][view_index]
    normal = _normalize(eye[None, :] - p_center)
    sh = sh_sampler(world_pos)

    n = pair.shape[0]
    dev = pair.device
    smoke_static = env.smoke_static
    use_smoke_pool = (
        env.smoke_tex_ids is not None and smoke_static is not None and "smoke_ab" in scene
    )
    if use_smoke_pool:
        s8 = sample_smoke_interleaved(scene["smoke_ab"], smoke_static[0], smoke_static[1],
                                      smoke_static[2], uv)
        smoke_a, smoke_b = s8[..., 0:4], s8[..., 4:8]
    elif env.smoke_tex_ids is not None:
        # the smoke maps sampled per slot from the LDR pool, level 0
        lvl = torch.zeros(n, dtype=torch.int32, device=dev)
        smoke_a, smoke_b = (
            sample_bilinear_level(ldr_pool(scene), scene["tex"],
                                  torch.full((n,), t, dtype=torch.int32, device=dev),
                                  uv, lvl, False)
            for t in env.smoke_tex_ids[:2]
        )
    else:
        # no smoke textures bound: a round puff, alpha from the radial falloff
        fall = torch.clamp(1.0 - 2.0 * _norm(uv - 0.5), 0.0, 1.0)
        smoke_a = smoke_b = torch.stack([fall * 0.5] * 3 + [fall], dim=-1)
    left, bottom, front, emissive_s = (smoke_a[..., i] for i in range(4))
    right, top, back, alpha = (smoke_b[..., i] for i in range(4))

    red, green, blue = sh_channel_vectors(sh)
    avg_vec = (red + green + blue) / 3.0
    rgb_len = torch.stack([_norm(red), _norm(green), _norm(blue)], dim=-1)
    avg_len = torch.mean(rgb_len, dim=-1, keepdim=True)
    avg_dir = avg_vec / torch.clamp_min(avg_len, 1e-8)

    # cotangent frame of a screen-aligned quad: position derivatives are
    # the camera's right / down axes, uv derivatives (+du, 0) and (0, +dv)
    vi = uniforms["view_inverse"][view_index]
    cam_right = vi[:3, 0][None, :]
    cam_down = -vi[:3, 1][None, :]
    t = _normalize(torch.linalg.cross(cam_down.expand_as(normal), normal, dim=-1))
    b = _normalize(torch.linalg.cross(normal, cam_right.expand_as(normal), dim=-1))
    light_ts = torch.stack(
        [torch.sum(t * avg_dir, dim=-1), torch.sum(b * avg_dir, dim=-1),
         torch.sum(normal * avg_dir, dim=-1)],
        dim=-1,
    )
    h_map = torch.where(light_ts[..., 0] > 0, left, right)
    v_map = torch.where(light_ts[..., 1] > 0, top, bottom)
    z_map = torch.where(light_ts[..., 2] > 0, front, back)
    light_map = (
        h_map * light_ts[..., 0] * light_ts[..., 0]
        + v_map * light_ts[..., 1] * light_ts[..., 1]
        + z_map * light_ts[..., 2] * light_ts[..., 2]
    )
    directional = sh[:, 0, :] * rgb_len
    ambient = sh[:, 0, :] * 0.2 * (1.0 - rgb_len)
    if env.smoke_tex_ids is not None:
        lut_uv = torch.stack([emissive_s, p_lut_y], dim=-1)
    if use_smoke_pool:
        lw, lh, lwr, lflags = smoke_static[3:7]
        lut = _bilinear_core(scene["smoke_lut"], 0, lw, lh, lwr, lut_uv)[..., :3] * (1.0 / 255.0)
        if lflags & TEXFLAG_SRGB:
            lut = srgb_to_linear_exact(lut)
    elif env.smoke_tex_ids is not None:
        # the LUT is sRGB-encoded: TEXFLAG_SRGB decodes it
        lut = sample_bilinear_level(
            ldr_pool(scene), scene["tex"],
            torch.full((n,), env.smoke_tex_ids[2], dtype=torch.int32, device=dev),
            lut_uv, torch.zeros(n, dtype=torch.int32, device=dev), True,
        )[..., :3]
    else:
        lut = torch.zeros_like(p_emissive)
    emission = torch.where(p_use_lut[..., None], lut, emissive_s[..., None]) * p_emissive
    out = (directional * light_map[..., None] + ambient) * p_colour + emission
    out = tonemap_and_encode(out, inline_tonemapping, inline_srgb)
    alpha = torch.where(valid, alpha, 0.0)
    return out, alpha
