"""Deferred shading: visibility buffer -> lit pixels (port of
``superconductor_tpu/ops/shade.py``).

Ported: g-buffer interpolation with analytic screen derivatives, the PBR
pieces (nonlinear L1 SH irradiance, GGX specular at the SH dominant
direction, cotangent-frame normal mapping), every SH lighting branch (the
light volume and the lightmaps, each on its SH-interleaved pool or
layered through the HDR pool, and the constant ambient fallback), and
``shade`` and the alpha-clip test ``albedo_alpha`` on every material path:
the interleaved pool (matq), the classic per-slot samplers, and textures
pre-sampled by the material-path partition.

Material textures are sampled through ops/sample.py's wrappers
(``sample.sample_material``, ``sample.sample_classic``), looked up in that
module at each call.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import sample
from .geometry import TriangleAttrs, TriangleSetup, device_values
from .sample import FLAGS, META, SLOTS, _bitcast_i32, _factors, _unpack_mat_row, _unpack_mq_row
from .texture import (
    hdr_pool,
    ldr_pool,
    sample_3d_from_layers,
    sample_bilinear_level,
    sample_lightmap_sh,
    sample_lightvol_sh,
)
from .tonemap import linear_to_srgb_approx, tonemap_and_encode

MAT_UNLIT = 1


class GBuffer(NamedTuple):
    """Flat per-pixel (P,) SoA after attribute interpolation."""

    valid: torch.Tensor
    world_pos: torch.Tensor  # (P, 3)
    normal: torch.Tensor  # (P, 3) interpolated, unnormalised
    uv: torch.Tensor  # (P, 2)
    lm_uv: torch.Tensor  # (P, 2)
    material: torch.Tensor  # (P,) i32
    front_facing: torch.Tensor  # (P,) bool
    lightmapped: torch.Tensor  # (P,) bool
    dpdx: torch.Tensor  # (P, 3)
    dpdy: torch.Tensor
    duvdx: torch.Tensor  # (P, 2)
    duvdy: torch.Tensor
    mat_tail: Optional[torch.Tensor] = None  # (P, 24+4L) mat_row_mq tail


def _sum3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of x's three entries along `dim` as (x0 + x1) + x2: the order
    the CPU's reductions (torch's and XLA's) take, written out so that no
    device's reduction order rounds the g-buffer apart (as clip_transform
    writes out its dot order)."""
    a, b, c = x.unbind(dim)
    return (a + b) + c


def interpolate_gbuffer(
    pair: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    tri: TriangleSetup,
    attrs: TriangleAttrs,
    shade_row: Optional[torch.Tensor] = None,
    row_cols: Optional[int] = None,
) -> GBuffer:
    """Gather the winner's setup (+ packed attribute, + material) row and
    interpolate perspective-correctly; barycentrics are recomputed from the
    edge functions, derivatives differentiate N(p)/D(p) analytically.
    `row_cols`: the real columns of a padded shade_row (shade_row_pad),
    sliced off after the gather."""
    valid = pair >= 0
    p = torch.clamp_min(pair, 0)
    av32 = None
    mat_tail = None
    if shade_row is not None:
        row = shade_row[p]
        if row_cols is not None:
            row = row[:, :row_cols]
        setup = row[:, 0:16]
        av32 = row[:, 16:48]
        if row.shape[-1] > 48:
            mat_tail = row[:, 48:]
    else:
        setup = tri.setup[p]
        if attrs.packed is not None:
            av32 = attrs.packed[p]
    front_facing = setup[:, 15] == 0.0

    adj = setup[:, 0:9].reshape(-1, 3, 3)
    dx = adj[:, :, 0]
    dy = adj[:, :, 1]
    e = adj[:, :, 0] * px[:, None] + adj[:, :, 1] * py[:, None] + adj[:, :, 2]
    d_val = _sum3(e, -1)
    d_dx = _sum3(dx, -1)
    d_dy = _sum3(dy, -1)
    inv_d = 1.0 / torch.where(d_val == 0, 1.0, d_val)
    bary = e * inv_d[:, None]

    if av32 is not None:
        wp_v = av32[:, 0:9].reshape(-1, 3, 3)
        n_v = av32[:, 9:18].reshape(-1, 3, 3)
        uv_v = av32[:, 18:24].reshape(-1, 3, 2)
        lm_v = av32[:, 24:30].reshape(-1, 3, 2)
        material = _bitcast_i32(av32[:, 30])
        lightmapped = av32[:, 31] != 0
    else:
        wp_v = attrs.world_pos[p]
        n_v = attrs.normal[p]
        uv_v = attrs.uv[p]
        lm_v = attrs.lm_uv[p]
        material = attrs.material[p]
        lightmapped = attrs.lightmapped[p]

    def interp(av):
        return _sum3(av * bary[..., None], -2)

    def deriv(av):
        n_val = _sum3(e[..., None] * av, -2)
        n_dx = _sum3(dx[..., None] * av, -2)
        n_dy = _sum3(dy[..., None] * av, -2)
        ddx = (n_dx - n_val * (d_dx * inv_d)[..., None]) * inv_d[..., None]
        ddy = (n_dy - n_val * (d_dy * inv_d)[..., None]) * inv_d[..., None]
        return ddx, ddy

    dpdx, dpdy = deriv(wp_v)
    duvdx, duvdy = deriv(uv_v)
    return GBuffer(
        valid=valid,
        world_pos=interp(wp_v),
        normal=interp(n_v),
        uv=interp(uv_v),
        lm_uv=interp(lm_v),
        material=material,
        front_facing=front_facing,
        lightmapped=lightmapped,
        dpdx=dpdx,
        dpdy=dpdy,
        duvdx=duvdx,
        duvdy=duvdy,
        mat_tail=mat_tail,
    )


def _normalize(v, eps=1e-12):
    return v * torch.rsqrt(torch.clamp_min(torch.sum(v * v, dim=-1, keepdim=True), eps))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def eval_sh_nonlinear(sh, normal):
    """Nonlinear L1 SH irradiance. sh (P, 4, 3) [L0, L1x, L1y, L1z] rgb;
    normal (P, 3) -> (P, 3)."""
    r1 = torch.stack([sh[:, 1, :], sh[:, 2, :], sh[:, 3, :]], dim=-2)
    r0 = sh[:, 0, :]
    length = torch.sqrt(torch.sum(r1 * r1, dim=-2) + 1e-20)
    a = (1.0 - length) / (1.0 + length)
    pexp = 1.0 + 2.0 * length
    ndot = torch.sum(r1 * normal[..., :, None], dim=-2)
    q = torch.clamp_min(0.5 * (1.0 + ndot), 0.0)
    return r0 * (a + (1.0 - a) * (pexp + 1.0) * torch.pow(q, pexp))


def sh_channel_vectors(sh):
    red = torch.stack([sh[:, 1, 0], sh[:, 2, 0], sh[:, 3, 0]], dim=-1)
    green = torch.stack([sh[:, 1, 1], sh[:, 2, 1], sh[:, 3, 1]], dim=-1)
    blue = torch.stack([sh[:, 1, 2], sh[:, 2, 2], sh[:, 3, 2]], dim=-1)
    return red, green, blue


def ggx_specular(n, v, l, roughness, f0, f90):
    """D_GGX * V_SmithGGXCorrelated * F_Schlick."""
    h = _normalize(v + l)
    ndv = torch.clamp_min(_dot(n, v), 1e-4)
    ndl = torch.clamp_min(_dot(n, l), 0.0)
    ndh = torch.clamp_min(_dot(n, h), 0.0)
    vdh = torch.clamp_min(_dot(v, h), 0.0)
    a2 = roughness * roughness
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp_min(math.pi * denom * denom, 1e-8)
    lv = ndl * torch.sqrt(ndv * ndv * (1.0 - a2) + a2)
    ll = ndv * torch.sqrt(ndl * ndl * (1.0 - a2) + a2)
    vis = 0.5 / torch.clamp_min(lv + ll, 1e-8)
    fresnel = f0 + (f90[..., None] - f0) * torch.pow(1.0 - vdh, 5.0)[..., None]
    return (d * vis)[..., None] * fresnel, ndl


def sh_specular_approximation(sh, normal, view, roughness_perceptual, f0, f90):
    red, green, blue = sh_channel_vectors(sh)
    avg_dir = (red + green + blue) / 3.0
    dir_len = torch.sqrt(torch.sum(avg_dir * avg_dir, dim=-1) + 1e-20)
    smoothness = 1.0 - roughness_perceptual
    adjusted_smoothness = smoothness * torch.sqrt(dir_len)
    adjusted_roughness_p = 1.0 - adjusted_smoothness
    actual_roughness = adjusted_roughness_p * adjusted_roughness_p
    light = avg_dir / dir_len[..., None]
    strength = sh[:, 0, :] * dir_len[..., None]
    spec, ndl = ggx_specular(normal, view, light, actual_roughness, f0, f90)
    return spec * strength * ndl[..., None]


def compute_cotangent_frame_normal(geo_normal, map_normal_ts, dpdx, dpdy,
                                   duvdx, duvdy):
    """Normal mapping without precomputed tangents, with analytic
    derivatives. geo_normal must be unit length."""
    n = geo_normal
    dp2perp = torch.linalg.cross(dpdy, n, dim=-1)
    dp1perp = torch.linalg.cross(n, dpdx, dim=-1)
    t = dp2perp * duvdx[..., 0:1] + dp1perp * duvdy[..., 0:1]
    b = dp2perp * duvdx[..., 1:2] + dp1perp * duvdy[..., 1:2]
    t2 = torch.sum(t * t, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    invmax = torch.rsqrt(torch.clamp_min(torch.maximum(t2, b2), 1e-20))
    t = t * invmax
    b = b * invmax
    world = (
        t * map_normal_ts[..., 0:1]
        + b * map_normal_ts[..., 1:2]
        + n * map_normal_ts[..., 2:3]
    )
    return _normalize(world)


def sample_spherical_harmonics(gbuf: GBuffer, scene: dict, uniforms: dict, env):
    """(P, 4, 3) SH coefficients per pixel (reference ops/shade.py:291): the
    light volume at the probe-box coordinates of the world position, the
    lightmaps at lm_uv where the lane is lightmapped, else the constant
    ambient. Each texture set is sampled on its SH-interleaved pool when
    the scene publishes one and its static dims are bound, else layer by
    layer through the HDR pool; the L1 bands are stored 0..1-encoded and
    unpacked with * 255/127 - 128/127."""
    p = gbuf.world_pos.shape[0]
    dev = gbuf.world_pos.device
    scale = 255.0 / 127.0
    bias = -128.0 / 127.0

    def unpack(taps):
        return torch.stack(
            [taps[0]] + [t * scale + bias for t in taps[1:]], dim=-2
        )

    def layered(tex_ids, sample):
        return [sample(torch.full((p,), i, dtype=torch.int32, device=dev))[..., :3]
                for i in tex_ids]

    sh = None
    if env.lightvol_tex_ids is not None:
        rescaled = (gbuf.world_pos - uniforms["probes_bottom_left"]) / uniforms["probes_scale"]
        z_layers = env.lightvol_z_layers
        if "lv_sh" in scene and env.lightvol_wh is not None:
            w, h = env.lightvol_wh
            t12 = sample_lightvol_sh(scene["lv_sh"], w, h, z_layers, rescaled)
            taps = [t12[..., 3 * i:3 * i + 3] for i in range(4)]
        else:
            taps = layered(env.lightvol_tex_ids, lambda tid: sample_3d_from_layers(
                hdr_pool(scene), scene["tex_hdr"], tid, rescaled, z_layers))
        sh = unpack(taps)
    if env.lightmap_tex_ids is not None:
        if "lm_sh" in scene and env.lightmap_wh is not None:
            w, h = env.lightmap_wh
            t12 = sample_lightmap_sh(scene["lm_sh"], w, h, gbuf.lm_uv)
            taps = [t12[..., 3 * i:3 * i + 3] for i in range(4)]
        else:
            lvl = torch.zeros((p,), dtype=torch.int32, device=dev)
            taps = layered(env.lightmap_tex_ids, lambda tid: sample_bilinear_level(
                hdr_pool(scene), scene["tex_hdr"], tid, gbuf.lm_uv, lvl, False))
        sh_lm = unpack(taps)
        sh = sh_lm if sh is None else torch.where(gbuf.lightmapped[:, None, None], sh_lm, sh)
    if sh is None:
        ambient = device_values(env.ambient_sh, torch.float32, dev).reshape(4, 3)
        sh = ambient.expand(p, 4, 3)
    return sh


def _mq_rows(m: dict, mat, gbuf=None):
    """The lanes' mat_row_mq rows: the shade_row tail when present, else
    one row gather."""
    if gbuf is not None and gbuf.mat_tail is not None:
        return gbuf.mat_tail
    return m["mat_row_mq"][mat]


def _material_rows_mq(m: dict, mat, gbuf=None):
    """mat_row_mq unpacked -- from the shade_row tail when present, else one
    row gather."""
    return _unpack_mq_row(_mq_rows(m, mat, gbuf))


def _material_rows(m: dict, mat):
    """(pf (P,12) f32, pi (P,8) i32, mtm (P,24) i32 or None, mlv (P,4,L,3)
    i32 or None) of the classic samplers -- from ONE mat_row gather when
    the scene publishes it, else the separate packed rows (reference
    ops/shade.py:363). mlv is each slot's in-register mip table."""
    if "mat_row" in m:
        return _unpack_mat_row(m["mat_row"][mat])
    mtm = m["mat_tex_meta"][mat] if "mat_tex_meta" in m else None
    return m["packed_f"][mat], m["packed_i"][mat], mtm, None


def _whole_pool(scene: dict) -> bool:
    """Every material samples the interleaved pool (no partial pool)."""
    return ("texels_mq" in scene and "mat_row_mq" in scene["materials"]
            and "matq_capable" not in scene)


def _interleaved(scene: dict, gbuf: GBuffer, aniso_taps: int, slots):
    """The wanted slots of the g-buffer's lanes from the whole interleaved
    pool, the material rows from the shade_row tail when present, else by
    material id."""
    if gbuf.mat_tail is not None:
        rows, mat = gbuf.mat_tail, None
    else:
        rows, mat = scene["materials"]["mat_row_mq"], gbuf.material
    return sample.sample_material(
        scene["texels_mq"], rows, gbuf.uv, gbuf.duvdx, gbuf.duvdy, aniso_taps, mat=mat,
        slots=slots, texels_tail=scene.get("texels_mq_tail"),
    )


def shade(
    gbuf: GBuffer,
    scene: dict,
    uniforms: dict,
    view_index: int,
    env=None,
    inline_tonemapping: bool = True,
    inline_srgb: bool = True,
    aniso_taps: int = 1,
    s16=None,
):
    """-> (rgb (P, 3) display-encoded, alpha (P,)); misses are black with
    alpha 0. The material textures come pre-sampled in `s16` (P, 16) from
    the material-path partition, else from the interleaved pool when every
    material takes it, else from the classic per-slot samplers (partial
    pools without the partition, scenes without the pool)."""
    m = scene["materials"]
    if env is None:
        raise ValueError("shade needs EnvBindings")
    if s16 is not None:
        # factors and flags still come from the material row (incapable
        # materials' rows carry their real pf / pi)
        pf, pi = _factors(_mq_rows(m, gbuf.material, gbuf))
    elif _whole_pool(scene):
        pf, pi = _factors(_mq_rows(m, gbuf.material, gbuf))
        s16 = _interleaved(scene, gbuf, aniso_taps, SLOTS)
    else:
        pf, pi = _factors(m["mat_row"][:, :META][gbuf.material])
        s16 = sample.sample_classic(ldr_pool(scene), m["mat_row"], gbuf.material, gbuf.uv,
                                    gbuf.duvdx, gbuf.duvdy, aniso_taps)
    albedo = s16[..., 0:4] * pf[..., 0:4]
    normal_tex = s16[..., 4:8]
    mr = s16[..., 8:12]
    emissive_tex = s16[..., 12:16]

    metallic = mr[..., 2] * pf[..., 7]
    roughness = mr[..., 1] * pf[..., 8]
    emissive = emissive_tex[..., :3] * pf[..., 4:7]
    alpha = albedo[..., 3]
    albedo_rgb = albedo[..., :3]

    geo_n = _normalize(gbuf.normal)
    geo_n = torch.where(gbuf.front_facing[..., None], geo_n, -geo_n)
    map_n = normal_tex[..., :3] * (255.0 / 127.0) - (128.0 / 127.0)
    scale = pf[..., 9][..., None]
    map_n = map_n * torch.cat([scale, scale, torch.ones_like(scale)], dim=-1)
    map_n = _normalize(map_n)
    n = compute_cotangent_frame_normal(
        geo_n, map_n, gbuf.dpdx, gbuf.dpdy, gbuf.duvdx, gbuf.duvdy
    )

    eye = uniforms["eye"][view_index]
    view = _normalize(eye[None, :] - gbuf.world_pos)
    sh = sample_spherical_harmonics(gbuf, scene, uniforms, env)

    diffuse = albedo_rgb * (1.0 - metallic[..., None]) * eval_sh_nonlinear(sh, n)
    sh_boost = sh.clone()
    sh_boost[:, 0, :] = sh_boost[:, 0, :] * (math.pi * math.pi)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo_rgb * metallic[..., None]
    f90 = torch.ones_like(metallic)
    specular = sh_specular_approximation(sh_boost, n, view, roughness, f0, f90)
    lit = tonemap_and_encode(diffuse + specular + emissive, inline_tonemapping, inline_srgb)
    unlit_rgb = linear_to_srgb_approx(albedo_rgb) if inline_srgb else albedo_rgb
    unlit = (pi[..., 4] & MAT_UNLIT) != 0
    rgb = torch.where(unlit[..., None], unlit_rgb, lit)
    rgb = torch.where(gbuf.valid[..., None], rgb, 0.0)
    alpha = torch.where(gbuf.valid, alpha, 0.0)
    return rgb, alpha


def albedo_alpha(gbuf: GBuffer, scene: dict, aniso_taps: int = 1, albedo4=None):
    """(albedo alpha, material alpha cutoff) for the alpha-clip test, with
    the same trilinear lod as full shading (reference ops/shade.py:546);
    the cutoff rides the material row already gathered. `albedo4` is the
    pre-sampled (P, 4) albedo of the material-path partition; partial
    pools without it take the classic sampler."""
    m = scene["materials"]
    if albedo4 is not None:
        pf = _mq_rows(m, gbuf.material, gbuf)[..., :FLAGS]
    elif _whole_pool(scene):
        pf = _mq_rows(m, gbuf.material, gbuf)[..., :FLAGS]
        albedo4 = _interleaved(scene, gbuf, aniso_taps, (0,))
    else:
        pf = m["mat_row"][:, :FLAGS][gbuf.material]
        albedo4 = sample.sample_classic(ldr_pool(scene), m["mat_row"], gbuf.material, gbuf.uv,
                                        gbuf.duvdx, gbuf.duvdy, aniso_taps, slots=(0,))
    albedo = albedo4 * pf[..., 0:4]
    return albedo[..., 3], pf[..., 10]
