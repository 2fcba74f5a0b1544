"""Gather-based texture sampling from flat texel pools (port of
``superconductor_tpu/ops/texture.py``).

Ported: the pool selectors, wrap/fetch, the one-tap bilinear core, sRGB
decode, isotropic LOD, the classic per-slot samplers
(``sample_bilinear_level``, ``sample_trilinear`` with its three
descriptor paths, ``sample_anisotropic``), the cubemap sampler (static
placement and through the descriptor tables), and the interleaved
material sampler (``sample_material_interleaved``: all four material
textures of a pixel from one 64-channel row per trilinear level, or from
one wide 208-channel mq3 row for both levels), the smoke pool sampler (``sample_smoke_interleaved``) and the light-volume /
lightmap samplers: layered (``sample_3d_from_layers``) and on the
SH-interleaved pools (``sample_lightvol_sh``, ``sample_lightmap_sh``).
"""

from __future__ import annotations

import torch

from .geometry import device_values
from .tonemap import srgb_to_linear_exact

WRAP_REPEAT = 0
WRAP_CLAMP = 1
TEXFLAG_SRGB = 1


def ldr_pool(scene: dict) -> torch.Tensor:
    """Quad-packed (N, 16) LDR pool when published, else the flat pool."""
    return scene.get("texels_q", scene["texels"])


def hdr_pool(scene: dict) -> torch.Tensor:
    return scene.get("texels_hdr_q", scene["texels_hdr"])


def _clamp_to(coord, size):
    if isinstance(size, int):
        return torch.clamp(coord, 0, size - 1)
    return torch.minimum(torch.clamp_min(coord, 0), size - 1)


def _wrap(coord, size, wrap_mode):
    """REPEAT = floor modulo, CLAMP = clamp to [0, size-1]. size and
    wrap_mode are per-lane tensors or static Python ints."""
    if isinstance(wrap_mode, int):
        if wrap_mode == WRAP_REPEAT:
            return torch.remainder(coord, size)
        return _clamp_to(coord, size)
    return torch.where(
        wrap_mode == WRAP_REPEAT, torch.remainder(coord, size), _clamp_to(coord, size)
    )


def _fetch(texels: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return texels[index]


def _lerp4(t00, t10, t01, t11, fx, fy):
    return (
        t00 * (1 - fx) * (1 - fy)
        + t10 * fx * (1 - fy)
        + t01 * (1 - fx) * fy
        + t11 * fx * fy
    )


def _bilinear_core(texels, off, w, h, wrap_mode, uv):
    """One bilinear tap at a mip placement -> raw (P, 4) f32 (u8 pools not
    normalised, no sRGB decode)."""
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)

    if texels.shape[-1] == 16:  # quad-packed pool: one gather, 4 texels
        xi = _wrap(x0, w, wrap_mode)
        yi = _wrap(y0, h, wrap_mode)
        clamped = wrap_mode == WRAP_CLAMP
        fx = torch.where((clamped & (x0 < 0))[..., None], 0.0, fx)
        fy = torch.where((clamped & (y0 < 0))[..., None], 0.0, fy)
        q = _fetch(texels, off + yi * w + xi).to(torch.float32)
        t00, t10, t01, t11 = q[..., 0:4], q[..., 4:8], q[..., 8:12], q[..., 12:16]
    else:

        def tap(xi, yi):
            xi = _wrap(xi, w, wrap_mode)
            yi = _wrap(yi, h, wrap_mode)
            return _fetch(texels, off + yi * w + xi).to(torch.float32)

        t00 = tap(x0, y0)
        t10 = tap(x0 + 1, y0)
        t01 = tap(x0, y0 + 1)
        t11 = tap(x0 + 1, y0 + 1)
    return _lerp4(t00, t10, t01, t11, fx, fy)


def _decode_u8(out, texels, decode_srgb, flags):
    """u8 pools: normalise to [0, 1] and, with decode_srgb, sRGB-decode the
    colour channels of textures flagged TEXFLAG_SRGB."""
    if texels.dtype != torch.uint8:
        return out
    out = out * (1.0 / 255.0)
    if decode_srgb:
        out = _srgb_decode(out, flags)
    return out


def sample_bilinear_level(texels, tex_desc, tex_id, uv, level, decode_srgb=True):
    """Bilinear sample of texture `tex_id` (P,) at mip `level` (P,) i32,
    clamped to the chain, from the flat (N, 4) or quad-packed (N, 16) pool
    -> (P, 4) f32 (reference ops/texture.py:46)."""
    if "tex_meta" in tex_desc:
        meta = tex_desc["tex_meta"][tex_id]
        base, count, wrap_mode = meta[..., 0], meta[..., 1], meta[..., 2]
        flags = meta[..., 3]
        lvl = _clamp_to(level, count)
        owh = tex_desc["mip_owh"][base + lvl]
        off, w, h = owh[..., 0], owh[..., 1], owh[..., 2]
    else:
        base = tex_desc["tex_mip_base"][tex_id]
        count = tex_desc["tex_mip_count"][tex_id]
        wrap_mode = tex_desc["tex_wrap"][tex_id]
        flags = None
        entry = base + _clamp_to(level, count)
        off = tex_desc["mip_offset"][entry]
        w = tex_desc["mip_w"][entry]
        h = tex_desc["mip_h"][entry]
    out = _bilinear_core(texels, off, w, h, wrap_mode, uv)
    if texels.dtype == torch.uint8 and decode_srgb and flags is None:
        flags = tex_desc["tex_flags"][tex_id]
    return _decode_u8(out, texels, decode_srgb, flags)


def _srgb_decode(out, flags):
    srgb = (flags & TEXFLAG_SRGB) != 0
    rgb = torch.where(srgb[..., None], srgb_to_linear_exact(out[..., :3]), out[..., :3])
    return torch.cat([rgb, out[..., 3:]], dim=-1)


def _select_level(levels, lvl):
    """levels (P, L, C) i32, lvl (P,) -> (P, C): row lvl of each lane's
    table by a select ladder (clamps lvl to [0, L-1])."""
    out = levels[..., 0, :]
    for j in range(1, levels.shape[-2]):
        out = torch.where((lvl >= j)[..., None], levels[..., j, :], out)
    return out


def sample_trilinear(texels, tex_desc, tex_id, uv, lod, decode_srgb=True,
                     meta=None, levels_owh=None):
    """Trilinear: the two nearest mips blended by the fractional lod
    (reference ops/texture.py:154). Three descriptor paths, as there: the
    in-register mip table `levels_owh` (P, L, 3) with a pre-gathered
    `meta` row; the mip_owh2 pair rows; or two bilinear_level calls. The
    first two zero the fraction below lod 0 (pure mip 0), exactly as the
    two-call path's clamp does."""
    l0 = torch.floor(lod).to(torch.int32)
    f = (lod - torch.floor(lod))[..., None]
    if levels_owh is not None and meta is not None:
        count, wrap_mode, flags = meta[..., 1], meta[..., 2], meta[..., 3]
        lvl = _clamp_to(l0, count)
        f = torch.where((l0 < 0)[..., None], 0.0, f)
        a_owh = _select_level(levels_owh, lvl)
        b_owh = _select_level(levels_owh, _clamp_to(l0 + 1, count))
        a = _bilinear_core(texels, a_owh[..., 0], a_owh[..., 1], a_owh[..., 2], wrap_mode, uv)
        b = _bilinear_core(texels, b_owh[..., 0], b_owh[..., 1], b_owh[..., 2], wrap_mode, uv)
    elif "mip_owh2" in tex_desc and ("tex_meta" in tex_desc or meta is not None):
        if meta is None:
            meta = tex_desc["tex_meta"][tex_id]
        base, count, wrap_mode = meta[..., 0], meta[..., 1], meta[..., 2]
        flags = meta[..., 3]
        lvl = _clamp_to(l0, count)
        f = torch.where((l0 < 0)[..., None], 0.0, f)
        row = tex_desc["mip_owh2"][base + lvl]  # (P, 8): this mip + next
        a = _bilinear_core(texels, row[..., 0], row[..., 1], row[..., 2], wrap_mode, uv)
        b = _bilinear_core(texels, row[..., 4], row[..., 5], row[..., 6], wrap_mode, uv)
    else:
        a = sample_bilinear_level(texels, tex_desc, tex_id, uv, l0, decode_srgb)
        b = sample_bilinear_level(texels, tex_desc, tex_id, uv, l0 + 1, decode_srgb)
        return a * (1 - f) + b * f
    a = _decode_u8(a, texels, decode_srgb, flags)
    b = _decode_u8(b, texels, decode_srgb, flags)
    return a * (1 - f) + b * f


def mip_level_from_derivatives(dudx, dvdx, dudy, dvdy, tex_w, tex_h):
    """Isotropic LOD from analytic uv screen derivatives."""
    du2 = (dudx * tex_w) ** 2 + (dvdx * tex_h) ** 2
    dv2 = (dudy * tex_w) ** 2 + (dvdy * tex_h) ** 2
    rho2 = torch.maximum(du2, dv2)
    return 0.5 * torch.log2(torch.clamp_min(rho2, 1e-12))


def sample_smoke_interleaved(pool32, w: int, h: int, wrap_mode: int, uv):
    """Both smoke maps' level-0 bilinear taps from one (w*h, 32) u8 row
    gather (Scene.device_smoke rows: [quad_a | quad_b]) at static placement
    (EnvBindings.smoke_static) -> (P, 8) f32 in [0, 1], the math of two
    sample_bilinear_level(level=0, decode_srgb=False) calls (reference
    ops/texture.py:236)."""
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None, None]
    fy = (y - y0)[..., None, None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    xi = _wrap(x0, w, wrap_mode)
    yi = _wrap(y0, h, wrap_mode)
    if wrap_mode == WRAP_CLAMP:
        fx = torch.where((x0 < 0)[..., None, None], 0.0, fx)
        fy = torch.where((y0 < 0)[..., None, None], 0.0, fy)
    q = pool32[yi * w + xi].to(torch.float32)  # (P, 32)
    qr = q.reshape(*q.shape[:-1], 2, 4, 4)  # (P, slot, corner, ch)
    out = _lerp4(qr[..., 0, :], qr[..., 1, :], qr[..., 2, :], qr[..., 3, :], fx, fy)
    return out.reshape(*q.shape[:-1], 8) * (1.0 / 255.0)


def sample_cubemap(texels_hdr, tex_desc, base_tex_id, direction, lod=None,
                   static=None):
    """Cubemap stored as 6 consecutive textures (+X,-X,+Y,-Y,+Z,-Z),
    bilinear. With static pool placement `static` = (face_offsets(6), w,
    h) (EnvBindings.ibl_cubemap_static) and no lod: one gather per pixel,
    CLAMP wrap. Otherwise through the descriptor tables: one bilinear tap
    at the base level without lod, else trilinear at `lod`."""
    d = direction
    ax, ay, az = torch.abs(d[..., 0]), torch.abs(d[..., 1]), torch.abs(d[..., 2])
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az) & ~is_x
    face = torch.where(
        is_x,
        torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    ).to(torch.int32)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp_min(ma, 1e-20)
    sc = torch.where(
        is_x,
        torch.where(x >= 0, -z, z),
        torch.where(is_y, x, torch.where(z >= 0, x, -x)),
    )
    tc = torch.where(is_y, torch.where(y >= 0, z, -z), -y)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    uv = torch.stack([u, v], dim=-1)
    if static is not None and lod is None:
        offs, w, h = static
        off = device_values(offs, torch.int32, d.device)[face]
        out = _bilinear_core(texels_hdr, off, w, h, WRAP_CLAMP, uv)
        if texels_hdr.dtype == torch.uint8:
            out = out * (1.0 / 255.0)
        return out
    tex_id = base_tex_id + face
    if lod is None:
        lvl = torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)
        return sample_bilinear_level(texels_hdr, tex_desc, tex_id, uv, lvl, decode_srgb=False)
    return sample_trilinear(texels_hdr, tex_desc, tex_id, uv, lod, decode_srgb=False)


def _layer_pair(z_coord, z_layers: int):
    """The two layers a z lerp blends and its fraction: layers clamped to
    [0, z_layers - 1], the fraction left as is (so below the first and
    above the last layer both taps read the edge layer)."""
    z = z_coord * z_layers - 0.5
    z0 = torch.floor(z)
    zi = torch.clamp(z0.to(torch.int32), 0, z_layers - 1)
    return zi, torch.clamp(zi + 1, 0, z_layers - 1), (z - z0)[..., None]


def sample_3d_from_layers(texels_hdr, tex_desc, tex_id, point, z_layers: int):
    """A 3D texture stored as z_layers equal-sized mip entries: xy bilinear
    in the two nearest layers, then a lerp across z (reference
    ops/texture.py:335)."""
    zi, zi1, fz = _layer_pair(point[..., 2], z_layers)
    xy = point[..., :2]
    a = sample_bilinear_level(texels_hdr, tex_desc, tex_id, xy, zi, decode_srgb=False)
    b = sample_bilinear_level(texels_hdr, tex_desc, tex_id, xy, zi1, decode_srgb=False)
    return a * (1 - fz) + b * fz


def sample_lightvol_sh(lv_sh, w: int, h: int, z_layers: int, point):
    """Trilinear sample of the SH-interleaved light volume (w*h*z_layers,
    48) f16 pool (upload.sh_pool) -> (P, 12) [L0 | Lx | Ly | Lz] rgb: one
    row gather per z layer at static addressing, the math of
    sample_3d_from_layers over the four volumes (reference
    ops/texture.py:358)."""
    plane, fx, fy = _sh_plane_index(w, h, point[..., 0], point[..., 1])
    zi, zi1, fz = _layer_pair(point[..., 2], z_layers)

    def tap(zl):
        return _sh_bilinear(lv_sh[zl * (w * h) + plane], fx, fy)

    return tap(zi) * (1 - fz) + tap(zi1) * fz


def sample_lightmap_sh(lm_sh, w: int, h: int, uv):
    """Bilinear sample of the SH-interleaved lightmap (w*h, 48) pool ->
    (P, 12): one row gather for all four lightmaps (reference
    ops/texture.py:383)."""
    plane, fx, fy = _sh_plane_index(w, h, uv[..., 0], uv[..., 1])
    return _sh_bilinear(lm_sh[plane], fx, fy)


def _sh_plane_index(w: int, h: int, u, v):
    """Texel index and bilinear fractions on the SH-interleaved pools:
    static dims, CLAMP wrap with baked neighbours, so the fraction is
    zeroed at the negative edge as on the quad pool."""
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    xi = torch.clamp(x0, 0, w - 1)
    yi = torch.clamp(y0, 0, h - 1)
    fx = torch.where((x0 < 0)[..., None], 0.0, fx)
    fy = torch.where((y0 < 0)[..., None], 0.0, fy)
    return yi * w + xi, fx, fy


def _sh_bilinear(q, fx, fy):
    """(P, 48) f16 footprint rows, widened to f32 before the lerp."""
    q = q.to(torch.float32)
    return _lerp4(q[..., 0:12], q[..., 12:24], q[..., 24:36], q[..., 36:48], fx, fy)


def _matq_bilinear(texels_mq, owh, wrap_mode, uv):
    """One bilinear tap of the material-interleaved pool -> raw (P, 16):
    the four slots' results from ONE (P, 64) row gather."""
    off, w, h = owh[..., 0], owh[..., 1], owh[..., 2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None, None]
    fy = (y - y0)[..., None, None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    xi = _wrap(x0, w, wrap_mode)
    yi = _wrap(y0, h, wrap_mode)
    clamped = wrap_mode == WRAP_CLAMP
    fx = torch.where((clamped & (x0 < 0))[..., None, None], 0.0, fx)
    fy = torch.where((clamped & (y0 < 0))[..., None, None], 0.0, fy)
    q = texels_mq[off + yi * w + xi].to(torch.float32)  # (P, 64)
    qr = q.reshape(*q.shape[:-1], 4, 4, 4)  # (P, slot, corner, ch)
    out = _lerp4(qr[..., 0, :], qr[..., 1, :], qr[..., 2, :], qr[..., 3, :], fx, fy)
    return out.reshape(*q.shape[:-1], 16)


def _mq3_levels(texels_mq3, a_owh, b_owh, self_pair, wrap_mode, uv):
    """Both trilinear levels of all four material slots from ONE gather of
    the wide (N, 208) pool (scene/upload.py matq_tables mq3 rows: level-L
    quad, then level-(L+1) 3x3, self-paired at the chain end) -> raw
    (a16, b16) (P, 16) f32, the values _matq_bilinear gives at a_owh and
    b_owh: the level-b 2x2 is picked from the baked 3x3 by the floor(x/2)
    grid correspondence (clean halving chains: matq_plan mq3_ok)."""
    off, w, h = a_owh[..., 0], a_owh[..., 1], a_owh[..., 2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - torch.floor(x))[..., None, None]
    fy = (y - torch.floor(y))[..., None, None]
    xi = _wrap(x0, w, wrap_mode)
    yi = _wrap(y0, h, wrap_mode)
    clamped = wrap_mode == WRAP_CLAMP
    fx = torch.where((clamped & (x0 < 0))[..., None, None], 0.0, fx)
    fy = torch.where((clamped & (y0 < 0))[..., None, None], 0.0, fy)
    row = texels_mq3[off + yi * w + xi].to(torch.float32)  # (P, 208)
    lead = row.shape[:-1]
    qr = row[..., :64].reshape(*lead, 4, 4, 4)
    a16 = _lerp4(qr[..., 0, :], qr[..., 1, :], qr[..., 2, :], qr[..., 3, :], fx, fy)

    wb, hb = b_owh[..., 1], b_owh[..., 2]
    xb = uv[..., 0] * wb - 0.5
    yb = uv[..., 1] * hb - 0.5
    x1 = torch.floor(xb).to(torch.int32)
    y1 = torch.floor(yb).to(torch.int32)
    fx1 = (xb - torch.floor(xb))[..., None, None]
    fy1 = (yb - torch.floor(yb))[..., None, None]
    fx1 = torch.where((clamped & (x1 < 0))[..., None, None], 0.0, fx1)
    fy1 = torch.where((clamped & (y1 < 0))[..., None, None], 0.0, fy1)

    def window_pos(v1, v0, vi, vb_dim):
        # the level-b tap's place in the baked 3-window, for REPEAT
        # (unwrapped-consistent) and CLAMP (edge-duplicated); p0 in {0, 1},
        # p1 in {1, 2} by construction
        c_rep = torch.where(self_pair, v0, v0 >> 1)
        p0_rep = v1 - (c_rep - 1)
        c_cl = torch.where(self_pair, vi, vi >> 1)
        p0_cl = torch.minimum(torch.clamp_min(v1, 0), vb_dim - 1) - (c_cl - 1)
        p1_cl = torch.minimum(torch.clamp_min(v1 + 1, 0), vb_dim - 1) - (c_cl - 1)
        p0 = torch.clamp(torch.where(clamped, p0_cl, p0_rep), 0, 2)
        p1 = torch.clamp(torch.where(clamped, p1_cl, p0_rep + 1), 0, 2)
        return p0, p1

    px0, px1 = window_pos(x1, x0, xi, wb)
    py0, py1 = window_pos(y1, y0, yi, hb)
    t3 = row[..., 64:].reshape(-1, 4, 9, 4)  # (P, slot, yy * 3 + xx, ch)
    lanes = torch.arange(t3.shape[0], device=row.device)

    def at(py, px):  # -> (..., slot, ch)
        cell = (py * 3 + px).reshape(-1).long()
        return t3[lanes, :, cell].reshape(*lead, 4, 4)

    b16 = _lerp4(at(py0, px0), at(py0, px1), at(py1, px0), at(py1, px1), fx1, fy1)
    return a16.reshape(*lead, 16), b16.reshape(*lead, 16)


def _matq_srgb(out16, mask):
    """Per-slot sRGB decode by mask bit (bit s = slot s), alpha linear."""
    o = out16.reshape(*out16.shape[:-1], 4, 4)
    bits = device_values([1, 2, 4, 8], torch.int32, out16.device)
    srgb = (mask[..., None] & bits) != 0
    rgb = torch.where(srgb[..., None], srgb_to_linear_exact(o[..., :3]), o[..., :3])
    return torch.cat([rgb, o[..., 3:]], dim=-1).reshape(*out16.shape[:-1], 16)


def sample_material_interleaved(
    texels_mq, meta, owh, uv, duvdx, duvdy, taps: int, decode_srgb=True,
    texels_tail=None,
):
    """All four material textures of each pixel, two row gathers (one per
    trilinear level). meta (P, 4) i32 [wrap, srgb_mask, count, pad]; owh
    (P, L, 4) i32 per level (offset, w, h, tail_offset). Returns (P, 16)
    f32 [albedo | normal | mr | emissive] RGBA. Wide (N, 208) mq3 rows give
    both levels from one gather (_mq3_levels)."""
    wide = texels_mq.shape[-1] == 208
    wrap_mode, mask, count = meta[..., 0], meta[..., 1], meta[..., 2]
    w = owh[..., 0, 1].to(torch.float32)
    h = owh[..., 0, 2].to(torch.float32)
    dx2 = (duvdx[..., 0] * w) ** 2 + (duvdx[..., 1] * h) ** 2
    dy2 = (duvdy[..., 0] * w) ** 2 + (duvdy[..., 1] * h) ** 2

    def trilinear(uv_t, lod):
        l0 = torch.floor(lod).to(torch.int32)
        f = (lod - torch.floor(lod))[..., None]
        lvl = torch.minimum(torch.clamp_min(l0, 0), count - 1)
        f = torch.where((l0 < 0)[..., None], 0.0, f)
        a_owh = _select_level(owh, lvl)
        b_owh = _select_level(owh, torch.minimum(torch.clamp_min(l0 + 1, 0), count - 1))
        if wide:
            a, b = _mq3_levels(texels_mq, a_owh, b_owh, l0 >= count - 1, wrap_mode, uv_t)
        elif texels_tail is not None and owh.shape[-1] >= 4:
            a = _matq_bilinear(texels_mq, a_owh, wrap_mode, uv_t)
            b_towh = torch.cat([b_owh[..., 3:4], b_owh[..., 1:3]], dim=-1)
            b = _matq_bilinear(texels_tail, b_towh, wrap_mode, uv_t)
        else:
            a = _matq_bilinear(texels_mq, a_owh, wrap_mode, uv_t)
            b = _matq_bilinear(texels_mq, b_owh, wrap_mode, uv_t)
        a = a * (1.0 / 255.0)
        b = b * (1.0 / 255.0)
        if decode_srgb:
            a = _matq_srgb(a, mask)
            b = _matq_srgb(b, mask)
        return a * (1 - f) + b * f

    if taps <= 1:
        lod = torch.clamp_min(
            0.5 * torch.log2(torch.clamp_min(torch.maximum(dx2, dy2), 1e-12)), 0.0
        )
        return trilinear(uv, lod)
    major_is_x = dx2 >= dy2
    rho_maj2 = torch.maximum(dx2, dy2)
    rho_min2 = torch.minimum(dx2, dy2)
    ratio2 = torch.clamp(rho_maj2 / torch.clamp_min(rho_min2, 1e-12), 1.0, float(taps) ** 2)
    lod = torch.clamp_min(
        0.5 * torch.log2(torch.clamp_min(rho_maj2 / ratio2, 1e-12)), 0.0
    )
    major = torch.where(major_is_x[..., None], duvdx, duvdy)
    out = None
    for i in range(taps):
        t = (i + 0.5) / taps - 0.5
        s = trilinear(uv + major * t, lod)
        out = s if out is None else out + s
    return out / taps


def sample_anisotropic(
    texels, tex_desc, tex_id, uv, duvdx, duvdy, taps: int, decode_srgb=True,
    meta=None, levels_owh=None,
):
    """`taps` trilinear samples averaged along the major-axis uv
    derivative, lod from the minor axis clamped by the tap count; taps=1 is
    trilinear at the isotropic (major-axis) lod (reference
    ops/texture.py:629). The mip-0 size comes from a (P, 6) `meta` row
    (mat_tex_meta), else from the descriptor tables."""
    if meta is not None and meta.shape[-1] >= 6:
        w = meta[..., 4].to(torch.float32)
        h = meta[..., 5].to(torch.float32)
    else:
        if meta is not None:
            base = meta[..., 0]
        elif "tex_meta" in tex_desc:
            base = tex_desc["tex_meta"][tex_id][..., 0]
        else:
            base = tex_desc["tex_mip_base"][tex_id]
        if meta is not None or "tex_meta" in tex_desc:
            owh = tex_desc["mip_owh"][base]
            w = owh[..., 1].to(torch.float32)
            h = owh[..., 2].to(torch.float32)
        else:
            w = tex_desc["mip_w"][base].to(torch.float32)
            h = tex_desc["mip_h"][base].to(torch.float32)
    dx2 = (duvdx[..., 0] * w) ** 2 + (duvdx[..., 1] * h) ** 2
    dy2 = (duvdy[..., 0] * w) ** 2 + (duvdy[..., 1] * h) ** 2
    if taps <= 1:
        lod = torch.clamp_min(
            0.5 * torch.log2(torch.clamp_min(torch.maximum(dx2, dy2), 1e-12)), 0.0
        )
        return sample_trilinear(texels, tex_desc, tex_id, uv, lod, decode_srgb,
                                meta=meta, levels_owh=levels_owh)
    major_is_x = dx2 >= dy2
    rho_maj2 = torch.maximum(dx2, dy2)
    rho_min2 = torch.minimum(dx2, dy2)
    ratio2 = torch.clamp(rho_maj2 / torch.clamp_min(rho_min2, 1e-12), 1.0, float(taps) ** 2)
    lod = torch.clamp_min(
        0.5 * torch.log2(torch.clamp_min(rho_maj2 / ratio2, 1e-12)), 0.0
    )
    major = torch.where(major_is_x[..., None], duvdx, duvdy)
    out = None
    for i in range(taps):
        t = (i + 0.5) / taps - 0.5
        s = sample_trilinear(texels, tex_desc, tex_id, uv + major * t, lod, decode_srgb,
                             meta=meta, levels_owh=levels_owh)
        out = s if out is None else out + s
    return out / taps
