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

``interpolate_gbuffer`` launches csrc/gbuffer.cu's hand-written kernel
for CUDA tensors and runs its plain version, the torch chain
``interpolate_gbuffer_plain``, for CPU tensors (bit for bit with the
kernel on the card). ``shade`` samples the material textures through
ops/sample.py's wrappers (``sample.sample_material``,
``sample.sample_classic``, looked up in that module at each call) and,
for CUDA tensors, computes the rest in csrc/shade.cu's hand-written kernel
(``shade_lanes``); its plain version ``shade_plain`` runs the torch chain
``shade_lanes_plain`` instead, as CPU tensors do. The chain's three-term
sums and cross products are written out in a fixed order (``_sum3``,
``_cross``), which the kernel follows.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import sample
from .geometry import TriangleAttrs, TriangleSetup, device_values
from .raster import _kernel_fn, _launched
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


def interpolate_gbuffer_plain(
    pair: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    tri: TriangleSetup,
    attrs: TriangleAttrs,
    shade_row: Optional[torch.Tensor] = None,
    row_cols: Optional[int] = None,
) -> GBuffer:
    """interpolate_gbuffer's plain version, the torch chain: gather the
    winner's setup (+ packed attribute, + material) row and interpolate
    perspective-correctly; barycentrics are recomputed from the edge
    functions, derivatives differentiate N(p)/D(p) analytically.
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


def interpolate_gbuffer(
    pair: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    tri: TriangleSetup,
    attrs: TriangleAttrs,
    shade_row: Optional[torch.Tensor] = None,
    row_cols: Optional[int] = None,
) -> GBuffer:
    """The g-buffer of each lane's winner pair (P,) i32 (-1 = none) at
    pixel centres px, py (P,) f32 -> GBuffer: from the fused shade row
    (setup 0-16, packed attributes 16-48, the mat_row_mq tail 48-row_cols;
    `row_cols` the real columns of a padded row) or from tri.setup and
    attrs.packed. CUDA tensors launch csrc/gbuffer.cu gbuffer_kernel (bit
    for bit with the plain version on the card; it reads the rows' columns
    in place), CPU tensors run interpolate_gbuffer_plain; anything the
    kernel does not take raises, the unpacked attribute tables included.
    Counts its launches in interpolate_gbuffer.LAUNCHES."""
    dev = pair.device
    if dev.type == "cpu":
        return interpolate_gbuffer_plain(pair, px, py, tri, attrs, shade_row=shade_row,
                                         row_cols=row_cols)
    lanes = pair.shape[0] if pair.dim() == 1 else -1
    if pair.dtype != torch.int32 or pair.dim() != 1:
        raise TypeError(f"interpolate_gbuffer: pair must be (P,) int32, got {pair.dtype} "
                        f"{tuple(pair.shape)}")
    for name, t in (("px", px), ("py", py)):
        if t.device != dev or t.dtype != torch.float32 or t.shape != (lanes,):
            raise ValueError(f"interpolate_gbuffer: {name} must be ({lanes},) float32 on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if shade_row is not None:
        cols = shade_row.shape[1] if shade_row.dim() == 2 else 0
        real = cols if row_cols is None else int(row_cols)
        if not 48 <= real <= cols:
            raise ValueError(f"interpolate_gbuffer: a shade row of {real} real columns in "
                             f"{tuple(shade_row.shape)}; it needs setup and packed (48)")
        _check_rows("shade_row", shade_row, dev)
        setup, packed = shade_row[:, 0:16], shade_row[:, 16:48]
        tail_cols = real - 48
    else:
        if attrs.packed is None:
            raise ValueError("interpolate_gbuffer: the kernel takes the packed attribute rows "
                             "(attrs.packed), not the unpacked tables")
        setup, packed, tail_cols = tri.setup, attrs.packed, 0
        for name, t, width in (("tri.setup", setup, 16), ("attrs.packed", packed, 32)):
            if t.dim() != 2 or t.shape[1] != width:
                raise ValueError(f"interpolate_gbuffer: {name} must be (T, {width}), got "
                                 f"{tuple(t.shape)}")
            _check_rows(name, t, dev)
        if packed.shape[0] != setup.shape[0]:
            raise ValueError("interpolate_gbuffer: tri.setup and attrs.packed differ in rows")
    if setup.shape[0] == 0:
        raise ValueError("interpolate_gbuffer: no rows to gather from")
    if dev.type != "cuda":
        raise ValueError(f"interpolate_gbuffer: the kernel runs on CUDA tensors, not {dev}")
    vec = all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 for t in (setup, packed))

    def empty(*shape, dtype=torch.float32):
        return torch.empty((lanes, *shape), dtype=dtype, device=dev)

    g = GBuffer(valid=empty(dtype=torch.bool), world_pos=empty(3), normal=empty(3),
                uv=empty(2), lm_uv=empty(2), material=empty(dtype=torch.int32),
                front_facing=empty(dtype=torch.bool), lightmapped=empty(dtype=torch.bool),
                dpdx=empty(3), dpdy=empty(3), duvdx=empty(2), duvdy=empty(2),
                mat_tail=empty(tail_cols) if tail_cols else None)
    if lanes:
        tail_src = shade_row[:, 48:] if tail_cols else None
        with torch.cuda.device(dev):
            err = _kernel_fn("sc_gbuffer")(
                lanes, pair.data_ptr(), pair.stride(0), px.data_ptr(), px.stride(0),
                py.data_ptr(), py.stride(0), setup.data_ptr(), setup.stride(0),
                packed.data_ptr(), packed.stride(0), setup.shape[0], int(vec),
                None if tail_src is None else tail_src.data_ptr(),
                0 if tail_src is None else tail_src.stride(0), tail_cols,
                *(t.data_ptr() for t in (g.valid, g.front_facing, g.lightmapped, g.material,
                                         g.world_pos, g.normal, g.dpdx, g.dpdy, g.uv,
                                         g.lm_uv, g.duvdx, g.duvdy)),
                None if g.mat_tail is None else g.mat_tail.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"g-buffer kernel launch failed: cudaError_t {err}")
        _launched(_GBUFFER_COUNTER)
    return g


interpolate_gbuffer.LAUNCHES = 0
# the wrapper whose LAUNCHES count its kernel, however the frame's name for
# it is rebound (a recording or plain twin put in its place)
_GBUFFER_COUNTER = interpolate_gbuffer


def _check_rows(name, rows, dev) -> None:
    """An f32 row table on dev whose columns are adjacent (any row stride)."""
    if rows.device != dev:
        raise ValueError(f"interpolate_gbuffer: {name} is on {rows.device}, expected {dev}")
    if rows.dtype != torch.float32:
        raise TypeError(f"interpolate_gbuffer: {name} must be float32, got {rows.dtype}")
    if rows.dim() != 2 or rows.stride(1) != 1 or rows.data_ptr() % 4:
        raise ValueError(f"interpolate_gbuffer: {name} must be a (rows, columns) table with "
                         f"adjacent columns, got {tuple(rows.shape)} strides {rows.stride()}")


def _normalize(v, eps=1e-12):
    return v * torch.rsqrt(torch.clamp_min(_sum3(v * v, -1)[..., None], eps))


def _dot(a, b):
    return _sum3(a * b, -1)


def _cross(a, b):
    """a x b over the last dim as (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 -
    a1 b0), each product and difference its own operation: no device's
    cross kernel contracts them into FMAs (csrc/shade.cu computes the
    same)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def eval_sh_nonlinear(sh, normal):
    """Nonlinear L1 SH irradiance. sh (P, 4, 3) [L0, L1x, L1y, L1z] rgb;
    normal (P, 3) -> (P, 3)."""
    r1 = torch.stack([sh[:, 1, :], sh[:, 2, :], sh[:, 3, :]], dim=-2)
    r0 = sh[:, 0, :]
    length = torch.sqrt(_sum3(r1 * r1, -2) + 1e-20)
    a = (1.0 - length) / (1.0 + length)
    pexp = 1.0 + 2.0 * length
    ndot = _sum3(r1 * normal[..., :, None], -2)
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
    dir_len = torch.sqrt(_sum3(avg_dir * avg_dir, -1) + 1e-20)
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
    dp2perp = _cross(dpdy, n)
    dp1perp = _cross(n, dpdx)
    t = dp2perp * duvdx[..., 0:1] + dp1perp * duvdy[..., 0:1]
    b = dp2perp * duvdx[..., 1:2] + dp1perp * duvdy[..., 1:2]
    t2 = _sum3(t * t, -1)[..., None]
    b2 = _sum3(b * b, -1)[..., None]
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
    sample_spherical_harmonics.CALLS += 1
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


sample_spherical_harmonics.CALLS = 0  # calls, for a run to show the chain did not run


class _ShPools(ctypes.Structure):
    """csrc/sh_sample.cuh ShPools, field for field (8 B each)."""

    _fields_ = [(f.rstrip("*"), ctypes.c_void_p if f.endswith("*") else ctypes.c_longlong)
                for f in "lv* lv_s lv_rows lv_vec lv_w lv_h lv_z lm* lm_s lm_rows lm_vec lm_w lm_h "
                         "bl* bl_s scale* scale_s".split()]


_pools_checked: list = []  # [True] once the library's ShPools has the mirror's size


def _check_pools_mirror() -> None:
    """Raises unless csrc/sh_sample.cuh's ShPools, as the kernel library
    was built, has _ShPools' size (checked once)."""
    if not _pools_checked:
        size = _kernel_fn("sc_sh_pools_bytes")()
        if size != ctypes.sizeof(_ShPools):
            raise RuntimeError(f"csrc/sh_sample.cuh's ShPools takes {size} B, its ctypes mirror "
                               f"{ctypes.sizeof(_ShPools)} B")
        _pools_checked.append(True)


def _pool_table(fn: str, name: str, t, dev) -> tuple:
    """(row stride in halves, rows, 16-B aligned rows) of an SH pool the
    kernels take: a non-empty (rows, 48) float16 table on dev with adjacent
    columns and 4-B aligned rows."""
    if not isinstance(t, torch.Tensor) or t.device != dev or t.dtype != torch.float16 \
            or t.dim() != 2 or t.shape[1] != 48 or t.shape[0] < 1 or t.stride(1) != 1 \
            or t.stride(0) % 2 or t.data_ptr() % 4:
        raise ValueError(f"{fn}: {name} must be a non-empty (rows, 48) float16 table on {dev} "
                         f"with adjacent columns and 4-B aligned rows, got "
                         + (f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}"
                            if isinstance(t, torch.Tensor) else type(t).__name__))
    return t.stride(0), t.shape[0], int(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0)


class PoolSH:
    """The SH of a frame's lanes (sample_spherical_harmonics on `scene`,
    `uniforms` and `env`) as the shade kernels read it in place: called on
    world positions (the particle shade's sh_sampler), the stand-in
    g-buffer render/frame.py gave it (lm_uv 0, not lightmapped); `sample`
    on a g-buffer (the deferred shade). Where every bound texture set has
    its SH-interleaved pool and static dims (`pooled`), csrc/shade.cu's
    kernels sample those pools themselves (csrc/sh_sample.cuh,
    `pools_struct` gives them the tables); elsewhere (the layered path,
    a configuration without the pools) the wrappers take the SH from this
    torch chain."""

    def __init__(self, scene: dict, uniforms: dict, env):
        self.scene, self.uniforms, self.env = scene, uniforms, env

    def __call__(self, world_pos: torch.Tensor) -> torch.Tensor:
        n, dev = world_pos.shape[0], world_pos.device
        stand_in = GBuffer(
            valid=None, world_pos=world_pos, normal=None, uv=None,
            lm_uv=torch.zeros_like(world_pos[..., :2]), material=None, front_facing=None,
            lightmapped=torch.zeros(n, dtype=torch.bool, device=dev),
            dpdx=None, dpdy=None, duvdx=None, duvdy=None,
        )
        return self.sample(stand_in)

    def sample(self, gbuf: GBuffer) -> torch.Tensor:
        return sample_spherical_harmonics(gbuf, self.scene, self.uniforms, self.env)

    def _sets(self) -> tuple:
        """(light volume, lightmaps): each bound set's (pool key, dims), or
        None where the set is not bound."""
        env = self.env
        lv = None if env.lightvol_tex_ids is None else ("lv_sh", env.lightvol_wh)
        lm = None if env.lightmap_tex_ids is None else ("lm_sh", env.lightmap_wh)
        return lv, lm

    def pooled(self) -> bool:
        """Some texture set is bound, and every bound one has its pool in
        the scene and its static dims: sample_spherical_harmonics takes the
        interleaved path for each."""
        sets = [s for s in self._sets() if s is not None]
        return bool(sets) and all(key in self.scene and wh is not None for key, wh in sets)

    def pools_struct(self, fn: str, dev) -> _ShPools:
        """The ShPools of csrc/shade.cu's kernels (pooled() only): the
        bound pools' tables, dims and the probe box on dev; raises on pools
        and uniforms the kernels do not take."""
        lv, lm = self._sets()
        p = _ShPools()
        if lv is not None:
            w, h = (int(v) for v in lv[1])
            z = int(self.env.lightvol_z_layers or 0)
            s, rows, vec = _pool_table(fn, "scene['lv_sh']", self.scene.get("lv_sh"), dev)
            if w < 1 or h < 1 or z < 1 or rows < w * h * z or w * h * z >= 2 ** 31:
                raise ValueError(f"{fn}: the light volume's pool holds {rows} rows, its dims "
                                 f"{w} x {h} x {z} want {w * h * z}")
            for name in ("probes_bottom_left", "probes_scale"):
                t = self.uniforms.get(name)
                if not isinstance(t, torch.Tensor) or t.device != dev \
                        or t.dtype != torch.float32 or tuple(t.shape) != (3,) or t.data_ptr() % 4:
                    raise ValueError(f"{fn}: uniforms[{name!r}] must be (3,) float32 on {dev}, "
                                     f"got " + (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                                                if isinstance(t, torch.Tensor)
                                                else type(t).__name__))
            bl, sc = self.uniforms["probes_bottom_left"], self.uniforms["probes_scale"]
            p.lv, p.lv_s, p.lv_rows, p.lv_vec = self.scene["lv_sh"].data_ptr(), s, rows, vec
            p.lv_w, p.lv_h, p.lv_z = w, h, z
            p.bl, p.bl_s, p.scale, p.scale_s = bl.data_ptr(), bl.stride(0), sc.data_ptr(), \
                sc.stride(0)
        if lm is not None:
            w, h = (int(v) for v in lm[1])
            s, rows, vec = _pool_table(fn, "scene['lm_sh']", self.scene.get("lm_sh"), dev)
            if w < 1 or h < 1 or rows < w * h or w * h >= 2 ** 31:
                raise ValueError(f"{fn}: the lightmaps' pool holds {rows} rows, its dims "
                                 f"{w} x {h} want {w * h}")
            p.lm, p.lm_s, p.lm_rows, p.lm_vec = self.scene["lm_sh"].data_ptr(), s, rows, vec
            p.lm_w, p.lm_h = w, h
        return p


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


def _material_inputs(gbuf: GBuffer, scene: dict, aniso_taps: int, s16):
    """(s16 (P, 16), rows, mat) of shade: the lanes' material textures, and
    the table whose rows hold their factors and flags (rows[mat], or with
    mat None a row a lane). The textures come pre-sampled in `s16` from the
    material-path partition, else from the interleaved pool when every
    material takes it, else from the classic per-slot samplers (partial
    pools without the partition, scenes without the pool); the factors
    from mat_row_mq (the shade row's tail when the g-buffer carries it;
    incapable materials' rows carry their real factors too), else from
    mat_row."""
    m = scene["materials"]
    if s16 is not None or _whole_pool(scene):
        if gbuf.mat_tail is not None:
            rows, mat = gbuf.mat_tail, None
        else:
            rows, mat = m["mat_row_mq"], gbuf.material
        if s16 is None:
            s16 = _interleaved(scene, gbuf, aniso_taps, SLOTS)
        return s16, rows, mat
    s16 = sample.sample_classic(ldr_pool(scene), m["mat_row"], gbuf.material, gbuf.uv,
                                gbuf.duvdx, gbuf.duvdy, aniso_taps)
    return s16, m["mat_row"], gbuf.material


def _ambient_only(env) -> bool:
    """sample_spherical_harmonics gives every lane env.ambient_sh."""
    return env.lightvol_tex_ids is None and env.lightmap_tex_ids is None


def shade_lanes_plain(gbuf: GBuffer, s16, rows, mat, sh, ambient_sh, eye,
                      inline_tonemapping: bool = True, inline_srgb: bool = True):
    """shade_lanes' plain version, the torch chain: the factors and flags
    of the lanes' material rows, the PBR terms, the SH lighting (`sh` (P,
    4, 3), or with sh None the 12 `ambient_sh`), the display transform,
    the unlit branch and the misses. A PoolSH `sh` is sampled here, on
    gbuf."""
    pf, pi = _factors(rows if mat is None else rows[:, :META][mat])
    if isinstance(sh, PoolSH):
        sh = sh.sample(gbuf)
    if sh is None:
        sh = device_values(ambient_sh, torch.float32, s16.device).reshape(4, 3).expand(
            s16.shape[0], 4, 3)
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

    view = _normalize(eye[None, :] - gbuf.world_pos)

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


def shade_lanes(gbuf: GBuffer, s16, rows, mat, sh, ambient_sh, eye,
                inline_tonemapping: bool = True, inline_srgb: bool = True):
    """-> (rgb (P, 3), alpha (P,)) of the lanes of `gbuf` from their
    material textures s16 (P, 16) f32, the table `rows` (R, >= 20) f32
    whose rows hold their factors and flags, indexed by mat (P,) i32, or
    with mat None a row a lane (the g-buffer's mat_tail), their SH
    coefficients sh (P, 4, 3) f32, or a PoolSH (the frame's light volume
    and lightmaps), or with sh None the 12 host floats `ambient_sh`, and the
    view's eye (3,) f32 on the device. CUDA tensors launch csrc/shade.cu
    shade_kernel (bit for bit with the plain version on the card; it reads
    the rows, the eye and every lane's inputs in place, and skips an
    invalid lane's arithmetic); a pooled PoolSH the kernel samples itself
    at the valid lanes' world_pos, lm_uv and lightmapped
    (csrc/sh_sample.cuh), another one (the layered path) gives its torch
    chain's SH first, counted in shade.SAMPLED_SH. CPU tensors run
    shade_lanes_plain; anything the kernel does not take raises. Counts
    its launches in shade.LAUNCHES."""
    dev = gbuf.valid.device
    if dev.type == "cpu":
        return shade_lanes_plain(gbuf, s16, rows, mat, sh, ambient_sh, eye,
                                 inline_tonemapping, inline_srgb)
    pools = None
    if isinstance(sh, PoolSH):
        if sh.pooled():
            pools, sh = sh, None
        else:
            sh = sh.sample(gbuf)
            _SHADE_COUNTER.SAMPLED_SH += 1
    lanes = gbuf.valid.shape[0] if gbuf.valid.dim() == 1 else -1
    for name, t in (("valid", gbuf.valid), ("front_facing", gbuf.front_facing)):
        if t.device != dev or t.dtype != torch.bool or t.shape != (lanes,):
            raise ValueError(f"shade: gbuf.{name} must be ({lanes},) bool on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t, width in (("gbuf.normal", gbuf.normal, 3), ("gbuf.world_pos", gbuf.world_pos, 3),
                           ("gbuf.dpdx", gbuf.dpdx, 3), ("gbuf.dpdy", gbuf.dpdy, 3),
                           ("gbuf.duvdx", gbuf.duvdx, 2), ("gbuf.duvdy", gbuf.duvdy, 2),
                           ("s16", s16, 16)):
        _check_lane_rows(name, t, (lanes, width), dev)
    if rows.device != dev or rows.dtype != torch.float32:
        raise TypeError(f"shade: the material rows must be float32 on {dev}, got {rows.dtype} "
                        f"on {rows.device}")
    if rows.dim() != 2 or rows.shape[1] < META or (lanes and rows.shape[0] == 0) \
            or rows.stride(1) != 1 or rows.data_ptr() % 4:
        raise ValueError(f"shade: the material rows must be a (R, >= {META}) table with "
                         f"adjacent columns, non-empty where there are lanes, got "
                         f"{tuple(rows.shape)} strides {rows.stride()}")
    if mat is None:
        if rows.shape[0] != lanes:
            raise ValueError(f"shade: a material row a lane needs {lanes} rows, got "
                             f"{rows.shape[0]}")
        mat_ptr, mat_s = None, 0
    else:
        if mat.device != dev or mat.dtype != torch.int32 or mat.shape != (lanes,) \
                or mat.data_ptr() % 4:
            raise ValueError(f"shade: mat must be ({lanes},) int32 on {dev}, got {mat.dtype} "
                             f"{tuple(mat.shape)} on {mat.device}")
        mat_ptr, mat_s = mat.data_ptr(), mat.stride(0)
    if sh is not None:
        _check_lane_rows("sh", sh, (lanes, 4, 3), dev)
        if sh.stride(1) != 3:
            raise ValueError(f"shade: sh must hold each lane's (4, 3) adjacent, got strides "
                             f"{sh.stride()}")
    lm_uv = lightmapped = None
    if pools is not None:
        pools = pools.pools_struct("shade", dev)
        if pools.lm_w:
            _check_lane_rows("gbuf.lm_uv", gbuf.lm_uv, (lanes, 2), dev)
            lm_uv = gbuf.lm_uv
            if pools.lv_w:
                t = gbuf.lightmapped
                if not isinstance(t, torch.Tensor) or t.device != dev or t.dtype != torch.bool \
                        or tuple(t.shape) != (lanes,):
                    raise ValueError(f"shade: gbuf.lightmapped must be ({lanes},) bool on {dev}")
                lightmapped = t
    ambient = torch.tensor(ambient_sh, dtype=torch.float32)
    if ambient.numel() != 12:
        raise ValueError(f"shade: ambient_sh must hold 12 values, got {ambient.numel()}")
    if eye.device != dev or eye.dtype != torch.float32 or eye.shape != (3,) \
            or eye.data_ptr() % 4:
        raise ValueError(f"shade: eye must be (3,) float32 on {dev}, got {eye.dtype} "
                         f"{tuple(eye.shape)} on {eye.device}")
    if lanes >= 2 ** 31:
        raise ValueError(f"shade: {lanes} lanes")
    _need_cuda("shade", dev)
    rgb = torch.empty((lanes, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((lanes,), dtype=torch.float32, device=dev)
    if lanes:
        s16_vec = s16.data_ptr() % 16 == 0 and s16.stride(0) % 4 == 0
        g = gbuf
        with torch.cuda.device(dev):
            if pools is not None:
                _check_pools_mirror()
            err = _kernel_fn("sc_shade")(
                lanes, g.valid.data_ptr(), g.valid.stride(0), g.front_facing.data_ptr(),
                g.front_facing.stride(0),
                *[x for t in (g.normal, g.world_pos, g.dpdx, g.dpdy, g.duvdx, g.duvdy)
                  for x in (t.data_ptr(), t.stride(0))],
                s16.data_ptr(), s16.stride(0), int(s16_vec), rows.data_ptr(), rows.stride(0),
                rows.shape[0], mat_ptr, mat_s,
                None if sh is None else sh.data_ptr(), 0 if sh is None else sh.stride(0),
                None if pools is None else ctypes.byref(pools),
                None if lm_uv is None else lm_uv.data_ptr(),
                0 if lm_uv is None else lm_uv.stride(0),
                None if lightmapped is None else lightmapped.data_ptr(),
                0 if lightmapped is None else lightmapped.stride(0),
                (ctypes.c_float * 12)(*ambient.tolist()), eye.data_ptr(), eye.stride(0),
                int(bool(inline_tonemapping)), int(bool(inline_srgb)), rgb.data_ptr(),
                alpha.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"shade kernel launch failed: cudaError_t {err}")
        _launched(_SHADE_COUNTER)
    return rgb, alpha


def _need_cuda(fn: str, dev) -> None:
    """A kernel's wrapper past its checks: the kernel runs on CUDA tensors
    only (a wrapper takes its plain version for CPU tensors alone)."""
    if dev.type != "cuda":
        raise ValueError(f"{fn}: the kernel runs on CUDA tensors, not {dev}")


def _check_lane_rows(name, t, shape, dev) -> None:
    """An f32 tensor of `shape` on dev whose last dim is adjacent (any lane
    stride), 4-B aligned."""
    if t.device != dev:
        raise ValueError(f"shade: {name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"shade: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or t.stride(-1) != 1 or t.data_ptr() % 4:
        raise ValueError(f"shade: {name} must be {tuple(shape)} with adjacent components, got "
                         f"{tuple(t.shape)} strides {t.stride()}")


def shade_inputs(gbuf: GBuffer, scene: dict, uniforms: dict, view_index: int, env=None,
                 inline_tonemapping: bool = True, inline_srgb: bool = True,
                 aniso_taps: int = 1, s16=None) -> dict:
    """shade_lanes' arguments of a shade call: the material sampling
    (_material_inputs), the SH (a PoolSH where a light volume or lightmaps
    are bound: shade_lanes_plain samples it with the torch chain, the
    kernel reads its pools in place; else the ambient coefficients by
    value) and the view's eye."""
    if env is None:
        raise ValueError("shade needs EnvBindings")
    tex, rows, mat = _material_inputs(gbuf, scene, aniso_taps, s16)
    sh = None if _ambient_only(env) else PoolSH(scene, uniforms, env)
    return dict(gbuf=gbuf, s16=tex, rows=rows, mat=mat, sh=sh, ambient_sh=env.ambient_sh,
                eye=uniforms["eye"][view_index], inline_tonemapping=inline_tonemapping,
                inline_srgb=inline_srgb)


def shade_plain(
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
    """shade's plain version, the torch chain: shade_inputs, then
    shade_lanes_plain."""
    return shade_lanes_plain(**shade_inputs(gbuf, scene, uniforms, view_index, env,
                                            inline_tonemapping, inline_srgb, aniso_taps, s16))


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
    material takes it, else from the classic per-slot samplers
    (_material_inputs). The rest is shade_lanes on shade_inputs: CUDA
    tensors launch csrc/shade.cu, CPU tensors run the torch chain (so that
    shade is shade_plain there). Counts the kernel's launches in
    shade.LAUNCHES."""
    return shade_lanes(**shade_inputs(gbuf, scene, uniforms, view_index, env,
                                      inline_tonemapping, inline_srgb, aniso_taps, s16))


shade.LAUNCHES = 0
shade.SAMPLED_SH = 0  # launches whose SH the torch chain sampled first (the layered path)
# the wrapper whose LAUNCHES count the shade kernel's launches, however the
# frame's name for it is rebound (a recording or plain twin put in its place)
_SHADE_COUNTER = shade


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
