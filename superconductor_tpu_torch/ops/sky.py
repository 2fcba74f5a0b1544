"""Skybox: a ray per pixel centre from the inverse projection, sampled
from the IBL cubemap (port of ``superconductor_tpu/ops/sky.py``): over the
whole band (``sample_skybox``) or at the flat pixel indices of the sky
worklist (``sample_skybox_at``).

Both wrappers launch csrc/sky.cu's hand-written kernel for CUDA tensors
and run their plain versions, the torch chains ``sample_skybox_plain`` and
``sample_skybox_at_plain``, for CPU tensors (bit for bit with the kernel
on the card). No wrapper falls back: anything the kernel does not take
raises. ``sample_skybox.LAUNCHES`` and ``sample_skybox_at.LAUNCHES`` count
the kernel's launches from each, as ops/raster.py's wrappers count theirs;
the frame (render/frame.py) calls both by the names it imports.
"""

from __future__ import annotations

import ctypes

import torch

from ..math3d import quat_rotate
from .geometry import device_values
from .raster import _kernel_fn, _launched
from .texture import WRAP_CLAMP, hdr_pool, sample_cubemap
from .tonemap import tonemap_and_encode

# csrc/sky.cu Texel: the HDR pool's texel types
_TEXEL_TYPES = {torch.uint8: 0, torch.float16: 1, torch.float32: 2}


def _rays_from_ndc(ndc_x, ndc_y, projection_inverse, view_quat):
    """World rays: camera rotation * (projection_inverse @ (x, y, 0, 1)).xyz,
    the 4x4 product written out as (x*m0 + y*m1) + (0*m2 + 1*m3), the
    summation order of the reference's CPU dot (ops/geometry.py
    clip_transform)."""
    m = projection_inverse
    zero = torch.zeros_like(ndc_x)
    one = torch.ones_like(ndc_x)
    ray = torch.stack(
        [
            (ndc_x * m[j, 0] + ndc_y * m[j, 1]) + (zero * m[j, 2] + one * m[j, 3])
            for j in range(3)
        ],
        dim=-1,
    )
    return quat_rotate(view_quat[None, :], ray)


def skybox_rays(width, height, projection_inverse, view_quat, y_offset=0,
                full_height=None):
    """(H*W, 3) world rays through every pixel centre of the band
    [y_offset, y_offset + height) of a full_height-tall image."""
    full_height = full_height or height
    dev = projection_inverse.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5 + y_offset
    ) / full_height * 2.0
    ndc_x = xs[None, :].expand(height, width).reshape(-1)
    ndc_y = ys[:, None].expand(height, width).reshape(-1)
    return _rays_from_ndc(ndc_x, ndc_y, projection_inverse, view_quat)


def skybox_rays_at(idx, width, projection_inverse, view_quat, y_offset=0,
                   full_height=None):
    """Rays through the centres of flat band pixel indices `idx` (P,), by
    div/mod (the sky-worklist path, RenderConfig.sky_px_cap)."""
    x = torch.remainder(idx, width).to(torch.float32) + 0.5
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32) + 0.5 + y_offset
    ndc_x = x / width * 2.0 - 1.0
    ndc_y = 1.0 - y / full_height * 2.0
    return _rays_from_ndc(ndc_x, ndc_y, projection_inverse, view_quat)


def shade_sky_rays(scene, env, rays, inline_tonemapping=True, inline_srgb=True):
    """Cubemap sample + display transform for rays (P, 3)."""
    base = env.ibl_cubemap_base
    if base < 0:
        rgb = device_values(env.clear_color, torch.float32, rays.device)
        rgb = rgb.expand(rays.shape[0], 3)
    else:
        rgb = sample_cubemap(
            hdr_pool(scene), scene["tex_hdr"], base, rays,
            static=getattr(env, "ibl_cubemap_static", None),
        )[..., :3]
    return tonemap_and_encode(rgb, inline_tonemapping, inline_srgb)


def sample_skybox_plain(scene, env, width, height, projection_inverse, view_quat,
                        inline_tonemapping=True, inline_srgb=True, y_offset=0,
                        full_height=None):
    """sample_skybox's plain version, the torch chain: the band's rays,
    the cubemap sample and the display transform."""
    rays = skybox_rays(width, height, projection_inverse, view_quat, y_offset,
                       full_height)
    return shade_sky_rays(scene, env, rays, inline_tonemapping, inline_srgb)


def sample_skybox_at_plain(scene, env, idx, width, projection_inverse, view_quat,
                           inline_tonemapping=True, inline_srgb=True, y_offset=0,
                           full_height=None):
    """sample_skybox_at's plain version, the torch chain."""
    rays = skybox_rays_at(idx, width, projection_inverse, view_quat, y_offset,
                          full_height)
    return shade_sky_rays(scene, env, rays, inline_tonemapping, inline_srgb)


def sample_skybox(scene, env, width, height, projection_inverse, view_quat,
                  inline_tonemapping=True, inline_srgb=True, y_offset=0,
                  full_height=None):
    """Skybox colour (H*W, 3) f32 of every pixel of the band [y_offset,
    y_offset + height) of a full_height-tall image (None: height).
    projection_inverse (4, 4) and view_quat (4,) f32 on the device. CUDA
    tensors launch csrc/sky.cu sky_kernel, CPU tensors run
    sample_skybox_plain. Counts its launches in sample_skybox.LAUNCHES."""
    if projection_inverse.device.type == "cpu":
        return sample_skybox_plain(scene, env, width, height, projection_inverse, view_quat,
                                   inline_tonemapping, inline_srgb, y_offset, full_height)
    return _sky_launch(scene, env, int(height) * int(width), width, None, projection_inverse,
                       view_quat, inline_tonemapping, inline_srgb, y_offset,
                       full_height or height, _SKYBOX_COUNTER)


sample_skybox.LAUNCHES = 0
# the wrappers whose LAUNCHES count the kernel's launches, however the
# frame's names for them are rebound (a recording or plain twin put in
# their place)
_SKYBOX_COUNTER = sample_skybox


def sample_skybox_at(scene, env, idx, width, projection_inverse, view_quat,
                     inline_tonemapping=True, inline_srgb=True, y_offset=0,
                     full_height=None):
    """Skybox colour (P, 3) f32 at flat band pixel indices `idx` (P,) i32
    or i64 only (the sky worklist): covered pixels never pay the cubemap
    gather. CUDA tensors launch csrc/sky.cu sky_kernel, CPU tensors run
    sample_skybox_at_plain. Counts its launches in
    sample_skybox_at.LAUNCHES."""
    if projection_inverse.device.type == "cpu":
        return sample_skybox_at_plain(scene, env, idx, width, projection_inverse, view_quat,
                                      inline_tonemapping, inline_srgb, y_offset, full_height)
    if full_height is None:
        raise TypeError("sample_skybox_at: full_height is required")
    dev = projection_inverse.device
    if idx.device != dev or idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise ValueError(f"sample_skybox_at: idx must be (P,) int32 or int64 on {dev}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    return _sky_launch(scene, env, idx.shape[0], width, idx, projection_inverse, view_quat,
                       inline_tonemapping, inline_srgb, y_offset, full_height,
                       _SKYBOX_AT_COUNTER)


sample_skybox_at.LAUNCHES = 0
_SKYBOX_AT_COUNTER = sample_skybox_at


def kernel_variant(scene, env, band, inline_tonemapping, inline_srgb) -> tuple:
    """csrc/sky.cu sky_kernel's template arguments for a launch: (band,
    texel type (_TEXEL_TYPES; 3 without a cubemap), quad-packed pool, static
    placement, aces, srgb); without a cubemap the pool's two are 0."""
    texel, quad, static = 3, 0, 0
    if env.ibl_cubemap_base >= 0:
        pool = hdr_pool(scene)
        texel, quad = _TEXEL_TYPES[pool.dtype], int(pool.shape[1] == 16)
        static = int(getattr(env, "ibl_cubemap_static", None) is not None)
    return (int(bool(band)), texel, quad, static, int(bool(inline_tonemapping)),
            int(bool(inline_srgb)))


def pixels_a_thread() -> int:
    """The pixels (worklist lanes) a thread of the built csrc/sky.cu
    kernel computes (its kPx)."""
    return int(_kernel_fn("sc_sky_pixels_a_thread")())


def _variant_code(variant: tuple) -> int:
    """csrc/sky.cu launch's code of a kernel_variant."""
    band, texel, quad, static, aces, srgb = variant
    return band << 6 | texel << 4 | quad << 3 | static << 2 | aces << 1 | srgb


def fast_divisor(d: int) -> tuple:
    """(multiplier, shift) for the kernel's division of 0 <= n < 2 ** 31 by
    d >= 1: n // d == (n * multiplier >> 32) >> shift, with multiplier 0
    meaning d == 1 (CUTLASS's FastDivmod: multiplier ceil(2 ** (31 + l) /
    d), shift l - 1, l = ceil(log2 d))."""
    if d == 1:
        return 0, 0
    log2 = (d - 1).bit_length()
    return ((1 << (31 + log2)) + d - 1) // d, log2 - 1


def _sky_launch(scene, env, lanes, width, idx, projection_inverse, view_quat,
                inline_tonemapping, inline_srgb, y_offset, full_height, counter):
    """Check the inputs of csrc/sky.cu's kernel, allocate its (lanes, 3)
    result and launch it on the current stream (idx None: the band's pixels
    in order, lanes // width rows); counts the launch in counter.LAUNCHES."""
    dev = projection_inverse.device
    for name, t, shape in (("projection_inverse", projection_inverse, (4, 4)),
                           ("view_quat", view_quat, (4,))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"sky: {name} must be {shape} float32 on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    width, full_height = int(width), int(full_height)
    if width <= 0 or full_height <= 0:
        raise ValueError(f"sky: width {width} and full_height {full_height} must be positive")
    if lanes >= 2 ** 31:
        raise ValueError(f"sky: {lanes} pixels")
    pool, faces, face_table = None, [0] * 24, None
    if env.ibl_cubemap_base >= 0:
        pool = hdr_pool(scene)
        if pool.device != dev or pool.dtype not in _TEXEL_TYPES or pool.dim() != 2 \
                or pool.shape[1] not in (4, 16) or not pool.is_contiguous() \
                or pool.shape[0] == 0:
            raise ValueError(f"sky: the HDR pool must be a contiguous, non-empty (N, 4) or "
                             f"(N, 16) u8, f16 or f32 pool on {dev}, got {pool.dtype} "
                             f"{tuple(pool.shape)} on {pool.device}")
        static = getattr(env, "ibl_cubemap_static", None)
        if static is not None:
            offs, w, h = static
            faces = [v for off in offs for v in (int(off), int(w), int(h), WRAP_CLAMP)]
        else:
            face_table = descriptor_faces(scene["tex_hdr"], env.ibl_cubemap_base, dev)
    if dev.type != "cuda":
        raise ValueError(f"sky: the kernel runs on CUDA tensors, not {dev}")
    variant = kernel_variant(scene, env, idx is None, inline_tonemapping, inline_srgb)
    clear = torch.tensor(env.clear_color, dtype=torch.float32).tolist()
    out = torch.empty((lanes, 3), dtype=torch.float32, device=dev)
    if lanes:
        host_faces = (ctypes.c_int * 24)(*faces)
        div_mul, div_shift = fast_divisor(width)
        with torch.cuda.device(dev):
            err = _kernel_fn("sc_sky")(
                lanes, width, lanes // width, int(y_offset),
                # x / width and y / full_height: products with the reciprocals
                # taken in double, rounded once to f32 (ctypes' c_float)
                1.0 / width, 1.0 / full_height, div_mul, div_shift,
                None if idx is None else idx.data_ptr(), 0 if idx is None else idx.stride(0),
                int(idx is not None and idx.dtype == torch.int64),
                projection_inverse.data_ptr(), projection_inverse.stride(0),
                projection_inverse.stride(1), view_quat.data_ptr(), view_quat.stride(0),
                None if pool is None else pool.data_ptr(), 0 if pool is None else pool.shape[0],
                int(pool is not None and pool.data_ptr() % 16 == 0),
                ctypes.addressof(host_faces),
                None if face_table is None else face_table.data_ptr(), *clear,
                _variant_code(variant), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"sky kernel launch failed: cudaError_t {err}")
        _launched(counter)
    return out


def descriptor_faces(tex_desc: dict, base: int, dev) -> torch.Tensor:
    """(6, 4) i32 (offset, w, h, wrap) of level 0 of the cubemap's faces,
    textures base .. base + 5, gathered on the device from the packed
    descriptor rows (tex_meta, mip_owh) as texture.sample_bilinear_level
    gathers them (no host read)."""
    if "tex_meta" not in tex_desc:
        raise ValueError("sky: the descriptor placement takes the packed tex_meta / mip_owh rows")
    tex_id = torch.arange(6, dtype=torch.int32, device=dev) + base
    level = torch.zeros((6,), dtype=torch.int32, device=dev)
    meta = tex_desc["tex_meta"][tex_id]
    count, wrap = meta[:, 1], meta[:, 2]
    owh = tex_desc["mip_owh"][meta[:, 0] + torch.minimum(torch.clamp_min(level, 0), count - 1)]
    return torch.stack([owh[:, 0], owh[:, 1], owh[:, 2], wrap], dim=1).to(torch.int32).contiguous()
