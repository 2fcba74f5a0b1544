"""Skybox: a ray per pixel centre from the inverse projection, sampled
from the IBL cubemap (port of ``superconductor_tpu/ops/sky.py``): over the
whole band (``sample_skybox``) or at the flat pixel indices of the sky
worklist (``sample_skybox_at``)."""

from __future__ import annotations

import torch

from ..math3d import quat_rotate
from .geometry import device_values
from .texture import hdr_pool, sample_cubemap
from .tonemap import tonemap_and_encode


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


def sample_skybox(scene, env, width, height, projection_inverse, view_quat,
                  inline_tonemapping=True, inline_srgb=True, y_offset=0,
                  full_height=None):
    rays = skybox_rays(width, height, projection_inverse, view_quat, y_offset,
                       full_height)
    return shade_sky_rays(scene, env, rays, inline_tonemapping, inline_srgb)


def sample_skybox_at(scene, env, idx, width, projection_inverse, view_quat,
                     inline_tonemapping=True, inline_srgb=True, y_offset=0,
                     full_height=None):
    """Skybox colour at flat band pixel indices only (the sky worklist):
    covered pixels never pay the cubemap gather."""
    rays = skybox_rays_at(idx, width, projection_inverse, view_quat, y_offset,
                          full_height)
    return shade_sky_rays(scene, env, rays, inline_tonemapping, inline_srgb)
