"""Particle pipeline: camera-facing quads and the 6-way smoke lighting
model (port of ``superconductor_tpu/ops/particles.py``).

Each particle is a view-space quad scaled by (scale.x, scale.y), rastered
by the k-buffer pass and shaded per pixel. Bound smoke textures are
sampled on the smoke pool (both maps in one row gather, the emissive LUT
from its own rows) when the scene publishes it, else per slot from the
LDR pool; without smoke textures the reference shades a procedural radial
puff (its own branch, not a fallback).

``particle_geometry`` and ``shade_particles`` launch hand-written kernels
for CUDA tensors (csrc/geometry.cu ``view_setup_kernel(ParticleQuadArgs)``,
one launch a view; csrc/shade.cu ``shade_kernel(ParticleShadeArgs)``, one
launch a layer, the SH pools sampled in it where the frame's ``PoolSH``
gives them; two where the SH comes from another sampler) and run
their plain versions, the torch chains ``particle_geometry_plain`` and
``shade_particles_plain``, for CPU tensors (bit for bit with the kernels
on the card). Each counts its launches in its ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .geometry import TriangleSetup, _setup_from_clip, clip_transform, device_values
from .lines import _quad_corner_ids
from .raster import _kernel_fn, _launched
from . import shade as _shade_mod
from .shade import PoolSH, _ambient_only, _normalize, _ShPools, sh_channel_vectors
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


def particle_geometry_plain(particles: dict, view, view_inverse, projection, width: int,
                            height: int, flip_viewport: bool = False):
    """particle_geometry's plain version, the torch chain (reference
    ops/particles.py:42). Corners x, y in {-0.5, 0.5}, two triangles (0,
    1, 2) and (0, 2, 3) per quad, all of the first triangles before all of
    the second."""
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


def shade_particles_plain(pair, px, py, tri: TriangleSetup, attrs: ParticleAttrs,
                          particles: dict, scene: dict, uniforms: dict, env, view_index: int,
                          sh_sampler, inline_tonemapping: bool = True,
                          inline_srgb: bool = True):
    """shade_particles' plain version, the torch chain: per-pixel particle
    shading -> (rgb display-encoded, alpha)
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


# --- The kernels (csrc/geometry.cu, csrc/shade.cu) ---------------------------

def _mirror(name: str, source: str, fields: str, extra: tuple = (), nested: dict = None):
    """A ctypes Structure of `fields` (each 8 B: pointers where the name
    ends in "*", a struct where `nested` names its mirror, else long long)
    and then `extra`."""
    nested = nested or {}
    spec = [(f.rstrip("*"), nested[f] if f in nested else
             ctypes.c_void_p if f.endswith("*") else ctypes.c_longlong) for f in fields.split()]
    return type(name, (ctypes.Structure,), {
        "_fields_": spec + list(extra), "__doc__": f"{source} {name.lstrip('_')}, field for field."})


_QuadArgs = _mirror("_QuadArgs", "csrc/geometry.cu ParticleQuadArgs", """
    n center* scale* valid* uv_offset* uv_scale* colour* emissive_colour* use_emissive_lut*
    lut_y* view* view_s0 view_s1 view_inverse* vi_s0 vi_s1 projection* proj_s0 proj_s1 width
    height flip_viewport setup* bbox* tri_valid* tri_id* particle* num_valid* uv* world_pos*
    packed*""")
_ShadeArgs = _mirror("_ShadeArgs", "csrc/shade.cu ParticleShadeArgs", """
    lanes form pair* pair_s px* px_s py* py_s packed* packed_s n_rows packed_vec eye* eye_s
    view_inverse* vi_s0 vi_s1 sh* sh_s0 sh_s1 sh_s2 pools smoke smoke_ab* ab_s ab_rows ab_w
    ab_h ab_wrap smoke_lut* lut_s lut_rows lut_w lut_h lut_wrap lut_srgb texels* texels_s
    texels_rows texels_quad tex_meta* meta_s n_tex mip_owh* owh_s n_owh tex_a tex_b tex_lut
    aces srgb rgb* alpha* world_pos*""", (("ambient", ctypes.c_float * 12),),
    {"pools": _ShPools})
SMOKE_PUFF, SMOKE_POOL, SMOKE_SLOTS = 0, 1, 2  # csrc/shade.cu kSmoke*
PARTICLE_COLUMNS = {"center": (torch.float32, 3), "scale": (torch.float32, 2),
                    "valid": (torch.bool, None), "uv_offset": (torch.float32, 2),
                    "uv_scale": (torch.float32, 2), "colour": (torch.float32, 3),
                    "emissive_colour": (torch.float32, 3),
                    "use_emissive_lut": (torch.int32, None), "lut_y": (torch.float32, None)}

_args_checked: set = set()  # the mirrors whose size matched the library's struct


def _entry(symbol: str, size_symbol: str, mirror, *size_args):
    """The kernel library's entry point `symbol`, after checking (once)
    that its struct of arguments has the mirror's size."""
    if mirror not in _args_checked:
        size = _kernel_fn(size_symbol)(*size_args)
        if size != ctypes.sizeof(mirror):
            raise RuntimeError(f"{mirror.__doc__.split()[0]}'s {mirror.__name__.lstrip('_')} "
                               f"takes {size} B, its ctypes mirror {ctypes.sizeof(mirror)} B")
        _args_checked.add(mirror)
    return _kernel_fn(symbol)


def _launch(fn: str, symbol: str, size_symbol: str, args, *size_args) -> None:
    err = _entry(symbol, size_symbol, type(args), *size_args)(
        ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed: cudaError_t {err}")


def _tensor(fn: str, name: str, t, dtype, shape, dev) -> None:
    """t: a contiguous `dtype` tensor of `shape` on dev."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor, got {type(t).__name__}")
    if t.device != dev or t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype} on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {shape}, got {tuple(t.shape)} "
                         f"strides {t.stride()}")


def _matrix(fn: str, name: str, m, dev) -> None:
    """m: a (4, 4) f32 tensor on dev, 4-B aligned (any strides)."""
    if not isinstance(m, torch.Tensor) or m.device != dev or m.dtype != torch.float32 \
            or tuple(m.shape) != (4, 4) or m.data_ptr() % 4:
        raise ValueError(f"{fn}: {name} must be a (4, 4) float32 tensor on {dev}, got "
                         + (f"{m.dtype} {tuple(m.shape)} on {m.device}"
                            if isinstance(m, torch.Tensor) else type(m).__name__))


def particle_geometry(particles: dict, view, view_inverse, projection, width: int,
                      height: int, flip_viewport: bool = False):
    """Particles -> camera-facing quads -> (TriangleSetup, ParticleAttrs)
    (reference ops/particles.py:42): a quad a particle about its centre
    in view space, its corners x, y in {-0.5, 0.5} times its scale,
    two triangles (0, 1, 2) and (0, 2, 3), all of the first triangles
    before all of the second, with their setup rows, boxes and packed
    shading rows. CUDA tensors launch csrc/geometry.cu
    view_setup_kernel(ParticleQuadArgs) once (bit for bit with the plain
    version on the card), CPU tensors run particle_geometry_plain; anything
    the kernel does not take raises. Counts its launches in
    particle_geometry.LAUNCHES."""
    dev = particles["center"].device
    if dev.type == "cpu":
        return particle_geometry_plain(particles, view, view_inverse, projection, width, height,
                                       flip_viewport)
    fn = "particle_geometry"
    n = particles["center"].shape[0]
    for name, (dtype, cols) in PARTICLE_COLUMNS.items():
        _tensor(fn, f"particles[{name!r}]", particles.get(name), dtype,
                (n,) if cols is None else (n, cols), dev)
    for name, m in (("view", view), ("view_inverse", view_inverse), ("projection", projection)):
        _matrix(fn, name, m, dev)
    if not (1 <= int(width) < 2 ** 24 and 1 <= int(height) < 2 ** 24) or 4 * n >= 2 ** 31:
        raise ValueError(f"{fn}: a {width} x {height} target and {n} particles")
    if dev.type != "cuda":
        raise ValueError(f"{fn}: the kernel runs on CUDA tensors, not {dev}")
    t = 2 * n

    def empty(*shape, dtype=torch.float32):
        return torch.empty((t, *shape), dtype=dtype, device=dev)

    setup, bbox, uv, world, packed = empty(16), empty(4, dtype=torch.int32), empty(3, 2), \
        empty(3, 3), empty(32)
    valid, tri_id, pid = empty(dtype=torch.bool), empty(dtype=torch.int32), \
        empty(dtype=torch.int32)
    num_valid = torch.empty((), dtype=torch.int32, device=dev)
    a = _QuadArgs(n, *(particles[k].data_ptr() for k in PARTICLE_COLUMNS),
                  view.data_ptr(), *view.stride(), view_inverse.data_ptr(),
                  *view_inverse.stride(), projection.data_ptr(), *projection.stride(),
                  int(width), int(height), int(bool(flip_viewport)),
                  *(x.data_ptr() for x in (setup, bbox, valid, tri_id, pid, num_valid, uv, world,
                                           packed)))
    with torch.cuda.device(dev):
        _launch(fn, "sc_particle_quads", "sc_geometry_args_bytes", a, 4)
    _launched(_PARTICLE_GEOMETRY_COUNTER)
    return (TriangleSetup(setup=setup, tri_id=tri_id, inst_id=pid, bbox=bbox, valid=valid,
                          num_valid=num_valid),
            ParticleAttrs(uv=uv, world_pos=world, particle=pid, packed=packed))


particle_geometry.LAUNCHES = 0
# the wrapper whose LAUNCHES count its kernel, however the frame's name for
# it is rebound (a recording or plain twin put in its place)
_PARTICLE_GEOMETRY_COUNTER = particle_geometry


def _u8_rows(fn: str, name: str, t, cols, dev) -> tuple:
    """(words a row, rows) of a u8 table of `cols` (a tuple of allowed
    widths) adjacent columns on dev, its rows 4-B aligned."""
    if not isinstance(t, torch.Tensor) or t.device != dev or t.dtype != torch.uint8 \
            or t.dim() != 2 or t.shape[1] not in cols or t.shape[0] < 1 or t.stride(1) != 1 \
            or t.stride(0) % 4 or t.data_ptr() % 4:
        raise ValueError(f"{fn}: {name} must be a non-empty (rows, {' or '.join(map(str, cols))})"
                         f" uint8 table on {dev} with 4-B aligned rows, got "
                         + (f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}"
                            if isinstance(t, torch.Tensor) else type(t).__name__))
    return t.stride(0) // 4, t.shape[0]


def _i32_rows(fn: str, name: str, t, dev) -> None:
    if not isinstance(t, torch.Tensor) or t.device != dev or t.dtype != torch.int32 \
            or t.dim() != 2 or t.shape[1] != 4 or t.shape[0] < 1 or t.stride(1) != 1 \
            or t.data_ptr() % 4:
        raise ValueError(f"{fn}: {name} must be a non-empty (rows, 4) int32 table on {dev} with "
                         f"adjacent columns")


def _smoke_fields(fn: str, scene: dict, env, dev) -> dict:
    """_ShadeArgs' smoke fields of the branch shade_particles_plain takes."""
    static = env.smoke_static
    if env.smoke_tex_ids is not None and static is not None and "smoke_ab" in scene:
        ab_s, ab_rows = _u8_rows(fn, "scene['smoke_ab']", scene["smoke_ab"], (32,), dev)
        lut_s, lut_rows = _u8_rows(fn, "scene['smoke_lut']", scene["smoke_lut"], (16,), dev)
        sw, sh, swrap, lw, lh, lwrap, lflags = (int(v) for v in static[:7])
        return dict(smoke=SMOKE_POOL, smoke_ab=scene["smoke_ab"].data_ptr(), ab_s=ab_s,
                    ab_rows=ab_rows, ab_w=sw, ab_h=sh, ab_wrap=swrap,
                    smoke_lut=scene["smoke_lut"].data_ptr(), lut_s=lut_s, lut_rows=lut_rows,
                    lut_w=lw, lut_h=lh, lut_wrap=lwrap,
                    lut_srgb=int(bool(lflags & TEXFLAG_SRGB)))
    if env.smoke_tex_ids is not None:
        texels = ldr_pool(scene)
        texels_s, texels_rows = _u8_rows(fn, "the LDR pool", texels, (4, 16), dev)
        desc = scene["tex"]
        for name in ("tex_meta", "mip_owh"):
            _i32_rows(fn, f"scene['tex'][{name!r}]", desc.get(name), dev)
        meta, owh = desc["tex_meta"], desc["mip_owh"]
        tex_a, tex_b, tex_lut = (int(t) for t in env.smoke_tex_ids[:3])
        return dict(smoke=SMOKE_SLOTS, texels=texels.data_ptr(), texels_s=texels_s,
                    texels_rows=texels_rows, texels_quad=int(texels.shape[1] == 16),
                    tex_meta=meta.data_ptr(), meta_s=meta.stride(0), n_tex=meta.shape[0],
                    mip_owh=owh.data_ptr(), owh_s=owh.stride(0), n_owh=owh.shape[0],
                    tex_a=tex_a, tex_b=tex_b, tex_lut=tex_lut)
    return dict(smoke=SMOKE_PUFF)


def ambient_values(env) -> torch.Tensor:
    """The SH the kernel takes by value where the environment binds no
    light volume and no lightmaps: env.ambient_sh as f32 on the host, the
    values sample_spherical_harmonics gives every lane there."""
    return torch.tensor(env.ambient_sh, dtype=torch.float32).reshape(-1)


def sh_form(env, sh_sampler) -> str:
    """How shade_particles' kernel takes a layer's SH: "ambient" (no light
    volume and no lightmaps bound: env.ambient_sh by value), "pools" (a
    PoolSH whose pools the kernel samples at each lane, one launch) or
    "sampled" (any other sampler, or a PoolSH on the layered path: a
    position launch, the sampler, a full launch)."""
    if _ambient_only(env):
        return "ambient"
    return "pools" if isinstance(sh_sampler, PoolSH) and sh_sampler.pooled() else "sampled"


def _lane_vector(fn: str, name: str, t, dtype, lanes: int, dev) -> None:
    if not isinstance(t, torch.Tensor) or t.device != dev or t.dtype != dtype \
            or tuple(t.shape) != (lanes,) or t.data_ptr() % 4:
        raise ValueError(f"{fn}: {name} must be ({lanes},) {dtype} on {dev}, got "
                         + (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                            if isinstance(t, torch.Tensor) else type(t).__name__))


def shade_particles(pair, px, py, tri: TriangleSetup, attrs: ParticleAttrs,
                    particles: dict, scene: dict, uniforms: dict, env, view_index: int,
                    sh_sampler, inline_tonemapping: bool = True,
                    inline_srgb: bool = True):
    """Per-pixel particle shading of a layer's lanes -> (rgb (P, 3)
    display-encoded, alpha (P,)) (reference ops/particles.py:166): pair
    (P,) i32 (-1 = none) into the billboards, px, py (P,) f32 the pixel
    centres; barycentrics from the quad triangle's setup edges, SH
    lighting at the interpolated world position, the six-way light maps
    and emissive mask from the smoke maps (or a radial puff without them),
    the emission from the LUT where the particle asks for it. CUDA tensors
    launch csrc/shade.cu shade_kernel(ParticleShadeArgs) on the packed rows
    (attrs.packed, required there), by the SH's form (sh_form): one launch
    with env.ambient_sh by value where the environment binds no light
    volume and no lightmaps, or where `sh_sampler` is a pooled PoolSH (the
    frame's) whose SH pools the kernel samples at each lane
    (csrc/sh_sample.cuh); with another sampler (or a PoolSH on the layered
    path), a launch writes the lanes' world positions, `sh_sampler` samples
    the SH there, and a second launch shades with it (bit for bit with the
    plain version on the card). Dead lanes (pair -1) that repeat a key a
    stride apart, as the frame's lanes past its worklist's count do, are
    computed once a run of them (csrc/shade.cu). CPU
    tensors run shade_particles_plain; anything the kernel does not take
    raises. Counts its launches in shade_particles.LAUNCHES."""
    dev = pair.device
    if dev.type == "cpu":
        return shade_particles_plain(pair, px, py, tri, attrs, particles, scene, uniforms, env,
                                     view_index, sh_sampler, inline_tonemapping, inline_srgb)
    fn = "shade_particles"
    if pair.dtype != torch.int32 or pair.dim() != 1 or pair.data_ptr() % 4:
        raise ValueError(f"{fn}: pair must be (P,) int32, got {pair.dtype} {tuple(pair.shape)}")
    lanes = pair.shape[0]
    for name, t in (("px", px), ("py", py)):
        _lane_vector(fn, name, t, torch.float32, lanes, dev)
    rows = attrs.packed
    if rows is None:
        raise ValueError(f"{fn}: the kernel takes the packed rows (attrs.packed), not the "
                         f"unpacked tables")
    if rows.device != dev or rows.dtype != torch.float32 or rows.dim() != 2 \
            or rows.shape[1] != 32 or rows.shape[0] < 1 or rows.stride(1) != 1 \
            or rows.data_ptr() % 4:
        raise ValueError(f"{fn}: attrs.packed must be a non-empty (T, 32) float32 table on "
                         f"{dev} with adjacent columns, got {rows.dtype} {tuple(rows.shape)} "
                         f"strides {rows.stride()} on {rows.device}")
    eye, vi = uniforms["eye"], uniforms["view_inverse"]
    views = eye.shape[0] if eye.dim() == 2 else -1
    if not (hasattr(view_index, "__index__") and 0 <= view_index < views):
        raise ValueError(f"{fn}: view {view_index!r} of {views}")
    eye, vi = eye[view_index], vi[view_index]
    if eye.device != dev or eye.dtype != torch.float32 or eye.shape != (3,) or eye.data_ptr() % 4:
        raise ValueError(f"{fn}: the eye must be (3,) float32 on {dev}, got {eye.dtype} "
                         f"{tuple(eye.shape)} on {eye.device}")
    _matrix(fn, "view_inverse", vi, dev)
    smoke = _smoke_fields(fn, scene, env, dev)
    ambient = ambient_values(env)
    if ambient.numel() != 12:
        raise ValueError(f"{fn}: ambient_sh must hold 12 values, got {ambient.numel()}")
    form = sh_form(env, sh_sampler)
    pools = sh_sampler.pools_struct(fn, dev) if form == "pools" else None
    if lanes >= 2 ** 31:
        raise ValueError(f"{fn}: {lanes} lanes")
    _shade_mod._need_cuda(fn, dev)
    rgb = torch.empty((lanes, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((lanes,), dtype=torch.float32, device=dev)
    if not lanes:
        return rgb, alpha
    a = _ShadeArgs(
        lanes=lanes, pair=pair.data_ptr(), pair_s=pair.stride(0), px=px.data_ptr(),
        px_s=px.stride(0), py=py.data_ptr(), py_s=py.stride(0), packed=rows.data_ptr(),
        packed_s=rows.stride(0), n_rows=rows.shape[0],
        packed_vec=int(rows.data_ptr() % 16 == 0 and rows.stride(0) % 4 == 0),
        eye=eye.data_ptr(), eye_s=eye.stride(0), view_inverse=vi.data_ptr(), vi_s0=vi.stride(0),
        vi_s1=vi.stride(1), aces=int(bool(inline_tonemapping)), srgb=int(bool(inline_srgb)),
        rgb=rgb.data_ptr(), alpha=alpha.data_ptr(),
        ambient=(ctypes.c_float * 12)(*ambient.tolist()), **smoke)
    with torch.cuda.device(dev):
        if form == "pools":
            _shade_mod._check_pools_mirror()
            a.pools = pools
        elif form == "sampled":
            world_pos = torch.empty((lanes, 3), dtype=torch.float32, device=dev)
            a.form, a.world_pos = 1, world_pos.data_ptr()
            _launch(fn, "sc_particle_shade", "sc_particle_shade_args_bytes", a)
            _launched(_PARTICLE_SHADE_COUNTER)
            sh = sh_sampler(world_pos)
            if not isinstance(sh, torch.Tensor) or sh.device != dev \
                    or sh.dtype != torch.float32 or tuple(sh.shape) != (lanes, 4, 3) \
                    or sh.data_ptr() % 4:
                raise ValueError(f"{fn}: sh_sampler must give ({lanes}, 4, 3) float32 on {dev}")
            a.form, a.sh = 0, sh.data_ptr()
            a.sh_s0, a.sh_s1, a.sh_s2 = sh.stride()
        _launch(fn, "sc_particle_shade", "sc_particle_shade_args_bytes", a)
    _launched(_PARTICLE_SHADE_COUNTER)
    return rgb, alpha


shade_particles.LAUNCHES = 0
# (as _PARTICLE_GEOMETRY_COUNTER)
_PARTICLE_SHADE_COUNTER = shade_particles
