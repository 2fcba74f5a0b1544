"""The deferred stages' CUDA kernels against their plain versions on the
card, bit for bit: ops/shade.py interpolate_gbuffer (csrc/gbuffer.cu
gbuffer_kernel), ops/sky.py sample_skybox / sample_skybox_at
(csrc/sky.cu sky_kernel) and ops/shade.py shade / shade_lanes
(csrc/shade.cu shade_kernel). This file imports no JAX: its tests run only
where there is a card (-m gpu) and skip elsewhere.

    python -m pytest -q -m gpu tests/test_torch_deferred_card.py

The cases also serve tests/test_torch_sky.py and
tests/test_torch_shade_kernel.py, which hold the plain versions to the
JAX package on the CPU:

* g-buffer: seeded setup and packed rows holding NaN, +-inf and -0, rows
  whose edge functions sum to 0 (d_val == 0), dead lanes (pair < 0, which
  read row 0); the fused shade row with a
  tail, padded (row_cols) and without a tail, and the setup and packed
  tables as contiguous and as strided, unaligned views.
* sky: a 6-face cubemap in f16, f32 and u8 pools, quad-packed and flat,
  at the static placement and through the descriptor tables (faces of
  unequal sizes, REPEAT and CLAMP); a band with y_offset > 0 of a taller
  image, a band 61 pixels wide (not a multiple of the kernel's 2 pixels a
  thread, its rows' starts not 8-B aligned), a one-row band at a large
  y_offset, both inline flags, the sky worklist at int32 and int64 indices
  (the band's last pixel among them), a worklist of an odd length ending
  in dead lanes (the sentinel clamped to the band's
  last pixel, as render/frame.py _Worklist.lane_safe gives them), the clear
  colour; and a camera whose rays pass exactly through the cube's edges
  and corners (|x| = |y| = |z|), so that the face choice and CLAMP at
  texels 0 and w - 1 are exercised. On the card only: worklist indices
  far outside the band (negative, beyond 2 ** 31), strided and unaligned
  index tensors, and pools whose base is not 16-B aligned.
* shade: SHADE_CASES, every material path (the interleaved pool by the
  g-buffer's mat_tail and by material id, unlit materials, the classic
  samplers, the partition's s16) and SH source (ambient, light volume,
  lightmaps) under each inline_tonemapping x inline_srgb, on seeded lanes
  of the small hero, all-passes and lit scenes; on the card with NaN, +-inf
  and -0 in their g-buffer vectors and the partition's s16, and invalid
  lanes; shade_lanes on layouts the frame does not make (SHADE_LAYOUTS).
"""

import dataclasses
import functools
import zlib

import numpy as np
import pytest
import torch

from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.ops import sky as port_sky
from superconductor_tpu_torch.ops.geometry import TriangleAttrs, TriangleSetup
from superconductor_tpu_torch.render.env import EnvBindings

torch.set_num_threads(2)

LANES = 4096
ROWS = 97
TAIL = 64  # a mat_row_mq row of 10 levels: 24 + 4 * 10

# name -> (row source, row_cols or None); sources: "shade" (setup | packed
# | tail), "shade-padded" (padded to 128 columns), "shade-no-tail" (48
# columns), "tables" (contiguous tri.setup and attrs.packed), "strided"
# (tri.setup and attrs.packed as unaligned column views of wider rows)
GBUFFER_CASES = ("shade", "shade-padded", "shade-no-tail", "tables", "strided")


def gbuffer_rows(seed: int = 3):
    """(setup (ROWS, 16), packed (ROWS, 32), tail (ROWS, TAIL)) f32 numpy:
    normal-ish values with NaN, +-inf and -0 sprinkled in, rows 5 and 11
    with all-zero edges (d_val == 0), front and back faces, lightmapped and
    not, material bits including negative and NaN patterns."""
    rng = np.random.default_rng(seed)
    setup = rng.normal(scale=0.01, size=(ROWS, 16)).astype(np.float32)
    setup[:, 2::3][:, :3] = rng.normal(scale=2.0, size=(ROWS, 3)).astype(np.float32)
    setup[:, 15] = rng.choice([0.0, 1.0, -0.0], size=ROWS).astype(np.float32)
    packed = rng.normal(scale=3.0, size=(ROWS, 32)).astype(np.float32)
    packed[:, 30] = rng.integers(-3, 40, size=ROWS).astype(np.int32).view(np.float32)
    packed[:, 31] = rng.choice([0.0, -0.0, 1.0, np.nan], size=ROWS).astype(np.float32)
    tail = rng.normal(size=(ROWS, TAIL)).astype(np.float32)
    tail.view(np.int32)[::7, 3] = 0x7FC01234  # a NaN with a payload: copied, not computed
    for arr in (setup[:, :9], packed[:, :30]):
        flat = arr.reshape(-1)
        idx = rng.choice(flat.size, size=flat.size // 40, replace=False)
        flat[idx] = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0], size=idx.size)
        arr[...] = flat.reshape(arr.shape)
    setup[[5, 11], :9] = 0.0
    setup[17, :9] = -0.0
    return setup, packed, tail


def gbuffer_lanes(seed: int = 4):
    """(pair (LANES,) i32 in [-ROWS - 3, ROWS), px, py (LANES,) f32 pixel
    centres): one lane in 8 dead (-1) and more with other negative pairs
    (all of which read row 0); the first lanes on the rows whose edges are
    zero."""
    rng = np.random.default_rng(seed)
    pair = rng.integers(0, ROWS, size=LANES).astype(np.int32)
    pair[::8] = -1
    pair[3::29] = rng.integers(-ROWS - 3, 0, size=pair[3::29].size)
    pair[:4] = (5, 11, 17, -1)
    px = (rng.integers(0, 1920, size=LANES) + 0.5).astype(np.float32)
    py = (rng.integers(0, 1080, size=LANES) + 0.5).astype(np.float32)
    return pair, px, py


def gbuffer_args(case: str, device="cpu") -> dict:
    """interpolate_gbuffer's arguments for GBUFFER_CASES' `case`: the
    rows of gbuffer_rows, the lanes of gbuffer_lanes (px and py as strided
    views of one buffer)."""
    setup, packed, tail = gbuffer_rows()
    pair, px, py = gbuffer_lanes()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lanes = torch.from_numpy(np.stack([px, py], 1)).to(device)  # px, py as strided views
    args = dict(pair=t(pair), px=lanes[:, 0], py=lanes[:, 1], shade_row=None, row_cols=None)
    dummy = torch.zeros((ROWS, 3), device=device)
    if case.startswith("shade"):
        cols = {"shade": [setup, packed, tail], "shade-padded": [setup, packed, tail],
                "shade-no-tail": [setup, packed]}[case]
        row = np.concatenate(cols, 1)
        if case == "shade-padded":
            args["row_cols"] = row.shape[1]
            row = np.pad(row, ((0, 0), (0, 128 - row.shape[1])))
        args["shade_row"] = t(row)
        s_t, p_t = t(setup), t(packed)
    elif case == "tables":
        s_t, p_t = t(setup), t(packed)
    else:  # unaligned column views of wider rows
        wide = torch.zeros((ROWS, 57), device=device)
        wide[:, 1:17] = t(setup)
        wide[:, 20:52] = t(packed)
        s_t, p_t = wide[:, 1:17], wide[:, 20:52]
    args["tri"] = TriangleSetup(setup=s_t, tri_id=dummy[:, 0].int(), inst_id=dummy[:, 0].int(),
                                bbox=dummy.int(), valid=dummy[:, 0].bool(),
                                num_valid=torch.zeros((), dtype=torch.int32, device=device))
    args["attrs"] = TriangleAttrs(
        world_pos=p_t[:, 0:9].reshape(-1, 3, 3), normal=p_t[:, 9:18].reshape(-1, 3, 3),
        uv=p_t[:, 18:24].reshape(-1, 3, 2), lm_uv=p_t[:, 24:30].reshape(-1, 3, 2),
        material=p_t[:, 30].contiguous().view(torch.int32), lightmapped=p_t[:, 31] != 0,
        packed=p_t)
    return args


# --- the sky ------------------------------------------------------------------

SKY_W, SKY_H = 64, 32
FACE = 8  # the static cube's face size
DEAD_LANES = 6  # a "-dead" worklist's dead lanes
# name -> (pool "quad" | "flat", texel dtype, placement "static" | "desc" |
# "clear", camera "random" | "edges", inline (tonemapping, srgb), band
# (height, y_offset, full_height) or None, idx dtype "i32" | "i64" (the
# worklist; "-dead": ending in DEAD_LANES dead lanes) or None (the band))
SKY_CASES = {
    "static-quad-f16": ("quad", "f16", "static", "random", (True, True), None, None),
    "static-quad-f32-band": ("quad", "f32", "static", "random", (True, False), (16, 8, 32),
                             None),
    "static-quad-u8": ("quad", "u8", "static", "random", (False, True), None, None),
    "static-flat-f32": ("flat", "f32", "static", "random", (False, False), None, None),
    "static-quad-f16-edges": ("quad", "f16", "static", "edges", (False, False), None, None),
    "static-flat-u8-edges": ("flat", "u8", "static", "edges", (True, True), None, None),
    "static-quad-f16-at-i32": ("quad", "f16", "static", "random", (True, True), (16, 8, 32),
                               "i32"),
    "static-quad-f32-at-i64": ("quad", "f32", "static", "edges", (False, True), (32, 0, 32),
                               "i64"),
    "desc-quad-f16": ("quad", "f16", "desc", "random", (True, True), None, None),
    "desc-flat-f32": ("flat", "f32", "desc", "edges", (False, False), None, None),
    "desc-flat-u8-at-i32": ("flat", "u8", "desc", "random", (True, True), (16, 8, 32), "i32"),
    "clear": ("quad", "f16", "clear", "random", (True, True), None, None),
    "clear-raw-at-i64": ("quad", "f16", "clear", "random", (False, False), (16, 8, 32), "i64"),
    "static-quad-f16-band-w61": ("quad", "f16", "static", "random", (True, True), (16, 8, 32),
                                 None),
    "desc-quad-f32-row": ("quad", "f32", "desc", "random", (True, False), (1, 1000, 1080), None),
    "static-flat-f16-at-i32-dead": ("flat", "f16", "static", "random", (False, True),
                                    (16, 8, 32), "i32-dead"),
}
# the cases' band widths other than SKY_W
SKY_WIDTHS = {"static-quad-f16-band-w61": 61}
_DTYPES = {"f16": np.float16, "f32": np.float32, "u8": np.uint8}
BASE = 2  # the cubemap's first texture id (two textures before it)
# descriptor placement: faces of unequal sizes (w, h), wrap, and mip count
DESC_FACES = ((8, 8, 1, 3), (4, 6, 0, 1), (8, 4, 1, 2), (2, 2, 0, 1), (6, 8, 1, 1),
              (8, 8, 0, 4))


@functools.lru_cache(maxsize=None)
def sky_tables(pool: str, texel: str, placement: str):
    """(texels_hdr (N, 4), texels_hdr_q (N, 16) or None, the descriptor
    arrays, ibl_cubemap_static or None) numpy: seeded texels (HDR values
    up to ~4 in float pools) and two dummy textures ahead of the cube."""
    rng = np.random.default_rng(zlib.crc32(f"{pool} {texel} {placement}".encode()))
    sizes = [(3, 3, 0, 1), (5, 2, 1, 1)]  # the dummy textures
    sizes += DESC_FACES if placement == "desc" else [(FACE, FACE, 1, 1)] * 6
    offset, mip_offset, mip_w, mip_h, meta = 7, [], [], [], []
    for w, h, wrap, count in sizes:
        meta.append((len(mip_offset), count, wrap, 0))
        for lvl in range(count):
            lw, lh = max(1, w >> lvl), max(1, h >> lvl)
            mip_offset.append(offset)
            mip_w.append(lw)
            mip_h.append(lh)
            offset += lw * lh + 3
    n = offset + 5
    if texel == "u8":
        flat = rng.integers(0, 256, size=(n, 4)).astype(np.uint8)
    else:
        flat = (rng.gamma(1.0, 1.0, size=(n, 4))).astype(_DTYPES[texel])
    quad = None
    if pool == "quad":  # neighbours need not match the flat pool for the test
        quad = (rng.integers(0, 256, size=(n, 16)).astype(np.uint8) if texel == "u8"
                else rng.gamma(1.0, 1.0, size=(n, 16)).astype(_DTYPES[texel]))
    meta = np.asarray(meta, np.int32)
    desc = {
        "mip_offset": np.asarray(mip_offset, np.int32), "mip_w": np.asarray(mip_w, np.int32),
        "mip_h": np.asarray(mip_h, np.int32), "tex_mip_base": meta[:, 0].copy(),
        "tex_mip_count": meta[:, 1].copy(), "tex_wrap": meta[:, 2].copy(),
        "tex_flags": meta[:, 3].copy(), "tex_meta": meta,
        "mip_owh": np.stack([np.asarray(mip_offset, np.int32), np.asarray(mip_w, np.int32),
                             np.asarray(mip_h, np.int32),
                             np.zeros(len(mip_offset), np.int32)], 1),
    }
    static = None
    if placement == "static":
        static = (tuple(int(mip_offset[meta[BASE + f, 0]]) for f in range(6)), FACE, FACE)
    return flat, quad, desc, static


def sky_camera(camera: str):
    """(projection_inverse (4, 4), view quaternion (4,)) f32 numpy. edges:
    rays (64 ndc_x, 32 ndc_y, -1) under the identity rotation, exactly on
    the cube's edges and corners where |ndc_x| = 1/64 or |ndc_y| = 1/32."""
    if camera == "edges":
        m = np.zeros((4, 4), np.float32)
        m[0, 0], m[1, 1], m[2, 3], m[3, 2], m[3, 3] = 64.0, 32.0, -1.0, 1.0, 1.0
        return m, np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    rng = np.random.default_rng(11)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    m[:3, 2] *= 0.1
    q = rng.normal(size=4)
    return m, (q / np.linalg.norm(q)).astype(np.float32)


def sky_args(case: str, device="cpu", env_cls=EnvBindings) -> tuple:
    """(function name, keyword arguments) of SKY_CASES' `case` for
    ops/sky.py (or, with the JAX package's EnvBindings, its
    superconductor_tpu/ops/sky.py): the scene's pools and descriptor
    tables as torch tensors on `device`."""
    pool, texel, placement, camera, (tm, srgb), band, idx_dtype = SKY_CASES[case]
    flat, quad, desc, static = sky_tables(pool, texel, placement)
    scene = {"texels_hdr": torch.from_numpy(flat).to(device),
             "tex_hdr": {k: torch.from_numpy(v).to(device) for k, v in desc.items()}}
    if quad is not None:
        scene["texels_hdr_q"] = torch.from_numpy(quad).to(device)
    env = env_cls(ibl_cubemap_base=-1 if placement == "clear" else BASE,
                  ibl_cubemap_static=static, clear_color=(0.25, 0.5, 1.75))
    m, q = sky_camera(camera)
    height, y_offset, full_height = band or (SKY_H, 0, SKY_H)
    width = SKY_WIDTHS.get(case, SKY_W)
    kw = dict(scene=scene, env=env, width=width, projection_inverse=torch.from_numpy(m).to(device),
              view_quat=torch.from_numpy(q).to(device), inline_tonemapping=tm,
              inline_srgb=srgb, y_offset=y_offset, full_height=full_height)
    if idx_dtype is None:
        return "sample_skybox", dict(kw, height=height)
    rng = np.random.default_rng(12)
    npx = height * width
    idx = np.sort(rng.choice(npx, size=npx // 3, replace=False))
    idx[-1] = npx - 1  # the band's last pixel
    if idx_dtype.endswith("-dead"):  # dead lanes: the sentinel npx clamped to npx - 1
        idx = np.concatenate([idx, np.full(DEAD_LANES, npx - 1, idx.dtype)])
    dtype = {"i32": torch.int32, "i64": torch.int64}[idx_dtype.removesuffix("-dead")]
    return "sample_skybox_at", dict(kw, idx=torch.from_numpy(idx).to(dtype).to(device))


# --- the shade ------------------------------------------------------------------

SHADE_LANES = 2048
# name -> (scene, material path, SH source). Scenes: the headline's hero
# (every material on the interleaved pool), the small all-passes scene
# (a partial pool: the terrain takes the classic samplers) and the small
# lit scene (all-passes' plus a light volume and lightmaps, no ambient).
# Paths: "tail" (the interleaved pool, each lane's mat_row_mq row in the
# g-buffer's mat_tail, a strided view of a wider shade row), "by-id"
# (mat_row_mq by material id), "unlit" (by id, the even materials flagged
# MAT_UNLIT), "classic" (the classic samplers, mat_row by id), "partition"
# (s16 from render/frame.py _partition_material_sample, mat_row_mq by id).
# SH: the ambient coefficients, the light volume, or the lightmaps on half
# the lanes over the volume on the rest.
SHADE_CASES = {
    "tail": ("hero", "tail", "ambient"),
    "by-id": ("hero", "by-id", "ambient"),
    "unlit": ("hero", "unlit", "ambient"),
    "classic": ("all_passes", "classic", "ambient"),
    "partition": ("all_passes", "partition", "ambient"),
    "volume": ("lit", "classic", "volume"),
    "lightmap": ("lit", "classic", "lightmap"),
}
# (inline_tonemapping, inline_srgb)
SHADE_INLINE = ((True, True), (True, False), (False, True), (False, False))
SHADE_GBUFFER_FLOATS = ("world_pos", "normal", "dpdx", "dpdy", "duvdx", "duvdy")


@functools.lru_cache(maxsize=None)
def shade_host(scene: str):
    """(host Scene, uniforms dict of numpy f32, EnvBindings) of a shade
    case's scene, built by the port's host layer (the CPU tests build the
    same scene with the JAX package's for its side)."""
    from superconductor_tpu_torch import scenes

    if scene == "hero":
        host, _model, uniforms, env, _config = scenes.headline_host(256, 128)
    elif scene == "all_passes":
        host, _i, uniforms, env, _c, _d = scenes.all_passes_host(**scenes.ALL_PASSES_SMALL)
    else:
        host, _i, uniforms, env, _c, _d = scenes.lit_passes_host(**scenes.LIT_PASSES_SMALL)
    u = {k: np.asarray(v, np.float32) for k, v in uniforms.as_device_dict().items()}
    return host, u, env


@functools.lru_cache(maxsize=None)
def _shade_tables(scene: str, device: str) -> dict:
    from superconductor_tpu_torch.scene.upload import scene_to_torch

    return scene_to_torch(shade_host(scene)[0], device)


def shade_env(case: str, env):
    """The case's EnvBindings: the lit scene's with only the light volume
    bound, or with both (the lightmaps over the volume where lightmapped)."""
    if SHADE_CASES[case][2] == "volume":
        return dataclasses.replace(env, lightmap_tex_ids=None, lightmap_wh=None)
    return env


def shade_lanes_np(case: str, n_materials: int, uniforms: dict, nan: bool = False,
                   seed: int = 21) -> dict:
    """The g-buffer fields (numpy) of SHADE_LANES lanes of a case: one lane
    in 10 invalid, a third back-facing, unnormalised normals (some zero),
    positions around the scene (for the light volume, inside, on and
    outside its probe box), uv in [-1, 2] with footprints from under a
    texel to the whole mip chain, every material, half the lanes
    lightmapped. With `nan`, NaN, +-inf and -0 sprinkled over the normal,
    dpdx, dpdy and (with the ambient SH) world_pos of valid and invalid
    lanes alike."""
    rng = np.random.default_rng(seed + zlib.crc32(case.encode()) % 1000)
    p = SHADE_LANES

    def f32(x):
        return np.asarray(x, np.float32)

    if SHADE_CASES[case][2] == "ambient":
        world = f32(rng.normal(scale=3.0, size=(p, 3)))
    else:
        box = rng.uniform(-0.3, 1.3, size=(p, 3))
        box[: p // 16, 0] = rng.integers(0, 2, size=p // 16)
        world = f32(uniforms["probes_bottom_left"] + box * uniforms["probes_scale"])
    normal = f32(rng.normal(size=(p, 3)))
    normal[5::97] = 0.0
    foot = 10.0 ** rng.uniform(-5, -0.5, size=(p, 1))
    g = dict(
        valid=rng.uniform(size=p) > 0.1, world_pos=world, normal=normal,
        uv=f32(rng.uniform(-1.0, 2.0, size=(p, 2))),
        lm_uv=f32(rng.uniform(-0.2, 1.2, size=(p, 2))),
        material=rng.integers(0, n_materials, size=p).astype(np.int32),
        front_facing=rng.uniform(size=p) > 0.3, lightmapped=rng.uniform(size=p) < 0.5,
        dpdx=f32(rng.normal(scale=1e-2, size=(p, 3))),
        dpdy=f32(rng.normal(scale=1e-2, size=(p, 3))),
        duvdx=f32(rng.normal(size=(p, 2)) * foot), duvdy=f32(rng.normal(size=(p, 2)) * foot),
    )
    if nan:
        # not into what the samplers index by (uv, its footprint, and the
        # position the SH samplers read): a torch gather out of range stops
        # the card
        nan_fields = ("normal", "dpdx", "dpdy")
        if SHADE_CASES[case][2] == "ambient":
            nan_fields += ("world_pos",)
        for f in nan_fields:
            flat = g[f].reshape(-1)
            idx = rng.choice(flat.size, size=flat.size // 50, replace=False)
            flat[idx] = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0], size=idx.size)
    return g


def with_unlit(materials: dict, flag_even, copy) -> dict:
    """materials with MAT_UNLIT set in the flags (column 16) of the even
    material rows of mat_row_mq and mat_row; `copy` makes a writable int32
    view's owner of a table (numpy or torch) and `flag_even` sets the bit
    on it."""
    out = dict(materials)
    for key in ("mat_row_mq", "mat_row"):
        if key in out:
            out[key] = flag_even(copy(out[key]))
    return out


def _flag_even_torch(t: torch.Tensor) -> torch.Tensor:
    t.view(torch.int32)[::2, 16] |= port_shade.MAT_UNLIT
    return t


def shade_args(case: str, device="cpu", inline=(True, True), nan: bool = False) -> dict:
    """ops/shade.py shade's arguments for SHADE_CASES' `case` on `device`:
    the scene's tables (scene_to_torch), the lanes of shade_lanes_np as
    torch tensors (the float fields as strided views of one wider buffer),
    the case's env, view 0 and, for "partition", the partition's s16 (with
    `nan`, NaN, +-inf and -0 sprinkled into it too)."""
    from superconductor_tpu_torch.render import frame as port_frame

    scene_name, path, _sh = SHADE_CASES[case]
    host, u, env = shade_host(scene_name)
    tables = _shade_tables(scene_name, str(device))
    mats = tables["materials"]
    if path == "unlit":
        tables = dict(tables, materials=with_unlit(mats, _flag_even_torch, torch.clone))
    g = shade_lanes_np(case, mats["mat_row"].shape[0], u, nan=nan)
    wide = np.concatenate([np.zeros((SHADE_LANES, 1), np.float32)]
                          + [g[f] for f in SHADE_GBUFFER_FLOATS], axis=1)
    buf = torch.from_numpy(wide).to(device)
    fields, col = {}, 1
    for f in SHADE_GBUFFER_FLOATS:
        width = g[f].shape[1]
        fields[f] = buf[:, col:col + width]
        col += width
    for f in ("valid", "front_facing", "lightmapped", "material", "uv", "lm_uv"):
        fields[f] = torch.from_numpy(g[f]).to(device)
    if path == "tail":
        tail = mats["mat_row_mq"][fields["material"].long()]
        row = torch.zeros((SHADE_LANES, 48 + tail.shape[1]), device=device)
        row[:, 48:] = tail
        fields["mat_tail"] = row[:, 48:]
    gbuf = port_shade.GBuffer(**fields)
    s16 = None
    if path == "partition":
        need = int(((~tables["matq_capable"][fields["material"].long()]) & fields["valid"]).sum())
        s16, _n = port_frame._partition_material_sample(
            gbuf, tables, port_frame.RenderConfig(matq_classic_cap=need + 64), 1)
        if nan:
            rng = np.random.default_rng(31)
            idx = torch.from_numpy(rng.choice(s16.numel(), size=s16.numel() // 50,
                                              replace=False)).to(device)
            vals = torch.from_numpy(rng.choice([np.nan, np.inf, -np.inf, -0.0], size=idx.numel())
                                    .astype(np.float32)).to(device)
            s16 = s16.reshape(-1).index_put((idx,), vals).reshape(s16.shape)
    return dict(gbuf=gbuf, scene=tables,
                uniforms={k: torch.from_numpy(v).to(device) for k, v in u.items()},
                view_index=0, env=shade_env(case, env), inline_tonemapping=inline[0],
                inline_srgb=inline[1], aniso_taps=1, s16=s16)


# --- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/gbuffer.cu, csrc/sky.cu and csrc/shade.cu have "
                    "no CPU mode)")
    return torch.device("cuda", 0)


def _bit_equal(name: str, out: torch.Tensor, want: torch.Tensor) -> None:
    assert out.shape == want.shape and out.dtype == want.dtype, name
    if out.dtype == torch.float32:
        out, want = out.contiguous().view(torch.int32), want.contiguous().view(torch.int32)
    same = out == want
    assert bool(same.all()), f"{name}: {int((~same).sum())} of {same.numel()} values differ"


@pytest.mark.gpu
@pytest.mark.parametrize("case", GBUFFER_CASES)
def test_gbuffer_kernel_equals_plain_on_card(case):
    dev = _card()
    args = gbuffer_args(case, dev)
    before = port_shade.interpolate_gbuffer.LAUNCHES
    out = port_shade.interpolate_gbuffer(**args)
    torch.cuda.synchronize()
    assert port_shade.interpolate_gbuffer.LAUNCHES == before + 1
    want = port_shade.interpolate_gbuffer_plain(**args)
    for f in want._fields:
        if getattr(want, f) is None:
            assert getattr(out, f) is None, f
        else:
            _bit_equal(f, getattr(out, f), getattr(want, f))


@pytest.mark.gpu
@pytest.mark.parametrize("inline", SHADE_INLINE)
@pytest.mark.parametrize("case", sorted(SHADE_CASES))
def test_shade_kernel_equals_plain_on_card(case, inline):
    """shade's kernel against shade_plain on the same arguments, every
    lane by int32 view: lanes with NaN, +-inf and -0 in their g-buffer
    fields (and in the partition's s16), invalid lanes among them."""
    dev = _card()
    args = shade_args(case, dev, inline, nan=True)
    before = port_shade.shade.LAUNCHES
    rgb, alpha = port_shade.shade(**args)
    torch.cuda.synchronize()
    assert port_shade.shade.LAUNCHES == before + 1
    want_rgb, want_alpha = port_shade.shade_plain(**args)
    _bit_equal("rgb", rgb, want_rgb)
    _bit_equal("alpha", alpha, want_alpha)


# shade_lanes' inputs in layouts the frame does not make: s16 whose rows are
# not 16-B aligned (the kernel's scalar loads) and random, with NaN, +-inf
# and -0; per-lane SH with NaN; the eye of a second view; the material rows
# as a column view of a wider table, and a row a lane (mat None); no lanes
# (an empty worklist's g-buffer, its mat_tail empty: nothing launched)
SHADE_LAYOUTS = ("s16-unaligned-nan", "sh-lanes-nan", "eye-view1", "rows-strided",
                 "rows-a-lane", "no-lanes")


def shade_lanes_args(layout: str, device) -> dict:
    """shade_lanes' arguments of a SHADE_LAYOUTS layout, from the "by-id"
    case's lanes (the whole pool's textures sampled first)."""
    k = port_shade.shade_inputs(**shade_args("by-id", device, (True, True), nan=True))
    gbuf, s16, rows, mat, sh, eye = (k[n] for n in ("gbuf", "s16", "rows", "mat", "sh", "eye"))
    rng = np.random.default_rng(zlib.crc32(layout.encode()))
    p = SHADE_LANES
    if layout == "s16-unaligned-nan":
        vals = rng.normal(size=(p, 16)).astype(np.float32)
        vals.reshape(-1)[rng.choice(p * 16, size=p // 2, replace=False)] = np.nan
        vals[::13, 2] = np.inf
        vals[::17, 10] = -0.0
        buf = torch.zeros((p, 17), device=device)
        buf[:, 1:] = torch.from_numpy(vals).to(device)
        s16 = buf[:, 1:]
    elif layout == "sh-lanes-nan":
        vals = rng.normal(scale=0.5, size=(p, 4, 3)).astype(np.float32)
        vals.reshape(-1)[rng.choice(p * 12, size=p // 4, replace=False)] = np.nan
        sh = torch.from_numpy(vals).to(device)
    elif layout == "eye-view1":
        eye = torch.tensor([[9.0, 9.0, 9.0], [0.3, -1.5, 2.25]], device=device)[1]
    elif layout == "rows-strided":
        wide = torch.zeros((rows.shape[0], rows.shape[1] + 7), device=device)
        wide[:, 3:3 + rows.shape[1]] = rows
        rows = wide[:, 3:3 + rows.shape[1]]
    elif layout == "rows-a-lane":
        rows, mat = rows[gbuf.material.long()], None
    else:
        gbuf = port_shade.GBuffer(*[None if x is None else x[:0] for x in gbuf])
        s16, rows, mat = s16[:0], rows[:0], None  # an empty mat_tail
    return dict(k, gbuf=gbuf, s16=s16, rows=rows, mat=mat, sh=sh, eye=eye)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", SHADE_LAYOUTS)
def test_shade_lanes_layouts_on_card(layout):
    dev = _card()
    args = shade_lanes_args(layout, dev)
    before = port_shade.shade.LAUNCHES
    rgb, alpha = port_shade.shade_lanes(**args)
    torch.cuda.synchronize()
    assert port_shade.shade.LAUNCHES == before + (layout != "no-lanes")
    want_rgb, want_alpha = port_shade.shade_lanes_plain(**args)
    _bit_equal(layout, rgb, want_rgb)
    _bit_equal(layout, alpha, want_alpha)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SKY_CASES))
def test_sky_kernel_equals_plain_on_card(case):
    dev = _card()
    name, args = sky_args(case, dev)
    wrapper = getattr(port_sky, name)
    before = wrapper.LAUNCHES
    out = wrapper(**args)
    torch.cuda.synchronize()
    assert wrapper.LAUNCHES == before + 1
    _bit_equal(case, out, getattr(port_sky, name + "_plain")(**args))


# Worklist index tensors the frame never makes, each against the plain
# version on the card: indices far outside the band (negative, INT32_MIN,
# and for int64 beyond 2 ** 31, which take the kernel's 64-bit division),
# a strided index view and views whose start is not aligned to the
# kernel's index loads (scalar loads)
_FAR = [-1, -63, -64, -65, -2 ** 31, -2 ** 31 + 1, 2 ** 31 - 1, 0, 63, 64, 1000, 2047]
SKY_INDEX_LAYOUTS = {
    "i32-far": (torch.int32, _FAR),
    "i64-far": (torch.int64, _FAR + [-2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5, -2 ** 40,
                                     2 ** 40 + 3, 2 ** 62, -2 ** 62]),
    "i32-strided": (torch.int32, None),
    "i32-unaligned": (torch.int32, None),
    "i64-unaligned": (torch.int64, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(SKY_INDEX_LAYOUTS))
def test_sky_worklist_index_layouts_on_card(layout):
    dev = _card()
    name, args = sky_args("static-quad-f32-at-i64", dev)
    dtype, values = SKY_INDEX_LAYOUTS[layout]
    if values is not None:
        idx = torch.tensor(values + list(range(100, 117)), dtype=dtype, device=dev)
    elif layout == "i32-strided":
        idx = torch.arange(0, 2 * 301, dtype=dtype, device=dev)[::2]
    else:
        idx = torch.arange(0, 302, dtype=dtype, device=dev)[1:]
    args = dict(args, idx=idx)
    out = port_sky.sample_skybox_at(**args)
    torch.cuda.synchronize()
    _bit_equal(layout, out, port_sky.sample_skybox_at_plain(**args))


def _unaligned(pool: torch.Tensor) -> torch.Tensor:
    """pool's values in a contiguous tensor whose base is one element past
    a 16-B boundary."""
    buf = torch.empty(pool.numel() + 1, dtype=pool.dtype, device=pool.device)
    out = buf[1:].view(pool.shape)
    out.copy_(pool)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["static-quad-f16", "static-quad-u8", "static-flat-f32",
                                  "desc-flat-u8-at-i32", "static-flat-f16-at-i32-dead"])
def test_sky_unaligned_pool_on_card(case):
    """A pool whose base is not 16-B aligned takes the kernel's scalar texel
    loads, with the same bits."""
    dev = _card()
    name, args = sky_args(case, dev)
    scene = dict(args["scene"])
    key = "texels_hdr_q" if "texels_hdr_q" in scene else "texels_hdr"
    scene[key] = _unaligned(scene[key])
    args = dict(args, scene=scene)
    out = getattr(port_sky, name)(**args)
    torch.cuda.synchronize()
    _bit_equal(case, out, getattr(port_sky, name + "_plain")(**args))


@pytest.mark.gpu
def test_card_calls_never_reach_the_plain_versions(monkeypatch):
    """A CUDA call launches the kernel: with every plain version (and the
    chains under them) made to raise, the wrappers still answer."""
    dev = _card()

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA call reached a plain version")

    cases = {case: shade_args(case, dev) for case in ("tail", "classic", "volume")}
    for mod, name in ((port_shade, "interpolate_gbuffer_plain"),
                      (port_sky, "sample_skybox_plain"), (port_sky, "sample_skybox_at_plain"),
                      (port_sky, "shade_sky_rays"), (port_sky, "skybox_rays"),
                      (port_sky, "skybox_rays_at"), (port_shade, "shade_plain"),
                      (port_shade, "shade_lanes_plain"), (port_shade, "eval_sh_nonlinear"),
                      (port_shade, "sh_specular_approximation"), (port_shade, "ggx_specular"),
                      (port_shade, "compute_cotangent_frame_normal")):
        monkeypatch.setattr(mod, name, refuse)
    port_shade.interpolate_gbuffer(**gbuffer_args("shade", dev))
    for case in ("static-quad-f16", "desc-flat-u8-at-i32", "clear"):
        name, args = sky_args(case, dev)
        getattr(port_sky, name)(**args)
    for args in cases.values():
        port_shade.shade(**args)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_unpacked_route_raises_on_card():
    dev = _card()
    args = gbuffer_args("tables", dev)
    args["attrs"] = args["attrs"]._replace(packed=None)
    with pytest.raises(ValueError, match="packed"):
        port_shade.interpolate_gbuffer(**args)
