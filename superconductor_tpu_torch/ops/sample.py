"""The frame's two material samplers: one launch of a hand-written kernel
(``csrc/sample.cu``) for CUDA tensors, the plain version (the torch chain
the kernel replaces, bit for bit with it on the card) for CPU tensors.

* ``sample_classic`` -- the wanted slots of the lanes' materials through
  the classic per-slot sampler (``texture.sample_anisotropic`` on the
  slot's meta and in-register mip table), read from ``mat_row`` in place:
  ``classic_sample_kernel``. Plain version ``sample_classic_plain``: the
  lanes' rows gathered and unpacked, then ``classic_sample`` a slot.
* ``sample_material`` -- the wanted slots from the interleaved pool
  (``texture.sample_material_interleaved``) on the lanes' ``mat_row_mq``
  rows, by material id or a row a lane (the g-buffer's ``mat_tail``):
  ``material_sample_kernel``. Plain version ``sample_material_plain``.

The material tables' columns (scene/upload.py) are defined here and
nowhere else in Python: both tables lead with 12 f32 factors and 8 i32
flags (a slot's flags at FLAGS + slot); ``mat_row`` (M, 44 + 12 L) then
holds each slot's 6-int meta and each slot's L x 3-int mip table,
``mat_row_mq`` (M, 24 + 4 L) the interleaved pool's 4-int meta and L
(offset, w, h, tail offset) entries.

No wrapper falls back: anything its kernel does not take raises, and a
CUDA tensor never runs the plain version. ``sample_classic.LAUNCHES`` and
``sample_material.LAUNCHES`` count the launches as ops/raster.py's
wrappers count theirs (``_launched``). The frame (render/frame.py,
ops/shade.py) looks both wrappers up in this module at each call, so one
swap takes at every call site.
"""

from __future__ import annotations

import torch

from .raster import _kernel_fn, _launched
from .texture import sample_anisotropic, sample_material_interleaved

SLOTS = (0, 1, 2, 3)  # albedo, normal, metallic-roughness, emissive
# the material tables' columns
FACTORS, FLAGS, META = 0, 12, 20
SLOT_META = 6  # mat_row: a slot's base, count, wrap, flags, w, h
MAT_ROW_HEAD, MAT_ROW_LEVEL = META + 4 * SLOT_META, 4 * 3  # a level: each slot's offset, w, h
MQ_ROW_HEAD, MQ_ROW_LEVEL = META + 4, 4  # a level: offset, w, h, tail offset


def _bitcast_i32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _factors(row):
    """(pf (P,12) f32, pi (P,8) i32): the factors and flags both material
    tables lead with."""
    return row[..., FACTORS:FLAGS], _bitcast_i32(row[..., FLAGS:META])


def _unpack_mat_row(row):
    """(P, 44+12L) mat_row -> (pf (P,12) f32, pi (P,8) i32, mtm (P,24) i32,
    mlv (P,4,L,3) i32, None when L = 0): each slot's meta and in-register
    mip table."""
    pf, pi = _factors(row)
    mtm = _bitcast_i32(row[..., META:MAT_ROW_HEAD])
    mlv = None
    if row.shape[-1] > MAT_ROW_HEAD:
        L = (row.shape[-1] - MAT_ROW_HEAD) // MAT_ROW_LEVEL
        mlv = _bitcast_i32(row[..., MAT_ROW_HEAD:MAT_ROW_HEAD + MAT_ROW_LEVEL * L]).reshape(
            *row.shape[:-1], 4, L, 3)
    return pf, pi, mtm, mlv


def _unpack_mq_row(row):
    """(P, 24+4L) mat_row_mq -> (pf (P,12) f32, pi (P,8) i32, meta (P,4)
    i32, owh (P,L,4) i32)."""
    pf, pi = _factors(row)
    meta = _bitcast_i32(row[..., META:MQ_ROW_HEAD])
    L = (row.shape[-1] - MQ_ROW_HEAD) // MQ_ROW_LEVEL
    owh = _bitcast_i32(row[..., MQ_ROW_HEAD:MQ_ROW_HEAD + MQ_ROW_LEVEL * L]).reshape(
        *row.shape[:-1], L, MQ_ROW_LEVEL)
    return pf, pi, meta, owh


def classic_sample(pool, rows, slot: int, uv, duvdx, duvdy, taps: int, decode_srgb=True):
    """Material texture `slot` of each lane through the classic per-slot
    sampler (sample_anisotropic, lod from the texture's own mip-0 size) on
    the LDR pool; rows = _unpack_mat_row(...) of the lanes' mat_row rows,
    whose in-register mip tables need no descriptor table."""
    _pf, pi, mtm, mlv = rows
    return sample_anisotropic(
        pool, {}, pi[..., slot], uv, duvdx, duvdy, taps, decode_srgb,
        meta=mtm[..., SLOT_META * slot:SLOT_META * (slot + 1)], levels_owh=mlv[..., slot, :, :],
    )


def sample_classic_plain(pool, mat_row, mat, uv, duvdx, duvdy, taps: int, slots=SLOTS,
                         decode_srgb=True):
    """sample_classic's plain version: the lanes' mat_row rows gathered
    and unpacked, then classic_sample's torch chain a slot -> (P, 4 *
    len(slots)) f32."""
    rows = _unpack_mat_row(mat_row[mat])
    return torch.cat([classic_sample(pool, rows, s, uv, duvdx, duvdy, taps, decode_srgb)
                      for s in slots], dim=-1)


def sample_classic(pool, mat_row, mat, uv, duvdx, duvdy, taps: int, slots=SLOTS,
                   decode_srgb=True):
    """The wanted `slots` of each lane's material textures through the
    classic per-slot sampler -> (P, 4 * len(slots)) f32: sample_anisotropic
    (lod from the texture's own mip-0 size) on the slot's meta and mip
    table, read from the lanes' rows of mat_row (M, 44 + 12L) f32 (the
    table scene/upload.py material_tables publishes) by mat (P,) i32.
    pool: the flat (N, 4) or quad-packed (N, 16) u8 LDR pool (ldr_pool).
    uv, duvdx, duvdy: (P, 2) f32. CUDA tensors launch csrc/sample.cu
    classic_sample_kernel (bit for bit with the plain version on the card),
    CPU tensors run sample_classic_plain; anything the kernel does not take
    raises. Counts its launches in sample_classic.LAUNCHES."""
    dev = uv.device
    if dev.type == "cpu":
        return sample_classic_plain(pool, mat_row, mat, uv, duvdx, duvdy, taps, slots=slots,
                                    decode_srgb=decode_srgb)
    slot_code, n_slots = _slot_code(slots)
    lanes = _check_lanes("sample_classic", dev, uv, duvdx, duvdy)
    width = pool.shape[-1] if pool.dim() == 2 else None
    if width not in (4, 16):
        raise ValueError(f"sample_classic: pool must be (N, 4) or (N, 16), got "
                         f"{tuple(pool.shape)}")
    _check_pool("pool", pool, dev, width)
    L = _check_rows("mat_row", mat_row, dev, MAT_ROW_HEAD, MAT_ROW_LEVEL)
    if mat is None:
        raise ValueError("sample_classic: mat is required")
    mat_ptr, mat_s = _check_mat(mat, mat_row, lanes, dev)
    if dev.type != "cuda":
        raise ValueError(f"sample_classic: the kernel runs on CUDA tensors, not {dev}")
    out = torch.empty((lanes, 4 * n_slots), dtype=torch.float32, device=dev)
    if lanes:
        with torch.cuda.device(dev):
            err = _kernel_fn("sc_classic_sample")(
                lanes, uv.data_ptr(), uv.stride(0), duvdx.data_ptr(), duvdx.stride(0),
                duvdy.data_ptr(), duvdy.stride(0), mat_ptr, mat_s, mat_row.data_ptr(),
                mat_row.stride(0), mat_row.shape[0], L, pool.data_ptr(), pool.shape[0],
                int(width == 16), int(taps), int(bool(decode_srgb)), n_slots, slot_code,
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"classic sampler kernel launch failed: cudaError_t {err}")
        _launched(_CLASSIC_COUNTER)
    return out


sample_classic.LAUNCHES = 0
# the wrapper whose LAUNCHES count its kernel, however the module's name is
# rebound later (a recording or plain twin put in its place)
_CLASSIC_COUNTER = sample_classic


def sample_material_plain(texels_mq, rows, uv, duvdx, duvdy, taps: int, mat=None,
                          slots=SLOTS, decode_srgb=True, texels_tail=None):
    """sample_material's plain version: the material rows (rows[mat], or
    rows itself when mat is None: a row per lane) unpacked, then
    sample_material_interleaved's torch chain -> (P, 4 * len(slots)) f32,
    the wanted slots in their order."""
    _pf, _pi, meta, owh = _unpack_mq_row(rows if mat is None else rows[mat])
    s16 = sample_material_interleaved(texels_mq, meta, owh, uv, duvdx, duvdy, taps,
                                      decode_srgb, texels_tail=texels_tail)
    if tuple(slots) == SLOTS:
        return s16
    return torch.cat([s16[..., 4 * s:4 * s + 4] for s in slots], dim=-1)


def sample_material(texels_mq, rows, uv, duvdx, duvdy, taps: int, mat=None, slots=SLOTS,
                    decode_srgb=True, texels_tail=None):
    """The wanted `slots` of each lane's material textures from the
    interleaved pool -> (P, 4 * len(slots)) f32: sample_material_interleaved
    on the lanes' mat_row_mq rows, `rows` (M, 24+4L) f32 indexed by `mat`
    (P,) i32, or with mat None `rows` (P, 24+4L) itself (a strided view
    such as the g-buffer's mat_tail). texels_mq: (N, 64) u8 rows, with
    texels_tail (N', 64) for the second level, or the wide (N, 208) mq3
    rows. uv, duvdx, duvdy: (P, 2) f32. CUDA tensors launch csrc/sample.cu
    material_sample_kernel (bit for bit with the plain version on the
    card), CPU tensors run sample_material_plain; anything the kernel does
    not take raises. Counts its launches in sample_material.LAUNCHES."""
    dev = uv.device
    if dev.type == "cpu":
        return sample_material_plain(texels_mq, rows, uv, duvdx, duvdy, taps, mat=mat,
                                     slots=slots, decode_srgb=decode_srgb,
                                     texels_tail=texels_tail)
    slot_code, n_slots = _slot_code(slots)
    lanes = _check_lanes("sample_material", dev, uv, duvdx, duvdy)
    width = texels_mq.shape[-1] if texels_mq.dim() == 2 else None
    if width not in (64, 208):
        raise ValueError(f"sample_material: texels_mq must be (N, 64) or (N, 208), got "
                         f"{tuple(texels_mq.shape)}")
    _check_pool("texels_mq", texels_mq, dev, width)
    # csrc/sample.cu MatqRows: 64-B rows, with the tail pool, or mq3 rows
    # (which, as sample_material_interleaved, leave any tail pool unread)
    kind, tail_ptr, n_tail = (2 if width == 208 else 0), None, 0
    if texels_tail is not None and width == 64:
        _check_pool("texels_tail", texels_tail, dev, 64)
        kind, tail_ptr, n_tail = 1, texels_tail.data_ptr(), texels_tail.shape[0]
    L = _check_rows("rows", rows, dev, MQ_ROW_HEAD, MQ_ROW_LEVEL)
    mat_ptr, mat_s = _check_mat(mat, rows, lanes, dev)
    if dev.type != "cuda":
        raise ValueError(f"sample_material: the kernel runs on CUDA tensors, not {dev}")
    out = torch.empty((lanes, 4 * n_slots), dtype=torch.float32, device=dev)
    if lanes:
        with torch.cuda.device(dev):
            err = _kernel_fn("sc_material_sample")(
                lanes, uv.data_ptr(), uv.stride(0), duvdx.data_ptr(), duvdx.stride(0),
                duvdy.data_ptr(), duvdy.stride(0), mat_ptr, mat_s, rows.data_ptr(),
                rows.stride(0), rows.shape[0], L, texels_mq.data_ptr(), texels_mq.shape[0],
                kind, tail_ptr, n_tail, int(taps), int(bool(decode_srgb)), n_slots, slot_code,
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"material sampler kernel launch failed: cudaError_t {err}")
        _launched(_MATERIAL_COUNTER)
    return out


sample_material.LAUNCHES = 0
# the wrapper whose LAUNCHES count its kernel, however the module's name is
# rebound later (a recording or plain twin put in its place)
_MATERIAL_COUNTER = sample_material


def _slot_code(slots) -> tuple:
    """The kernels' slot list: 2 bits a slot, the first slot lowest."""
    slots = tuple(int(s) for s in slots)
    if not slots or len(slots) > 4 or len(set(slots)) != len(slots) \
            or not all(0 <= s < 4 for s in slots):
        raise ValueError(f"slots must be distinct material slots 0..3, got {slots}")
    return sum(s << (2 * k) for k, s in enumerate(slots)), len(slots)


def _check_lanes(name, dev, uv, duvdx, duvdy) -> int:
    """The lanes of (P, 2) f32 uv and derivatives (any lane stride, the
    two components adjacent), 4-byte aligned, on dev -> P."""
    lanes = uv.shape[0] if uv.dim() == 2 else -1
    for arg, t in (("uv", uv), ("duvdx", duvdx), ("duvdy", duvdy)):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape != (lanes, 2) or t.stride(1) != 1 or t.data_ptr() % 4:
            raise ValueError(f"{name}: {arg} must be (P, 2) with adjacent components, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if lanes >= 2 ** 31:
        raise ValueError(f"{name}: {lanes} lanes")
    return lanes


def _check_pool(name, pool, dev, width) -> None:
    """A contiguous (N, width) u8 pool on dev whose rows are aligned for
    the kernel's loads (16 B; 4 B for the flat pool)."""
    if pool.device != dev:
        raise ValueError(f"{name} is on {pool.device}, expected {dev}")
    if pool.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8, got {pool.dtype}")
    if pool.dim() != 2 or pool.shape[1] != width or not pool.is_contiguous() \
            or pool.data_ptr() % (4 if width == 4 else 16) or pool.shape[0] == 0:
        raise ValueError(f"{name} must be a contiguous, aligned, non-empty (N, {width}) pool, "
                         f"got {tuple(pool.shape)}")


def _check_rows(name, rows, dev, head: int, per_level: int) -> int:
    """A (R, head + per_level * L) f32 material table (rows adjacent
    columns, any row stride) on dev -> L >= 1."""
    if rows.device != dev:
        raise ValueError(f"{name} is on {rows.device}, expected {dev}")
    if rows.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {rows.dtype}")
    cols = rows.shape[-1] if rows.dim() == 2 else 0
    L = (cols - head) // per_level
    if rows.dim() != 2 or L < 1 or cols != head + per_level * L or rows.stride(1) != 1 \
            or rows.data_ptr() % 4 or rows.shape[0] == 0:
        raise ValueError(f"{name} must be a non-empty (R, {head} + {per_level} L) table with "
                         f"L >= 1, got {tuple(rows.shape)} strides {rows.stride()}")
    return L


def _check_mat(mat, rows, lanes, dev) -> tuple:
    """(pointer, stride) of the lanes' (P,) i32 material ids (any stride);
    (None, 0) when mat is None, which takes a row of `rows` a lane."""
    if mat is None:
        if rows.shape[0] != lanes:
            raise ValueError(f"a row a lane: rows must have {lanes} rows, got {rows.shape[0]}")
        return None, 0
    if mat.device != dev:
        raise ValueError(f"mat is on {mat.device}, expected {dev}")
    if mat.dtype != torch.int32:
        raise TypeError(f"mat must be int32, got {mat.dtype}")
    if mat.shape != (lanes,) or mat.data_ptr() % 4:
        raise ValueError(f"mat must be ({lanes},), got {tuple(mat.shape)}")
    return mat.data_ptr(), mat.stride(0)
