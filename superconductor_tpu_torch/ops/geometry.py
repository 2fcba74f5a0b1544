"""Geometry stage: draw expansion, vertex transform/skinning, homogeneous
triangle setup -- the port of ``superconductor_tpu/ops/geometry.py``.

Same data model as the reference: a (T, 16) f32 setup row per triangle
pair, [a0,b0,c0, a1,b1,c1, a2,b2,c2, zc0,zc1,zc2, wc0,wc1,wc2, flags], with
edge i evaluated as e_i(px, py) = a_i*px + b_i*py + c_i, plus a packed (T,
32) attribute row for the deferred stages. Integer tensors stay i32 at
every public boundary.

Two places where torch and jax differ and the port chooses on purpose:

* ``jnp.repeat(..., total_repeat_length=cap)`` becomes
  ``searchsorted(cumsum(counts), arange(cap), right=True)`` -- identical
  output for any total, including total != cap;
* the per-view clip transform (reference: ``w1 @ view_proj.T``) is written
  as explicit multiply-adds in a fixed order, so no library matmul (and no
  TF32) decides its rounding. A one-ulp change in a clip coordinate moves
  an edge coefficient by up to a few percent (the coefficients are
  differences of near-equal products), so the order matters: it is the
  one XLA's CPU dot uses, which makes the setup rows bit-exact.

``geometry_vertex_stage`` and ``geometry_view_setup`` launch
``csrc/geometry.cu``'s ``vertex_stage_kernel`` (two launches: the vertex
phase, then the triangle phase) and ``view_setup_kernel`` (one launch) on
CUDA tensors, bit for bit with the torch chains, and run those chains,
``geometry_vertex_stage_plain`` and ``geometry_view_setup_plain``, on CPU
tensors; anything a kernel does not take raises. Both take an optional
``out``: the rows of a larger table (``row_slice``) that the results are
written into. ``geometry_vertex_stage_merged`` and
``geometry_view_setup_merged`` do the same for the frame's static and
animated lists at once (``VertexList``), their rows in one merged table:
two vertex-stage launches for both lists and one setup launch a view.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..math3d import quat_rotate, similarity_apply

FLAG_BACKFACING = 1.0
PACKED_COLS = 32  # TriangleAttrs.packed's columns (pack_attrs)
SETUP_COLS = 16  # TriangleSetup.setup's columns
# csrc/geometry.cu vertex_stage_kernel: each block of the vertex phase
# keeps the draws' vertex count prefixes in shared memory, 4 B a draw
MAX_DRAWS = 16384
MAX_LISTS = 2  # draw lists a merged launch takes (csrc/geometry.cu kMaxLists)


def device_values(values, dtype, device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device), the same numbers,
    made on a CUDA device by one fill a value: a copy from pageable host
    memory synchronises with the host, and a CUDA graph cannot capture it."""
    host = torch.tensor(values, dtype=dtype)
    flat = [torch.full((), v, dtype=dtype, device=device) for v in host.reshape(-1).tolist()]
    return torch.stack(flat).reshape(host.shape)


class DrawList(NamedTuple):
    """One pass's instances padded to a static capacity (reference
    DrawList, ops/geometry.py:44): sim8 (N, 8) f32; first_tri, tri_count,
    first_vertex, vertex_count, joints_offset, material (N,) i32;
    lightmapped, valid (N,) bool."""

    sim8: torch.Tensor
    first_tri: torch.Tensor
    tri_count: torch.Tensor
    first_vertex: torch.Tensor
    vertex_count: torch.Tensor
    joints_offset: torch.Tensor
    material: torch.Tensor
    lightmapped: torch.Tensor
    valid: torch.Tensor


class TriangleSetup(NamedTuple):
    setup: torch.Tensor  # (T, 16) f32
    tri_id: torch.Tensor  # (T,) i32 scene triangle id
    inst_id: torch.Tensor  # (T,) i32 row into the DrawList
    bbox: torch.Tensor  # (T, 4) i32 [x0, y0, x1, y1] inclusive pixels
    valid: torch.Tensor  # (T,) bool
    num_valid: torch.Tensor  # () i32


class TriangleAttrs(NamedTuple):
    world_pos: torch.Tensor  # (T, 3, 3)
    normal: torch.Tensor  # (T, 3, 3)
    uv: torch.Tensor  # (T, 3, 2)
    lm_uv: torch.Tensor  # (T, 3, 2)
    material: torch.Tensor  # (T,) i32
    lightmapped: torch.Tensor  # (T,) bool
    # world_pos(9) | normal(9) | uv(6) | lm_uv(6) | material (i32 bits) |
    # lightmapped -- see pack_attrs
    packed: Optional[torch.Tensor] = None


def ragged_owner(counts: torch.Tensor, cap: int) -> tuple:
    """Expansion of per-row counts into `cap` slots: (owner (cap,) i32,
    slot_valid (cap,) bool, offsets (n,) i32, total () i32). owner[p] is
    the row whose range holds slot p (0 where p >= total), the port of
    ``jnp.repeat(arange(n), counts, total_repeat_length=cap)``."""
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    offsets = ends - counts
    total = counts.sum(dtype=torch.int32)
    pos = torch.arange(cap, dtype=torch.int32, device=counts.device)
    owner = torch.searchsorted(ends, pos, right=True, out_int32=True)
    slot_valid = pos < total
    owner = torch.where(slot_valid, owner, torch.zeros_like(owner))
    return owner, slot_valid, offsets, total


def expand_draws(draws: DrawList, t_cap: int):
    """Draw list -> per-triangle (inst_id, scene_tri, valid, total)."""
    counts = torch.where(draws.valid, draws.tri_count, torch.zeros_like(draws.tri_count))
    pair_inst, pair_valid, offsets, total = ragged_owner(counts, t_cap)
    pos = torch.arange(t_cap, dtype=torch.int32, device=counts.device)
    local = pos - offsets[pair_inst]
    scene_tri = draws.first_tri[pair_inst] + local
    scene_tri = torch.where(pair_valid, scene_tri, torch.zeros_like(scene_tri))
    return pair_inst, scene_tri, pair_valid, total


def expand_draw_vertices(draws: DrawList, v_cap: int):
    """Draw list -> (draw, vertex) pairs: (vp_inst, scene_vertex, offsets,
    vp_valid, total)."""
    counts = torch.where(
        draws.valid, draws.vertex_count, torch.zeros_like(draws.vertex_count)
    )
    vp_inst, vp_valid, offsets, total = ragged_owner(counts, v_cap)
    pos = torch.arange(v_cap, dtype=torch.int32, device=counts.device)
    local = pos - offsets[vp_inst]
    scene_vertex = torch.where(
        vp_valid, draws.first_vertex[vp_inst] + local, torch.zeros_like(local)
    )
    return vp_inst, scene_vertex, offsets, vp_valid, total


def skin_vertices(positions, normals, joint_indices, joint_weights, palette8):
    """Joint-palette skinning on packed Similarity joints (reference
    skin_vertices, ops/geometry.py:113). Joint rows clamp into the palette
    as the reference's gather does."""
    w = joint_weights / torch.sum(joint_weights, dim=-1, keepdim=True)
    ji = joint_indices.clamp(0, palette8.shape[0] - 1)
    j = palette8[ji]  # (..., 4, 8)
    p = similarity_apply(j, positions[..., None, :])
    skinned_pos = torch.sum(w[..., None] * p, dim=-2)
    n = quat_rotate(j[..., 4:8], normals[..., None, :])
    skinned_nrm = torch.sum(w[..., None] * n, dim=-2)
    return skinned_pos, skinned_nrm


def _uv_transform(uv, offset, scale, rotation):
    """KHR_texture_transform: offset + rot(rotation) * (scale * uv)."""
    c = torch.cos(rotation)[..., None]
    s = torch.sin(rotation)[..., None]
    su = uv * scale
    x = c[..., 0] * su[..., 0] - s[..., 0] * su[..., 1]
    y = s[..., 0] * su[..., 0] + c[..., 0] * su[..., 1]
    return offset + torch.stack([x, y], dim=-1)


class VertexList(NamedTuple):
    """One draw list's inputs to the vertex stage (geometry_vertex_stage's
    arguments but the materials and `out`), for the merged entries."""

    draws: DrawList
    indices: torch.Tensor
    positions: torch.Tensor
    normals: torch.Tensor
    uvs: torch.Tensor
    lm_uvs: Optional[torch.Tensor]
    tri_material: torch.Tensor
    t_cap: int
    v_cap: Optional[int] = None
    joint_palette: Optional[torch.Tensor] = None
    joint_indices: Optional[torch.Tensor] = None
    joint_weights: Optional[torch.Tensor] = None


class VertexStage(NamedTuple):
    """View-independent geometry (reference VertexStage, :162)."""

    w1: torch.Tensor  # (V_cap, 4) world-space homogeneous positions
    row3: torch.Tensor  # (T_cap, 3) transformed-vertex rows per corner
    pair_inst: torch.Tensor
    scene_tri: torch.Tensor
    pair_valid: torch.Tensor
    double_sided: torch.Tensor
    num_valid: torch.Tensor
    attrs: TriangleAttrs


def geometry_vertex_stage_plain(
    draws: DrawList,
    indices: torch.Tensor,
    positions: torch.Tensor,
    normals: torch.Tensor,
    uvs: torch.Tensor,
    lm_uvs: Optional[torch.Tensor],
    tri_material: torch.Tensor,
    materials: dict,
    t_cap: int,
    v_cap: Optional[int] = None,
    joint_palette: Optional[torch.Tensor] = None,
    joint_indices: Optional[torch.Tensor] = None,
    joint_weights: Optional[torch.Tensor] = None,
    out: Optional[TriangleAttrs] = None,
) -> VertexStage:
    """geometry_vertex_stage's plain version, the torch chain: every
    (draw, vertex) pair is skinned/transformed once, then triangles gather
    their three transformed rows (reference :194). With `out`, the packed
    rows and lightmapped flags are copied into out's and the attributes
    returned as views of them (attrs_rows)."""
    v_cap = v_cap or t_cap
    dev = positions.device

    vp_inst, scene_v, voffsets, vp_valid, vtotal = expand_draw_vertices(draws, v_cap)
    pos = positions[scene_v]
    nrm = normals[scene_v]
    uv = uvs[scene_v]
    lm = lm_uvs[scene_v] if lm_uvs is not None else torch.zeros_like(uv)

    if joint_palette is not None:
        ji = joint_indices[scene_v] + draws.joints_offset[vp_inst][:, None]
        jw = joint_weights[scene_v]
        pos, nrm = skin_vertices(pos, nrm, ji, jw, joint_palette)

    sim8 = draws.sim8[vp_inst]
    world_v = similarity_apply(sim8, pos)
    nrm_v = quat_rotate(sim8[:, 4:8], nrm)

    dmat = draws.material[vp_inst]
    uv_v = _uv_transform(
        uv,
        materials["uv_offset"][dmat],
        materials["uv_scale"][dmat],
        materials["uv_rotation"][dmat],
    )
    w1 = torch.cat([world_v, torch.ones_like(world_v[..., :1])], dim=-1)

    pair_inst, scene_tri, pair_valid, total = expand_draws(draws, t_cap)
    corner = torch.arange(3, dtype=torch.int32, device=dev)
    idx3 = indices[scene_tri[:, None] * 3 + corner[None, :]].to(torch.int32)
    row3 = voffsets[pair_inst][:, None] + (
        idx3 - draws.first_vertex[pair_inst][:, None]
    )
    row_ok = torch.all((row3 >= 0) & (row3 < vtotal), dim=1)
    row3 = row3.clamp(0, v_cap - 1)
    pair_valid = pair_valid & row_ok

    mat = tri_material[scene_tri]
    double_sided = (materials["flags"][mat] & 2) != 0

    attrs = pack_attrs(
        TriangleAttrs(
            world_pos=world_v[row3],
            normal=nrm_v[row3],
            uv=uv_v[row3],
            lm_uv=lm[row3],
            material=mat,
            lightmapped=draws.lightmapped[pair_inst],
        )
    )
    if out is not None:
        _check_out_attrs("geometry_vertex_stage_plain", out, t_cap, dev)
        out.packed.copy_(attrs.packed)
        out.lightmapped.copy_(attrs.lightmapped)
        attrs = attrs_rows(out.packed, out.lightmapped)
    return VertexStage(
        w1=w1,
        row3=row3,
        pair_inst=pair_inst,
        scene_tri=scene_tri.to(torch.int32),
        pair_valid=pair_valid,
        double_sided=double_sided,
        num_valid=total.to(torch.int32),
        attrs=attrs,
    )


def geometry_vertex_stage_merged_plain(
    lists: tuple, materials: dict, out: Optional[TriangleAttrs] = None
) -> tuple:
    """geometry_vertex_stage_merged's plain version: each list's
    geometry_vertex_stage_plain, its rows written into `out` (a new merged
    table when None) at its offset, the lists' in order."""
    rows = sum(lst.t_cap for lst in lists)
    if out is None:
        out = attrs_table(rows, lists[0].positions.device)
    stages, at = [], 0
    for lst in lists:
        stages.append(geometry_vertex_stage_plain(
            **lst._asdict(), materials=materials, out=row_slice(out, at, at + lst.t_cap)))
        at += lst.t_cap
    return tuple(stages)


def clip_transform(w1: torch.Tensor, view_proj: torch.Tensor) -> torch.Tensor:
    """(..., 4) rows times view_proj^T as explicit multiply-adds in the fixed
    order (x*m0 + y*m1) + (z*m2 + w*m3) per output column -- the order
    XLA's CPU dot uses for these shapes (the reference's matmuls and
    einsums of rows by a 4x4), so the port's clip coordinates (and with
    them the setup rows) equal the reference's bit for bit. The products
    and sums are separate ops: no FMA contraction, no TF32."""
    m = view_proj.to(w1.dtype)
    cols = [
        (w1[..., 0] * m[j, 0] + w1[..., 1] * m[j, 1])
        + (w1[..., 2] * m[j, 2] + w1[..., 3] * m[j, 3])
        for j in range(4)
    ]
    return torch.stack(cols, dim=-1)


def geometry_view_setup_plain(
    stage: VertexStage,
    view_proj: torch.Tensor,
    width: int,
    height: int,
    flip_viewport: bool = False,
    out: Optional[TriangleSetup] = None,
) -> TriangleSetup:
    """geometry_view_setup's plain version, the torch chain: the clip
    transform, then the homogeneous edge setup. With `out`, every row field
    is copied into out's and out's tensors are returned."""
    clip_v = clip_transform(stage.w1, view_proj)
    clip = clip_v[stage.row3]  # (T, 3, 4)
    setup, valid, bbox = _setup_from_clip(
        clip, stage.pair_valid, stage.double_sided, width, height,
        flip_viewport, vertex_ids=stage.row3,
    )
    tri = TriangleSetup(
        setup=setup,
        tri_id=stage.scene_tri,
        inst_id=stage.pair_inst,
        bbox=bbox,
        valid=valid,
        num_valid=stage.num_valid,
    )
    if out is None:
        return tri
    _check_out_setup("geometry_view_setup_plain", out, stage.row3.shape[0], stage.w1.device)
    for name in ("setup", "tri_id", "inst_id", "bbox", "valid"):
        getattr(out, name).copy_(getattr(tri, name))
    return out._replace(num_valid=stage.num_valid)


def geometry_view_setup_merged_plain(
    stages: tuple,
    view_proj: torch.Tensor,
    width: int,
    height: int,
    flip_viewport: bool = False,
    out: Optional[TriangleSetup] = None,
) -> TriangleSetup:
    """geometry_view_setup_merged's plain version: each stage's
    geometry_view_setup_plain, its rows written into `out` (a new merged
    table when None) at its offset; num_valid the stages' summed by torch's
    add."""
    rows = sum(stage.row3.shape[0] for stage in stages)
    if out is None:
        out = setup_table(rows, stages[0].w1.device)
    num_valid, at = None, 0
    for stage in stages:
        t = stage.row3.shape[0]
        tri = geometry_view_setup_plain(stage, view_proj, width, height, flip_viewport,
                                        row_slice(out, at, at + t))
        num_valid = tri.num_valid if num_valid is None else num_valid + tri.num_valid
        at += t
    return out._replace(num_valid=num_valid)


def geometry_pass(
    draws: DrawList,
    indices: torch.Tensor,
    positions: torch.Tensor,
    normals: torch.Tensor,
    uvs: torch.Tensor,
    lm_uvs: Optional[torch.Tensor],
    tri_material: torch.Tensor,
    materials: dict,
    view_proj: torch.Tensor,  # (4, 4)
    width: int,
    height: int,
    t_cap: int,
    v_cap: Optional[int] = None,
    flip_viewport: bool = False,
    joint_palette: Optional[torch.Tensor] = None,
    joint_indices: Optional[torch.Tensor] = None,
    joint_weights: Optional[torch.Tensor] = None,
):
    """Full geometry stage of one view -> (TriangleSetup, TriangleAttrs):
    geometry_vertex_stage + geometry_view_setup (reference :319, without its
    double_sided_from_material, which no caller sets). Multi-view callers
    call the two halves and share the VertexStage across views, as
    render/frame.py does."""
    stage = geometry_vertex_stage(
        draws, indices, positions, normals, uvs, lm_uvs, tri_material, materials, t_cap,
        v_cap=v_cap, joint_palette=joint_palette, joint_indices=joint_indices,
        joint_weights=joint_weights,
    )
    tri = geometry_view_setup(stage, view_proj, width, height, flip_viewport=flip_viewport)
    return tri, stage.attrs


def pack_attrs(attrs: TriangleAttrs) -> TriangleAttrs:
    """Fill TriangleAttrs.packed (reference pack_attrs, :367)."""
    t = attrs.material.shape[0]
    packed = torch.cat(
        [
            attrs.world_pos.reshape(t, 9),
            attrs.normal.reshape(t, 9),
            attrs.uv.reshape(t, 6),
            attrs.lm_uv.reshape(t, 6),
            attrs.material.to(torch.int32).view(torch.float32).reshape(t, 1),
            attrs.lightmapped.to(torch.float32).reshape(t, 1),
        ],
        dim=-1,
    )
    return attrs._replace(packed=packed)


def _setup_from_clip(clip, pair_valid, double_sided, width, height,
                     flip_viewport, vertex_ids=None):
    """Homogeneous triangle setup from clip coords (T, 3, 4) -> (setup,
    valid, bbox); reference _setup_from_clip (:386). With vertex_ids, each
    edge's products are formed with its two vertices in canonical
    (id-sorted) order times an orientation sign, so triangles sharing an
    edge get exactly negated edge functions: watertight without snapping."""
    xc, yc, wc = clip[..., 0], clip[..., 1], clip[..., 3]
    zc = clip[..., 2]
    if flip_viewport:
        yc = -yc
    xv = (xc + wc) * (width * 0.5)
    yv = (wc - yc) * (height * 0.5)

    def edge_coeffs(j, k):
        if vertex_ids is None:
            yj, wj, xj = yv[:, j], wc[:, j], xv[:, j]
            yk, wk, xk = yv[:, k], wc[:, k], xv[:, k]
            a = yj * wk - yk * wj
            b = wj * xk - wk * xj
            c = xj * yk - xk * yj
            return a, b, c
        swap = vertex_ids[:, j] > vertex_ids[:, k]
        sign = torch.where(swap, -1.0, 1.0)

        def pick(arr):
            return (
                torch.where(swap, arr[:, k], arr[:, j]),
                torch.where(swap, arr[:, j], arr[:, k]),
            )

        yj, yk = pick(yv)
        wj, wk = pick(wc)
        xj, xk = pick(xv)
        a = (yj * wk - yk * wj) * sign
        b = (wj * xk - wk * xj) * sign
        c = (xj * yk - xk * yj) * sign
        return a, b, c

    a0, b0, c0 = edge_coeffs(1, 2)
    a1, b1, c1 = edge_coeffs(2, 0)
    a2, b2, c2 = edge_coeffs(0, 1)

    m00, m01, m02 = xv[:, 0], yv[:, 0], wc[:, 0]
    det = m00 * a0 + m01 * b0 + m02 * c0

    front_facing = det < 0.0
    keep = front_facing | double_sided
    flip = torch.where(front_facing, -1.0, 1.0)
    valid = pair_valid & keep & (det != 0.0)

    edge = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2], dim=-1) * flip[:, None]
    flags = torch.where(front_facing, 0.0, FLAG_BACKFACING)
    setup = torch.cat([edge, zc, wc, flags[:, None]], dim=-1).to(torch.float32)

    eps = 1e-6
    w_ok = wc > eps
    inv_w = torch.where(w_ok, 1.0 / torch.clamp_min(wc, eps), 0.0)
    px = xv * inv_w
    py = yv * inv_w
    big = 1e9
    x0 = torch.where(w_ok, px, big).amin(dim=1)
    x1 = torch.where(w_ok, px, -big).amax(dim=1)
    y0 = torch.where(w_ok, py, big).amin(dim=1)
    y1 = torch.where(w_ok, py, -big).amax(dim=1)
    any_behind = ~torch.all(w_ok, dim=1)
    all_behind = ~torch.any(w_ok, dim=1)
    x0 = torch.where(any_behind, 0.0, x0)
    y0 = torch.where(any_behind, 0.0, y0)
    x1 = torch.where(any_behind, float(width - 1), x1)
    y1 = torch.where(any_behind, float(height - 1), y1)
    valid = valid & ~all_behind

    offscreen = (x1 < 0) | (y1 < 0) | (x0 > width - 1) | (y0 > height - 1)
    valid = valid & ~offscreen

    bx0 = torch.floor(x0 - 0.5).clamp(0, width - 1).to(torch.int32)
    by0 = torch.floor(y0 - 0.5).clamp(0, height - 1).to(torch.int32)
    bx1 = torch.ceil(x1 + 0.5).clamp(0, width - 1).to(torch.int32)
    by1 = torch.ceil(y1 + 0.5).clamp(0, height - 1).to(torch.int32)
    bbox = torch.stack([bx0, by0, bx1, by1], dim=-1)
    return setup, valid, bbox


def make_draw_list(sim8, first_tri, tri_count, first_vertex=None,
                   vertex_count=None, joints_offset=None, material=None,
                   lightmapped=None, valid=None, device="cuda") -> DrawList:
    """Convenience constructor with defaults for optional fields."""

    def i32(x, n):
        if x is None:
            return torch.zeros(n, dtype=torch.int32, device=device)
        return torch.as_tensor(x, device=device).to(torch.int32)

    sim8 = torch.as_tensor(sim8, device=device).to(torch.float32)
    n = sim8.shape[0]
    return DrawList(
        sim8=sim8,
        first_tri=i32(first_tri, n),
        tri_count=i32(tri_count, n),
        first_vertex=i32(first_vertex, n),
        vertex_count=i32(vertex_count, n),
        joints_offset=i32(joints_offset, n),
        material=i32(material, n),
        lightmapped=torch.zeros(n, dtype=torch.bool, device=device)
        if lightmapped is None
        else torch.as_tensor(lightmapped, device=device).to(torch.bool),
        valid=torch.ones(n, dtype=torch.bool, device=device)
        if valid is None
        else torch.as_tensor(valid, device=device).to(torch.bool),
    )


# --- The rows of a merged table ---------------------------------------------

def attrs_rows(packed: torch.Tensor, lightmapped: torch.Tensor) -> TriangleAttrs:
    """TriangleAttrs of packed rows (T, 32) and lightmapped flags (T,): every
    other field a view into `packed` (pack_attrs' columns; material the
    int32 bits of column 30)."""
    t = packed.shape[0]
    return TriangleAttrs(
        world_pos=packed[:, 0:9].view(t, 3, 3),
        normal=packed[:, 9:18].view(t, 3, 3),
        uv=packed[:, 18:24].view(t, 3, 2),
        lm_uv=packed[:, 24:30].view(t, 3, 2),
        material=packed[:, 30].view(torch.int32),
        lightmapped=lightmapped,
        packed=packed,
    )


def attrs_table(rows: int, device) -> TriangleAttrs:
    """attrs_rows of new (uninitialised) tables of `rows` rows."""
    return attrs_rows(torch.empty((rows, PACKED_COLS), dtype=torch.float32, device=device),
                      torch.empty((rows,), dtype=torch.bool, device=device))


def setup_table(rows: int, device) -> TriangleSetup:
    """A TriangleSetup of new (uninitialised) row tables of `rows` rows,
    num_valid None."""
    i32 = dict(dtype=torch.int32, device=device)
    return TriangleSetup(
        setup=torch.empty((rows, SETUP_COLS), dtype=torch.float32, device=device),
        tri_id=torch.empty((rows,), **i32),
        inst_id=torch.empty((rows,), **i32),
        bbox=torch.empty((rows, 4), **i32),
        valid=torch.empty((rows,), dtype=torch.bool, device=device),
        num_valid=None,
    )


def row_slice(rows, lo: int, hi: int):
    """Rows [lo, hi) of every row field of a TriangleAttrs or TriangleSetup
    (views; a field that is None or 0-d is None)."""
    return type(rows)(*[None if f is None or f.dim() == 0 else f[lo:hi] for f in rows])


def _check_out_attrs(fn: str, out: TriangleAttrs, t_cap: int, device) -> None:
    """out.packed (t_cap, 32) f32 with adjacent columns, its rows 16-B
    aligned, and out.lightmapped (t_cap,) bool, contiguous, on `device`."""
    p, lm = out.packed, out.lightmapped
    if p is None or p.device != device or p.dtype != torch.float32 \
            or tuple(p.shape) != (t_cap, PACKED_COLS) or p.stride(1) != 1 \
            or (t_cap > 1 and p.stride(0) != PACKED_COLS) or p.data_ptr() % 16:
        raise ValueError(f"{fn}: out.packed must be ({t_cap}, {PACKED_COLS}) float32 rows on "
                         f"{device}, 16-B aligned, got "
                         + ("None" if p is None else f"{p.dtype} {tuple(p.shape)} strides "
                            f"{p.stride()} on {p.device}"))
    if lm is None or lm.device != device or lm.dtype != torch.bool \
            or tuple(lm.shape) != (t_cap,) or not lm.is_contiguous():
        raise ValueError(f"{fn}: out.lightmapped must be ({t_cap},) bool on {device}, got "
                         + ("None" if lm is None else f"{lm.dtype} {tuple(lm.shape)} on "
                            f"{lm.device}"))


def _check_out_setup(fn: str, out: TriangleSetup, rows: int, device) -> None:
    """out's setup (rows, 16) f32 and bbox (rows, 4) i32, 16-B aligned,
    tri_id and inst_id (rows,) i32, valid (rows,) bool, each contiguous on
    `device`."""
    want = {"setup": ((rows, SETUP_COLS), torch.float32), "tri_id": ((rows,), torch.int32),
            "inst_id": ((rows,), torch.int32), "bbox": ((rows, 4), torch.int32),
            "valid": ((rows,), torch.bool)}
    for name, (shape, dtype) in want.items():
        t = getattr(out, name)
        if t is None or t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or (name in ("setup", "bbox") and t.data_ptr() % 16):
            raise ValueError(f"{fn}: out.{name} must be {shape} {dtype} contiguous on {device}"
                             + (", 16-B aligned" if name in ("setup", "bbox") else "") + ", got "
                             + ("None" if t is None else f"{t.dtype} {tuple(t.shape)} on "
                                f"{t.device}"))


# --- The kernels (csrc/geometry.cu) ------------------------------------------

def _i64_or_pointer(name: str):
    return ctypes.c_longlong if name in ("n", "lists", "parts", "t_cap", "v_cap", "v_rows",
                                         "width", "height", "flip_viewport") \
        or name.startswith("n_") else ctypes.c_void_p


def _mirror(name: str, fields: tuple, extra: tuple = ()):
    """A ctypes Structure of `fields` (each 8 B) and then `extra`."""
    return type(name, (ctypes.Structure,), {
        "_fields_": [(f, _i64_or_pointer(f)) for f in fields] + list(extra),
        "__doc__": f"csrc/geometry.cu {name.lstrip('_')}, field for field."})


_ListArgs = _mirror("_ListArgs", (
    "n", "sim8", "first_tri", "tri_count", "first_vertex", "vertex_count", "joints_offset",
    "material", "lightmapped", "valid", "t_cap", "v_cap", "indices", "n_indices", "positions",
    "n_positions", "normals", "n_normals", "uvs", "n_uvs", "lm_uvs", "n_lm_uvs",
    "tri_material", "n_tri_material", "palette", "n_palette", "joint_indices",
    "n_joint_indices", "joint_weights", "n_joint_weights", "ends", "corner", "w1", "row3",
    "pair_inst", "scene_tri", "pair_valid", "double_sided", "num_valid", "packed",
    "lightmapped_out"))
_VertexArgs = _mirror("_VertexArgs", (
    "lists", "uv_offset", "n_uv_offset", "uv_scale", "n_uv_scale", "uv_rotation",
    "n_uv_rotation", "mat_flags", "n_mat_flags"), (("list", _ListArgs * MAX_LISTS),))
_SetupPart = _mirror("_SetupPart", (
    "t_cap", "v_rows", "row3", "pair_valid", "double_sided", "w1", "scene_tri", "pair_inst",
    "num_valid"))
_SetupArgs = _mirror("_SetupArgs", (
    "parts", "view_proj", "width", "height", "flip_viewport", "setup", "valid", "bbox",
    "tri_id", "inst_id", "num_valid"), (("part", _SetupPart * MAX_LISTS),))
# sc_geometry_args_bytes(which) -> the mirror of that struct
_MIRRORS = (_VertexArgs, _SetupArgs, _ListArgs, _SetupPart)

_args_checked: list = []  # True once every mirror's size matched the library's


def _kernel(symbol: str):
    """The geometry library's entry point `symbol`, after checking (once)
    that each struct of arguments in the library has its mirror's size."""
    from .raster import _kernel_fn

    if not _args_checked:
        for which, mirror in enumerate(_MIRRORS):
            size = _kernel_fn("sc_geometry_args_bytes")(which)
            if size != ctypes.sizeof(mirror):
                raise RuntimeError(f"csrc/geometry.cu's {mirror.__name__.lstrip('_')} takes "
                                   f"{size} B, its ctypes mirror {ctypes.sizeof(mirror)} B")
        _args_checked.append(True)
    return _kernel_fn(symbol)


def _launched(wrapper) -> None:
    """ops/raster.py _launched (imported at the call: ops/raster.py imports
    this module)."""
    from .raster import _launched as launched

    launched(wrapper)


def _table(fn: str, name: str, t, dtype, cols, device) -> None:
    """t: a non-empty contiguous table of `dtype` on `device`, 1-D (cols
    None) or (rows, cols)."""
    if t is None:
        raise ValueError(f"{fn}: {name} is missing")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    shape_ok = t.dim() == 1 if cols is None else (t.dim() == 2 and t.shape[1] == cols)
    if not shape_ok or t.shape[0] < 1 or not t.is_contiguous():
        want = "(rows,)" if cols is None else f"(rows, {cols})"
        raise ValueError(f"{fn}: {name} must be a non-empty contiguous {want} table, got "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _draws_checked(fn: str, draws: DrawList, device) -> int:
    """The draw list's rows, after checking its columns."""
    n = draws.sim8.shape[0] if draws.sim8.dim() == 2 else -1
    _table(fn, "draws.sim8", draws.sim8, torch.float32, 8, device)
    for name in ("first_tri", "tri_count", "first_vertex", "vertex_count", "joints_offset",
                 "material"):
        _table(fn, f"draws.{name}", getattr(draws, name), torch.int32, None, device)
    for name in ("lightmapped", "valid"):
        _table(fn, f"draws.{name}", getattr(draws, name), torch.bool, None, device)
    if any(c.shape[0] != n for c in draws[1:]) or n > MAX_DRAWS:
        raise ValueError(f"{fn}: the draw list's columns must hold the same 1 to {MAX_DRAWS} "
                         f"rows, got {[tuple(c.shape) for c in draws]}")
    return n


def _list_checked(fn: str, lst: VertexList, device) -> tuple:
    """(draw rows, t_cap, v_cap) of one list, after checking its inputs."""
    n = _draws_checked(fn, lst.draws, device)
    _table(fn, "indices", lst.indices, torch.int32, None, device)
    _table(fn, "positions", lst.positions, torch.float32, 3, device)
    _table(fn, "normals", lst.normals, torch.float32, 3, device)
    _table(fn, "uvs", lst.uvs, torch.float32, 2, device)
    if lst.lm_uvs is not None:
        _table(fn, "lm_uvs", lst.lm_uvs, torch.float32, 2, device)
    _table(fn, "tri_material", lst.tri_material, torch.int32, None, device)
    if lst.joint_palette is not None:
        _table(fn, "joint_palette", lst.joint_palette, torch.float32, 8, device)
        _table(fn, "joint_indices", lst.joint_indices, torch.int32, 4, device)
        _table(fn, "joint_weights", lst.joint_weights, torch.float32, 4, device)
    t_cap, v_cap = lst.t_cap, lst.v_cap or lst.t_cap
    if not (1 <= t_cap and 1 <= v_cap and t_cap + v_cap < 2 ** 31):
        raise ValueError(f"{fn}: t_cap {t_cap} and v_cap {v_cap} must be at least 1 and sum "
                         f"under 2 ** 31")
    return n, t_cap, v_cap


def _lists_checked(fn: str, lists, device) -> list:
    """[(n, t_cap, v_cap)] of the lists, after checking them; the caps
    summed over the lists must stay under 2 ** 31 too."""
    sizes = [_list_checked(fn, lst, device) for lst in lists]
    if sum(t + v for _, t, v in sizes) >= 2 ** 31:
        raise ValueError(f"{fn}: the lists' capacities must sum under 2 ** 31")
    return sizes


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _vertex_stages(fn: str, lists, materials: dict, out: Optional[TriangleAttrs],
                   counter) -> tuple:
    """The VertexStage of each list, by one vertex-phase and one
    triangle-phase launch of csrc/geometry.cu vertex_stage_kernel over all
    of them, each list's rows in new tables of all the lists (w1, the
    scratch, the prefixes and the triangle fields) and in `out` (a new
    merged attribute table when None) at its offset. Counts the two
    launches on `counter`."""
    if not isinstance(lists, (tuple, list)) or not 1 <= len(lists) <= MAX_LISTS:
        raise ValueError(f"{fn}: 1 to {MAX_LISTS} draw lists, got "
                         f"{len(lists) if isinstance(lists, (tuple, list)) else type(lists)}")
    dev = lists[0].positions.device
    sizes = _lists_checked(fn, lists, dev)
    for name, dtype, cols in (("uv_offset", torch.float32, 2), ("uv_scale", torch.float32, 2),
                              ("uv_rotation", torch.float32, None), ("flags", torch.int32, None)):
        _table(fn, f"materials[{name!r}]", materials.get(name), dtype, cols, dev)
    rows = sum(t for _, t, _ in sizes)
    if out is None:
        out = attrs_table(rows, dev)
    else:
        _check_out_attrs(fn, out, rows, dev)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: the kernel runs on CUDA tensors, not {dev}")

    i32 = dict(dtype=torch.int32, device=dev)
    vertices = sum(v for _, _, v in sizes)
    w1 = torch.empty((vertices, 4), dtype=torch.float32, device=dev)
    corner = torch.empty((2 * vertices, 4), dtype=torch.float32, device=dev)
    ends = torch.empty((2 * sum(n for n, _, _ in sizes),), **i32)
    row3 = torch.empty((rows, 3), **i32)
    pair_inst = torch.empty((rows,), **i32)
    scene_tri = torch.empty((rows,), **i32)
    pair_valid = torch.empty((rows,), dtype=torch.bool, device=dev)
    double_sided = torch.empty((rows,), dtype=torch.bool, device=dev)
    num_valid = torch.empty((len(lists),), **i32)
    parts, stages = [], []
    t0 = v0 = n0 = 0
    for i, (lst, (n, t_cap, v_cap)) in enumerate(zip(lists, sizes)):
        skinned = lst.joint_palette is not None
        tri = slice(t0, t0 + t_cap)
        stage = VertexStage(
            w1=w1[v0:v0 + v_cap], row3=row3[tri], pair_inst=pair_inst[tri],
            scene_tri=scene_tri[tri], pair_valid=pair_valid[tri],
            double_sided=double_sided[tri], num_valid=num_valid[i],
            attrs=attrs_rows(out.packed[tri], out.lightmapped[tri]))
        parts.append(_ListArgs(
            n, *[c.data_ptr() for c in lst.draws], t_cap, v_cap,
            *[x for t in (lst.indices, lst.positions, lst.normals, lst.uvs, lst.lm_uvs,
                          lst.tri_material)
              for x in (_ptr(t), 0 if t is None else t.shape[0])],
            *[x for t in (lst.joint_palette, lst.joint_indices, lst.joint_weights)
              for x in ((t.data_ptr(), t.shape[0]) if skinned else (None, 0))],
            ends[2 * n0:].data_ptr(), corner[2 * v0:].data_ptr(),
            *[t.data_ptr() for t in (stage.w1, stage.row3, stage.pair_inst, stage.scene_tri,
                                     stage.pair_valid, stage.double_sided, stage.num_valid,
                                     stage.attrs.packed, stage.attrs.lightmapped)]))
        stages.append(stage)
        t0, v0, n0 = t0 + t_cap, v0 + v_cap, n0 + n
    m = materials
    args = _VertexArgs(
        len(lists), *[x for name in ("uv_offset", "uv_scale", "uv_rotation", "flags")
                      for x in (m[name].data_ptr(), m[name].shape[0])],
        (_ListArgs * MAX_LISTS)(*parts))
    with torch.cuda.device(dev):
        err = _kernel("sc_vertex_stage")(ctypes.addressof(args),
                                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vertex stage kernel launch failed: cudaError_t {err}")
    _launched(counter)  # the vertex phase
    _launched(counter)  # the triangle phase
    return tuple(stages)


def geometry_vertex_stage(
    draws: DrawList,
    indices: torch.Tensor,
    positions: torch.Tensor,
    normals: torch.Tensor,
    uvs: torch.Tensor,
    lm_uvs: Optional[torch.Tensor],
    tri_material: torch.Tensor,
    materials: dict,
    t_cap: int,
    v_cap: Optional[int] = None,
    joint_palette: Optional[torch.Tensor] = None,
    joint_indices: Optional[torch.Tensor] = None,
    joint_weights: Optional[torch.Tensor] = None,
    out: Optional[TriangleAttrs] = None,
) -> VertexStage:
    """View-independent half of the geometry pass: every (draw, vertex)
    pair is skinned/transformed once, then triangles gather their three
    transformed rows (reference :194). CUDA tensors launch csrc/geometry.cu
    vertex_stage_kernel twice, its vertex phase and its triangle phase (bit
    for bit with the plain version on the card); CPU tensors run
    geometry_vertex_stage_plain; anything the kernel does not take raises.
    The attributes are views into the packed rows (attrs_rows), which go
    into out.packed and out.lightmapped when `out` is given. Counts its
    launches in geometry_vertex_stage.LAUNCHES."""
    if positions.device.type == "cpu":
        return geometry_vertex_stage_plain(
            draws, indices, positions, normals, uvs, lm_uvs, tri_material, materials, t_cap,
            v_cap, joint_palette, joint_indices, joint_weights, out)
    lst = VertexList(draws, indices, positions, normals, uvs, lm_uvs, tri_material, t_cap,
                     v_cap, joint_palette, joint_indices, joint_weights)
    return _vertex_stages("geometry_vertex_stage", (lst,), materials, out,
                          _VERTEX_STAGE_COUNTER)[0]


geometry_vertex_stage.LAUNCHES = 0
# the wrapper whose LAUNCHES count the vertex stage kernel's launches,
# however the frame's name for it is rebound (a recording or plain twin)
_VERTEX_STAGE_COUNTER = geometry_vertex_stage


def geometry_vertex_stage_merged(lists: tuple, materials: dict,
                                 out: Optional[TriangleAttrs] = None) -> tuple:
    """The vertex stage of 1 or 2 draw lists (VertexList each, sharing
    `materials`) -> their VertexStages, each list's packed rows and
    lightmapped flags written into `out` (a new table of the lists' t_cap
    summed when None) at its offset, the lists' in order. CUDA tensors
    launch csrc/geometry.cu vertex_stage_kernel twice for all the lists
    (bit for bit with the plain version on the card); CPU tensors run
    geometry_vertex_stage_merged_plain; anything the kernel does not take
    raises. Counts its launches in geometry_vertex_stage_merged.LAUNCHES."""
    if lists and lists[0].positions.device.type == "cpu":
        return geometry_vertex_stage_merged_plain(lists, materials, out)
    return _vertex_stages("geometry_vertex_stage_merged", lists, materials, out,
                          _VERTEX_STAGE_MERGED_COUNTER)


geometry_vertex_stage_merged.LAUNCHES = 0
_VERTEX_STAGE_MERGED_COUNTER = geometry_vertex_stage_merged


def _stage_checked(fn: str, stage: VertexStage, device, merged: bool) -> int:
    """A stage's triangle slots, after checking what the setup reads of it
    (its num_valid too when `merged`)."""
    t_cap = stage.row3.shape[0] if stage.row3.dim() == 2 else -1
    _table(fn, "stage.row3", stage.row3, torch.int32, 3, device)
    _table(fn, "stage.w1", stage.w1, torch.float32, 4, device)
    if stage.w1.data_ptr() % 16:
        raise ValueError(f"{fn}: stage.w1 must be 16-B aligned")
    for name, dtype in (("pair_valid", torch.bool), ("double_sided", torch.bool),
                        ("scene_tri", torch.int32), ("pair_inst", torch.int32)):
        t = getattr(stage, name)
        _table(fn, f"stage.{name}", t, dtype, None, device)
        if t.shape[0] != t_cap:
            raise ValueError(f"{fn}: stage.{name} must hold {t_cap} rows, got {t.shape[0]}")
    nv = stage.num_valid
    if merged and (nv is None or nv.device != device or nv.dtype != torch.int32
                   or nv.dim() != 0):
        raise ValueError(f"{fn}: stage.num_valid must be a () int32 tensor on {device}, got "
                         + ("None" if nv is None else f"{nv.dtype} {tuple(nv.shape)} on "
                            f"{nv.device}"))
    return t_cap


def _view_setup(fn: str, stages, view_proj: torch.Tensor, width: int, height: int,
                flip_viewport: bool, out: Optional[TriangleSetup], merged: bool,
                counter) -> TriangleSetup:
    """One launch of csrc/geometry.cu view_setup_kernel over the stages'
    slots, their rows in `out` (new tables when None) in order. `merged`:
    the stages' num_valid summed into a new tensor, tri_id and inst_id
    always copied; else (one stage) its num_valid, and tri_id and inst_id
    copied only into an `out`. Counts the launch on `counter`."""
    if not isinstance(stages, (tuple, list)) or not 1 <= len(stages) <= MAX_LISTS:
        raise ValueError(f"{fn}: 1 to {MAX_LISTS} stages, got "
                         f"{len(stages) if isinstance(stages, (tuple, list)) else type(stages)}")
    dev = stages[0].w1.device
    t_caps = [_stage_checked(fn, stage, dev, merged) for stage in stages]
    if view_proj.device != dev or view_proj.dtype != torch.float32 \
            or tuple(view_proj.shape) != (4, 4) or not view_proj.is_contiguous():
        raise ValueError(f"{fn}: view_proj must be a contiguous (4, 4) float32 matrix on {dev}, "
                         f"got {view_proj.dtype} {tuple(view_proj.shape)} on {view_proj.device}")
    if not (1 <= width < 2 ** 31 and 1 <= height < 2 ** 31):
        raise ValueError(f"{fn}: {width} x {height} px")
    rows = sum(t_caps)
    if rows >= 2 ** 31:
        raise ValueError(f"{fn}: the stages' triangle slots must sum under 2 ** 31")
    if out is not None:
        _check_out_setup(fn, out, rows, dev)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: the kernel runs on CUDA tensors, not {dev}")

    if out is not None:
        tri = out
    elif merged:
        tri = setup_table(rows, dev)
    else:
        tri = setup_table(rows, dev)._replace(tri_id=stages[0].scene_tri,
                                              inst_id=stages[0].pair_inst)
    copy_ids = merged or out is not None
    num_valid = torch.empty((), dtype=torch.int32, device=dev) if merged \
        else stages[0].num_valid
    parts = [_SetupPart(t, s.w1.shape[0], *[x.data_ptr() for x in (
        s.row3, s.pair_valid, s.double_sided, s.w1, s.scene_tri, s.pair_inst)],
        s.num_valid.data_ptr() if merged else None) for t, s in zip(t_caps, stages)]
    args = _SetupArgs(
        len(stages), view_proj.data_ptr(), int(width), int(height), int(bool(flip_viewport)),
        tri.setup.data_ptr(), tri.valid.data_ptr(), tri.bbox.data_ptr(),
        *((tri.tri_id.data_ptr(), tri.inst_id.data_ptr()) if copy_ids else (None, None)),
        num_valid.data_ptr() if merged else None, (_SetupPart * MAX_LISTS)(*parts))
    with torch.cuda.device(dev):
        err = _kernel("sc_view_setup")(ctypes.addressof(args),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"view setup kernel launch failed: cudaError_t {err}")
    _launched(counter)
    return tri._replace(num_valid=num_valid)


def geometry_view_setup(
    stage: VertexStage,
    view_proj: torch.Tensor,
    width: int,
    height: int,
    flip_viewport: bool = False,
    out: Optional[TriangleSetup] = None,
) -> TriangleSetup:
    """Per-view half: clip transform + homogeneous edge setup. CUDA
    tensors launch csrc/geometry.cu view_setup_kernel once (bit for bit
    with the plain version on the card; it reads view_proj through its
    device pointer); CPU tensors run geometry_view_setup_plain; anything the
    kernel does not take raises. With `out`, the rows (and tri_id and
    inst_id, copied from the stage) go into out's tensors. Counts its
    launches in geometry_view_setup.LAUNCHES."""
    if stage.w1.device.type == "cpu":
        return geometry_view_setup_plain(stage, view_proj, width, height, flip_viewport, out)
    return _view_setup("geometry_view_setup", (stage,), view_proj, width, height,
                       flip_viewport, out, False, _VIEW_SETUP_COUNTER)


geometry_view_setup.LAUNCHES = 0
_VIEW_SETUP_COUNTER = geometry_view_setup


def geometry_view_setup_merged(
    stages: tuple,
    view_proj: torch.Tensor,
    width: int,
    height: int,
    flip_viewport: bool = False,
    out: Optional[TriangleSetup] = None,
) -> TriangleSetup:
    """One view's setup of 1 or 2 stages (geometry_vertex_stage_merged's)
    -> one TriangleSetup of their rows in order (into `out` when given, else
    new tables), tri_id and inst_id copied from the stages, num_valid their
    sum (int32, wrapping, as torch's add). CUDA tensors launch
    csrc/geometry.cu view_setup_kernel once (bit for bit with the plain
    version on the card); CPU tensors run geometry_view_setup_merged_plain;
    anything the kernel does not take raises. Counts its launches in
    geometry_view_setup_merged.LAUNCHES."""
    if stages and stages[0].w1.device.type == "cpu":
        return geometry_view_setup_merged_plain(stages, view_proj, width, height,
                                                flip_viewport, out)
    return _view_setup("geometry_view_setup_merged", stages, view_proj, width, height,
                       flip_viewport, out, True, _VIEW_SETUP_MERGED_COUNTER)


geometry_view_setup_merged.LAUNCHES = 0
_VIEW_SETUP_MERGED_COUNTER = geometry_view_setup_merged
